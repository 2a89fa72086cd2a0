"""Shift-invariant HALS: exact block coordinate descent for conv-NMF.

The plain-NMF HALS solver (:mod:`tnmf_tpu.engine_hals`) requires the
degenerate single-transform geometry; this module lifts exact coordinate
descent to the *shift-invariant* factorization

    R[n, c, x] = sum_{m, b} H[n, m, x - b] * W[m, c, b]

for reconstruction mode ``'full'`` (``T = S - A + 1``: every activation's
atom footprint lies fully inside the sample — the classic conv-NMF /
sparse-coding formulation).  The reference library has no coordinate
solver of any kind (Lee–Seung MU only, ``TransformInvariantNMF.py:136-179``).

**The phase decomposition is what makes exact CD tractable on an
accelerator.**
A naive exact coordinate sweep is ``prod(T)`` *sequential* scalar updates
(every activation overlaps its neighbours), which no accelerator can run.
But activations of the *same phase* — positions spaced exactly ``A`` apart
per axis — have pairwise **disjoint** footprints, so the sub-block
``{H[n, m, p + A*k] : n, m, k}`` has a block-diagonal Gram: per position
``p + A*k`` it is the *same* dense atom Gram ``G = <W_m, W_m'>`` (full
overlap at equal shift), and zero across positions.  Minimizing over one
phase therefore decomposes into ``n * prod(K)`` independent M-dimensional
regularized NNLS problems sharing one ``(M, M)`` Gram — exactly the
plain-NMF HALS geometry, solved by the existing Gauss–Seidel kernel
(:func:`tnmf_tpu.engine_hals._sweep_H`) with the phase's patch
correlations as ``P``.  Sweeping the ``prod(A)`` phases in Gauss–Seidel
order (with the residual ``E = V - R`` updated after each phase) is exact
block CD over all of H:

    for p in phases:                 # prod(A) sequential steps
        P    = corr(E, W)[phase p] + G @ H[phase p]   # add own term back
        H_p  = HALS_sweep(H_p, G, P, l1, l2)          # exact per position
        E   -= conv(delta H_p, W)                     # disjoint placement

Cost: each phase touches patches that tile the whole residual once, so a
full exact H sweep costs the FLOPs of ~one MU gradient pair plus
``prod(A)`` strided passes over E (HBM-bound; measured numbers in
``benchmarks/hals_conv.py``).  Every per-position subproblem is solved by
``inner`` Gauss–Seidel passes over the atoms (Gillis & Glineur 2012
acceleration — the Gram is reused).

W updates stay multiplicative (one Lee–Seung step per outer iteration,
computed from the maintained residual: ``neg = corr_W(V)``,
``pos = corr_W(V - E)`` — no extra reconstruction).  Exact W-side CD
would need the ``(M * prod(A))^2`` activation shift-Gram with no phase
separation (all atom offsets mutually overlap); MU keeps the iteration
monotone — an exact CD block step and a majorization step both decrease
the objective — at gradient cost.  The W step does **not** sum-normalize
(HALS convention, like sklearn; matches :mod:`tnmf_tpu.engine_hals`).

Layout notes (these ARE the design): the loop-carried tensors keep
large minor dimensions, because anything reshaped per phase at a traced
offset relayouts in full.  H is carried **phase-major**,
``(P, n, M, K)`` with the per-phase position count ``K`` flattened minor
(P = prod(A)): extracting phase ``p`` is one ``dynamic_index`` on the
major axis.  The residual stays **canonical** ``(n, C, *spatial)``; the
phase-p patch correlations are one *strided* convolution
(``window_strides = A``) of a traced-offset spatial slice, and the
scatter-back of the updated phase is one transposed convolution
(``lhs_dilation = A`` — non-overlapping placement, no accumulation
conflicts).  Reshaping ``(.., K1, A1, .., Kd, Ad)`` views per phase
instead would leave ``A``-sized minor axes and make every phase pay a
full relayout of H and E.  Transform axes are zero-padded up to multiples of
``A`` so every phase has the same static patch count; padded positions
would otherwise capture real residual (their patches overhang the valid
region) and are masked back to zero after each sweep.

Energy bookkeeping is free: the loop carries ``E`` itself, so the
objective ``0.5 * ||E||^2`` needs no reconstruction (the MU engine pays
one reconstruction per recorded energy, ``engine.fit_loop_energies``).

The P*M sequential chain steps per sweep (about 1000 at 16 atoms 8x8)
are latency-bound by construction; ``benchmarks/hals_conv.py`` races
this solver against plain and extrapolated MU to a tolerance.
Recommendation: ``extrapolate=True`` for speed; ``solver='hals'`` when
exactness/guaranteed monotone descent per block matters or MU stalls.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from .engine_hals import _acc_dtype, _sweep_H
from .ops.modes import ConvPlan

def applicable(plan: ConvPlan) -> bool:
    """Shift-invariant exact CD applies to the non-degenerate 'full'
    geometry (interior-only footprints).  The degenerate case belongs to
    the cheaper plain-NMF solver (:mod:`tnmf_tpu.engine_hals`).  This is
    THE gate — the model driver and the serving export both route their
    solver='hals' geometry decisions through it."""
    return plan.mode == 'full' and math.prod(plan.transform_shape) > 1


def _geom(plan: ConvPlan):
    A = plan.atom_shape
    T = plan.transform_shape
    K = tuple(-(-t // a) for t, a in zip(T, A))
    Tp = tuple(k * a for k, a in zip(K, A))
    return A, T, K, Tp


def gram_W(W, precision):
    """Dense atom Gram ``G[m, m'] = sum_{c, b} W[m,c,b] W[m',c,b]`` (the
    per-position block of the phase sub-problem), in f32+."""
    W2 = W.reshape(W.shape[0], -1)
    W2 = W2.astype(_acc_dtype(W2))
    return jnp.matmul(W2, W2.T, precision=precision)


def _phase_starts(p, A):
    """Unravel the flat phase index into per-axis offsets (traced int32)."""
    p = jnp.asarray(p, jnp.int32)
    starts = []
    for a in reversed(A):
        p, r = jnp.divmod(p, jnp.int32(a))
        starts.append(r.astype(jnp.int32))
    return tuple(reversed(starts))


def _dn(d):
    sp = 'DHW'[3 - d:]
    return ('NC' + sp, 'OI' + sp, 'NC' + sp)


def h_phase_sweep(E_pad, H_pm, W, G, l1, l2, *, plan: ConvPlan, inner: int):
    """One exact Gauss–Seidel pass over all ``prod(A)`` phases of H.

    ``E_pad``: residual ``V - R`` zero-padded to ``Tp + A - 1`` per axis
    (canonical layout); ``H_pm``: H in the phase-major carry
    ``(P, n, M, prod(K))``.  Returns the updated pair (the residual stays
    consistent with the returned H — the invariant the outer loop relies
    on).
    """
    A, T, K, Tp = _geom(plan)
    d = plan.ndim
    P_, n, M = H_pm.shape[:3]
    C = E_pad.shape[1]
    nK = n * math.prod(K)
    acc = G.dtype
    dn = _dn(d)
    l1a, l2a = l1.astype(acc), l2.astype(acc)
    # transposed-conv kernel for the non-overlapping placement: the conv
    # correlates, so placing W at stride-A positions needs the spatially
    # flipped kernel with I=M, O=C
    Wt = jnp.flip(jnp.swapaxes(W, 0, 1).astype(acc),
                  axis=tuple(range(2, 2 + d)))
    Wc = W.astype(acc)

    # mask of positions that exist in the un-padded transform grid,
    # per phase offset: valid iff p_i + A_i * k_i < T_i
    def valid_mask(starts):
        m = None
        for i, (a, t, k) in enumerate(zip(A, T, K)):
            ki = jnp.arange(k)
            vi = (starts[i] + a * ki) < t
            vi = vi.reshape((1,) * i + (k,) + (1,) * (d - 1 - i))
            m = vi if m is None else jnp.logical_and(m, vi)
        return m  # (K1, ..., Kd)

    def body(p, carry):
        E_pad, H_pm = carry
        starts = _phase_starts(p, A)

        # phase-p activations: (n, M, K) -> rows (n*K, M)
        Hp = jax.lax.dynamic_index_in_dim(H_pm, p, axis=0, keepdims=False)
        rows = jnp.moveaxis(Hp, 1, -1).reshape(nK, M)

        # phase-p patch correlations: ONE strided conv of the traced-
        # offset spatial slice (window A, stride A -> K outputs per axis)
        Esl = jax.lax.dynamic_slice(
            E_pad, (jnp.int32(0), jnp.int32(0)) + starts, (n, C) + Tp)
        Pc = jax.lax.conv_general_dilated(
            Esl.astype(acc), Wc, window_strides=A,
            padding=[(0, 0)] * d, dimension_numbers=dn,
            preferred_element_type=acc,
            precision=plan.lax_precision)              # (n, M, K1..Kd)
        Pc = jnp.moveaxis(Pc.reshape(n, M, -1), 1, -1).reshape(nK, M)

        # P = corr(E, W)[phase] + G @ h (add the block's own term back)
        P = Pc + jnp.matmul(rows.astype(acc), G,
                            precision=plan.lax_precision)

        new = rows
        for _ in range(inner):
            new = _sweep_H(new, G, P, l1a, l2a)
        # padded positions overhang the valid region - keep them zero
        vm = valid_mask(starts).reshape(1, -1, 1)
        new = jnp.where(jnp.broadcast_to(vm, (n,) + vm.shape[1:])
                        .reshape(nK, 1), new, rows)

        # scatter-back: transposed conv (lhs_dilation = A) places each
        # delta's atom patch at its stride-A position — disjoint, so no
        # accumulation conflicts
        new_pm = jnp.moveaxis(new.reshape((n, math.prod(K), M)),
                              -1, 1)                   # (n, M, K)
        delta = (new_pm - Hp.astype(new_pm.dtype)).reshape((n, M) + K)
        dR = jax.lax.conv_general_dilated(
            delta.astype(acc), Wt, window_strides=(1,) * d,
            padding=[(a - 1, a - 1) for a in A],
            lhs_dilation=A, dimension_numbers=dn,
            preferred_element_type=acc,
            precision=plan.lax_precision)              # (n, C, Tp...)
        E_pad = jax.lax.dynamic_update_slice(
            E_pad, Esl - dR.astype(Esl.dtype),
            (jnp.int32(0), jnp.int32(0)) + starts)

        H_pm = jax.lax.dynamic_update_index_in_dim(
            H_pm, new_pm.astype(H_pm.dtype), p, axis=0)
        return E_pad, H_pm

    # unroll=2 overlaps consecutive phases' slicing/addressing work
    # (the phases stay sequentially dependent through E — unrolling is
    # semantically identity)
    return jax.lax.fori_loop(0, math.prod(A), body, (E_pad, H_pm),
                             unroll=2)


def _pad_to(x, spatial, ndim):
    pads = [(0, 0)] * (x.ndim - ndim) + [
        (0, s - xs) for s, xs in zip(spatial, x.shape[x.ndim - ndim:])]
    return jnp.pad(x, pads)


def _encode(V, W, H, plan):
    """Canonical (V, W, H) -> the loop-carried (E_pad, H_pm) pair."""
    from .ops import conv
    A, T, K, Tp = _geom(plan)
    d = plan.ndim
    n, M = H.shape[:2]
    R = conv.reconstruct(W, H, plan)
    E = (V - R.astype(V.dtype)).astype(V.dtype)
    E_pad = _pad_to(E, tuple(t + a - 1 for t, a in zip(Tp, A)), d)
    Hr = _pad_to(H, Tp, d).reshape(
        (n, M) + tuple(x for ka in zip(K, A) for x in ka))
    # phase-major carry (P, n, M, prod(K)): position count minor (large
    # minor axis), phase index major (cheap dynamic_index per phase)
    perm = tuple(3 + 2 * i for i in range(d)) + (0, 1) \
        + tuple(2 + 2 * i for i in range(d))
    return E_pad, jnp.transpose(Hr, perm).reshape(
        (math.prod(A), n, M, math.prod(K)))


def _decode_h(H_pm, plan):
    A, T, K, Tp = _geom(plan)
    d = plan.ndim
    _, n, M, _ = H_pm.shape
    Hr = H_pm.reshape(A + (n, M) + K)
    inv = (d, d + 1) + tuple(x for i in range(d) for x in (d + 2 + i, i))
    H = jnp.transpose(Hr, inv).reshape((n, M) + Tp)
    return H[(Ellipsis,) + tuple(slice(0, t) for t in T)]


def _mu_W_from_residual(V, E_pad, W, H, plan):
    """One multiplicative W step from the maintained residual:
    ``neg = corr_W(V, H)``, ``pos = corr_W(V - E, H)`` — the Lee–Seung
    ratio without normalization (HALS convention: W carries its scale;
    exactly sklearn's un-normalized dictionary side)."""
    from . import engine
    from .ops import conv
    A, T, K, Tp = _geom(plan)
    S = plan.sample_shape
    E = E_pad[(Ellipsis,) + tuple(slice(0, s) for s in S)]
    R = V - E
    neg, pos = conv.grad_W_pair(conv.extend_data(V, plan), R, H, plan)
    return (W * neg / (pos + engine.EPS)).astype(W.dtype)


_STATICS = ('inner', 'update_H', 'update_W', 'plan')


def _iteration(V, E_pad, H_r, W, G, l1, l2, *, inner, update_H, update_W,
               plan):
    if update_H:
        E_pad, H_r = h_phase_sweep(E_pad, H_r, W, G, l1, l2,
                                   plan=plan, inner=inner)
    if update_W:
        from .ops import conv
        H = _decode_h(H_r, plan)
        W = _mu_W_from_residual(V, E_pad, W, H, plan)
        G = gram_W(W, plan.lax_precision)
        # W changed: refresh the residual invariant (one reconstruction,
        # the same cost the MU engine pays in its W half)
        R = conv.reconstruct(W, H, plan)
        A, T, K, Tp = _geom(plan)
        E_pad = _pad_to((V - R.astype(V.dtype)).astype(V.dtype),
                        tuple(t + a - 1 for t, a in zip(Tp, A)), plan.ndim)
    return E_pad, H_r, W, G


def _energy_from_residual(E_pad):
    acc = _acc_dtype(E_pad)
    Ef = E_pad.astype(acc)
    return 0.5 * jnp.sum(Ef * Ef)


@partial(jax.jit, static_argnames=_STATICS, donate_argnums=(1, 2))
def fit_loop(V, W, H, n_iterations, l1, l2, *, inner: int, update_H: bool,
             update_W: bool, plan: ConvPlan):
    """The whole shift-invariant HALS fit as one on-device loop
    (``n_iterations`` traced — changing it never recompiles)."""
    E_pad, H_r = _encode(V, W, H, plan)
    G = gram_W(W, plan.lax_precision)

    def body(_, carry):
        return _iteration(V, *carry, l1, l2, inner=inner, update_H=update_H,
                          update_W=update_W, plan=plan)

    E_pad, H_r, W, G = jax.lax.fori_loop(0, n_iterations, body,
                                         (E_pad, H_r, W, G))
    return W, _decode_h(H_r, plan)


@partial(jax.jit, static_argnames=_STATICS, donate_argnums=(1, 2))
def update_step(V, W, H, l1, l2, *, inner: int, update_H: bool,
                update_W: bool, plan: ConvPlan):
    """One outer iteration on canonical tensors (callback path)."""
    E_pad, H_r = _encode(V, W, H, plan)
    G = gram_W(W, plan.lax_precision)
    E_pad, H_r, W, G = _iteration(V, E_pad, H_r, W, G, l1, l2, inner=inner,
                                  update_H=update_H, update_W=update_W,
                                  plan=plan)
    return W, _decode_h(H_r, plan)


#: scan-chunk length of the recording loop (engine.ENERGY_CHUNK rationale)
ENERGY_CHUNK = 32


@partial(jax.jit, static_argnames=_STATICS + ('chunk',),
         donate_argnums=(1, 2))
def _energies_chunk(V, W, H, k, l1, l2, *, chunk: int, inner: int,
                    update_H: bool, update_W: bool, plan: ConvPlan):
    E_pad, H_r = _encode(V, W, H, plan)
    G = gram_W(W, plan.lax_precision)
    acc = _acc_dtype(V)

    def body(carry, i):
        def active(carry):
            out = _iteration(V, *carry, l1, l2, inner=inner,
                             update_H=update_H, update_W=update_W, plan=plan)
            return out, _energy_from_residual(out[0]).astype(acc)

        def idle(carry):
            return carry, jnp.zeros((), acc)

        return jax.lax.cond(i < k, active, idle, carry)

    (E_pad, H_r, W, G), energies = jax.lax.scan(
        body, (E_pad, H_r, W, G), jnp.arange(chunk))
    return W, _decode_h(H_r, plan), energies


def fit_loop_energies(V, W, H, l1, l2, *, n_iterations: int, inner: int,
                      update_H: bool, update_W: bool, plan: ConvPlan):
    """Fit with an on-device per-iteration energy trace — free of extra
    reconstructions (the residual is the loop state)."""
    n = int(n_iterations)
    traces, done = [], 0
    while done < n:
        k = jnp.int32(min(ENERGY_CHUNK, n - done))
        W, H, es = _energies_chunk(V, W, H, k, l1, l2, chunk=ENERGY_CHUNK,
                                   inner=inner, update_H=update_H,
                                   update_W=update_W, plan=plan)
        traces.append(es)
        done += ENERGY_CHUNK
    energies = (jnp.concatenate(traces)[:n] if traces
                else jnp.zeros((0,), _acc_dtype(V)))
    return W, H, energies


@partial(jax.jit, static_argnames=_STATICS + ('check_every', 'n_buf'),
         donate_argnums=(1, 2))
def fit_loop_tol(V, W, H, n_max, tol, l1, l2, *, check_every: int,
                 n_buf: int = 0, inner: int, update_H: bool, update_W: bool,
                 plan: ConvPlan):
    """Adaptive fit with on-device convergence detection (the engine's
    ``(e_prev - e) / e_init < tol`` protocol); ``n_buf > 0`` records the
    per-iteration energy trace.  Returns
    ``(W, H, n_done, e_final, energies_or_None)``."""
    E_pad, H_r = _encode(V, W, H, plan)
    G = gram_W(W, plan.lax_precision)
    acc = _acc_dtype(V)
    tol = tol.astype(acc)
    record = n_buf > 0

    def inner_body(j, state):
        carry = _iteration(V, *state[:4], l1, l2, inner=inner,
                           update_H=update_H, update_W=update_W, plan=plan)
        if record:
            trace, i0 = state[4:]
            trace = trace.at[i0 + j].set(
                _energy_from_residual(carry[0]).astype(acc))
            return carry + (trace, i0)
        return carry

    e0 = _energy_from_residual(E_pad).astype(acc)
    scale = jnp.maximum(e0, jnp.asarray(jnp.finfo(acc).tiny, acc))

    def cond(state):
        i, rel = state[4], state[6]
        return jnp.logical_and(i < n_max, rel >= tol)

    def body(state):
        carry, (i, e_prev, _) = state[:4], state[4:7]
        k = jnp.minimum(check_every, n_max - i)
        carry = carry + ((state[7], i) if record else ())
        carry = jax.lax.fori_loop(0, k, inner_body, carry)
        e = (carry[4][i + k - 1] if record
             else _energy_from_residual(carry[0]).astype(acc))
        out = carry[:4] + (i + k, e, (e_prev - e) / scale)
        return out + ((carry[4],) if record else ())

    state = (E_pad, H_r, W, G, jnp.asarray(0, jnp.int32), e0,
             jnp.asarray(jnp.inf, acc))
    if record:
        state = state + (jnp.full((n_buf,), jnp.nan, acc),)
    state = jax.lax.while_loop(cond, body, state)
    W, n_done, e = state[2], state[4], state[5]
    trace = state[7] if record else None
    return W, _decode_h(state[1], plan), n_done, e, trace


# ---------------------------------------------------------------------------
# NumPy oracle (tests): entrywise exact CD in plain loops
# ---------------------------------------------------------------------------

def np_conv_hals_h_sweep(V, W, H, l1: float = 0.0, l2: float = 0.0,
                         inner: int = 1) -> 'np.ndarray':
    """Float64 oracle of one exact H phase-sweep in mode 'full'.

    Phases in the same flat order as :func:`h_phase_sweep`; within a
    phase, ``inner`` Gauss–Seidel passes over atoms, each entry the exact
    1-D minimizer against the current residual.  Deliberately written as
    scalar loops over positions (independence within a phase makes the
    in-phase order irrelevant — the vectorized kernel relies on exactly
    that)."""
    import numpy as np
    V = np.asarray(V, np.float64)
    W = np.asarray(W, np.float64)
    H = np.asarray(H, np.float64).copy()
    from .ops import oracle
    A = W.shape[2:]
    T = H.shape[2:]
    M = W.shape[0]
    G = np.einsum('mcx,kcx->mk', W.reshape(W.shape[0], W.shape[1], -1),
                  W.reshape(W.shape[0], W.shape[1], -1))
    E = V - oracle.reconstruct(W, H, 'full')
    tiny = np.finfo(np.float64).tiny
    for p in np.ndindex(*A):
        positions = [t for t in np.ndindex(*T)
                     if all((ti - pi) % ai == 0 for ti, pi, ai
                            in zip(t, p, A))]
        for _ in range(inner):
            for j in range(M):
                for n in range(V.shape[0]):
                    for t in positions:
                        patch = E[(n,) + (slice(None),)
                                  + tuple(slice(ti, ti + ai)
                                          for ti, ai in zip(t, A))]
                        u = (np.sum(patch * W[j])
                             + G[j, j] * H[(n, j) + t] - l1)
                        new = max(u / max(G[j, j] + l2, tiny), 0.0)
                        dh = new - H[(n, j) + t]
                        if dh != 0.0:
                            E[(n,) + (slice(None),)
                              + tuple(slice(ti, ti + ai)
                                      for ti, ai in zip(t, A))] -= dh * W[j]
                            H[(n, j) + t] = new
    return H
