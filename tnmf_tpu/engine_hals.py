"""HALS (hierarchical alternating least squares) solver for the plain-NMF
geometry — an exact block-coordinate-descent alternative to the
multiplicative updates, with no reference counterpart (the reference
implements only Lee–Seung MU, ``TransformInvariantNMF.py:136-179``).

Applies when shift invariance degenerates to classic NMF (reconstruction
mode ``'full'`` with ``atom_shape == sample_shape``, i.e.
``prod(transform_shape) == 1`` — the same corner the ``'dot'`` strategy
lowers to a single matmul, :mod:`tnmf_tpu.ops.dot`).  With ``V`` flattened
to ``(n, F)``, ``H`` to ``(n, m)`` and ``W`` to ``(m, F)``, each outer
iteration updates one factor at a time by sweeping its components in
Gauss–Seidel order, each component solved *exactly* (the 1-D nonnegative
least-squares minimizer in closed form):

    H[:, j] <- max(0, (P[:, j] - sum_{k != j} H[:, k] G[k, j] - l1)
                      / (G[j, j] + l2)),   G = W W^T,  P = V W^T
    W[j, :] <- max(0, (B[j, :] - sum_{k != j} A[j, k] W[k, :])
                      / A[j, j]),          A = H^T H,  B = H^T V

This is sklearn's ``NMF(solver='cd')`` algorithm (Cichocki & Phan 2009
fast HALS; cross-checked trajectory-exact against sklearn in
``tests/test_hals.py``) with the **accelerated** variant of Gillis &
Glineur 2012: the Gram/cross matrices ``(G, P)`` / ``(A, B)`` are exact
regardless of the *other* factor's last update, so each one — the only
quantities that touch the ``(n, F)`` data — can be reused for several
inner component sweeps.  On an accelerator that split is the whole
design: the Grams are large matmuls (the ``O(n m F)`` work), while a
component sweep is ``m`` small matvecs (``O(n m^2)`` / ``O(m^2 F)``) run
as one ``lax.fori_loop`` of dynamic-slice updates.  Crucially the sweep's
*time* is not its FLOPs: each chain step costs a latency floor (1.4e-5 s
on an H100, :data:`HALS_COSTS`) regardless of operand size —
:func:`auto_inner` therefore prices Gram refresh vs sweep in seconds,
buying extra (staler) inner sweeps only in the Gram-bound huge-``F``
regime.

Why offer HALS at all: per outer iteration it decreases the Frobenius
objective at least as much as one exact coordinate pass can (each
component update is the exact minimizer, vs MU's fixed-point step), it
converges in substantially fewer iterations on ill-conditioned problems,
and — unlike MU — **zero is not absorbing** (a zeroed component re-enters
whenever its partial residual correlation turns positive, so dead-atom
revival is unnecessary by construction).

Numerics: all contractions accumulate in float32
(``preferred_element_type``) under bfloat16 storage and honor
``plan.lax_precision``; the component loops carry the factors in their
storage dtype.  Data parallelism: the Grams are per-sample sums, so under
a ``shard_axis='samples'`` mesh GSPMD turns them into all-reduces
automatically while the H sweep stays fully sample-parallel
(``tests/test_hals.py::test_hals_sharded_matches_single``).

Energy convention matches the MU engine: ``0.5 * ||V - H W||_F^2``
(:func:`tnmf_tpu.ops.beta.divergence` at beta = 2), so ``energies_`` /
``tol`` semantics are directly comparable across solvers.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .ops import beta as beta_ops
from .ops.modes import ConvPlan

#: division guard for dead components (a component whose factor row is all
#: zero has a zero diagonal Gram entry; the guarded ratio then yields 0 for
#: it instead of nan, and the component may still re-enter a later sweep)
_TINY = jnp.finfo(jnp.float32).tiny


def _acc_dtype(*xs):
    """Accumulation dtype: at least float32 (bfloat16 storage accumulates
    in float32; float64 test runs keep float64)."""
    return jnp.promote_types(jnp.result_type(*xs), jnp.float32)


def _dot(a, b, precision):
    """Matmul accumulating in at least float32."""
    return jnp.matmul(a, b, precision=precision,
                      preferred_element_type=_acc_dtype(a, b))


#: component-block width of the delayed-update sweeps
#: (:func:`_sweep_H_blocked` / :func:`_sweep_W_blocked` — kept as a
#: documented measured NEGATIVE, not routed by :func:`_iteration`)
_BLOCK = 8

#: unroll factor of the sweep fori_loops: the chain step is latency-bound
#: (a small matvec behind microseconds of loop/slice overhead), so
#: unrolling amortizes the while-loop trip cost without changing the math
_UNROLL = 8


def _sweep_H(H, G, P, l1, l2):
    """One Gauss–Seidel pass over the ``m`` activation columns.

    ``H (n, m)`` in storage dtype; ``G (m, m)`` / ``P (n, m)`` in float32.
    Column ``j``'s exact minimizer uses the *current* H (components
    ``< j`` already updated this pass) — sklearn's in-order coordinate
    descent (``shuffle=False``).
    """
    m = H.shape[1]

    def body(j, H):
        g = jax.lax.dynamic_slice_in_dim(G, j, 1, axis=1)          # (m, 1)
        gjj = jnp.squeeze(jax.lax.dynamic_slice_in_dim(g, j, 1, axis=0))
        hj = jax.lax.dynamic_slice_in_dim(H, j, 1, axis=1)          # (n, 1)
        pj = jax.lax.dynamic_slice_in_dim(P, j, 1, axis=1)
        u = pj - _dot(H, g, None) + hj.astype(gjj.dtype) * gjj - l1
        denom = gjj + l2
        new = jnp.maximum(u / jnp.maximum(denom, _TINY), 0.0)
        # dead component (zero dictionary row -> zero curvature): keep the
        # old column rather than divide by ~0 — sklearn's `hess != 0` skip
        new = jnp.where(denom > 0, new.astype(H.dtype), hj)
        return jax.lax.dynamic_update_slice_in_dim(H, new, j, axis=1)

    return jax.lax.fori_loop(0, m, body, H, unroll=_UNROLL)


def _sweep_H_blocked(H, G, P, l1, l2, n_sweeps: int, block: int = _BLOCK):
    """``n_sweeps`` delayed-update blocked Gauss–Seidel passes over H.

    Algebraically the same update sequence as :func:`_sweep_H` (each
    column's minimizer sees every previously updated column —
    ``tests/test_hals.py::test_hals_blocked_sweeps_equal_plain``), but the
    sequential chain step touches only the current ``(n, block)`` tile:
    the running product ``C = H @ G`` carries all cross-block coupling
    and is refreshed once per block with one matmul
    (``C += (H_B - H0_B) @ G[B, :]``) — the delayed-update trick of
    blocked Cholesky applied to coordinate descent.  Per pass that is
    ``m`` latency-bound steps of O(n*block) + ``m/block`` matmuls of
    O(n*block*m), instead of ``m`` steps of O(n*m).  Requires
    ``block | m``.

    **Not routed.**  It pays the same ``m`` latency-bound chain steps as
    the plain sweep *plus* rewriting the (n, m) running product per block,
    so it cannot shorten a latency-bound sweep; its time on a GPU is not
    measured.  The levers for that regime are loop unrolling
    (``_UNROLL``) and a time-based ``auto_inner`` (fresh Grams beat extra
    sweeps once the sweep dominates wall-clock).
    """
    n, m = H.shape
    nb = m // block
    acc = G.dtype
    C = _dot(H.astype(acc), G, None)                                # (n, m)
    # (nb, b, b) diagonal blocks of G and (nb, b, m) row-blocks, gathered
    # once so the inner loops only dynamic-slice small operands
    Grows = G.reshape(nb, block, m)
    Gdiag = jnp.moveaxis(
        G.reshape(nb, block, nb, block).diagonal(axis1=0, axis2=2), -1, 0)

    def block_body(b_idx, state):
        H, C = state
        j0 = b_idx * block
        H0B = jax.lax.dynamic_slice_in_dim(H, j0, block, axis=1)    # (n, b)
        CB = jax.lax.dynamic_slice_in_dim(C, j0, block, axis=1)
        PB = jax.lax.dynamic_slice_in_dim(P, j0, block, axis=1)
        GBB = jax.lax.dynamic_index_in_dim(Gdiag, b_idx, axis=0,
                                           keepdims=False)          # (b, b)

        def col_body(t, HB):
            g = jax.lax.dynamic_slice_in_dim(GBB, t, 1, axis=1)     # (b, 1)
            gjj = jnp.squeeze(jax.lax.dynamic_slice_in_dim(g, t, 1, axis=0))
            ht = jax.lax.dynamic_slice_in_dim(HB, t, 1, axis=1)     # (n, 1)
            pt = jax.lax.dynamic_slice_in_dim(PB, t, 1, axis=1)
            ct = jax.lax.dynamic_slice_in_dim(CB, t, 1, axis=1)
            h0t = jax.lax.dynamic_slice_in_dim(H0B, t, 1, axis=1)
            # delta of already-updated columns (cols >= t are still H0)
            delta = HB.astype(acc) - H0B.astype(acc)                # (n, b)
            u = (pt - ct - _dot(delta, g, None)
                 + h0t.astype(acc) * gjj - l1)
            denom = gjj + l2
            new = jnp.maximum(u / jnp.maximum(denom, _TINY), 0.0)
            new = jnp.where(denom > 0, new.astype(HB.dtype), ht)
            return jax.lax.dynamic_update_slice_in_dim(HB, new, t, axis=1)

        HB = jax.lax.fori_loop(0, block, col_body, H0B)
        GB = jax.lax.dynamic_index_in_dim(Grows, b_idx, axis=0,
                                          keepdims=False)           # (b, m)
        C = C + _dot(HB.astype(acc) - H0B.astype(acc), GB, None)
        H = jax.lax.dynamic_update_slice_in_dim(H, HB, j0, axis=1)
        return H, C

    def sweep(_, state):
        return jax.lax.fori_loop(0, nb, block_body, state)

    H, _ = jax.lax.fori_loop(0, n_sweeps, sweep, (H, C))
    return H


def _sweep_W(W, A, B, l1, l2):
    """One Gauss–Seidel pass over the ``m`` dictionary rows.

    ``W (m, F)`` in storage dtype; ``A (m, m)`` / ``B (m, F)`` in float32.
    ``l1``/``l2`` regularize the dictionary (sklearn's ``alpha_H`` side —
    the frozen-factor Gram absorbs L2 into the curvature, L1 shifts the
    correlation, exactly like the H sweep).  Row updates are contiguous
    slices (W is carried components-major).
    """
    m = W.shape[0]

    def body(j, W):
        a = jax.lax.dynamic_slice_in_dim(A, j, 1, axis=0)           # (1, m)
        ajj = jnp.squeeze(jax.lax.dynamic_slice_in_dim(a, j, 1, axis=1))
        wj = jax.lax.dynamic_slice_in_dim(W, j, 1, axis=0)          # (1, F)
        bj = jax.lax.dynamic_slice_in_dim(B, j, 1, axis=0)
        u = bj - _dot(a, W, None) + ajj * wj.astype(ajj.dtype) - l1
        denom = ajj + l2
        new = jnp.maximum(u / jnp.maximum(denom, _TINY), 0.0)
        # unused component (zero activation column): keep the old row
        new = jnp.where(denom > 0, new.astype(W.dtype), wj)
        return jax.lax.dynamic_update_slice_in_dim(W, new, j, axis=0)

    return jax.lax.fori_loop(0, m, body, W, unroll=_UNROLL)


def _sweep_W_blocked(W, A, B, l1, l2, n_sweeps: int, block: int = _BLOCK):
    """``n_sweeps`` delayed-update blocked Gauss–Seidel passes over the
    dictionary rows — same scheme as :func:`_sweep_H_blocked` with the
    running product ``C = A @ W`` carrying cross-block coupling; each
    chain step touches a ``(block, F)`` tile instead of ``(m, F)``."""
    m = W.shape[0]
    nb = m // block
    acc = A.dtype
    C = _dot(A, W.astype(acc), None)                                # (m, F)
    Adiag = jnp.moveaxis(
        A.reshape(nb, block, nb, block).diagonal(axis1=0, axis2=2), -1, 0)
    Acols = jnp.moveaxis(A.reshape(m, nb, block), 1, 0)             # (nb, m, b)

    def block_body(b_idx, state):
        W, C = state
        j0 = b_idx * block
        W0B = jax.lax.dynamic_slice_in_dim(W, j0, block, axis=0)    # (b, F)
        CB = jax.lax.dynamic_slice_in_dim(C, j0, block, axis=0)
        BB = jax.lax.dynamic_slice_in_dim(B, j0, block, axis=0)
        ABB = jax.lax.dynamic_index_in_dim(Adiag, b_idx, axis=0,
                                           keepdims=False)          # (b, b)

        def row_body(t, WB):
            a = jax.lax.dynamic_slice_in_dim(ABB, t, 1, axis=0)     # (1, b)
            ajj = jnp.squeeze(jax.lax.dynamic_slice_in_dim(a, t, 1, axis=1))
            wt = jax.lax.dynamic_slice_in_dim(WB, t, 1, axis=0)     # (1, F)
            bt = jax.lax.dynamic_slice_in_dim(BB, t, 1, axis=0)
            ct = jax.lax.dynamic_slice_in_dim(CB, t, 1, axis=0)
            w0t = jax.lax.dynamic_slice_in_dim(W0B, t, 1, axis=0)
            delta = WB.astype(acc) - W0B.astype(acc)                # (b, F)
            u = (bt - ct - _dot(a, delta, None)
                 + ajj * w0t.astype(acc) - l1)
            denom = ajj + l2
            new = jnp.maximum(u / jnp.maximum(denom, _TINY), 0.0)
            new = jnp.where(denom > 0, new.astype(WB.dtype), wt)
            return jax.lax.dynamic_update_slice_in_dim(WB, new, t, axis=0)

        WB = jax.lax.fori_loop(0, block, row_body, W0B)
        AB = jax.lax.dynamic_index_in_dim(Acols, b_idx, axis=0,
                                          keepdims=False)           # (m, b)
        C = C + _dot(AB, WB.astype(acc) - W0B.astype(acc), None)
        W = jax.lax.dynamic_update_slice_in_dim(W, WB, j0, axis=0)
        return W, C

    def sweep(_, state):
        return jax.lax.fori_loop(0, nb, block_body, state)

    W, _ = jax.lax.fori_loop(0, n_sweeps, sweep, (W, C))
    return W


def _iteration(V2, W2, H2, l1, l2, l1w, l2w, *, inner: int, update_H: bool,
               update_W: bool, precision):
    """One outer HALS iteration: H sweeps (fresh Grams), then W sweeps.

    H first, then W — the MU engine's order (and sklearn's: its ``W``
    is this module's ``H``).  ``l1``/``l2`` regularize H, ``l1w``/``l2w``
    the dictionary (sklearn's ``alpha_W`` / ``alpha_H`` sides under the
    W<->H name swap).  ``inner`` static sweeps reuse each Gram pair
    (Gillis & Glineur 2012 acceleration).
    """
    if update_H:
        Wt = W2.astype(_acc_dtype(W2)).T
        G = _dot(W2, Wt, precision)                                # (m, m)
        P = _dot(V2, Wt, precision)                                # (n, m)
        l1h, l2h = l1.astype(G.dtype), l2.astype(G.dtype)
        for _ in range(inner):
            H2 = _sweep_H(H2, G, P, l1h, l2h)
    if update_W:
        Ht = H2.astype(_acc_dtype(H2)).T
        A = _dot(Ht, H2, precision)                                # (m, m)
        B = _dot(Ht, V2, precision)                                # (m, F)
        l1v, l2v = l1w.astype(A.dtype), l2w.astype(A.dtype)
        for _ in range(inner):
            W2 = _sweep_W(W2, A, B, l1v, l2v)
    return W2, H2


def _flatten(V, W, H):
    """Canonical model tensors -> the 2-D HALS views (free reshapes)."""
    V2 = V.reshape(V.shape[0], -1)                                  # (n, F)
    W2 = W.reshape(W.shape[0], -1)                                  # (m, F)
    H2 = H.reshape(H.shape[0], H.shape[1])                          # (n, m)
    return V2, W2, H2


def _energy(V2, W2, H2, precision):
    R = _dot(H2, W2.astype(_acc_dtype(W2)), precision)
    return beta_ops.divergence(V2, R, 2.0).astype(_acc_dtype(V2))


_STATICS = ('inner', 'update_H', 'update_W', 'plan')


@partial(jax.jit, static_argnames=_STATICS, donate_argnums=(1, 2))
def update_step(V, W, H, l1, l2, l1w, l2w, *, inner: int, update_H: bool,
                update_W: bool, plan: ConvPlan):
    """One outer iteration on the canonical model shapes (callback path)."""
    V2, W2, H2 = _flatten(V, W, H)
    W2, H2 = _iteration(V2, W2, H2, l1, l2, l1w, l2w, inner=inner, update_H=update_H,
                        update_W=update_W, precision=plan.lax_precision)
    return W2.reshape(W.shape), H2.reshape(H.shape)


@partial(jax.jit, static_argnames=_STATICS, donate_argnums=(1, 2))
def fit_loop(V, W, H, n_iterations, l1, l2, l1w, l2w, *, inner: int, update_H: bool,
             update_W: bool, plan: ConvPlan):
    """The no-callback fast path: the whole HALS fit as one on-device loop
    with donated factor buffers.  ``n_iterations`` is traced — varying it
    never recompiles."""
    V2, W2, H2 = _flatten(V, W, H)

    def body(_, WH):
        return _iteration(V2, *WH[::-1], l1, l2, l1w, l2w, inner=inner,
                          update_H=update_H, update_W=update_W,
                          precision=plan.lax_precision)[::-1]

    H2, W2 = jax.lax.fori_loop(0, n_iterations, body, (H2, W2))
    return W2.reshape(W.shape), H2.reshape(H.shape)


#: scan-chunk length of the energy-recording loop (same rationale as
#: engine.ENERGY_CHUNK: one compiled graph serves every n_iterations)
ENERGY_CHUNK = 32


@partial(jax.jit, static_argnames=_STATICS + ('chunk',),
         donate_argnums=(1, 2))
def _energies_chunk(V, W, H, k, l1, l2, l1w, l2w, *, chunk: int, inner: int,
                    update_H: bool, update_W: bool, plan: ConvPlan):
    V2, W2, H2 = _flatten(V, W, H)
    precision = plan.lax_precision

    def body(WH, i):
        def active(WH):
            W2, H2 = _iteration(V2, WH[0], WH[1], l1, l2, l1w, l2w, inner=inner,
                                update_H=update_H, update_W=update_W,
                                precision=precision)
            return (W2, H2), _energy(V2, W2, H2, precision)

        def idle(WH):
            return WH, jnp.zeros((), _acc_dtype(V2))

        return jax.lax.cond(i < k, active, idle, WH)

    (W2, H2), energies = jax.lax.scan(body, (W2, H2), jnp.arange(chunk))
    return W2.reshape(W.shape), H2.reshape(H.shape), energies


def fit_loop_energies(V, W, H, l1, l2, l1w, l2w, *, n_iterations: int, inner: int,
                      update_H: bool, update_W: bool, plan: ConvPlan):
    """HALS fit with an on-device per-iteration energy trace, dispatched in
    fixed-length compiled chunks with the live count traced (changing
    ``n_iterations`` never recompiles)."""
    n = int(n_iterations)
    traces = []
    done = 0
    while done < n:
        k = jnp.int32(min(ENERGY_CHUNK, n - done))
        W, H, es = _energies_chunk(V, W, H, k, l1, l2, l1w, l2w, chunk=ENERGY_CHUNK,
                                   inner=inner, update_H=update_H,
                                   update_W=update_W, plan=plan)
        traces.append(es)
        done += ENERGY_CHUNK
    energies = (jnp.concatenate(traces)[:n] if traces
                else jnp.zeros((0,), jnp.promote_types(V.dtype, jnp.float32)))
    return W, H, energies


@partial(jax.jit, static_argnames=_STATICS + ('check_every', 'n_buf'),
         donate_argnums=(1, 2))
def fit_loop_tol(V, W, H, n_max, tol, l1, l2, l1w, l2w, *, check_every: int,
                 n_buf: int = 0, inner: int, update_H: bool, update_W: bool,
                 plan: ConvPlan):
    """Adaptive HALS fit with on-device convergence detection — the same
    ``(e_prev - e) / e_init < tol`` protocol as :func:`engine.fit_loop_tol`
    (one dispatch regardless of where it stops).

    ``n_buf > 0`` (static, >= the largest possible ``n_max``) additionally
    records the per-iteration energy into an on-device trace (entries past
    ``n_done`` stay NaN) — the HALS counterpart of the MU engine's
    ``tol`` + ``record_energies`` composition.

    Returns ``(W, H, n_done, e_final, energies_or_None)``."""
    V2, W2, H2 = _flatten(V, W, H)
    precision = plan.lax_precision
    acc = _acc_dtype(V2)
    tol = tol.astype(acc)
    record = n_buf > 0

    def inner_body(j, state):
        H2, W2 = state[:2]
        W2, H2 = _iteration(V2, W2, H2, l1, l2, l1w, l2w, inner=inner,
                            update_H=update_H, update_W=update_W,
                            precision=precision)
        if record:
            trace, i0 = state[2:]
            trace = trace.at[i0 + j].set(_energy(V2, W2, H2, precision))
            return H2, W2, trace, i0
        return H2, W2

    e0 = _energy(V2, W2, H2, precision)
    scale = jnp.maximum(e0, jnp.asarray(jnp.finfo(acc).tiny, acc))

    def cond(state):
        i, rel = state[2], state[4]
        return jnp.logical_and(i < n_max, rel >= tol)

    def body(state):
        H2, W2, i, e_prev, _ = state[:5]
        k = jnp.minimum(check_every, n_max - i)
        carry = (H2, W2) + ((state[5], i) if record else ())
        carry = jax.lax.fori_loop(0, k, inner_body, carry)
        H2, W2 = carry[:2]
        # when recording, the last in-block iteration already wrote
        # e(W, H) to the trace — read it back instead of paying another
        # reconstruction
        e = (carry[2][i + k - 1] if record
             else _energy(V2, W2, H2, precision))
        out = (H2, W2, i + k, e, (e_prev - e) / scale)
        return out + ((carry[2],) if record else ())

    state = (H2, W2, jnp.asarray(0, jnp.int32), e0,
             jnp.asarray(jnp.inf, acc))
    if record:
        state = state + (jnp.full((n_buf,), jnp.nan, acc),)
    state = jax.lax.while_loop(cond, body, state)
    H2, W2, n_done, e = state[0], state[1], state[2], state[3]
    trace = state[5] if record else None
    return W2.reshape(W.shape), H2.reshape(H.shape), n_done, e, trace


#: cost model behind ``auto_inner``, by ``device_kind``: achieved float32
#: matmul rate at the default precision (FLOP/s), achieved device-memory
#: bandwidth (bytes/s) and the latency of one Gauss–Seidel chain step (s).
#: Measured with ``benchmarks/lowering.py`` (hals section) on an NVIDIA H100
#: 80GB HBM3 at a 400 W power limit: an 8192^3 TF32 matmul ran 2.82e14
#: FLOP/s, a 1 GiB elementwise copy 2.16e12 B/s, and one extra inner sweep
#: pair at 16384x4096/256 cost 7.1 ms, i.e. 1.39e-5 s per chain step.
#: A device not listed here gets the FLOP-ratio rule, which assumes no rate.
HALS_COSTS = {
    'NVIDIA H100 80GB HBM3': (2.8e14, 2.2e12, 1.4e-5),
}


def auto_inner(n_components: int, n_features: int,
               inner: Optional[object] = 'auto',
               n_samples: Optional[int] = None) -> int:
    """Resolve the inner-sweep count.

    ``'auto'`` follows the accelerated-HALS principle of Gillis & Glineur
    2012 — reuse each Gram pair for extra component sweeps while those
    sweeps are nearly free next to the data-touching matmuls.  When the
    first JAX device's ``device_kind`` is in :data:`HALS_COSTS` the two sides are priced in *time*, not FLOPs, because a sweep is
    latency-bound (``m`` sequential chain steps, each a loop trip, dynamic
    slices and a small matvec) while the Grams are matmul/bandwidth-bound:
    ``inner = clamp(round(0.5 + t_gram / (2 t_sweep)), 1, 8)`` buys extra
    (staler) sweeps only when a Gram refresh costs more than the sweeps it
    would improve — the huge-``F``, small-``m`` regime.  At 16384x4096/256
    on the H100 that gives ``inner=1`` (a sweep pair costs 7.1 ms, the
    Grams 0.25 ms).  Without ``n_samples``, or on any other device, the
    FLOP-ratio rule ``clamp(round(0.5 F / m), 1, 8)`` is used.
    """
    if inner != 'auto' and inner is not None:
        iv = int(inner)
        if iv < 1:
            raise ValueError('hals_inner must be >= 1 or "auto"')
        return iv
    m, F = max(n_components, 1), n_features
    costs = HALS_COSTS.get(jax.devices()[0].device_kind)
    if not n_samples or costs is None:
        return max(1, min(8, round(0.5 * F / m)))
    flops, bps, step = costs
    n = n_samples
    # per factor update: the V-touching cross matmul + the small Gram,
    # plus one V read from device memory; vs m latency-bound chain steps
    t_gram = (2 * n * m * F + 2 * m * m * F) / flops + 4 * n * F / bps
    t_sweep = m * step + 2 * n * m * m / flops
    return max(1, min(8, round(0.5 + t_gram / (2 * t_sweep))))


# ---------------------------------------------------------------------------
# NumPy oracle (tests)
# ---------------------------------------------------------------------------

def np_hals_iteration(V2, W2, H2, l1: float = 0.0, l2: float = 0.0,
                      inner: int = 1, l1w: float = 0.0, l2w: float = 0.0,
                      update_H: bool = True, update_W: bool = True
                      ) -> Tuple['np.ndarray', 'np.ndarray']:
    """Float64 NumPy mirror of one outer iteration (Gauss–Seidel order),
    the trajectory oracle for ``tests/test_hals.py``."""
    import numpy as np
    V2 = np.asarray(V2, np.float64)
    W2 = np.asarray(W2, np.float64).copy()
    H2 = np.asarray(H2, np.float64).copy()
    tiny = np.finfo(np.float64).tiny
    if update_H:
        G, P = W2 @ W2.T, V2 @ W2.T
        for _ in range(inner):
            for j in range(H2.shape[1]):
                if G[j, j] + l2 <= 0:
                    continue  # dead component: sklearn's `hess != 0` skip
                u = P[:, j] - H2 @ G[:, j] + H2[:, j] * G[j, j] - l1
                H2[:, j] = np.maximum(u / max(G[j, j] + l2, tiny), 0.0)
    if update_W:
        A, B = H2.T @ H2, H2.T @ V2
        for _ in range(inner):
            for j in range(W2.shape[0]):
                if A[j, j] + l2w <= 0:
                    continue  # unused component: keep the old row
                u = B[j] - A[j] @ W2 + A[j, j] * W2[j] - l1w
                W2[j] = np.maximum(u / max(A[j, j] + l2w, tiny), 0.0)
    return W2, H2
