"""Phase-decomposed direct-convolution strategy.

The plain conv strategy (:mod:`tnmf_tpu.ops.conv`) starves the matrix
units on channel-poor problems: at the flagship 64x256x256 / 16-atom /
1-channel scale its three convolutions carry 1-16 channels.  This module
re-lowers the whole MU iteration in a **phase-blocked domain**: the
activation tensor H is carried as

    Hph[n, Y1..Yk, (m, p1..pk)] = H[n, m, r1*Y1 + p1, ..., rk*Yk + pk]

with per-axis phase factors ``r`` — a space-to-depth view of the shift
axes, carried **channels-last** (phased channels in the minormost axis).
Channels-last is deliberate: the phased channel count ``M*prod(r)`` (256
at the flagship config) is the widest, most regular axis, so the default
row-major layout keeps the elementwise MU ratio's accesses contiguous
(a channels-second carry makes the minormost axis the ragged spatial
extent).  Every operator is a convolution whose channel counts are multiplied by
the ``prod(r)`` phase count on *both* sides:

* ``grad_H_pair`` — one conv of the phased extended data (``C*prod(r)``
  input channels) against a one-hot-expanded kernel (``M*prod(r)`` output
  channels, small taps), producing the gradient **directly in H's phased
  layout** — no unshuffle, and the MU ratio becomes a pure elementwise op
  between identically-shaped phased tensors.
* ``reconstruct`` — one strided conv of phased H against a one-hot-expanded
  flipped kernel with per-axis output blocking ``s``, then the standard
  pixel unshuffle.
* ``grad_W_pair`` — one conv contracting samples (dn ``('CN','IO','NC')``)
  between the channel-stacked phased data and phased H; because phased H
  has ``M*prod(r)`` "output" channels the contraction runs ``prod(r)``
  times wider than in the plain lowering (M), and a tiny one-hot einsum
  reassembles the (M, C, *atom) gradient from the phase terms.
* lateral inhibition — per-axis one-hot phase-space convs in the same
  layout (:func:`inhibition_positive_term_phased`).

Measured on an NVIDIA H100 80GB HBM3 (400 W) at the flagship config
(64x256x256, 16 atoms 9x9, C=1; ``benchmarks/lowering.py``): 5.21 ->
2.41 ms per full MU iteration in f32 and 5.39 -> 1.92 ms in bf16 against
the plain conv strategy, which is why the lowering policy
(:func:`tnmf_tpu.engine.prefers_phased`) selects it on a GPU.  Numerically
the operators match the oracle/conv paths to f64 roundoff
(tests/test_phased.py).

Generality: all four reconstruction modes, 1-3 shift dimensions (the lax
conv limit).  Arbitrary transform sizes are handled by **absorbing zero
padding**: H's shift axes are padded up to phase- and block-divisible
sizes; padded positions start at zero and zero is absorbing under the
multiplicative update, so trajectories are identical to the unpadded
problem (mode-independent: whatever a padded position's gradient
statistics read, ``0 * neg/pos`` keeps it exactly zero, and zero
activations contribute nothing to any contraction).  The gradient
operators are mode-generic through the extended data tensor; only
:func:`reconstruct` handles modes explicitly, entirely at the conv
boundary — 'full' left-pads the conv input by ``(a-1)/r`` zero blocks
(block-aligned because ``r | a-1``), 'circular' prepends the last
``(a-1)/r`` canonical blocks of H (block-aligned because geometry demands
``r | T``), and 'reflect' prepends a phase-permuted, block-reversed slice
of H (the reflection ``x -> -x`` maps phase ``q`` to ``(r - q) % r``, so
the offset-1 boundary reversal IS block-aligned in phase space; see
:func:`_reflect_left`).  Reference roles covered: ``NumPy_FFT.py:52-93``
(the gradient/reconstruct hot loop of /root/reference).

Spatial (context-parallel) meshes — measured negative.  The model gates the
phased lowering off under ``shard_axis='spatial'/'both'``
(models/tnmf.py).  Measured on the virtual 8-device mesh (valid mode,
60x28 sample, 5x5 atoms, H spatial axis 64 = 8x8): the plain conv update
step stays partitioned (H output sharded ``P(None, None, 'data')``, 33
halo ``collective-permute`` ops), while the SAME step through this module
comes back **fully replicated** (H output spec ``P()``, 4 ``all-gather``
ops, zero permutes) — GSPMD cannot propagate the spatial sharding through
the phase encode's pad-to-``t_pad`` + space-to-depth reshape + channels-
last transpose (the padded block count, e.g. 68/4 = 17 here, is not
divisible by the mesh, and the transpose moves the sharded dim minormost).
Replication silently defeats the memory point of spatial sharding, so the
gate stays; pinned by ``tests/test_phased.py::
test_phased_spatial_mesh_replicates``.  Lifting it would need mesh-aware
geometry (``t_pad`` a multiple of ``r * n_shards`` plus sharding
constraints on the phased carry) and pays a per-iteration reshard of the
extended data stream — revisit if huge-single-image spatial fits become a
real workload.
"""

from __future__ import annotations

import itertools
import math
from functools import lru_cache
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from . import conv as conv_ops
from .modes import ConvPlan

# phase count cap: beyond it the one-hot kernels only inflate FLOPs
_MAX_PHASES = 16
# default per-axis reconstruction output blocking by rank (targets ~64
# output channels for C=1).  These factors also set the valid-mode padding
# congruence in :func:`geometry`; the reconstruction conv itself may
# *locally* double the minormost block for channel-poor data
# (:func:`_rec_block`) without changing any carried shape.
_REC_BLOCK = {1: (64,), 2: (8, 8), 3: (4, 4, 4)}


def _rec_block(g, n_channels: int, itemsize: int = 2,
               n_atoms: int = 1) -> Tuple[int, ...]:
    """Effective reconstruction output blocking for ``n_channels`` data.

    The rec conv's output channel count is ``C * prod(s)``; at the base 2-D
    blocking and C=1 that is 64.  For narrow dtypes (bf16) and one
    channel the minormost block is doubled (128 output channels) at ~1.5x
    one-hot FLOP inflation; float32 and C >= 2 keep the base blocking.
    Which way this choice goes on a GPU is not measured yet (the H100
    flagship figures in the module docstring include it).  Purely local to the
    reconstruction: ``t_pad`` keeps the base-``s`` congruence and
    :func:`reconstruct` tops up any non-congruent strided grid with
    absorbing conv padding.
    """
    s = g['s']
    if n_channels == 1 and itemsize < 4 and math.prod(s) < 128:
        doubled = s[:-1] + (2 * s[-1],)
        # the doubled blocking must respect the same resource caps the
        # strategy choice checked at the base blocking (e.g. the 64^3
        # volume config is phased-applicable at (4,4,4) but its doubled
        # placement tensor would exceed the cap — it keeps the base)
        if _rec_caps_ok(g, doubled, n_atoms):
            s = doubled
    return s


# ---------------------------------------------------------------------------
# plan-level geometry: phase factors, output blocking, absorbing padding
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def geometry(plan: ConvPlan):
    """Phase/blocking geometry for ``plan`` or None when not applicable.

    Returns a dict with per-axis phase factors ``r``, reconstruction output
    blocking ``s``, padded transform extents ``t_pad`` (multiples of ``r``;
    in 'valid' mode additionally ``t_pad - a + 1`` a multiple of ``s`` so
    the unpadded strided output grid covers the sample exactly), and the
    padded extended extents ``e_pad = t_pad + a - 1``.
    """
    if plan.mode not in ('valid', 'full', 'circular', 'reflect') or plan.ndim > 3:
        return None
    A = plan.atom_shape
    T = plan.transform_shape
    if plan.mode == 'circular' and any(a - 1 > t for a, t in zip(A, T)):
        return None  # the wrap in reconstruct() would need multiple periods
    if plan.mode == 'reflect' and any(a > t for a, t in zip(A, T)):
        return None  # reflection sources (H[1..a-1]) must exist canonically

    # per-axis phase factor: the largest r with (a-1) % r == 0 so that the
    # padding congruences t' = 0 (mod r), t' = a-1 (mod s) are solvable
    # (r divides s); circular mode additionally needs r | t so the
    # wrap-around concat in reconstruct() is block-aligned
    def _ok(c, a, t):
        return (a - 1) % c == 0 and (plan.mode != 'circular' or t % c == 0)

    rs = [next((c for c in (4, 2, 1) if _ok(c, a, t)), 1)
          for a, t in zip(A, T)]
    while math.prod(rs) > _MAX_PHASES:
        rs[rs.index(max(rs))] //= 2
    rs = tuple(rs)
    ss = _REC_BLOCK[plan.ndim]
    if math.prod(rs) == 1:
        return None  # even atoms on every axis: no phase structure to exploit
    t_pad, e_pad = [], []
    for a, t, r, s in zip(A, T, rs, ss):
        tp = t
        if plan.mode == 'valid':
            # no conv padding on the reconstruct: the strided output grid
            # must cover exactly the sample extent
            while tp % r or (tp - a + 1) % s:
                tp += 1
        else:
            # full/circular/reflect cover the output grid with explicit conv
            # padding in reconstruct(), so only block divisibility matters
            # (circular: r | t already, hence tp == t and no absorbing pad)
            while tp % r:
                tp += 1
        t_pad.append(tp)
        e_pad.append(tp + a - 1)
    return dict(r=rs, s=ss, t_pad=tuple(t_pad), e_pad=tuple(e_pad), a=A, t=T)


def applicable(plan: ConvPlan, n_channels: int, n_atoms: int) -> bool:
    """Whether the phased lowering applies and is expected to win.

    The phase trick pays off when channels are scarce (it multiplies both
    conv operands' channel counts); with >= 16 native channels the plain
    conv lowering already feeds the matrix units (same threshold as the
    space-to-depth output blocking in :mod:`tnmf_tpu.ops.conv`).
    """
    g = geometry(plan)
    if g is None or n_channels >= 16:
        return False
    if plan.ndim == 1 and plan.transform_shape[0] < 256:
        return False  # the (64,) output blocking would pad tiny signals away
    # one-hot kernel and placement caps at the BASE blocking: strategy
    # selection is blocking-independent (the narrow-dtype doubled blocking
    # checks the same caps itself and falls back to base when it would
    # bust them — see :func:`_rec_caps_ok` / :func:`_rec_block`)
    return _rec_caps_ok(g, g['s'], n_atoms)


def _rec_caps_ok(g, s: Tuple[int, ...], n_atoms: int) -> bool:
    """Resource caps of the strided reconstruction at output blocking
    ``s``: the one-hot kernel must stay reasonable, and so must the cached
    host-side placement tensor (``(prod(s), pp, prod(ky), prod(A))`` — an
    lru-cached jit constant; e.g. 21x21 atoms at r=(4,4) would allocate
    ~88 MB, where the plain conv strategy needs nothing)."""
    pp = math.prod(g['r'])
    ky = tuple((si - 1 + a - 1) // r + 1
               for a, r, si in zip(g['a'], g['r'], s))
    if n_atoms * pp * math.prod(s) * math.prod(ky) > 2 ** 22:
        return False
    return math.prod(s) * pp * math.prod(ky) * math.prod(g['a']) <= 2 ** 23


# ---------------------------------------------------------------------------
# phase (space-to-depth) reshapes
# ---------------------------------------------------------------------------

def _phase(x: jnp.ndarray, r: Tuple[int, ...]) -> jnp.ndarray:
    """(N, F, *E) canonical -> (N, *(E/r), F*prod(r)) channels-last, channel
    order (f, p1..pk)."""
    N, F = x.shape[:2]
    E = x.shape[2:]
    nd = len(r)
    x = x.reshape((N, F) + tuple(
        v for e, rr in zip(E, r) for v in (e // rr, rr)))
    # (N, F, Y1, r1, ..., Yk, rk) -> (N, Y1..Yk, F, r1..rk)
    perm = ([0] + [2 + 2 * i for i in range(nd)] + [1]
            + [3 + 2 * i for i in range(nd)])
    x = x.transpose(perm)
    return x.reshape((N,) + tuple(e // rr for e, rr in zip(E, r)) +
                     (F * math.prod(r),))


def _unphase(x: jnp.ndarray, F: int, r: Tuple[int, ...]) -> jnp.ndarray:
    """Inverse of :func:`_phase`: (N, *B, F*prod(r)) -> (N, F, *(B*r))."""
    N = x.shape[0]
    nd = len(r)
    blocks = x.shape[1:1 + nd]
    x = x.reshape((N,) + blocks + (F,) + r)
    perm = [0, 1 + nd]
    for i in range(nd):
        perm += [1 + i, 2 + nd + i]
    x = x.transpose(perm)
    return x.reshape((N, F) + tuple(b * rr for b, rr in zip(blocks, r)))


def encode_h(H: jnp.ndarray, plan: ConvPlan) -> jnp.ndarray:
    """Canonical H -> padded, phase-blocked H (the loop-carried form)."""
    g = geometry(plan)
    pads = [(0, 0), (0, 0)] + [(0, tp - t) for tp, t in zip(g['t_pad'], g['t'])]
    return _phase(jnp.pad(H, pads), g['r'])


def decode_h(Hph: jnp.ndarray, plan: ConvPlan, n_atoms: int) -> jnp.ndarray:
    """Phased H -> canonical H (crops the absorbing padding)."""
    g = geometry(plan)
    H = _unphase(Hph, n_atoms, g['r'])
    return H[(Ellipsis,) + tuple(slice(0, t) for t in g['t'])]


# ---------------------------------------------------------------------------
# one-hot kernel builders (host-side placement tensors, cached)
# ---------------------------------------------------------------------------

def _ranges(dims):
    return itertools.product(*(range(d) for d in dims))


def _flat(idx, dims) -> int:
    f = 0
    for i, d in zip(idx, dims):
        f = f * d + i
    return f


@lru_cache(maxsize=None)
def _grad_placement(A, r):
    """P[p, q, k, a] = 1 iff the phased grad kernel tap (q, k) reads atom
    offset a from output phase p: p + a = r*k + q per axis (flattened
    multi-indices)."""
    import numpy as np
    K = tuple((rr - 1 + a - 1) // rr + 1 for a, rr in zip(A, r))
    pp = math.prod(r)
    P = np.zeros((pp, pp, math.prod(K), math.prod(A)), np.float32)
    for p in _ranges(r):
        for a in _ranges(A):
            q = tuple((pi + ai) % ri for pi, ai, ri in zip(p, a, r))
            k = tuple((pi + ai) // ri for pi, ai, ri in zip(p, a, r))
            P[_flat(p, r), _flat(q, r), _flat(k, K), _flat(a, A)] = 1.0
    return P, K


@lru_cache(maxsize=None)
def _rec_placement(A, r, s):
    """P[sp, q, t, a] = 1 iff reconstruction output phase ``sp`` reads atom
    offset ``a`` from H phase ``q`` at tap ``t``: a = r*t + q - sp per axis
    (flipped-W indexing applied by the caller)."""
    import numpy as np
    T = tuple((si - 1 + a - 1) // ri + 1 for a, ri, si in zip(A, r, s))
    P = np.zeros((math.prod(s), math.prod(r), math.prod(T), math.prod(A)),
                 np.float32)
    for sp in _ranges(s):
        for q in _ranges(r):
            for t in _ranges(T):
                a = tuple(ri * ti + qi - spi
                          for ri, ti, qi, spi in zip(r, t, q, sp))
                if all(0 <= ai < Ai for ai, Ai in zip(a, A)):
                    P[_flat(sp, s), _flat(q, r), _flat(t, T), _flat(a, A)] = 1.0
    return P, T


def _grad_kernel(W: jnp.ndarray, g) -> jnp.ndarray:
    """(M, C, *A) -> (M*pp, C*pp, *K) correlation kernel in phase space."""
    M, C = W.shape[:2]
    A, r = g['a'], g['r']
    P, K = _grad_placement(A, r)
    # one-hot placement = pure gather; HIGHEST keeps the dictionary weights
    # exact under a TF32 matmul default (conv_ops._EXACT rationale)
    Kk = jnp.einsum('mca,pqka->mpcqk', W.reshape(M, C, -1),
                    jnp.asarray(P, W.dtype), precision=conv_ops._EXACT)
    pp = math.prod(r)
    return Kk.reshape((M * pp, C * pp) + K)


def _rec_kernel(W: jnp.ndarray, g) -> jnp.ndarray:
    """(M, C, *A) -> (C*prod(s), M*pp, *T) strided reconstruction kernel
    (W flip folded in; ``s`` is the channel-adaptive effective blocking)."""
    M, C = W.shape[:2]
    A, r, s = g['a'], g['r'], _rec_block(g, C, jnp.dtype(W.dtype).itemsize,
                                         n_atoms=M)
    Wf = jnp.flip(W, axis=tuple(range(2, 2 + len(A))))
    P, T = _rec_placement(A, r, s)
    Kk = jnp.einsum('mca,sqta->csmqt', Wf.reshape(M, C, -1),
                    jnp.asarray(P, W.dtype), precision=conv_ops._EXACT)
    pp = math.prod(r)
    return Kk.reshape((C * math.prod(s), M * pp) + T)


# ---------------------------------------------------------------------------
# the operator contract (prepare_data / reconstruct / grad pairs)
# ---------------------------------------------------------------------------

def _dn(nd: int, kind: str):
    # channels-LAST activations (phased channels minormost); kernels stay
    # (O, I, *taps).  grad_W contracts over samples: lhs batches the data
    # channels (last axis) and feeds N as the contraction, output kept
    # (batch=C-side, feature=M-side, *taps) so the reassembly is identical
    # to the channels-second formulation.
    sp = conv_ops._dim_letters(nd)
    if kind == 'std':
        return ('N' + sp + 'C', 'OI' + sp, 'N' + sp + 'C')
    return ('C' + sp + 'N', 'I' + sp + 'O', 'NC' + sp)  # sample-contracting


def _conv(lhs, rhs, dn, preferred, precision, strides=None, keep_low=False,
          padding=None):
    # sub-f32 storage still accumulates in f32; keep_low rounds the
    # *output* to the storage dtype (used for the H-gradient pair in bf16
    # mode, halving the dominant memory stream of the iteration — the MU
    # ratio is robust to bf16 gradient statistics, tests/test_bfloat16.py)
    if not keep_low and jnp.dtype(preferred).itemsize < 4:
        preferred = jnp.float32
    nd = lhs.ndim - 2
    return lax.conv_general_dilated(
        lhs, rhs, window_strides=strides or (1,) * nd,
        padding=padding or [(0, 0)] * nd,
        dimension_numbers=dn, preferred_element_type=preferred,
        precision=precision)


def _extend_phased(X: jnp.ndarray, plan: ConvPlan) -> jnp.ndarray:
    """Mode extension + absorbing pad + phase blocking of a data tensor."""
    g = geometry(plan)
    Xe = conv_ops.extend_data(X, plan)
    pads = [(0, 0), (0, 0)] + [
        (0, ep - xe) for ep, xe in zip(g['e_pad'], Xe.shape[2:])]
    return _phase(jnp.pad(Xe, pads), g['r'])


def prepare_data(V: jnp.ndarray, plan: ConvPlan) -> jnp.ndarray:
    """Loop-invariant phased extension of the data tensor."""
    return _extend_phased(V, plan)


#: the phased prepared domain (mode extension + absorbing pad + phase
#: reshape) is an entrywise replication/zero-fill of the canonical domain,
#: so elementwise beta-divergence factors apply directly to prepared
#: tensors (engine._beta_factors)
FACTORS_IN_PREPARED = True


def _unshuffle_cl(out: jnp.ndarray, C: int, ks: Tuple[int, ...]) -> jnp.ndarray:
    """(N, *B, C*prod(ks)) channels-last blocked -> (N, C, *(B*ks))
    canonical (the channels-last pixel unshuffle)."""
    N = out.shape[0]
    nd = len(ks)
    B = out.shape[1:1 + nd]
    x = out.reshape((N,) + B + (C,) + ks)
    perm = [0, 1 + nd]
    for i in range(nd):
        perm += [1 + i, 2 + nd + i]
    x = x.transpose(perm)
    return x.reshape((N, C) + tuple(b * k for b, k in zip(B, ks)))


def _reflect_left(x: jnp.ndarray, g, ax: int, n_blocks: int) -> jnp.ndarray:
    """Prepend ``n_blocks`` blocks of the even left reflection along shift
    axis ``ax``.  Canonical position ``-k`` holds ``H[k]`` (numpy 'reflect'
    semantics, edge excluded); with ``k = r*j - q`` that value lives at
    phase ``(r - q) % r``, block ``j`` (phase 0) or ``j - 1`` (phase >= 1)
    — a phase-permuted, block-reversed read of the canonical region,
    block-aligned for any ``r | a-1`` (no ``r | T`` requirement).  Sources
    (``H[1..a-1]``) never touch the absorbing right padding."""
    r = g['r']
    nd = len(r)
    N, CH = x.shape[0], x.shape[-1]
    F = CH // math.prod(r)
    blocks = x.shape[1:1 + nd]
    xr = x.reshape((N,) + blocks + (F,) + r)
    bax, pax = 1 + ax, 2 + nd + ax
    rr = r[ax]
    parts = []
    for q in range(rr):
        j0, j1 = (1, n_blocks + 1) if q == 0 else (0, n_blocks)
        src = lax.slice_in_dim(xr, (rr - q) % rr, (rr - q) % rr + 1, axis=pax)
        src = lax.slice_in_dim(src, j0, j1, axis=bax)
        parts.append(jnp.flip(src, axis=bax))
    ext = jnp.concatenate(parts, axis=pax)
    out = jnp.concatenate([ext, xr], axis=bax)
    nb = tuple(b + (n_blocks if i == ax else 0) for i, b in enumerate(blocks))
    return out.reshape((N,) + nb + (CH,))


def reconstruct(W: jnp.ndarray, Hph: jnp.ndarray, plan: ConvPlan) -> jnp.ndarray:
    """R[n,c,*S] from phased H: strided phase-space conv + pixel unshuffle.

    Mode handling lives entirely at the conv boundary.  The canonical
    reconstruction reads the *left-extended* H (oracle docstring): 'full'
    zero-extends by a-1 — expressed as ``(a-1)/r`` blocks of conv zero
    padding (block-aligned since ``r | a-1``); 'circular' wrap-extends —
    expressed by prepending the last ``(a-1)/r`` canonical blocks of H
    (block-aligned since geometry demands ``r | T``).  The placement
    tensor is mode-independent: a left extension shifts the input block
    index and the canonical output position by the same amount, so the
    per-tap atom offsets ``a = r*t + q - sp`` are unchanged.  Right zero
    padding tops up the strided output grid to ``ceil(S/s)`` blocks; any
    overhang reads absorbing/pad zeros and is cropped."""
    g = geometry(plan)
    s, r, A = (_rec_block(g, W.shape[1], jnp.dtype(W.dtype).itemsize,
                          n_atoms=W.shape[0]),
               g['r'], g['a'])
    nd = plan.ndim
    K3 = _rec_kernel(W, g)
    taps = K3.shape[2:]
    strides = tuple(si // ri for si, ri in zip(s, r))
    x = Hph
    if plan.mode in ('circular', 'reflect'):
        for ax, (a, rr, t) in enumerate(zip(A, r, g['t'])):
            lb = (a - 1) // rr
            if not lb:
                continue
            if plan.mode == 'circular':
                wrap = lax.slice_in_dim(x, (t - (a - 1)) // rr, t // rr,
                                        axis=1 + ax)
                x = jnp.concatenate([wrap, x], axis=1 + ax)
            else:
                x = _reflect_left(x, g, ax, lb)
    pad = []
    for i in range(nd):
        left = (A[i] - 1) // r[i] if plan.mode == 'full' else 0
        n_req = -(-plan.sample_shape[i] // s[i])
        need = (n_req - 1) * strides[i] + taps[i]
        pad.append((left, max(0, need - x.shape[1 + i] - left)))
    out = _conv(x, K3, _dn(nd, 'std'), W.dtype, plan.lax_precision, strides,
                padding=pad)
    R = _unshuffle_cl(out, W.shape[1], s).astype(W.dtype)
    return R[(Ellipsis,) + tuple(slice(0, si) for si in plan.sample_shape)]


def corr_H(Xs: jnp.ndarray, W: jnp.ndarray, plan: ConvPlan) -> jnp.ndarray:
    """Single-stream H-gradient correlation of a phased prepared tensor
    against the one-hot-expanded dictionary kernel; output in H's phased
    layout.  The batch extent of ``Xs`` is free (repeated calls with the
    same W share one ``_grad_kernel`` build via XLA CSE)."""
    g = geometry(plan)
    K2 = _grad_kernel(W, g)
    return _conv(Xs, K2, _dn(plan.ndim, 'std'), W.dtype, plan.lax_precision,
                 keep_low=True)


def grad_H_pair_prepared(As: jnp.ndarray, Bs: jnp.ndarray, W: jnp.ndarray,
                         plan: ConvPlan) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(neg, pos) H-gradient correlations of two already-phased streams.

    They run as TWO separate convs on purpose: a batch-stacked conv (the
    plain conv strategy's trick) forces the consumer to slice its output
    across the batch dim, which blocks XLA's conv-output fusion and
    materializes the stacked H-sized gradient pair (~500 MB at the
    flagship scale) to device memory.  Kept separate, each conv can fuse
    into the downstream MU ratio.
    """
    return corr_H(As, W, plan), corr_H(Bs, W, plan)


def grad_H_pair(Vs: jnp.ndarray, R: jnp.ndarray, W: jnp.ndarray,
                plan: ConvPlan) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(neg, pos) of dE/dH, both in H's phased layout.  ``Vs`` is the
    phased prepared data; ``R`` the current data-space reconstruction."""
    return grad_H_pair_prepared(Vs, _extend_phased(R, plan), W, plan)


# ---------------------------------------------------------------------------
# fused reconstruction -> gradient path (round 5: the roofline's R streams)
#
# The MU gradients consume the *phased extended* reconstruction; computing
# it via the canonical ``reconstruct`` costs a pixel-unshuffle, a crop, a
# zero-extension and a re-phase — up to four R-sized memory passes per
# reconstruction, twice per iteration.  At ``s = r`` the reconstruction
# conv's raw blocked output (N, *blocks, C*pp, channel order (c, phase))
# IS the phased layout of R on the grid-aligned core, and in 'valid' mode
# the zero extension is block-aligned (r | a-1), so it can be expressed as
# *conv input padding* of the downstream gradient conv: (a-1)/r zero
# blocks on each side.  The R stream then materializes exactly once (the
# rec conv's write) and is read exactly once (the grad conv) — the
# minimum any schedule can do.
#
# Exactness gate: ``t_pad == t``.  With absorbing transform padding the
# raw output's overhang (canonical positions >= S) is computed from REAL
# right-edge activations, where the extended R must be zero — those
# configurations keep the canonical path.
# ---------------------------------------------------------------------------

def fused_rec_supported(plan: ConvPlan, dtype=jnp.float32) -> bool:
    """Whether the fused path runs: float32 only.  It saves R-sized memory
    passes, but its ``s = r`` reconstruction conv carries only ``C*pp``
    output channels and gives up the doubled blocking of
    :func:`_rec_block`, so narrow dtypes keep the canonical path.  The
    split by dtype is not re-measured on a GPU.

    Geometry: mode 'full' is unconditionally exact (positions past the
    sample read only absorbing H zeros, so the raw overhang already *is*
    the zero fill the extended stream needs).  Mode 'valid' is exact when
    ``t_pad == t`` (no absorbing padding — nothing to clean) or when
    ``r | S`` per axis (the raw overhang beyond the sample, which carries
    real right-edge activations where the extended R needs zeros,
    occupies *whole* blocks and is dropped by one static slice before the
    gradient conv).  circular/reflect wrap real data into the extension
    and keep the canonical path."""
    g = geometry(plan)
    if g is None or jnp.dtype(dtype).itemsize < 4:
        return False
    if plan.mode == 'full':
        return True
    if plan.mode != 'valid':
        return False
    return (tuple(g['t_pad']) == tuple(g['t'])
            or all(s % rr == 0
                   for s, rr in zip(plan.sample_shape, g['r'])))


def _rec_kernel_r(W: jnp.ndarray, g) -> jnp.ndarray:
    """The ``s = r`` reconstruction kernel: raw conv output lands directly
    in the r-blocked phased layout the gradient convs consume."""
    M, C = W.shape[:2]
    A, r = g['a'], g['r']
    Wf = jnp.flip(W, axis=tuple(range(2, 2 + len(A))))
    P, T = _rec_placement(A, r, r)
    Kk = jnp.einsum('mca,sqta->csmqt', Wf.reshape(M, C, -1),
                    jnp.asarray(P, W.dtype), precision=conv_ops._EXACT)
    pp = math.prod(r)
    return Kk.reshape((C * pp, M * pp) + T)


def rec_blocks(W: jnp.ndarray, Hph: jnp.ndarray, plan: ConvPlan) -> jnp.ndarray:
    """Raw phased reconstruction: (N, *(t-a+1)/r blocks, C*pp), canonical
    position ``b*r + p`` at block b, channel (c, p) — the phased extended
    R minus its zero border blocks (conv padding downstream).  Mode
    'full' left-extends H by (a-1) zeros exactly like :func:`reconstruct`
    — block-aligned conv padding."""
    g = geometry(plan)
    K3 = _rec_kernel_r(W, g)
    # 'full': H is zero-extended by (a-1) on BOTH sides (reconstruct's
    # left conv padding, plus a right extension so the raw grid reaches
    # R's tail at canonical [t_pad, S) — those outputs read real H taps;
    # positions past S read only absorbing zeros and stay zero)
    ext = (tuple((a - 1) // rr for a, rr in zip(g['a'], g['r']))
           if plan.mode == 'full' else (0,) * plan.ndim)
    return _conv(Hph, K3, _dn(plan.ndim, 'std'), W.dtype,
                 plan.lax_precision, keep_low=True,
                 padding=[(e, e) for e in ext])


def _ext_border(plan: ConvPlan, g) -> Tuple[int, ...]:
    """Left zero-block count of the phased extended stream: (a-1)/r in
    'valid' mode (the grad reads X extended on both sides), zero in
    'full' (the grad reads X unextended)."""
    if plan.mode == 'full':
        return (0,) * len(g['r'])
    return tuple((a - 1) // rr for a, rr in zip(g['a'], g['r']))


def _clean_blocks(Rb: jnp.ndarray, plan: ConvPlan, g):
    """The sample-covering prefix of the raw blocks plus the (left, right)
    zero-block counts completing the ``e_pad`` grid.  With absorbing
    transform padding (``t_pad > t``) the raw overhang beyond the sample
    carries real right-edge activations where the extended R needs zeros;
    the gate guarantees ``r | S`` there, so the overhang is whole blocks
    and one static slice drops it."""
    L = _ext_border(plan, g)
    if plan.mode == 'valid' and tuple(g['t_pad']) != tuple(g['t']):
        clean = tuple(s // rr for s, rr in zip(plan.sample_shape, g['r']))
        Rb = Rb[(slice(None),) + tuple(slice(0, c) for c in clean)]
    e_blocks = tuple(e // rr for e, rr in zip(g['e_pad'], g['r']))
    right = tuple(e - l - b
                  for e, l, b in zip(e_blocks, L, Rb.shape[1:-1]))
    return Rb, L, right


def grad_H_pair_fused(Vs: jnp.ndarray, W: jnp.ndarray, Hph: jnp.ndarray,
                      plan: ConvPlan) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(neg, pos) of dE/dH with the reconstruction fused into the positive
    gradient conv's input — no canonical R, no extend/phase round trip."""
    g = geometry(plan)
    Rb = rec_blocks(W, Hph, plan)
    K2 = _grad_kernel(W, g)
    dn = _dn(plan.ndim, 'std')
    neg = _conv(Vs, K2, dn, W.dtype, plan.lax_precision, keep_low=True)
    Rb, L, right = _clean_blocks(Rb, plan, g)
    pos = _conv(Rb, K2, dn, W.dtype, plan.lax_precision, keep_low=True,
                padding=list(zip(L, right)))
    return neg, pos


def grad_W_pair_fused(Vs: jnp.ndarray, W: jnp.ndarray, Hph: jnp.ndarray,
                      plan: ConvPlan) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(neg, pos) of dE/dW from the raw phased reconstruction: the zero
    border becomes a pad of the stacked stream (the stacked conv's concat
    materializes either way; the unshuffle/re-phase round trip is gone)."""
    g = geometry(plan)
    Rb = rec_blocks(W, Hph, plan)
    Rb, L, right = _clean_blocks(Rb, plan, g)
    pads = [(0, 0)] + list(zip(L, right)) + [(0, 0)]
    return grad_W_pair_prepared(Vs, jnp.pad(Rb, pads), Hph, plan)


@lru_cache(maxsize=None)
def _band_placement(taps: int, r: Tuple[int, ...], axis: int):
    """One-hot P[p, q, t, d] mapping the canonical 1-D kernel tap
    ``d - rad`` onto the phase-space conv tap ``t`` along ``axis``:
    canonical offset = r[axis]*(t - t_off) + (q - p) on that axis, with
    every other phase axis held equal."""
    import numpy as np
    rad = (taps - 1) // 2
    rr = r[axis]
    T = 2 * ((rad + rr - 1) // rr) + 1
    t_off = (T - 1) // 2
    pp = math.prod(r)
    P = np.zeros((pp, pp, T, taps), np.float32)
    for p in _ranges(r):
        for q in _ranges(r):
            if any(pi != qi for i, (pi, qi) in enumerate(zip(p, q)) if i != axis):
                continue
            dp = q[axis] - p[axis]
            for t in range(T):
                d = rr * (t - t_off) + dp
                if -rad <= d <= rad:
                    P[_flat(p, r), _flat(q, r), t, d + rad] = 1.0
    return P, T, t_off


def _phase_conv_1d(x: jnp.ndarray, k: jnp.ndarray, plan: ConvPlan, axis: int,
                   M: int) -> jnp.ndarray:
    """Zero-padded canonical 1-D convolution along shift axis ``axis``,
    executed as ONE phase-space conv whose layouts match the grad conv's —
    no transposes (a banded-einsum formulation pays a full-tensor relayout
    per non-minor axis)."""
    g = geometry(plan)
    r = g['r']
    nd = len(r)
    pp = math.prod(r)
    P, T, t_off = _band_placement(int(k.shape[0]), r, axis)
    # one-hot gathers of the kernel taps: keep exact (conv_ops._EXACT)
    Kp = jnp.einsum('pqtd,d->pqt', jnp.asarray(P, k.dtype), k,
                    precision=conv_ops._EXACT)
    eye = jnp.eye(M, dtype=k.dtype)
    K = jnp.einsum('mn,pqt->mpnqt', eye, Kp,
                   precision=conv_ops._EXACT).reshape(M * pp, M * pp, T)
    kshape = [M * pp, M * pp] + [1] * nd
    kshape[2 + axis] = T
    K = K.reshape(kshape)
    pad = [(0, 0)] * nd
    pad[axis] = (t_off, T - 1 - t_off)
    return _conv(x, K, _dn(nd, 'std'), x.dtype, None, padding=pad,
                 keep_low=True)


def inhibition_positive_term_phased(
        Hph: jnp.ndarray, kernels, plan: ConvPlan, n_atoms: int,
        inhibition, cross_inhibition,
        with_same_atom: bool, with_cross_atom: bool) -> jnp.ndarray:
    """The lateral-inhibition positive term, computed directly in the phased
    layout (same semantics as :func:`tnmf_tpu.ops.inhibition
    .inhibition_positive_term` on the zero-padded canonical H: the absorbing
    zero padding reproduces the reference's zero-padded boundary exactly).

    The per-axis convs use a dense ``(M*pp, M*pp, taps)`` kernel that is
    block-diagonal over atoms — only 1/M of its FLOPs are useful.  The
    alternative (atoms merged into the conv batch dim, kernel
    ``(pp, pp, taps)``, 16x fewer FLOPs) feeds the matrix units only
    ``pp`` channels; it is not measured on a GPU.
    """
    g = geometry(plan)
    r = g['r']
    pp = math.prod(r)
    M = Hph.shape[-1] // pp
    conv = Hph
    for axis, k in enumerate(kernels):
        conv = _phase_conv_1d(conv, jnp.asarray(k, Hph.dtype), plan, axis, M)
    term = jnp.zeros_like(Hph)
    if with_same_atom:
        term = term + inhibition * (conv - Hph)
    if with_cross_atom:
        c = conv.reshape(conv.shape[:-1] + (M, pp))
        cross = (c.sum(axis=-2, keepdims=True) - c).reshape(Hph.shape)
        term = term + (cross_inhibition / (n_atoms - 1)) * cross
    return term


def corr_W(Xs: jnp.ndarray, Hph: jnp.ndarray, plan: ConvPlan) -> jnp.ndarray:
    """Single-stream W-gradient correlation of a phased prepared tensor
    against phased H, with the one-hot phase reassembly folded in; output
    ``(M, C, *atom)`` in canonical atom-offset space.  The channel extent
    of ``Xs`` is free (it rides the conv's batch role)."""
    g = geometry(plan)
    A, r = g['a'], g['r']
    pp = math.prod(r)
    M = Hph.shape[-1] // pp
    C = Xs.shape[-1] // pp
    out = _conv(Xs, Hph, _dn(plan.ndim, 'gw'), Hph.dtype, plan.lax_precision)
    K = out.shape[2:]
    # the reassembly placement is the grad placement with the (p, q) roles
    # transposed: out[(c,q),(m,p),k] contributes to G[c,m,a] iff
    # p + a = r*k + q per axis
    P, Kgrid = _grad_placement(A, r)
    assert tuple(Kgrid) == tuple(K), (Kgrid, K)
    P4 = jnp.asarray(P.transpose(1, 0, 2, 3), out.dtype)
    o = out.reshape((C, pp, M, pp, math.prod(K)))
    # one-hot scatter-add of the phase terms: exact products (x1.0) keep
    # the f32 gradient statistics unrounded under a TF32 default
    G = jnp.einsum('cqmpk,qpka->cma', o, P4,
                   precision=conv_ops._EXACT).reshape((C, M) + A)
    return jnp.swapaxes(G, 0, 1)


def grad_W_pair_prepared(As: jnp.ndarray, Bs: jnp.ndarray, Hph: jnp.ndarray,
                         plan: ConvPlan) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(neg, pos) W-gradient correlations of two already-phased streams,
    stacked along the phased channel axis (the conv's batch role)."""
    c = As.shape[-1]
    G2 = corr_W(jnp.concatenate([As, Bs], axis=-1), Hph, plan)
    pp = math.prod(geometry(plan)['r'])
    return G2[:, :c // pp], G2[:, c // pp:]


def grad_W_pair(Vs: jnp.ndarray, R: jnp.ndarray, Hph: jnp.ndarray,
                plan: ConvPlan) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(neg, pos) of dE/dW from phased operands.

    One sample-contracting conv with M*pp live output columns (the plain
    lowering has M), then a tiny one-hot einsum sums the pp phase terms
    back into atom-offset space.
    """
    return grad_W_pair_prepared(Vs, _extend_phased(R, plan), Hph, plan)
