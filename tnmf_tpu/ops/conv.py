"""Direct-convolution strategy for the conv-NMF operators.

Maps each of the three operators onto a single ``lax.conv_general_dilated``
call, which XLA hands to cuDNN on a GPU.  This is the analogue of the
reference's strided-view einsum backend
(``/root/reference/tnmf/backends/NumPy.py``) — the sliding-window ("im2col")
structure that the reference builds manually with
``np.lib.stride_tricks.as_strided`` is exactly what the hardware convolution
unit consumes natively.  Unlike the reference's coordinate-space backend,
which only supports the 'valid' mode (``NumPy.py:26-27``), all four
reconstruction modes are supported here via the same boundary-extension
scheme used by :mod:`tnmf_tpu.ops.fft`.

Preferred for small atoms, where the FFT padding overhead dominates; the
engine selects between 'fft' and 'conv' by a FLOPs heuristic.

Dimension-number cheat sheet (k spatial dims):

* reconstruct: contract atoms      → lhs H (N,M,*) batch=N feat=M;
  kernel flip(W)^T (C,M,*A); out (N,C,*S).
* grad_H:      contract channels   → lhs Xext (N,C,*) batch=N feat=C;
  kernel W (M,C,*A); out (N,M,*T).
* grad_W:      contract samples+shifts → lhs Xext (N,C,*) batch=C feat=N;
  kernel H (N,M,*T) I=N O=M; out (C,M,*A) → transposed to (M,C,*A).
"""

from __future__ import annotations

import itertools
import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import jax.numpy as jnp
from jax import lax

from .modes import ConvPlan

_SPATIAL = 'DHW'  # up to 3 explicit spatial letters; rank > 3 uses generic dims

# one-hot placement contractions are pure gathers; HIGHEST keeps the
# gathered weights exact under a reduced-precision matmul default (TF32
# on a GPU)
_EXACT = lax.Precision.HIGHEST


def _dim_letters(ndim: int) -> str:
    if ndim <= 3:
        return _SPATIAL[3 - ndim:]
    raise NotImplementedError(
        'direct-conv strategy supports up to 3 shift dimensions; '
        'use the fft strategy for higher ranks')


def _pad_spatial(x: jnp.ndarray, left, right, mode: str) -> jnp.ndarray:
    pad = [(0, 0)] * 2 + [(l, r) for l, r in zip(left, right)]
    if mode == 'zero':
        return jnp.pad(x, pad)
    return jnp.pad(x, pad, mode=mode)


def extend_data(X: jnp.ndarray, plan: ConvPlan) -> jnp.ndarray:
    """Same boundary extension as :func:`tnmf_tpu.ops.fft.extend_data`,
    but materialized for every mode (incl. zeros) so the convolutions below
    all run with padding=0."""
    am1 = tuple(a - 1 for a in plan.atom_shape)
    zero = (0,) * plan.ndim
    if plan.mode == 'valid':
        return _pad_spatial(X, am1, am1, 'zero')
    if plan.mode == 'full':
        return X
    if plan.mode == 'circular':
        return _pad_spatial(X, zero, am1, 'wrap')
    if plan.mode == 'reflect':
        return _pad_spatial(X, zero, am1, 'reflect')
    raise ValueError(plan.mode)


def _extend_H(H: jnp.ndarray, plan: ConvPlan) -> jnp.ndarray:
    """Left-extend H to length S+A-1 per axis (see oracle docstring)."""
    am1 = tuple(a - 1 for a in plan.atom_shape)
    zero = (0,) * plan.ndim
    if plan.mode == 'valid':
        return H
    if plan.mode == 'full':
        return _pad_spatial(H, am1, am1, 'zero')
    if plan.mode == 'circular':
        return _pad_spatial(H, am1, zero, 'wrap')
    if plan.mode == 'reflect':
        return _pad_spatial(H, am1, zero, 'reflect')
    raise ValueError(plan.mode)


def prepare_data(V: jnp.ndarray, plan: ConvPlan) -> jnp.ndarray:
    """The extended data tensor; loop-invariant per fit."""
    return extend_data(V, plan)


#: the prepared domain (mode extension) is an entrywise replication/zero-fill
#: of the canonical domain, so elementwise beta-divergence factors can be
#: computed directly on prepared tensors (engine._beta_factors) — no
#: per-iteration re-extension of a V-shaped tensor
FACTORS_IN_PREPARED = True


def _conv(lhs, rhs, dn, preferred, precision=None, strides=None):
    # sub-float32 storage (bfloat16) still accumulates in float32
    if jnp.dtype(preferred).itemsize < 4:
        preferred = jnp.float32
    return lax.conv_general_dilated(
        lhs, rhs,
        window_strides=strides or (1,) * (lhs.ndim - 2),
        padding=[(0, 0)] * (lhs.ndim - 2),
        dimension_numbers=dn,
        preferred_element_type=preferred,
        precision=precision,
    )


# ---------------------------------------------------------------------------
# space-to-depth output blocking
#
# Correlations with few output channels (e.g. the reconstruction: C = 1-3
# image channels) leave the matrix units mostly idle.  Blocking k adjacent
# output positions per axis into the channel dimension — an expanded
# kernel holding k shifted copies of the original, applied with stride k,
# followed by a pixel-unshuffle — raises the channel count k-fold at an
# FLOP inflation of only (A + k - 1)/A per axis.  Measured on an NVIDIA
# H100 80GB HBM3 (400 W) at the flagship 64x1x256x256 / 16 atoms 9x9
# (benchmarks/lowering.py): the reconstruction takes 0.76 ms blocked vs
# 1.92 ms unblocked (f32; bf16 0.71 vs 2.60), and the whole conv MU
# iteration 5.21 vs 7.24 ms (f32; bf16 5.39 vs 9.38).
# ---------------------------------------------------------------------------

# skip blocking when the cached one-hot placement tensor would exceed this
# many f32 elements (8 MB): large atoms with blocking would otherwise retain
# a few-hundred-MB host constant in the lru_cache for the process lifetime
_PLACEMENT_MAX_ELEMS = 2 ** 21


def _block_factors(out_shape, n_out_channels, atom_shape, target=64):
    """Per-axis blocking factors: grow the effective channel count toward
    ``target`` with small factors that divide the output extent.

    With >= 16 native output channels blocking is skipped: the channel
    count already feeds the matrix units and blocking only inflates FLOPs
    (that cut-off is not re-measured on a GPU)."""
    q = max(int(n_out_channels), 1)
    if q >= 16:
        return (1,) * len(out_shape)
    budget = max(1, target // q)
    ks = []
    for s in out_shape:
        k = 1
        for cand in (8, 6, 4, 3, 2):
            if cand <= budget and s % cand == 0:
                k = cand
                break
        ks.append(k)
        budget //= k
    ks = tuple(ks)
    eshape = tuple(a + k - 1 for a, k in zip(atom_shape, ks))
    if math.prod(ks) * math.prod(eshape) * math.prod(atom_shape) > _PLACEMENT_MAX_ELEMS:
        return (1,) * len(out_shape)
    return ks


@lru_cache(maxsize=None)
def _placement(ks, A):
    """Constant one-hot placement tensor P[(j), (e), (a)] = 1 iff e = a + j
    (flattened multi-indices), mapping an atom kernel onto its ks-shifted
    copies in one contraction."""
    eshape = tuple(a + k - 1 for a, k in zip(A, ks))
    P = np.zeros((math.prod(ks), math.prod(eshape), math.prod(A)), np.float32)
    for jf, j in enumerate(itertools.product(*(range(k) for k in ks))):
        for af, a in enumerate(itertools.product(*(range(x) for x in A))):
            e = tuple(ji + ai for ji, ai in zip(j, a))
            ef = 0
            for ei, es in zip(e, eshape):
                ef = ef * es + ei
            P[jf, ef, af] = 1.0
    return P, eshape


def _expand_kernel(K, ks):
    """Ke[(q, j1..jn), f, d'...] = K[q, f, d' - j] (zero outside support).

    Built as ONE einsum against a constant one-hot placement tensor: the
    expansion is rebuilt every MU iteration (it depends on W), and the
    previous ``prod(ks)`` dynamic-update-slice formulation paid a fixed
    per-op cost that dominated small-problem iterations (up to 64 ops per
    conv)."""
    Q, F = K.shape[:2]
    A = K.shape[2:]
    P, eshape = _placement(ks, A)
    # the placement contraction is a pure gather (one-hot x weight): force
    # HIGHEST so a reduced-precision default (TF32 on a GPU) cannot round
    # the kernel weights themselves
    Ke = jnp.einsum('qfa,jea->qjfe', K.reshape(Q, F, -1),
                    jnp.asarray(P, K.dtype), precision=_EXACT)
    return Ke.reshape((Q * math.prod(ks), F) + eshape)


def _unshuffle(out, Q, ks):
    """(N, Q*prod(ks), *blocked) -> (N, Q, *full) pixel unshuffle."""
    N = out.shape[0]
    nd = len(ks)
    blocked = out.shape[2:]
    x = out.reshape((N, Q) + ks + blocked)
    # interleave: (N, Q, k1..kn, b1..bn) -> (N, Q, b1, k1, ..., bn, kn)
    perm = [0, 1]
    for i in range(nd):
        perm += [2 + nd + i, 2 + i]
    x = x.transpose(perm)
    return x.reshape((N, Q) + tuple(b * k for b, k in zip(blocked, ks)))


def _corr_blocked(Xp, K, dn, preferred, precision, out_shape):
    """Stride-1 correlation of ``Xp`` with ``K`` (already mode-extended),
    using space-to-depth output blocking when profitable."""
    Q = K.shape[0]
    ks = _block_factors(out_shape, Q, K.shape[2:])
    if math.prod(ks) == 1 or len(out_shape) > 3:
        return _conv(Xp, K, dn, preferred, precision)
    Ke = _expand_kernel(K, ks)
    out = _conv(Xp, Ke, dn, preferred, precision, strides=ks)
    return _unshuffle(out, Q, ks)


def reconstruct(W: jnp.ndarray, H: jnp.ndarray, plan: ConvPlan) -> jnp.ndarray:
    """R[n,c,*S] = sum_m (H[n,m] * W[m,c]) — the model reconstruction as one
    convolution (reference role: ``NumPy_FFT.py:90``)."""
    sp = _dim_letters(plan.ndim)
    dn = ('NC' + sp, 'OI' + sp, 'NC' + sp)
    Hp = _extend_H(H, plan)
    # R[n,c,x] = sum_{m,a} Hp[n,m,x+a] * W[m,c,A-1-a]
    Wk = jnp.flip(jnp.swapaxes(W, 0, 1), axis=tuple(range(2, 2 + plan.ndim)))
    # accumulate in f32 under low-precision storage, store R in storage dtype
    return _corr_blocked(Hp, Wk, dn, W.dtype, plan.lax_precision,
                         plan.sample_shape).astype(W.dtype)


def corr_H(Xp: jnp.ndarray, W: jnp.ndarray, plan: ConvPlan) -> jnp.ndarray:
    """Single-stream prepared-domain H-gradient correlation:
    ``G[n,m,t] = sum_{c,a} Xp[n,c,t+a] * W[m,c,a]`` (no flip).  ``Xp`` is a
    mode-extended data-space tensor; its batch extent is free (the stacked
    gradient pairs and the batch-1 beta=1 denominator both run through
    here)."""
    sp = _dim_letters(plan.ndim)
    dn = ('NC' + sp, 'OI' + sp, 'NC' + sp)
    return _corr_blocked(Xp, W, dn, W.dtype, plan.lax_precision,
                         plan.transform_shape)


def corr_W(Xp: jnp.ndarray, H: jnp.ndarray, plan: ConvPlan) -> jnp.ndarray:
    """Single-stream prepared-domain W-gradient correlation:
    ``G[m,c,a] = sum_{n,t} Xp[n,c,a+t] * H[n,m,t]``.  The channel extent of
    ``Xp`` is free (it rides the conv's batch role)."""
    sp = _dim_letters(plan.ndim)
    # batch role <- channel axis, feature role <- sample axis (contracted)
    dn = ('CN' + sp, 'IO' + sp, 'NC' + sp)
    return jnp.swapaxes(_conv(Xp, H, dn, H.dtype, plan.lax_precision), 0, 1)


def grad_H_pair_prepared(Ap: jnp.ndarray, Bp: jnp.ndarray, W: jnp.ndarray,
                         plan: ConvPlan) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(neg, pos) H-gradient correlations of two already-prepared streams.
    They run as ONE convolution with the streams stacked along the batch
    axis: one bigger kernel launch instead of two half-occupancy ones."""
    G2 = corr_H(jnp.concatenate([Ap, Bp], axis=0), W, plan)
    n = Ap.shape[0]
    return G2[:n], G2[n:]


def grad_W_pair_prepared(Ap: jnp.ndarray, Bp: jnp.ndarray, H: jnp.ndarray,
                         plan: ConvPlan) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(neg, pos) W-gradient correlations of two already-prepared streams,
    stacked along the channel axis (the conv's batch role)."""
    G2 = corr_W(jnp.concatenate([Ap, Bp], axis=1), H, plan)
    c = Ap.shape[1]
    return G2[:, :c], G2[:, c:]


def grad_H_pair(Vp: jnp.ndarray, R: jnp.ndarray, W: jnp.ndarray, plan: ConvPlan) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(neg, pos) parts of dE/dH as one stacked correlation (reference role:
    ``NumPy_FFT.py:71-88``)."""
    return grad_H_pair_prepared(Vp, extend_data(R, plan), W, plan)


def grad_W_pair(Vp: jnp.ndarray, R: jnp.ndarray, H: jnp.ndarray, plan: ConvPlan) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(neg, pos) parts of dE/dW as one stacked huge-kernel correlation
    (reference role: ``NumPy_FFT.py:52-69``)."""
    return grad_W_pair_prepared(Vp, extend_data(R, plan), H, plan)
