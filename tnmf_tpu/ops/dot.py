"""Plain-matmul lowering for the degenerate single-transform problem.

Applies when ``prod(plan.transform_shape) == 1`` — i.e. reconstruction
mode ``'full'`` with ``atom_shape == sample_shape``: shift invariance
degenerates to classic Lee–Seung NMF, ``V[n,c,*S] ~ sum_m H[n,m] *
W[m,c,*S]``.  Every operator then collapses to a single matmul over
the flattened ``(c, *S)`` feature axis — no convolution, no FFT, no
extension padding, no one-hot kernels.  The conv strategy handles this
case correctly but lowers it as a full-sample-sized convolution kernel;
the matmul formulation is the speed-of-light program for these shapes
(and is what sklearn's ``NMF(solver='mu')`` computes —
cross-checked in ``tests/test_dot_strategy.py``).

Same functional contract as :mod:`tnmf_tpu.ops.conv` /
:mod:`tnmf_tpu.ops.fft`: ``prepare_data`` / ``reconstruct`` /
``grad_H_pair`` / ``grad_W_pair``; H keeps its canonical
``(n, m, *transform_shape)`` layout (the shift axes are all length 1),
so regularizers, masks, beta losses and the transform-group adapter
compose unchanged.  Reference role: the degenerate corner of every
backend (``_Backend.py:60-73`` gives ``full`` -> sample - atom + 1 = 1).

Like the conv strategy, matmuls accumulate in float32 under bfloat16
storage and honor ``plan.lax_precision``.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from .modes import ConvPlan


def _dot(a, b, preferred, precision):
    # sub-float32 storage (bfloat16) still accumulates in float32
    if jnp.dtype(preferred).itemsize < 4:
        preferred = jnp.float32
    return jnp.matmul(a, b, precision=precision,
                      preferred_element_type=preferred)


def prepare_data(V: jnp.ndarray, plan: ConvPlan) -> jnp.ndarray:
    """Identity: the single-offset correlation needs no extension."""
    del plan
    return V


#: prepare_data is the identity, so beta-divergence factors trivially apply
#: to prepared tensors (engine._beta_factors); with beta = 1 the denominator
#: matmuls collapse to the classic KL-NMF row sums
FACTORS_IN_PREPARED = True


def reconstruct(W: jnp.ndarray, H: jnp.ndarray, plan: ConvPlan) -> jnp.ndarray:
    """R[n,c,*S] = sum_m H[n,m] * W[m,c,*S] — one (n,m)x(m,cF) matmul."""
    h = H.reshape(H.shape[:2])                      # (n, m)
    W2 = W.reshape(W.shape[0], -1)                  # (m, c*F)
    R = _dot(h, W2, W.dtype, plan.lax_precision)
    return R.reshape((H.shape[0],) + W.shape[1:]).astype(W.dtype)


def corr_H(Xp: jnp.ndarray, W: jnp.ndarray, plan: ConvPlan) -> jnp.ndarray:
    """Single-stream H-gradient matmul ``G[n,m] = sum_{cF} Xp[n,cF] W[m,cF]``."""
    G = _dot(Xp.reshape(Xp.shape[0], -1),
             W.reshape(W.shape[0], -1).T, W.dtype, plan.lax_precision)
    return G.astype(W.dtype).reshape(G.shape + (1,) * plan.ndim)


def corr_W(Xp: jnp.ndarray, H: jnp.ndarray, plan: ConvPlan) -> jnp.ndarray:
    """Single-stream W-gradient matmul ``G[m,c,*S] = sum_n H[n,m] Xp[n,c,*S]``."""
    h = H.reshape(H.shape[:2])                      # (n, m)
    G = _dot(h.T, Xp.reshape(Xp.shape[0], -1), H.dtype, plan.lax_precision)
    return G.astype(H.dtype).reshape((h.shape[1],) + Xp.shape[1:])


def grad_H_pair_prepared(Ap: jnp.ndarray, Bp: jnp.ndarray, W: jnp.ndarray,
                         plan: ConvPlan) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(neg, pos) H-gradient matmuls, batch-stacked (conv-strategy trick)."""
    n = Ap.shape[0]
    G2 = corr_H(jnp.concatenate([Ap, Bp], axis=0), W, plan)
    return G2[:n], G2[n:]


def grad_W_pair_prepared(Ap: jnp.ndarray, Bp: jnp.ndarray, H: jnp.ndarray,
                         plan: ConvPlan) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(neg, pos) W-gradient matmuls, channel-stacked."""
    c = Ap.shape[1]
    G2 = corr_W(jnp.concatenate([Ap, Bp], axis=1), H, plan)
    return G2[:, :c], G2[:, c:]


def grad_H_pair(Vp: jnp.ndarray, R: jnp.ndarray, W: jnp.ndarray,
                plan: ConvPlan) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(neg, pos) of dE/dH: X . W over (c, *S), V and R stacked along the
    batch axis into one matmul (same trick as the conv strategy)."""
    return grad_H_pair_prepared(Vp, R, W, plan)


def grad_W_pair(Vp: jnp.ndarray, R: jnp.ndarray, H: jnp.ndarray,
                plan: ConvPlan) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(neg, pos) of dE/dW: H^T . X over samples, V and R stacked along the
    channel axis into one matmul."""
    return grad_W_pair_prepared(Vp, R, H, plan)
