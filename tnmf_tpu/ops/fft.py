"""FFT strategy for the conv-NMF operators (jnp.fft on XLA).

Replaces the reference's scipy-FFT convolution backends
(``/root/reference/tnmf/backends/NumPy_FFT.py``,
``NumPy_CachingFFT.py``) with a single functional, jit-compatible
implementation.  Two structural improvements over the reference:

1. **No flips.** The reference realizes correlations by flipping one operand
   and convolving (``NumPy_FFT.py:29``).  Here correlations use the
   cross-correlation theorem directly: ``corr = irfft(F(X) * conj(F(K)))``.
   With the mode-specific boundary extension applied to ``X`` *before* the
   transform, every gradient becomes a plain ``[0:size]`` crop — no
   ``np.flip``, no per-plan crop offsets
   (cf. the ``lower_idx`` arithmetic in ``_NumPyFFTBackend.py:49-88``).

2. **Native circular mode.** Cyclic convolution of period ``S`` *is* the
   'circular' reconstruction mode, so those FFTs run at exactly the sample
   length with no padding and no cropping at all.

The transform of the (extended) data tensor ``V`` is loop-invariant; the
engine computes it once per fit via :func:`prepare_data` and passes it to the
gradient kernels — this is the dataflow equivalent of the reference's
``CachingFFT`` machinery (``NumPy_CachingFFT.py:22-140``) without any cache
invalidation state.  Repeated subexpressions inside one jitted update step
(e.g. ``F(W)`` shared between reconstruction and grad_H) are deduplicated by
XLA common-subexpression elimination.

All functions are shape-polymorphic in the leading sample axis so that
minibatch slices re-use the same code.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from .modes import ConvPlan


def _rfftn(x: jnp.ndarray, plan: ConvPlan) -> jnp.ndarray:
    if jnp.dtype(x.dtype).itemsize < 4:
        x = x.astype(jnp.float32)  # FFT needs >= single precision
    return _leading_flat(
        lambda y: jnp.fft.rfftn(y, s=plan.fft_shape, axes=plan.shift_axes), x)


def _irfftn(x: jnp.ndarray, plan: ConvPlan) -> jnp.ndarray:
    return _leading_flat(
        lambda y: jnp.fft.irfftn(y, s=plan.fft_shape, axes=plan.shift_axes), x)


def _leading_flat(f, x: jnp.ndarray) -> jnp.ndarray:
    """``f`` applied with the two leading (batch, channel) axes merged into
    one.  The reshape pins the transform's operand to the default row-major
    layout: under a 'samples+atoms' mesh the partitioner otherwise hands
    XLA:CPU's FFT an operand whose layout it rejects (a RET_CHECK in its
    FFT thunk).  A row-major reshape is free where the layout already is."""
    lead = x.shape[:2]
    y = f(x.reshape((lead[0] * lead[1], 1) + x.shape[2:]))
    return y.reshape(lead + y.shape[2:])


def _crop(x: jnp.ndarray, start: Tuple[int, ...], size: Tuple[int, ...]) -> jnp.ndarray:
    idx = (Ellipsis,) + tuple(slice(o, o + s) for o, s in zip(start, size))
    return x[idx]


def _pad_spatial(x: jnp.ndarray, left: Tuple[int, ...], right: Tuple[int, ...], mode: str) -> jnp.ndarray:
    pad = [(0, 0)] * 2 + [(l, r) for l, r in zip(left, right)]
    if mode == 'zero':
        return jnp.pad(x, pad)
    return jnp.pad(x, pad, mode=mode)


def extend_data(X: jnp.ndarray, plan: ConvPlan) -> jnp.ndarray:
    """Mode-specific boundary extension of a data-space tensor (V or R).

    After this extension both gradient correlations read only non-negative
    lags, so their inverse transforms crop at ``[0 : size]`` uniformly.
    """
    am1 = tuple(a - 1 for a in plan.atom_shape)
    zero = (0,) * plan.ndim
    if plan.mode == 'valid':
        return _pad_spatial(X, am1, am1, 'zero')
    if plan.mode == 'full':
        return X
    if plan.mode == 'circular':
        return X  # periodicity comes from the exact-length FFT itself
    if plan.mode == 'reflect':
        return _pad_spatial(X, zero, am1, 'reflect')
    raise ValueError(plan.mode)


def prepare_data(V: jnp.ndarray, plan: ConvPlan) -> jnp.ndarray:
    """Fourier transform of the extended data tensor; loop-invariant per fit."""
    return _rfftn(extend_data(V, plan), plan)


def reconstruct(W: jnp.ndarray, H: jnp.ndarray, plan: ConvPlan) -> jnp.ndarray:
    """R[n,c,x] = sum_{m,a} W[m,c,a] * Hext[n,m,x+(A-1)-a]."""
    am1 = tuple(a - 1 for a in plan.atom_shape)
    if plan.mode == 'reflect':
        Hp = _pad_spatial(H, am1, (0,) * plan.ndim, 'reflect')
    else:
        # valid: H already spans S+A-1; full/circular: FFT zero-fill / cyclic
        # wrap realize the extension for free.
        Hp = H
    Hf = _rfftn(Hp, plan)
    Wf = _rfftn(W, plan)
    Rf = jnp.einsum('nm...,mc...->nc...', Hf, Wf, precision=plan.lax_precision)
    R = _irfftn(Rf, plan).astype(W.dtype)
    if plan.mode in ('valid', 'reflect'):
        return _crop(R, am1, plan.sample_shape)
    # full: conv_full(H, W) has exactly sample length; circular: exact period
    return _crop(R, (0,) * plan.ndim, plan.sample_shape)


def corr_H(Xf: jnp.ndarray, W: jnp.ndarray, plan: ConvPlan) -> jnp.ndarray:
    """Single-stream Fourier-domain H-gradient correlation:
    ``G[n,m,t] = sum_{c,a} Xext[n,c,t+a] W[m,c,a]`` from the transformed
    prepared tensor ``Xf``.  The batch extent is free; repeated calls with
    the same W share one ``rfftn(W)`` via XLA CSE."""
    Wf_c = jnp.conj(_rfftn(W, plan))
    Gf = jnp.einsum('nc...,mc...->nm...', Xf, Wf_c, precision=plan.lax_precision)
    return _crop(_irfftn(Gf, plan), (0,) * plan.ndim, plan.transform_shape)


def corr_W(Xf: jnp.ndarray, H: jnp.ndarray, plan: ConvPlan) -> jnp.ndarray:
    """Single-stream Fourier-domain W-gradient correlation, summed over
    samples and shifts; ``H`` arrives in data space."""
    Hf_c = jnp.conj(_rfftn(H, plan))
    Gf = jnp.einsum('nc...,nm...->mc...', Xf, Hf_c, precision=plan.lax_precision)
    return _crop(_irfftn(Gf, plan), (0,) * plan.ndim, plan.atom_shape)


def grad_H_pair_prepared(Af: jnp.ndarray, Bf: jnp.ndarray, W: jnp.ndarray,
                         plan: ConvPlan) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(neg, pos) H-gradient correlations of two already-transformed
    streams, batch-stacked into one contraction."""
    G2 = corr_H(jnp.concatenate([Af, Bf], axis=0), W, plan)
    n = Af.shape[0]
    return G2[:n], G2[n:]


def grad_W_pair_prepared(Af: jnp.ndarray, Bf: jnp.ndarray, H: jnp.ndarray,
                         plan: ConvPlan) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(neg, pos) W-gradient correlations of two already-transformed
    streams, channel-stacked into one contraction."""
    G2 = corr_W(jnp.concatenate([Af, Bf], axis=1), H, plan)
    c = Af.shape[1]
    return G2[:, :c], G2[:, c:]


def grad_H_pair(Vf: jnp.ndarray, R: jnp.ndarray, W: jnp.ndarray, plan: ConvPlan) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(neg, pos) parts of dE/dH: corr(Xext, W) summed over channels.

    ``Vf`` is the precomputed :func:`prepare_data` transform of V; ``R`` is
    the current data-space reconstruction.
    """
    Rf = _rfftn(extend_data(R, plan), plan)
    tshape = plan.transform_shape
    zero = (0,) * plan.ndim
    Wf_c = jnp.conj(_rfftn(W, plan))
    out = []
    for Xf in (Vf, Rf):
        Gf = jnp.einsum('nc...,mc...->nm...', Xf, Wf_c, precision=plan.lax_precision)
        out.append(_crop(_irfftn(Gf, plan), zero, tshape))
    return tuple(out)


def grad_W_pair(Vf: jnp.ndarray, R: jnp.ndarray, H: jnp.ndarray, plan: ConvPlan) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(neg, pos) parts of dE/dW: corr(Xext, H) summed over samples and shifts."""
    zero = (0,) * plan.ndim
    Hf_c = jnp.conj(_rfftn(H, plan))
    Rf = _rfftn(extend_data(R, plan), plan)
    out = []
    for Xf in (Vf, Rf):
        Gf = jnp.einsum('nc...,nm...->mc...', Xf, Hf_c, precision=plan.lax_precision)
        out.append(_crop(_irfftn(Gf, plan), zero, plan.atom_shape))
    return tuple(out)
