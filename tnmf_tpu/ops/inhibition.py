"""Lateral-inhibition regularizer support.

The inhibition gradient is a separable multi-1D convolution of the activation
tensor H with small symmetric kernels ``1 - (i/(r+1))**2`` along each shift
axis, zero-padded at the boundary.  Mirrors the semantics of the reference's
``convolve_multi_1d`` (``/root/reference/tnmf/backends/_NumPyBackend.py:56-64``,
kernel construction at ``TransformInvariantNMF.py:163``), implemented here as
blocked banded-matrix contractions (matmuls) that fuse into the
surrounding update step (see :func:`_band_convolve_1d`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import jax.numpy as jnp

def inhibition_kernels(inhibition_range: Tuple[int, ...], dtype=np.float64) -> Tuple[np.ndarray, ...]:
    """Per-axis 1-D kernels ``1 - (i/(r+1))**2`` for i in [-r, r].

    A range of 0 yields the single-tap kernel [1.], matching the reference.
    """
    return tuple(
        (1.0 - (np.arange(-r, r + 1, dtype=dtype) / (r + 1)) ** 2)
        for r in inhibition_range
    )


def resolve_inhibition_range(
    inhibition_range: Optional[Union[int, Tuple[int, ...]]],
    atom_shape: Tuple[int, ...],
) -> Tuple[int, ...]:
    """Default: minimal range covering the atom size (reference
    ``TransformInvariantNMF.py:154-160``)."""
    if inhibition_range is None:
        return tuple(a - 1 for a in atom_shape)
    if isinstance(inhibition_range, int):
        return (inhibition_range,) * len(atom_shape)
    rng = tuple(int(r) for r in inhibition_range)
    if len(rng) != len(atom_shape):
        raise ValueError('inhibition_range must have one entry per atom axis')
    return rng


# block length for the blocked-banded contraction: long axes are cut into
# _BLOCK-sized windows with 2r halos so the band-matrix FLOP inflation stays
# at (_BLOCK + 2r)/taps instead of axis_len/taps
_BLOCK = 256

# below this tensor size the constant costs of the banded-matmul path (band
# build + GEMM dispatch) exceed its bandwidth win and the plain
# single-channel conv is faster (measured 2x at the 1-D fixture scale);
# above it the banded path wins up to 10x (see convolve_multi_1d)
_BAND_MIN_ELEMS = 1 << 14


def _band_matrix(kernel: jnp.ndarray, n_out: int, n_in: int, shift: int) -> jnp.ndarray:
    """Banded matrix ``B[x, u] = kernel[u - x - shift]`` (zero off the band).

    ``g = B @ window`` realizes the zero-padded 1-D correlation: boundary
    zeros are encoded by the band simply running off the matrix edge.

    Built gather-free (one fused masked-add per tap): the construction sits
    inside the jitted fit loop, where XLA does not hoist it out of the
    ``while``-loop body, where a ``kernel[indices]`` gather would be paid
    every iteration.
    """
    x = jnp.arange(n_out)[:, None]
    u = jnp.arange(n_in)[None, :]
    t = u - x - shift
    taps = int(kernel.shape[0])
    if taps <= 128:
        B = jnp.zeros((n_out, n_in), kernel.dtype)
        for i in range(taps):
            B = B + jnp.where(t == i, kernel[i], 0)
        return B
    inside = (t >= 0) & (t < taps)
    return jnp.where(inside, kernel[jnp.clip(t, 0, taps - 1)], 0)


_LETTERS = 'abcdefghijklm'
_OUT_LETTERS = 'nopqrstuvwxyz'


def _conv_1d_small(arr: jnp.ndarray, k: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Zero-padded 1-D convolution as a single-channel ``lax.conv`` — the
    small-tensor path (constant cost beats the band build + GEMM there)."""
    from jax import lax
    r = (k.shape[0] - 1) // 2
    moved = jnp.moveaxis(arr, axis, -1)
    lead_shape = moved.shape[:-1]
    flat = moved.reshape((-1, 1, moved.shape[-1]))
    res = lax.conv_general_dilated(
        flat, k.reshape((1, 1, -1)),
        window_strides=(1,),
        padding=[(r, r)],
        dimension_numbers=('NCH', 'OIH', 'NCH'),
        preferred_element_type=arr.dtype,
    )
    return jnp.moveaxis(res.reshape(lead_shape + (res.shape[-1],)), -1, axis)


def _band_convolve_blocked(arr: jnp.ndarray, kernel: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Zero-padded 1-D convolution along a *long* axis: windows of ``_BLOCK``
    outputs read ``_BLOCK + 2r`` inputs, so the band-matrix FLOP inflation
    stays at (block + 2r)/taps instead of axis_len/taps."""
    L = arr.shape[axis]
    k = kernel
    r = (k.shape[0] - 1) // 2
    nb = -(-L // _BLOCK)
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (r, nb * _BLOCK - L + r)
    arrp = jnp.pad(arr, pad)
    win = _BLOCK + 2 * r
    sl = [slice(None)] * arr.ndim
    blocks = []
    for i in range(nb):
        sl[axis] = slice(i * _BLOCK, i * _BLOCK + win)
        blocks.append(arrp[tuple(sl)])
    # stacked windows: (..., nb, win) on the two trailing axes
    stack = jnp.stack([jnp.moveaxis(b, axis, -1) for b in blocks], axis=-2)
    B = _band_matrix(k, _BLOCK, win, 0)  # out x reads window u = x + t
    out = jnp.einsum('...bu,xu->...bx', stack, B)
    out = out.reshape(out.shape[:-2] + (nb * _BLOCK,))
    sl = [slice(None)] * arr.ndim
    sl[-1] = slice(0, L)
    return jnp.moveaxis(out[tuple(sl)], -1, axis)


def convolve_multi_1d(
    arr: jnp.ndarray,
    kernels: Sequence[jnp.ndarray],
    axes: Sequence[int],
) -> jnp.ndarray:
    """Sequential zero-padded 1-D convolutions along ``axes``.

    The kernels here are symmetric so convolution equals correlation; the
    separable convolution runs as banded-matrix contractions.

    Rationale: a single-channel ``lax.conv`` along a non-minor axis forces a
    relayout of the whole tensor.  Contracting against small banded
    matrices (``B[x, u] = kernel[u - x + r]``; boundary zeros are encoded by
    the band running off the matrix edge) costs a FLOP inflation of only
    (axis_len + 2r)/taps — capped by windowing for long axes
    (:func:`_band_convolve_blocked`) — with no transposes, and all short
    axes fold into ONE einsum so XLA owns the contraction order and layouts
    end to end.
    """
    assert len(kernels) == len(axes)
    out = arr
    # under jax.export shape polymorphism (tnmf_tpu.serving) the batch
    # dimension is symbolic and the total size is inconclusive; the banded
    # path is the scalable choice for any batch the artifact will serve
    if isinstance(out.size, int) and out.size < _BAND_MIN_ELEMS:
        for axis, kernel in zip(axes, kernels):
            out = _conv_1d_small(out, jnp.asarray(kernel, out.dtype), axis % out.ndim)
        return out
    # long axes first, one at a time (windowed); short axes collected
    fused = []
    for axis, kernel in zip(axes, kernels):
        axis = axis % out.ndim
        k = jnp.asarray(kernel, dtype=out.dtype)
        r = (k.shape[0] - 1) // 2
        if out.shape[axis] > _BLOCK + 2 * r:
            out = _band_convolve_blocked(out, k, axis)
        else:
            fused.append((axis, k, r))
    if not fused:
        return out
    # all short axes in one einsum: '<in>,xu,yv,...-><out>'
    in_sub = list(_LETTERS[:out.ndim])
    out_sub = list(in_sub)
    operands = []
    for i, (axis, k, r) in enumerate(fused):
        L = out.shape[axis]
        in_sub[axis] = _LETTERS[out.ndim + i]
        out_sub[axis] = _OUT_LETTERS[i]
        operands.append(_band_matrix(k, L, L, -r))
    spec = ''.join(in_sub) + ',' + ','.join(
        _OUT_LETTERS[i] + _LETTERS[out.ndim + i] for i in range(len(fused))
    ) + '->' + ''.join(out_sub)
    return jnp.einsum(spec, out, *operands)


def inhibition_positive_term(
    H: jnp.ndarray,
    kernels: Sequence[jnp.ndarray],
    n_shift_axes: int,
    inhibition: jnp.ndarray,
    cross_inhibition: jnp.ndarray,
    n_atoms: int,
    with_same_atom: bool,
    with_cross_atom: bool,
) -> jnp.ndarray:
    """Additional positive-gradient term for the H update.

    Mirrors ``TransformInvariantNMF.py:252-269``: the same-atom term subtracts
    H itself (an atom must not suppress its own activation), the cross-atom
    term broadcasts the atom-summed inhibition minus the own-atom
    contribution, scaled by 1/(n_atoms-1).
    """
    axes = tuple(range(-n_shift_axes, 0))
    g = convolve_multi_1d(H, kernels, axes)
    term = jnp.zeros_like(H)
    if with_same_atom:
        term = term + inhibition * (g - H)
    if with_cross_atom:
        cross = g.sum(axis=1, keepdims=True) - g
        term = term + (cross_inhibition / (n_atoms - 1)) * cross
    return term
