"""Reconstruction-mode shape arithmetic for shift-invariant conv-NMF.

The factorization model approximates samples ``V[n, c, *sample_shape]`` with

    R = crop_mode( conv_full( extend_mode(H), W ) )

where ``W[m, c, *atom_shape]`` is the dictionary and ``H[n, m, *transform_shape]``
holds the per-atom activation maps.  The *reconstruction mode* determines how
activations near the sample boundary behave and therefore the size of the
shift ("transform") axes of ``H``:

    ==========  =======================  =========================================
    mode        transform_shape          boundary semantics
    ==========  =======================  =========================================
    'valid'     sample + atom - 1        atoms may hang off both sample edges
    'full'      sample - atom + 1        atoms must lie fully inside the sample
    'circular'  sample                   periodic wrap-around
    'reflect'   sample                   even reflection at the boundary
    ==========  =======================  =========================================

Shape semantics follow the reference implementation
(``/root/reference/tnmf/backends/_Backend.py:60-73``); the mode table mirrors
``/root/reference/tnmf/backends/_NumPyBackend.py:38-48``.  ``'same'`` is
accepted by the reference's shape helper but rejected by every backend, so it
is rejected here as well.

Everything in this module is host-side, trace-time shape planning: no jax
arrays are involved.  The :class:`ConvPlan` produced here is hashable and is
used as a static argument to the jitted kernels in
:mod:`tnmf_tpu.ops.fft` and :mod:`tnmf_tpu.ops.conv`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

SUPPORTED_MODES = ('valid', 'full', 'circular', 'reflect')


def transform_shape(mode: str, sample_shape: Tuple[int, ...], atom_shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """Shape of the shift axes of H for a given reconstruction mode."""
    if len(sample_shape) != len(atom_shape):
        raise ValueError(
            f'sample_shape {sample_shape} and atom_shape {atom_shape} must have the same rank')
    if mode == 'valid':
        return tuple(s + a - 1 for s, a in zip(sample_shape, atom_shape))
    if mode == 'full':
        if any(s - a + 1 <= 0 for s, a in zip(sample_shape, atom_shape)):
            raise ValueError(
                f'atom_shape {atom_shape} does not fit inside sample_shape {sample_shape} in "full" mode')
        return tuple(s - a + 1 for s, a in zip(sample_shape, atom_shape))
    if mode in ('circular', 'reflect'):
        return tuple(sample_shape)
    raise ValueError(
        f'Unsupported reconstruction mode "{mode}". '
        f'Please choose "valid", "full", "circular", or "reflect".')


def fast_fft_len(n: int, policy: str = '5-smooth') -> int:
    """Smallest FFT-friendly length >= n.

    ``'5-smooth'`` returns the smallest integer >= n whose prime factors are
    all in {2, 3, 5} (fast in pocketfft and cuFFT alike). ``'pow2'`` returns
    the next power of two.
    """
    if n <= 1:
        return 1
    if policy == 'pow2':
        return 1 << (n - 1).bit_length()
    if policy != '5-smooth':
        raise ValueError(f'unknown fft padding policy {policy!r}')
    best = 1 << (n - 1).bit_length()  # upper bound: next power of two
    p5 = 1
    while p5 <= best:
        p35 = p5
        while p35 <= best:
            x = p35
            while x < n:
                x *= 2
            if x < best:
                best = x
            p35 *= 3
        p5 *= 5
    return best


def fft_lengths(
    mode: str,
    sample_shape: Tuple[int, ...],
    atom_shape: Tuple[int, ...],
    policy: str = '5-smooth',
) -> Tuple[int, ...]:
    """Per-axis FFT length shared by the reconstruct / grad_H / grad_W plans.

    For ``'circular'`` mode the natural period is the sample length itself and
    no padding at all is required (cyclic convolution *is* the model), which
    is cheaper than the reference's pad-and-crop approach
    (``/root/reference/tnmf/backends/_NumPyFFTBackend.py:43``).

    For the linear modes the length must cover the full linear convolution /
    correlation support so that wrap-around never contaminates the cropped
    window. ``sample + transform - 1`` (the reference's choice) satisfies all
    three plans whenever ``sample >= atom``; taking the max with
    ``sample + 2*atom - 2`` also covers degenerate small-sample cases.
    """
    tshape = transform_shape(mode, sample_shape, atom_shape)
    if mode == 'circular':
        return tuple(sample_shape)
    out = []
    for s, a, t in zip(sample_shape, atom_shape, tshape):
        need = max(s + t - 1, s + 2 * a - 2)
        out.append(fast_fft_len(need, policy))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """Static description of one conv-NMF problem geometry.

    Hashable so that it can be passed as a static argument to ``jax.jit``.
    ``n_samples`` is deliberately *not* part of the plan: the kernels accept
    any leading batch size (jit re-specializes on array shapes), which is what
    makes minibatch slicing cheap.

    ``precision`` controls the multiply precision of convolutions and
    matmuls: None uses the backend default (on a GPU, float32 products in
    TF32 on the tensor cores: 10-bit mantissa, float32 accumulation —
    fastest), 'highest' forces full float32 products for workloads that
    need tighter float32 trajectories.
    """
    mode: str
    sample_shape: Tuple[int, ...]
    atom_shape: Tuple[int, ...]
    fft_shape: Tuple[int, ...]
    precision: str = None

    def __post_init__(self):
        if self.mode not in SUPPORTED_MODES:
            raise ValueError(
                f'Unsupported reconstruction mode "{self.mode}". '
                f'Please choose "valid", "full", "circular", or "reflect".')
        if self.precision not in (None, 'default', 'high', 'highest'):
            raise ValueError(
                f"precision must be None, 'default', 'high' or 'highest', "
                f'got {self.precision!r}')

    @classmethod
    def create(
        cls,
        mode: str,
        sample_shape: Tuple[int, ...],
        atom_shape: Tuple[int, ...],
        fft_policy: str = '5-smooth',
        precision: str = None,
    ) -> 'ConvPlan':
        sample_shape = tuple(int(s) for s in sample_shape)
        atom_shape = tuple(int(a) for a in atom_shape)
        # validates mode/shapes
        transform_shape(mode, sample_shape, atom_shape)
        return cls(
            mode=mode,
            sample_shape=sample_shape,
            atom_shape=atom_shape,
            fft_shape=fft_lengths(mode, sample_shape, atom_shape, fft_policy),
            precision=precision,
        )

    @property
    def lax_precision(self):
        if self.precision in (None, 'default'):
            return None
        from jax import lax
        return {'high': lax.Precision.HIGH, 'highest': lax.Precision.HIGHEST}[self.precision]

    @property
    def ndim(self) -> int:
        """Number of shift dimensions."""
        return len(self.atom_shape)

    @property
    def transform_shape(self) -> Tuple[int, ...]:
        return transform_shape(self.mode, self.sample_shape, self.atom_shape)

    @property
    def shift_axes(self) -> Tuple[int, ...]:
        """Axes of the shift dimensions in the canonical (B, F, *spatial) layout."""
        return tuple(range(2, 2 + self.ndim))

    @property
    def fft_size(self) -> int:
        return math.prod(self.fft_shape)
