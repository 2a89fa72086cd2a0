"""Jit-compiled execution engine for the multiplicative-update algorithm.

This module owns every jitted function of the framework.  The algorithm layer
(:mod:`tnmf_tpu.models.tnmf`) is a thin stateful wrapper that calls into
these pure functions, mirroring the algorithm/backend split of the reference
(``/root/reference/tnmf/TransformInvariantNMF.py`` vs ``tnmf/backends/``) —
except that the five interchangeable CPU backends collapse into four XLA
strategies ('fft', 'conv', the 'phased' lowering, and the plain-NMF
'dot' matmul lowering — the latter two auto-selected by
:func:`resolve_strategy`) behind one functional interface.

Design notes:

* The whole MU iteration is one jitted graph: XLA fuses the elementwise
  ratio update into the gradient contractions and deduplicates shared
  subexpressions (e.g. ``F(W)`` between reconstruction and grad_H), which
  subsumes the reference's ``NumPy_CachingFFT`` cache machinery.
* The transform/extension of V is loop-invariant and computed once per fit
  (:func:`prepare_data`).
* The no-callback fit path runs the full iteration loop on device inside a
  single ``lax.fori_loop`` with donated W/H buffers — zero host round-trips
  per iteration.  With a Python ``progress_callback`` the same step function
  is dispatched iteration-by-iteration, so both paths produce identical
  trajectories (reference callback contract:
  ``TransformInvariantNMF.py:318-324``).
* Scalars (sparsity, inhibition strengths, sag_lambda) are traced values, so
  changing them does not retrigger compilation; graph *structure* (mode,
  strategy, which regularizers are active, update_H/update_W) is static.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from .ops import beta as beta_ops
from .ops import conv as conv_ops
from .ops import fft as fft_ops
from .ops.inhibition import inhibition_positive_term
from .ops.modes import ConvPlan

EPS = 1.0e-9  # reference: TransformInvariantNMF.py:166


def get_ops(strategy):
    """The operator module ('fft', 'conv' or 'phased') implementing the
    backend contract: prepare_data / reconstruct / grad_H_pair /
    grad_W_pair.

    A tuple ``(base_strategy, TransformGroup)`` selects the transform-group
    adapter (:mod:`tnmf_tpu.ops.transforms`): the base operators run on the
    expanded tied dictionary and the W statistics are pulled back onto the
    canonical atoms.  The tuple is hashable, so it rides through every
    static ``strategy`` jit argument unchanged.
    """
    if isinstance(strategy, tuple):
        base, group = strategy
        from .ops.transforms import GroupOps
        return GroupOps(get_ops(base), group)
    if strategy == 'fft':
        return fft_ops
    if strategy == 'conv':
        return conv_ops
    if strategy == 'phased':
        from .ops import phased
        return phased
    if strategy == 'dot':
        from .ops import dot
        return dot
    raise ValueError(
        f'unknown strategy {strategy!r}; choose "fft", "conv", "phased" '
        f'or "dot"')


def _enc_h(H, plan: ConvPlan, strategy):
    """Canonical H -> the strategy's loop-carried representation (the
    phase-blocked layout for 'phased', identity otherwise).  For a
    transform-group tuple the base strategy decides the layout."""
    base = strategy[0] if isinstance(strategy, tuple) else strategy
    if base == 'phased':
        from .ops import phased
        return phased.encode_h(H, plan)
    return H


def _dec_h(H, plan: ConvPlan, strategy, n_atoms: int):
    """Inverse of :func:`_enc_h`.  ``n_atoms`` is the *canonical* atom
    count (W.shape[0]); under a transform group H carries one channel per
    (atom, transform) pair."""
    if isinstance(strategy, tuple):
        base, group = strategy
        if base != 'phased':
            return H
        from .ops import phased
        return phased.decode_h(H, plan, n_atoms * group.size)
    if strategy == 'phased':
        from .ops import phased
        return phased.decode_h(H, plan, n_atoms)
    return H


def _phased_device() -> bool:
    """The device half of the lowering policy: whether this backend runs
    channel-poor convolutions through the phase-decomposed lowering.

    True on a GPU.  Measured on an NVIDIA H100 80GB HBM3 (400 W power
    limit) through ``fit_loop`` (``benchmarks/lowering.py``): at the
    flagship 64x1x256x256 / 16 atoms 9x9 the phased iteration takes
    2.41 ms (f32) / 1.92 ms (bf16) against plain conv's 5.21 / 5.39 ms,
    and at 16x1 samples of 64^2, 128^2 and 256^2 with 7x7-15x15 atoms it
    beat both conv and fft at every geometry where it applies.  Off that
    family (f32, phased / conv ms, H100 80GB HBM3 at 700 W): 1-D
    16x4096 atom 9 0.147 / 0.141 and 16x16000 0.163 / 0.232; 3-D 8x64^3
    atoms 5^3 1.29 / 7.92 and 3^3 0.96 / 1.81; 3 channels at 64x256^2
    2.52 / 7.73; 8 channels at 16x128^2 0.41 / 0.84; 128 maps at the
    flagship 15.9 / 23.1.  At 16x64^2 with 15x15 atoms and 128 maps plain
    conv wins (1.64 / 1.15; fft 2.60): the gate does not weigh the map
    count.  The CPU
    keeps plain conv, so the float64 golden trajectories stay on it; tests
    patch this hook to run the phased lowering there."""
    return jax.devices()[0].platform == 'gpu'


def prefers_phased(plan: ConvPlan, n_atoms: int, n_channels: int) -> bool:
    """The lowering policy: whether 'conv' is lowered as 'phased' for this
    geometry on this device (:func:`_phased_device` and the geometry gate
    :func:`tnmf_tpu.ops.phased.applicable`)."""
    if not _phased_device():
        return False
    from .ops import phased
    return phased.applicable(plan, n_channels=n_channels, n_atoms=n_atoms)


def resolve_strategy(strategy: str, plan: ConvPlan, n_atoms: int,
                     n_channels: int, allow_phased: bool = True,
                     allow_dot: bool = True) -> str:
    """The lowering that runs for a requested ``strategy``.

    'auto' first takes :func:`choose_strategy`'s conv/fft threshold.  Then
    a specialized lowering replaces the plain one where it wins:

    * 'dot' (:mod:`tnmf_tpu.ops.dot`): the degenerate single-transform
      problem (mode 'full' with atom_shape == sample_shape) is plain NMF —
      pure matmuls beat any conv/fft lowering on every platform.  Replaces
      'conv'.  Gated by ``allow_dot`` (off for spatial meshes, whose
      layouts assume the canonical grid).
    * 'phased' (:mod:`tnmf_tpu.ops.phased`): re-lowers the MU iteration
      with phase-multiplied channel counts where :func:`prefers_phased`
      says so for ``n_atoms`` activation maps (atoms times transforms);
      trajectories match the plain conv strategy to float roundoff
      (tests/test_phased.py).  Replaces 'conv', and under 'auto' also
      'fft': phased beat fft at every geometry timed on the card where it
      applies (e.g. 64^2 samples, 15x15 atoms: phased 0.32 ms, fft 0.41,
      conv 0.51; see :func:`_phased_device`).  Gated by ``allow_phased``.

    Any other explicit strategy is kept as requested.
    """
    auto = strategy == 'auto'
    if auto:
        strategy = choose_strategy(plan)
    if strategy == 'conv' and allow_dot and math.prod(plan.transform_shape) == 1:
        return 'dot'
    if (strategy == 'conv' or (auto and strategy == 'fft')) and allow_phased \
            and prefers_phased(plan, n_atoms, n_channels):
        return 'phased'
    return strategy


def choose_strategy(plan: ConvPlan) -> str:
    """The conv/fft threshold behind ``strategy='auto'``
    (:func:`resolve_strategy` then applies the specialized lowerings).

    Direct convolution avoids FFT padding and wins for small atoms; the
    FFT path takes over once the per-output-point direct cost
    (~prod(atom)) outgrows the FFT's roughly atom-independent per-point
    cost.  Swept on an NVIDIA H100 80GB HBM3 (400 W) with
    ``benchmarks/lowering.py`` (16 x 1 samples, 16 atoms, mode 'valid',
    ms per MU iteration, conv / fft):

    * 64^2:  9x9 0.29 / 0.46, 15x15 0.51 / 0.41, 21x21 0.89 / 0.51
    * 128^2: 9x9 0.52 / 1.72, 15x15 1.82 / 1.68, 21x21 3.35 / 2.09
    * 256^2: 15x15 6.76 / 7.63, 21x21 12.45 / 7.66, 33x33 41.07 / 9.41

    so the crossover lies between 81 and 225 atom elements up to 128^2
    and between 225 and 441 at 256^2: ``max(128, prod(sample) / 256)``.
    """
    if math.prod(plan.transform_shape) == 1:
        # degenerate plain NMF (any rank — matmuls have no conv rank cap);
        # resolve_strategy lowers this to 'dot'.  With the dot gate off
        # (spatial mesh) conv is the correct rank<=3 fallback and raises
        # its clear NotImplementedError above rank 3.
        return 'conv'
    if plan.ndim > 3:
        return 'fft'  # lax conv supports at most 3 spatial dims here
    atom_elems = math.prod(plan.atom_shape)
    threshold = max(128, math.prod(plan.sample_shape) // 256)
    return 'conv' if atom_elems <= threshold else 'fft'


# ---------------------------------------------------------------------------
# jitted kernels
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=('w_shape', 'h_shape', 'n_shift_axes', 'dtype', 'init_W',
                                   'h_sharding', 'w_sharding'))
def init_matrices(key, *, w_shape, h_shape, n_shift_axes: int, dtype, init_W: bool = True,
                  h_sharding=None, w_sharding=None):
    """Device-side W/H initialization: ``1 - U[0, 1)`` with sum-normalized W,
    matching the reference's distribution (``_Backend.py:83-98``) but drawn
    from a JAX PRNG key entirely on device.

    This is the at-scale path: with ``h_sharding`` (a ``NamedSharding``,
    hashable and therefore static) H is constrained to its sharded layout
    *inside* the compiled program, so it is materialized directly across the
    mesh and never exists unsharded on any single device.
    """
    kw, kh = jax.random.split(key)
    H = 1.0 - jax.random.uniform(kh, h_shape, dtype=dtype)
    if h_sharding is not None:
        H = jax.lax.with_sharding_constraint(H, h_sharding)
    if init_W:
        W = 1.0 - jax.random.uniform(kw, w_shape, dtype=dtype)
        W = W / jnp.sum(W, axis=tuple(range(-n_shift_axes, 0)), keepdims=True)
        if w_sharding is not None:
            W = jax.lax.with_sharding_constraint(W, w_sharding)
    else:
        W = None
    return W, H

@partial(jax.jit, static_argnames=('plan', 'strategy'))
def prepare_data(V, *, plan: ConvPlan, strategy: str):
    """Loop-invariant preprocessing of the data tensor (FFT or extension)."""
    return get_ops(strategy).prepare_data(V, plan)


@partial(jax.jit, static_argnames=('plan', 'strategy'))
def reconstruct(W, H, *, plan: ConvPlan, strategy: str):
    return get_ops(strategy).reconstruct(W, _enc_h(H, plan, strategy), plan)


@partial(jax.jit, static_argnames=('plan', 'strategy', 'i_atom'))
def partial_reconstruct(W, H, *, plan: ConvPlan, strategy: str, i_atom: int):
    """Reconstruction restricted to one atom (reference ``_Backend.py:124``).
    Under a transform group the slice covers the canonical atom together
    with all of its tied transformed copies (H is laid out m-major)."""
    g = strategy[1].size if isinstance(strategy, tuple) else 1
    return get_ops(strategy).reconstruct(
        W[i_atom:i_atom + 1],
        _enc_h(H[:, i_atom * g:(i_atom + 1) * g], plan, strategy), plan)


@partial(jax.jit, static_argnames=('plan', 'strategy', 'beta'))
def energy(V, W, H, mask=None, *, plan: ConvPlan, strategy: str,
           beta: float = 2.0):
    """Reconstruction objective: ``0.5 * sum((V - R)^2)`` for the default
    Euclidean loss (reference ``_Backend.py:127-130``), the beta-divergence
    ``D_beta(V || R)`` otherwise (:mod:`tnmf_tpu.ops.beta`); with ``mask``,
    the per-entry weighted objective."""
    R = get_ops(strategy).reconstruct(W, _enc_h(H, plan, strategy), plan)
    acc = jnp.promote_types(V.dtype, jnp.float32)  # f32 accumulation for bf16
    return beta_ops.divergence(V, R, beta, mask).astype(acc)


@partial(jax.jit, static_argnames=('plan', 'strategy', 'n_atoms'))
def correlate_init_H(Vp, Vd, W, *, plan: ConvPlan, strategy, n_atoms: int):
    """Matched-filter activation init: ``H0 = c * (V star W)`` — the
    correlation of the (prepared) data with every atom, scaled by the
    least-squares-optimal coefficient along that direction,
    ``c = <V, R0> / <R0, R0>`` with ``R0 = reconstruct(W, V star W)``.

    Deterministic and computed entirely on device (sharded inputs yield
    sharded H).  A 1% relative floor keeps every entry strictly positive —
    zero is absorbing under multiplicative updates.  Returns H in the
    canonical layout.  No reference counterpart (the reference only draws
    H uniformly, ``_Backend.py:83-98``); the matched-filter start is the
    classic sparse-coding warm start — it reaches a given energy in fewer
    iterations than the uniform draw (substantially fewer on structured
    data, tests/test_h_init.py; ~10% on unstructured noise), and its real
    serving value is determinism plus the absence of any H-sized host
    draw/upload per ``transform`` call.
    """
    ops = get_ops(strategy)
    neg, _ = ops.grad_H_pair(Vp, jnp.zeros_like(Vd), W, plan)
    # conv/fft return f32 gradients under bf16 storage; the scale
    # reconstruction needs matching operand dtypes (bug surfaced by the
    # bf16 serving export: bf16 + conv + h_init='correlate' crashed)
    R0 = ops.reconstruct(W, neg.astype(W.dtype), plan)
    acc = jnp.promote_types(Vd.dtype, jnp.float32)
    num = jnp.sum(Vd.astype(acc) * R0.astype(acc))
    den = jnp.maximum(jnp.sum(R0.astype(acc) ** 2),
                      jnp.asarray(jnp.finfo(acc).tiny, acc))
    H0 = (num / den).astype(neg.dtype) * neg
    H0 = _dec_h(H0, plan, strategy, n_atoms)
    floor = 0.01 * jnp.mean(H0)
    return jnp.maximum(H0, floor).astype(W.dtype)


def _beta_grad_pair(ops, grad_pair, Vc, R, other, plan, beta, mask=None):
    """Generic (fallback) beta-divergence gradient pair: the strategy's
    Euclidean pair operator applied to ``A = V * R**(beta-2)`` (in the
    prepared-V slot) and ``B = R**(beta-1)`` (in the R slot).  ``Vc`` is
    the *canonical* data tensor — the loop-invariant ``prepare_data``
    transform moves inside the iteration because its input depends on R.
    A ``mask`` (missing-data / per-entry weights) multiplies both factors:
    the masked objective's gradients are the unmasked ones with every
    V-shaped stream weighted.  Only the masked path still routes here;
    unmasked beta fits use :func:`_beta_grad_H` / :func:`_beta_grad_W`."""
    A, B = beta_ops.factors(Vc, R, beta)
    if mask is not None:
        A = A * mask.astype(A.dtype)
        B = B * mask.astype(B.dtype)
    return grad_pair(ops.prepare_data(A, plan), B, other, plan)


def beta_prepares_data(strategy) -> bool:
    """Whether a ``beta != 2`` fit should pass ``prepare_data(V)`` (instead
    of the canonical V) in the engine's prepared-data slot: true for the
    strategies whose prepared domain is an entrywise replication/zero-fill
    of the canonical domain (conv / phased / dot and their transform-group
    adapters), where the beta factors are computed directly on prepared
    tensors and the per-iteration re-preparation of a V-shaped stream
    disappears.  Callers with a mask keep the canonical layout regardless
    (the factors are mask-weighted canonically)."""
    return bool(getattr(get_ops(strategy), 'FACTORS_IN_PREPARED', False))


def _beta_factors(ops, Vp, R, plan, beta, n_channels):
    """``(A_prep, B_prep)`` of the beta-divergence MU factors in the
    strategy's prepared domain; ``B_prep`` is None for beta = 1 (B = 1 —
    the denominators collapse to correlations of the boundary-extension
    pattern, see :func:`_beta_grad_H`).

    For ``FACTORS_IN_PREPARED`` strategies, ``Vp`` is the loop-invariant
    prepared data and the factors are elementwise ops on prepared tensors:
    valid because the mode extension replicates/zero-fills entries, so it
    commutes with any elementwise function that maps 0 to 0 — ``A`` rides
    on ``Vp`` (zero padding stays zero), and ``B``'s padding is re-zeroed
    by the extension-pattern mask.  Otherwise (fft: the prepared domain is
    spectral) ``Vp`` is the canonical data, factors are computed canonically
    and re-prepared per iteration (the transform of an R-dependent tensor
    is inherently loop-variant, like the reference's CachingFFT re-transform
    of H, ``NumPy_CachingFFT.py:222-249``)."""
    if getattr(ops, 'FACTORS_IN_PREPARED', False):
        Rp = ops.prepare_data(R, plan)
        acc = jnp.promote_types(Rp.dtype, jnp.float32)
        Rs = jnp.maximum(Rp.astype(acc), beta_ops.EPS_R)
        Vc = Vp.astype(acc)
        if beta == 1.0:
            return (Vc / Rs).astype(R.dtype), None
        ones = _ones_prepared(ops, plan, n_channels, R.dtype).astype(acc)
        if beta == 0.0:
            A = Vc / (Rs * Rs)
            B = ones / Rs
        else:
            A = Vc * Rs ** (beta - 2.0)
            B = ones * Rs ** (beta - 1.0)
        return A.astype(R.dtype), B.astype(R.dtype)
    A, B = beta_ops.factors(Vp, R, beta)
    Ap = ops.prepare_data(A, plan)
    Bp = None if beta == 1.0 else ops.prepare_data(B, plan)
    return Ap, Bp


def _ones_prepared(ops, plan, n_channels, dtype):
    """``prepare_data`` of an all-ones ``(1, n_channels, *sample)`` tensor —
    the mode boundary-extension pattern (1 over the extended data domain, 0
    in 'valid' zero padding / phased absorbing padding).  A jit constant:
    XLA constant-folds it and hoists it out of the fit loop."""
    return ops.prepare_data(
        jnp.ones((1, n_channels) + plan.sample_shape, dtype), plan)


def _beta_grad_H(ops, Vp, R, W, plan, beta, mask=None):
    """(neg, pos) of the beta-divergence H gradient.

    The masked path keeps the generic canonical formulation (factors are
    mask-weighted before preparation).  Unmasked, ``neg = corr(A, W)`` runs
    on prepared factors and — the beta = 1 specialization — ``pos =
    corr(extension_pattern, W)`` runs with batch extent 1 (B = 1 is
    sample-independent), shrinking the denominator correlation by the full
    batch factor.  Serizel/Essid/Richard 2016's beta-MU rules, cited but
    not implemented by the reference (``TransformInvariantNMF.py:136-139``)."""
    if mask is not None:
        return _beta_grad_pair(ops, ops.grad_H_pair, Vp, R, W, plan, beta,
                               mask)
    A, B = _beta_factors(ops, Vp, R, plan, beta, W.shape[1])
    if B is None:  # beta == 1: B = 1, one batch-1 denominator correlation
        ones = _ones_prepared(ops, plan, W.shape[1], R.dtype)
        return ops.corr_H(A, W, plan), ops.corr_H(ones, W, plan)
    return ops.grad_H_pair_prepared(A, B, W, plan)


def _beta_grad_W(ops, Vp, R, H, plan, beta, mask=None, n_channels=None):
    """(neg, pos) of the beta-divergence W gradient.  For beta = 1 the
    denominator ``corr(1, H)`` is sample-independent, so H is pre-summed
    over the batch and the correlation runs with batch/channel extents 1
    (under a data-parallel mesh the pre-sum is the same psum the Euclidean
    W statistics pay)."""
    if mask is not None:
        return _beta_grad_pair(ops, ops.grad_W_pair, Vp, R, H, plan, beta,
                               mask)
    if n_channels is None:
        n_channels = R.shape[1]
    A, B = _beta_factors(ops, Vp, R, plan, beta, n_channels)
    if B is None:  # beta == 1
        ones = _ones_prepared(ops, plan, 1, R.dtype)
        Hs = jnp.sum(H, axis=0, keepdims=True)
        return ops.corr_W(A, H, plan), ops.corr_W(ones, Hs, plan)
    return ops.grad_W_pair_prepared(A, B, H, plan)


def _mu_H(ops, Vp, W, H, sparsity, inhibition, cross_inhibition, kernels, *,
          plan, use_inhibition, use_cross, beta=2.0, mask=None, l2=None):
    """One multiplicative H update (reference ``_update_H``,
    ``TransformInvariantNMF.py:246-271``).  ``H`` is in the strategy's
    loop-carried representation (phase-blocked for 'phased').  For
    ``beta != 2``, ``Vp`` carries the canonical (unprepared) data tensor.

    ``l2`` (None = absent) adds a ridge penalty (lambda/2)*||H||_2^2 to the
    objective: its gradient ``l2 * H`` is nonnegative, so it joins the
    positive MU part — sklearn's ``alpha_H``/``l1_ratio`` L2 term (no
    reference counterpart).  Layout-safe for the phased carry: the term is
    elementwise in H and the absorbing zero padding stays zero.

    With ``mask`` (beta = 2) ``Vp`` arrives pre-masked (``prepare(mask*V)``,
    loop-invariant) and R is masked here — the exact MU rule for the
    masked/weighted Euclidean objective, since both gradient halves are
    correlations of V-shaped streams."""
    if (beta == 2.0 and mask is None
            and getattr(ops, 'grad_H_pair_fused', None) is not None
            and ops.fused_rec_supported(plan, H.dtype)):
        # phased fast path: the reconstruction's raw blocked output feeds
        # the positive gradient conv directly (ops.phased round-5 notes) —
        # the R stream is written once and read once, nothing else
        neg, pos = ops.grad_H_pair_fused(Vp, W, H, plan)
        if use_inhibition or use_cross:
            pos = pos + ops.inhibition_positive_term_phased(
                H.astype(pos.dtype), kernels, plan, W.shape[0],
                inhibition, cross_inhibition,
                with_same_atom=use_inhibition, with_cross_atom=use_cross)
        if l2 is not None:
            pos = pos + jnp.asarray(l2, pos.dtype) * H.astype(pos.dtype)
        return (H * neg / (pos + (EPS + sparsity))).astype(H.dtype)
    R = ops.reconstruct(W, H, plan)
    if beta == 2.0:
        Rm = R if mask is None else R * mask.astype(R.dtype)
        neg, pos = ops.grad_H_pair(Vp, Rm, W, plan)
    else:
        neg, pos = _beta_grad_H(ops, Vp, R, W, plan, beta, mask)
    if use_inhibition or use_cross:
        if getattr(ops, 'encode_h', None) is not None:
            # banded inhibition contraction directly in the phased layout —
            # no decode/encode transposes (ops.phased docstring)
            pos = pos + ops.inhibition_positive_term_phased(
                H.astype(pos.dtype), kernels, plan, W.shape[0],
                inhibition, cross_inhibition,
                with_same_atom=use_inhibition, with_cross_atom=use_cross)
        else:
            pos = pos + inhibition_positive_term(
                H, kernels, plan.ndim, inhibition, cross_inhibition,
                n_atoms=H.shape[1],
                with_same_atom=use_inhibition, with_cross_atom=use_cross)
    if l2 is not None:
        pos = pos + jnp.asarray(l2, pos.dtype) * H.astype(pos.dtype)
    # fft/conv: neg/pos are float32 under bfloat16 storage and the ratio is
    # formed in the accumulation dtype.  phased: the gradient pair is kept
    # in the storage dtype on purpose (keep_low — halving the dominant HBM
    # stream; the MU ratio is robust to bf16 statistics,
    # tests/test_bfloat16.py).
    return (H * neg / (pos + (EPS + sparsity))).astype(H.dtype)


def _normalize_W(W, n_shift_axes):
    """Sum-normalize atoms; bit-identical to plain division for nonzero
    sums, but returns zero atoms (not NaN) when an atom collapses to zero
    (e.g. all-zero data) — a deliberate robustness improvement over the
    reference's ``arr /= arr.sum()`` (``_Backend.py:75-77``)."""
    s = jnp.sum(W, axis=tuple(range(-n_shift_axes, 0)), keepdims=True)
    return W / jnp.where(s == 0, 1, s)


def _ortho_positive_term(W, ortho):
    """Gradient of the cross-atom orthogonality (dictionary diversity)
    penalty (lambda/2) * sum_{m != m'} <W_m, W_m'> (per channel, elementwise
    overlap): d/dW_m = lambda * sum_{m' != m} W_m' — nonnegative, so it
    joins the positive MU part (Choi 2008 orthogonal-NMF style; no
    reference counterpart).  Penalizes duplicate atoms directly: entries
    where other atoms carry mass are multiplicatively shrunk."""
    others = jnp.sum(W, axis=0, keepdims=True) - W
    return jnp.asarray(ortho, others.dtype) * others


def _mu_W(ops, Vp, W, H, *, plan, beta=2.0, mask=None, ortho=None):
    """One multiplicative W update with atom-wise sum normalization
    (reference ``_update_W`` + ``normalize``, ``TransformInvariantNMF.py:240-244``).

    ``ortho`` (None = absent) adds the cross-atom orthogonality penalty's
    gradient to the positive part (:func:`_ortho_positive_term`)."""
    if (beta == 2.0 and mask is None
            and getattr(ops, 'grad_W_pair_fused', None) is not None
            and ops.fused_rec_supported(plan, H.dtype)):
        # phased fast path (see _mu_H): no canonical R round trip
        neg, pos = ops.grad_W_pair_fused(Vp, W, H, plan)
        if ortho is not None:
            pos = pos + _ortho_positive_term(W, ortho).astype(pos.dtype)
        Wn = W * neg / (pos + EPS)
        return _normalize_W(Wn, plan.ndim).astype(W.dtype)
    R = ops.reconstruct(W, H, plan)
    if beta != 2.0:
        neg, pos = _beta_grad_W(ops, Vp, R, H, plan, beta, mask,
                                n_channels=W.shape[1])
    else:
        if mask is not None:
            R = R * mask.astype(R.dtype)  # Vp is prepare(mask*V) already
        neg, pos = ops.grad_W_pair(Vp, R, H, plan)
    if ortho is not None:
        pos = pos + _ortho_positive_term(W, ortho).astype(pos.dtype)
    Wn = W * neg / (pos + EPS)
    return _normalize_W(Wn, plan.ndim).astype(W.dtype)


_STEP_STATICS = ('plan', 'strategy', 'update_H', 'update_W', 'use_inhibition',
                 'use_cross', 'beta')


@partial(jax.jit, static_argnames=_STEP_STATICS)
def update_step(Vp, W, H, sparsity, inhibition, cross_inhibition, kernels,
                mask=None, l2_H=None, ortho_W=None, *,
                plan: ConvPlan, strategy: str,
                update_H: bool = True, update_W: bool = True,
                use_inhibition: bool = False, use_cross: bool = False,
                beta: float = 2.0):
    """One full MU iteration: H update then W update (reference
    ``fit_batch`` loop body, ``TransformInvariantNMF.py:334-340``).
    ``H`` is canonical at the boundary; the phased strategy encodes/decodes
    around the update."""
    ops = get_ops(strategy)
    H = _enc_h(H, plan, strategy)
    if update_H:
        H = _mu_H(ops, Vp, W, H, sparsity, inhibition, cross_inhibition,
                  kernels, plan=plan, use_inhibition=use_inhibition,
                  use_cross=use_cross, beta=beta,
                  mask=mask, l2=l2_H)
    if update_W:
        W = _mu_W(ops, Vp, W, H, plan=plan, beta=beta,
                  mask=mask, ortho=ortho_W)
    return W, _dec_h(H, plan, strategy, W.shape[0])


@partial(jax.jit, static_argnames=_STEP_STATICS, donate_argnums=(1, 2))
def fit_loop(Vp, W, H, n_iterations, sparsity, inhibition, cross_inhibition,
             kernels, mask=None, l2_H=None, ortho_W=None, *,
             plan: ConvPlan, strategy: str,
             update_H: bool = True, update_W: bool = True,
             use_inhibition: bool = False, use_cross: bool = False,
             beta: float = 2.0):
    """The no-callback fast path: the whole fit as one on-device loop with
    donated W/H buffers.  ``n_iterations`` is traced, so varying it does not
    recompile.  The phased strategy encodes H once before the loop and
    decodes once after — zero per-iteration relayout cost."""
    ops = get_ops(strategy)

    def body(_, WH):
        W, H = WH
        if update_H:
            H = _mu_H(ops, Vp, W, H, sparsity, inhibition, cross_inhibition,
                      kernels, plan=plan, use_inhibition=use_inhibition,
                      use_cross=use_cross, beta=beta,
                      mask=mask, l2=l2_H)
        if update_W:
            W = _mu_W(ops, Vp, W, H, plan=plan,
                      beta=beta, mask=mask, ortho=ortho_W)
        return W, H

    W, H = jax.lax.fori_loop(0, n_iterations, body, (W, _enc_h(H, plan, strategy)))
    return W, _dec_h(H, plan, strategy, W.shape[0])


# scan-chunk length of the energy-recording loop: one compiled graph serves
# every n_iterations (iterations beyond the requested count are masked out
# with lax.cond), at the cost of dispatching ceil(n/chunk) executions
ENERGY_CHUNK = 32


@partial(jax.jit, static_argnames=_STEP_STATICS + ('chunk',), donate_argnums=(2, 3))
def _fit_energies_chunk(Vp, V, W, H, k, sparsity, inhibition, cross_inhibition,
                        kernels, mask=None, l2_H=None, ortho_W=None, *,
                        chunk: int,
                        plan: ConvPlan, strategy: str,
                        update_H: bool = True, update_W: bool = True,
                        use_inhibition: bool = False, use_cross: bool = False,
                        beta: float = 2.0):
    """``chunk`` scan steps of the MU loop with per-iteration energies; only
    the first ``k`` (traced) steps actually update, the rest are identity —
    so one compilation covers every iteration count."""
    ops = get_ops(strategy)
    acc = jnp.promote_types(V.dtype, jnp.float32)

    def active(WH):
        W, H = WH
        if update_H:
            H = _mu_H(ops, Vp, W, H, sparsity, inhibition, cross_inhibition,
                      kernels, plan=plan, use_inhibition=use_inhibition,
                      use_cross=use_cross, beta=beta,
                      mask=mask, l2=l2_H)
        if update_W:
            W = _mu_W(ops, Vp, W, H, plan=plan,
                      beta=beta, mask=mask, ortho=ortho_W)
        R = ops.reconstruct(W, H, plan)
        return (W, H), beta_ops.divergence(V, R, beta, mask).astype(acc)

    def idle(WH):
        return WH, jnp.asarray(jnp.inf, acc)

    def body(WH, i):
        return jax.lax.cond(i < k, active, idle, WH)

    (W, H), energies = jax.lax.scan(body, (W, _enc_h(H, plan, strategy)),
                                    jnp.arange(chunk))
    return W, _dec_h(H, plan, strategy, W.shape[0]), energies


def fit_loop_energies(Vp, V, W, H, sparsity, inhibition, cross_inhibition,
                      kernels, mask=None, l2_H=None, ortho_W=None, *,
                      n_iterations: int,
                      plan: ConvPlan, strategy: str,
                      update_H: bool = True, update_W: bool = True,
                      use_inhibition: bool = False, use_cross: bool = False,
                      beta: float = 2.0):
    """Fused fit loop that also records the post-iteration reconstruction
    energy (the trace the reference logs per iteration,
    ``TransformInvariantNMF.py:346``).  Costs one extra reconstruction per
    iteration, like the reference's logging path.

    Implemented as ceil(n/ENERGY_CHUNK) executions of one fixed-length
    compiled chunk with the iteration count traced, so *changing
    ``n_iterations`` never recompiles* (a compilation can cost tens of
    seconds)."""
    statics = dict(chunk=ENERGY_CHUNK, plan=plan, strategy=strategy,
                   update_H=update_H, update_W=update_W,
                   use_inhibition=use_inhibition, use_cross=use_cross,
                   beta=beta)
    n = int(n_iterations)
    traces = []
    done = 0
    while done < n:
        k = jnp.int32(min(ENERGY_CHUNK, n - done))
        W, H, es = _fit_energies_chunk(
            Vp, V, W, H, k, sparsity, inhibition, cross_inhibition, kernels,
            mask, l2_H, ortho_W, **statics)
        traces.append(es)
        done += ENERGY_CHUNK
    energies = (jnp.concatenate(traces)[:n] if traces
                else jnp.zeros((0,), jnp.promote_types(V.dtype, jnp.float32)))
    return W, H, energies


@partial(jax.jit, static_argnames=_STEP_STATICS + ('check_every', 'n_buf'),
         donate_argnums=(2, 3))
def fit_loop_tol(Vp, V, W, H, n_max, tol, sparsity, inhibition,
                 cross_inhibition, kernels, mask=None, l2_H=None,
                 ortho_W=None, *,
                 check_every: int, n_buf: int = 0,
                 plan: ConvPlan, strategy: str,
                 update_H: bool = True, update_W: bool = True,
                 use_inhibition: bool = False, use_cross: bool = False,
                 beta: float = 2.0):
    """Adaptive fit with on-device convergence detection (no reference
    counterpart; sklearn-style ``tol`` semantics).

    Runs MU iterations in blocks of ``check_every`` inside one
    ``lax.while_loop`` and stops when the relative energy improvement over
    a block, ``(e_prev - e) / e_init``, drops below ``tol`` — or at
    ``n_max`` iterations.  The convergence check never leaves the device:
    the whole adaptive fit is ONE dispatch regardless of where it stops
    (a host-polled loop would pay a device round trip per check).
    ``n_max`` and ``tol`` are traced — changing them never recompiles.

    ``n_buf > 0`` (static, >= the largest possible ``n_max``) additionally
    records the per-iteration energy into an on-device trace (one extra
    reconstruction per iteration; entries past ``n_done`` stay NaN).

    Returns ``(W, H, n_done, e_final, energies_or_None)``.
    """
    ops = get_ops(strategy)
    acc = jnp.promote_types(V.dtype, jnp.float32)
    record = n_buf > 0

    def inner(j, state):
        W, H = state[:2]
        if update_H:
            H = _mu_H(ops, Vp, W, H, sparsity, inhibition, cross_inhibition,
                      kernels, plan=plan, use_inhibition=use_inhibition,
                      use_cross=use_cross, beta=beta,
                      mask=mask, l2=l2_H)
        if update_W:
            W = _mu_W(ops, Vp, W, H, plan=plan,
                      beta=beta, mask=mask, ortho=ortho_W)
        if record:
            trace, i0 = state[2:]
            return W, H, trace.at[i0 + j].set(e_of(W, H)), i0
        return W, H

    def e_of(W, H):
        R = ops.reconstruct(W, H, plan)
        return beta_ops.divergence(V, R, beta, mask).astype(acc)

    H = _enc_h(H, plan, strategy)
    e0 = e_of(W, H)
    scale = jnp.maximum(e0, jnp.asarray(jnp.finfo(acc).tiny, acc))

    def cond(state):
        i, rel = state[2], state[4]
        return jnp.logical_and(i < n_max, rel >= tol)

    def body(state):
        W, H, i, e_prev, _ = state[:5]
        k = jnp.minimum(check_every, n_max - i)
        carry = (W, H) + ((state[5], i) if record else ())
        carry = jax.lax.fori_loop(0, k, inner, carry)
        W, H = carry[:2]
        # when recording, the last in-block iteration already wrote
        # e(W, H) to the trace — read it back instead of paying another
        # reconstruction
        e = carry[2][i + k - 1] if record else e_of(W, H)
        out = (W, H, i + k, e, (e_prev - e) / scale)
        return out + ((carry[2],) if record else ())

    state = (W, H, jnp.asarray(0, jnp.int32), e0, jnp.asarray(jnp.inf, acc))
    if record:
        state = state + (jnp.full((n_buf,), jnp.nan, acc),)
    state = jax.lax.while_loop(cond, body, state)
    W, H, n_done, e = state[0], state[1], state[2], state[3]
    trace = state[5] if record else None
    return W, _dec_h(H, plan, strategy, W.shape[0]), n_done, e, trace


# extrapolation safeguard heuristics (Ang & Gillis 2019-style HER): the
# momentum weight grows geometrically while energy decreases and is cut on
# any increase (with the extrapolation sequence reset to the accepted
# iterates), so the loop degrades gracefully to plain MU on hard problems
_XTR_GROW, _XTR_SHRINK, _XTR_MAX = 1.05, 0.5, 0.95


@partial(jax.jit, static_argnames=_STEP_STATICS + ('check_every', 'n_buf'),
         donate_argnums=(2, 3))
def fit_loop_extrapolated(Vp, V, W, H, n_max, tol, beta0, sparsity,
                          inhibition, cross_inhibition, kernels, mask=None,
                          l2_H=None, ortho_W=None, *,
                          check_every: int, n_buf: int = 0,
                          plan: ConvPlan, strategy: str,
                          update_H: bool = True, update_W: bool = True,
                          use_inhibition: bool = False, use_cross: bool = False,
                          beta: float = 2.0):
    """Extrapolated (accelerated) MU: heuristic extrapolation with restarts.

    Plain MU is a fixed-point iteration with no momentum; following the
    extrapolation scheme of Ang & Gillis 2019 ("Accelerating nonnegative
    matrix factorization algorithms using extrapolation"), each update is
    computed at an extrapolated point ``Y = X_new + beta_k (X_new - X_old)``
    projected to the nonnegative orthant, which typically reaches a given
    tolerance in substantially fewer iterations at ~zero extra per-iteration
    cost (the extrapolation is one fused elementwise op; no extra
    convolutions).  The reference library has no acceleration of any kind
    (plain Lee-Seung MU, ``TransformInvariantNMF.py:217-238``).

    Safeguard: every ``check_every`` iterations the energy of the accepted
    iterates is evaluated on device; if it increased, the extrapolation
    sequence is reset (``Y = X``) and ``beta_k`` halves — so misbehaving
    momentum self-corrects toward plain MU.  On decrease ``beta_k`` grows by
    5% up to 0.95.  Stopping mirrors :func:`fit_loop_tol`: at ``n_max``
    iterations or when the relative per-block energy improvement drops
    below ``tol`` (pass ``tol=0`` to always run ``n_max``).

    ``n_buf > 0`` (static, must be >= the largest possible ``n_max``)
    additionally records the energy of the *accepted* iterates after every
    iteration into an on-device trace — the accelerated counterpart of
    :func:`fit_loop_energies` — at the cost of one extra reconstruction
    per iteration (entries past ``n_done`` stay NaN; the extrapolation
    trajectory itself is unchanged, the recording is read-only).

    Returns ``(W, H, n_done, e_final, energies_or_None)``.
    """
    ops = get_ops(strategy)
    acc = jnp.promote_types(V.dtype, jnp.float32)

    def xtr(Xn, Xold, bk):
        # MULTIPLICATIVE extrapolation Y = Xn * (Xn / Xold)^beta_k: additive
        # momentum clips at 0, and zeros are ABSORBING under MU (the
        # momentum would permanently kill activations/atoms — measured:
        # additive extrapolation plateaus 300x above the converged energy).
        # On the log scale positivity is exact, zeros stay fixed points
        # just like in plain MU, and the per-step ratio is trust-capped so
        # one aggressive step cannot fling an entry out of the basin.
        r = jnp.clip((Xn + EPS) / (Xold + EPS), 0.125, 8.0)
        return (Xn * r ** bk.astype(Xn.dtype)).astype(Xn.dtype)

    record = n_buf > 0

    def inner(j, state):
        W, H, Wy, Hy, bk = state[:5]
        if update_H:
            Hn = _mu_H(ops, Vp, Wy, Hy, sparsity, inhibition,
                       cross_inhibition, kernels, plan=plan,
                       use_inhibition=use_inhibition, use_cross=use_cross,
                       beta=beta, mask=mask, l2=l2_H)
            Hy = xtr(Hn, H, bk)
            H = Hn
        if update_W:
            Wn = _mu_W(ops, Vp, Wy, Hy, plan=plan,
                       beta=beta, mask=mask, ortho=ortho_W)
            Wy = _normalize_W(xtr(Wn, W, bk), plan.ndim).astype(Wn.dtype)
            W = Wn
        if record:
            trace, i0 = state[5:]
            trace = trace.at[i0 + j].set(e_of(W, H))
            return W, H, Wy, Hy, bk, trace, i0
        return W, H, Wy, Hy, bk

    def e_of(W, H):
        R = ops.reconstruct(W, H, plan)
        return beta_ops.divergence(V, R, beta, mask).astype(acc)

    H = _enc_h(H, plan, strategy)
    e0 = e_of(W, H)
    scale = jnp.maximum(e0, jnp.asarray(jnp.finfo(acc).tiny, acc))

    def cond(state):
        i, rel = state[5], state[7]
        return jnp.logical_and(i < n_max, rel >= tol)

    def body(state):
        W, H, Wy, Hy, bk, i, e_prev, _ = state[:8]
        k = jnp.minimum(check_every, n_max - i)
        carry = (W, H, Wy, Hy, bk) + ((state[8], i) if record else ())
        carry = jax.lax.fori_loop(0, k, inner, carry)
        W, H, Wy, Hy, bk = carry[:5]
        # the accepted-iterate energy was just written to the trace by the
        # last in-block iteration — reuse it when recording
        e = carry[5][i + k - 1] if record else e_of(W, H)
        worse = e > e_prev
        bk = jnp.where(worse, bk * _XTR_SHRINK,
                       jnp.minimum(bk * _XTR_GROW, _XTR_MAX))
        # on increase, drop the momentum: restart the extrapolation
        # sequence from the accepted iterates
        Wy = jnp.where(worse, W, Wy)
        Hy = jnp.where(worse, H, Hy)
        # a restarted block is not convergence — only a *small nonnegative*
        # improvement stops the fit
        rel = jnp.where(worse, jnp.asarray(jnp.inf, acc),
                        (e_prev - e) / scale)
        out = (W, H, Wy, Hy, bk, i + k, e, rel)
        return out + ((carry[5],) if record else ())

    bk0 = jnp.asarray(beta0, acc)
    state = (W, H, W, H, bk0, jnp.asarray(0, jnp.int32), e0,
             jnp.asarray(jnp.inf, acc))
    if record:
        state = state + (jnp.full((n_buf,), jnp.nan, acc),)
    state = jax.lax.while_loop(cond, body, state)
    W, H, n_done, e = state[0], state[1], state[5], state[6]
    trace = state[8] if record else None
    return W, _dec_h(H, plan, strategy, W.shape[0]), n_done, e, trace


@partial(jax.jit, static_argnames=('plan', 'strategy', 'use_inhibition', 'use_cross', 'beta'))
def update_H_step(Vp, W, H, sparsity, inhibition, cross_inhibition, kernels,
                  mask=None, l2_H=None, *,
                  plan: ConvPlan, strategy: str,
                  use_inhibition: bool = False, use_cross: bool = False,
                  beta: float = 2.0):
    """H-only update on a (mini)batch slice (canonical H in/out)."""
    ops = get_ops(strategy)
    H = _mu_H(ops, Vp, W, _enc_h(H, plan, strategy), sparsity, inhibition,
              cross_inhibition, kernels, plan=plan, use_inhibition=use_inhibition,
              use_cross=use_cross, beta=beta, mask=mask,
              l2=l2_H)
    return _dec_h(H, plan, strategy, W.shape[0])


@partial(jax.jit, static_argnames=('plan', 'strategy', 'beta'))
def update_W_step(Vp, W, H, mask=None, ortho_W=None, *, plan: ConvPlan,
                  strategy: str, beta: float = 2.0):
    """W-only update on a (mini)batch slice."""
    return _mu_W(get_ops(strategy), Vp, W, _enc_h(H, plan, strategy),
                 plan=plan, beta=beta, mask=mask,
                 ortho=ortho_W)


@partial(jax.jit, static_argnames=('plan', 'strategy', 'beta'))
def grad_W_stats(Vp, W, H, mask=None, *, plan: ConvPlan, strategy: str,
                 beta: float = 2.0):
    """(neg, pos) sufficient statistics of the W gradient for the minibatch
    accumulators (reference ``_accumulate_gradient_W``,
    ``TransformInvariantNMF.py:444-455``)."""
    ops = get_ops(strategy)
    H = _enc_h(H, plan, strategy)
    R = ops.reconstruct(W, H, plan)
    if beta != 2.0:
        return _beta_grad_W(ops, Vp, R, H, plan, beta, mask,
                            n_channels=W.shape[1])
    if mask is not None:
        R = R * mask.astype(R.dtype)
    return ops.grad_W_pair(Vp, R, H, plan)


@jax.jit
def accumulate_gradient(acc_neg, acc_pos, neg, pos, sag_lambda):
    """Exponentially-averaged (or, for sag_lambda == 1, plain-summed)
    gradient accumulation.  The branch is resolved with ``jnp.where`` so one
    compiled graph serves both cases."""
    is_sum = sag_lambda == 1.0
    keep = jnp.where(is_sum, 1.0, 1.0 - sag_lambda)
    add = jnp.where(is_sum, 1.0, sag_lambda)
    return keep * acc_neg + add * neg, keep * acc_pos + add * pos


@partial(jax.jit, static_argnames=('n_shift_axes',))
def apply_W_update(W, neg, pos, ortho_W=None, *, n_shift_axes: int):
    """W <- normalize(W * neg / (pos + eps)) from precomputed statistics.

    ``ortho_W`` adds the cross-atom orthogonality gradient from the
    *current* W at update time (it must not enter the accumulated
    statistics, which may average over past dictionaries)."""
    if ortho_W is not None:
        pos = pos + _ortho_positive_term(W, ortho_W).astype(pos.dtype)
    Wn = W * neg / (pos + EPS)
    return _normalize_W(Wn, n_shift_axes).astype(W.dtype)


@partial(jax.jit, donate_argnums=(0,))
def set_H_slice(H, Hb, start):
    """H[start:start+len(Hb)] <- Hb without a host round-trip.
    ``start`` is traced, so every batch offset shares one compilation."""
    return jax.lax.dynamic_update_slice_in_dim(H, Hb, start, axis=0)
