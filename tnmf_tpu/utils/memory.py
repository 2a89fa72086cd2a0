"""Device-memory planning: will this fit fit, and at what batch size?

``estimate_fit_memory(model, V_shape)`` predicts the HBM footprint of a
``fit_batch`` *before anything is allocated*: every persistent tensor
(data, its loop-invariant prepared form, the activation carrier, the
dictionary) is sized exactly via ``jax.eval_shape`` on the engine's real
operators — strategy-proof (conv / fft / phased / dot, transform groups,
all modes) with zero FLOPs or device memory spent.  Transients
(reconstruction streams, the double-buffered H update) are itemized on
top as the peak estimate.  ``suggest_batch_size`` inverts the estimate
against a device-memory budget.

The reference has no counterpart (its NumPy backends fail with a host
``MemoryError`` after minutes of compute); on an accelerator with a fixed
HBM pool, planning the activation footprint up front is a production
necessity — H alone is ``n_samples * n_atoms * prod(transform_shape)``
and routinely dwarfs the data (SURVEY.md §5 long-context analogue).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np


def _nbytes(sds) -> int:
    return int(np.prod(sds.shape)) * sds.dtype.itemsize


@dataclass
class MemoryEstimate:
    """Per-tensor device-memory breakdown of one ``fit_batch``.

    ``tensors`` maps a tensor name to ``(shape, dtype, bytes)``;
    transient entries are suffixed ``(transient)``.  ``peak_bytes`` is
    persistent + transient — an estimate of the high-water mark during an
    iteration (XLA may fuse some transients away; donation prevents
    worse).
    """

    strategy: str
    tensors: Dict[str, Tuple[Tuple[int, ...], str, int]] = field(default_factory=dict)

    @property
    def persistent_bytes(self) -> int:
        return sum(b for k, (_, _, b) in self.tensors.items()
                   if 'transient' not in k)

    @property
    def transient_bytes(self) -> int:
        return sum(b for k, (_, _, b) in self.tensors.items()
                   if 'transient' in k)

    @property
    def peak_bytes(self) -> int:
        return self.persistent_bytes + self.transient_bytes

    def __str__(self) -> str:
        rows = [f'strategy: {self.strategy}']
        for name, (shape, dtype, b) in self.tensors.items():
            rows.append(f'  {name:28s} {str(shape):24s} {dtype:9s} '
                        f'{b / 2**20:10.1f} MiB')
        rows.append(f'  {"persistent":28s} {"":24s} {"":9s} '
                    f'{self.persistent_bytes / 2**20:10.1f} MiB')
        rows.append(f'  {"peak (est.)":28s} {"":24s} {"":9s} '
                    f'{self.peak_bytes / 2**20:10.1f} MiB')
        return '\n'.join(rows)


def _add_tensor(est, name, sds, div, scale_by_samples=True):
    """Record one tensor row in a :class:`MemoryEstimate` (bytes divided
    by the sample-shard extent ``div`` for sample-scaled tensors)."""
    b = _nbytes(sds)
    if scale_by_samples:
        b = -(-b // div)
    est.tensors[name] = (tuple(int(x) for x in sds.shape),
                         np.dtype(sds.dtype).name, b)


def estimate_fit_memory(model, V_shape: Tuple[int, ...],
                        dtype=None, solver: str = 'mu') -> MemoryEstimate:
    """Predict the device-memory footprint of ``model.fit_batch(V)`` for a
    data tensor of shape ``V_shape = (n_samples, n_channels,
    *sample_shape)`` — without allocating anything.

    Uses the model's constructor configuration (atoms, mode, strategy
    request, transform group, dtype) and the engine's own operators under
    ``jax.eval_shape``.  Under a sample-sharded mesh the sample-scaled
    tensors are divided by the data-axis extent (per-device bytes).
    ``solver='hals'`` accounts the coordinate-descent loop state instead
    (the shift-invariant engine carries the padded residual and the
    phase-major H, :mod:`tnmf_tpu.engine_hals_conv`).
    """
    import jax
    import jax.numpy as jnp

    from .. import engine
    from ..ops.modes import ConvPlan

    if len(V_shape) < 3:
        raise ValueError('V_shape must be (n_samples, n_channels, *sample_shape)')
    n, c = int(V_shape[0]), int(V_shape[1])
    sample_shape = tuple(int(s) for s in V_shape[2:])
    dt = jnp.dtype(dtype) if dtype is not None else jnp.dtype(
        model._dtype if getattr(model, '_dtype', None) is not None else jnp.float32)

    if hasattr(model, 'atom_shapes'):  # MultiScaleTNMF
        return _estimate_multiscale(model, n, c, sample_shape, dt)

    plan = ConvPlan.create(model._reconstruction_mode, sample_shape,
                           model.atom_shape, model._fft_policy,
                           precision=model._precision)
    if solver == 'hals':
        return _estimate_hals(model, plan, n, c, sample_shape, dt)
    if solver != 'mu':
        raise ValueError(f"solver must be 'mu' or 'hals', got {solver!r}")
    n_maps = model.n_atoms * model.n_transforms
    # same resolution chain as _initialize_matrices (models/tnmf.py)
    strategy = engine.resolve_strategy(model._strategy_request, plan, n_maps, c)
    if model._group is not None:
        strategy = (strategy, model._group)

    # per-device divisor under a sample-sharded mesh
    div = 1
    if getattr(model, '_mesh', None) is not None and model._shard_axis == 'samples':
        div = int(model._mesh.size)

    V_s = jax.ShapeDtypeStruct((n, c) + sample_shape, dt)
    Vp_s = jax.eval_shape(
        lambda v: engine.prepare_data(v, plan=plan, strategy=strategy), V_s)
    H_s = jax.ShapeDtypeStruct((n, n_maps) + plan.transform_shape, dt)
    Hc_s = jax.eval_shape(lambda h: engine._enc_h(h, plan, strategy), H_s)
    W_s = jax.ShapeDtypeStruct((model.n_atoms, c) + model.atom_shape, dt)

    est = MemoryEstimate(strategy=str(strategy))

    def add(name, sds, scale_by_samples=True):
        _add_tensor(est, name, sds, div, scale_by_samples)

    add('V (device copy)', V_s)
    add('V prepared (loop-invariant)', Vp_s)
    add('H (loop carrier)', Hc_s)
    add('W (dictionary)', W_s, scale_by_samples=False)
    # per-iteration transients: the reconstruction, its prepared/extended
    # form feeding the gradient correlations, and the H-update output
    # (double-buffered against the carrier for one fused kernel)
    R_s = jax.ShapeDtypeStruct((n, c) + sample_shape, dt)
    add('R (transient)', R_s)
    add('R prepared (transient)', Vp_s)
    add('H update out (transient)', Hc_s)
    return est


def _estimate_hals(model, plan, n, c, sample_shape, dt) -> MemoryEstimate:
    """Loop-state accounting for ``solver='hals'``: the degenerate
    plain-NMF engine carries flat factor views plus the Gram/cross pair;
    the shift-invariant engine carries the padded residual and the
    phase-major H (:mod:`tnmf_tpu.engine_hals_conv`)."""
    import math as _math

    import jax
    import jax.numpy as jnp

    m = model.n_atoms
    acc = jnp.promote_types(dt, jnp.float32)
    div = 1
    if getattr(model, '_mesh', None) is not None and model._shard_axis == 'samples':
        div = int(model._mesh.size)

    def add(est, name, shape, dtype, scale_by_samples=True):
        _add_tensor(est, name, jax.ShapeDtypeStruct(shape, dtype), div,
                    scale_by_samples)

    if _math.prod(plan.transform_shape) == 1:  # plain-NMF engine
        F = c * _math.prod(sample_shape)
        est = MemoryEstimate(strategy='hals')
        add(est, 'V (device copy, flat view)', (n, F), dt)
        add(est, 'H (n, m)', (n, m), dt)
        add(est, 'W (m, F)', (m, F), dt, scale_by_samples=False)
        add(est, 'Gram G / A (m, m)', (m, m), acc, scale_by_samples=False)
        add(est, 'cross P (n, m)', (n, m), acc)
        add(est, 'cross B (m, F)', (m, F), acc, scale_by_samples=False)
        return est

    from .. import engine_hals_conv as ehc
    if not ehc.applicable(plan):
        raise ValueError("solver='hals' requires the degenerate plain-NMF "
                         "geometry or reconstruction_mode='full'")
    A, T, K, Tp = ehc._geom(plan)
    est = MemoryEstimate(strategy='hals-conv')
    add(est, 'V (device copy)', (n, c) + sample_shape, dt)
    add(est, 'E residual (padded carrier)',
        (n, c) + tuple(t + a - 1 for t, a in zip(Tp, A)), dt)
    add(est, 'H (phase-major carrier)',
        (_math.prod(A), n, m, _math.prod(K)), dt)
    add(est, 'W (dictionary)', (m, c) + A, dt, scale_by_samples=False)
    add(est, 'Gram G (m, m)', (m, m), acc, scale_by_samples=False)
    # per-phase transients: the sliced residual window and the NNLS rows
    add(est, 'phase patch slice (transient)', (n, c) + Tp, dt)
    add(est, 'phase rows (transient)', (n * _math.prod(K), m), acc)
    return est


def _estimate_multiscale(model, n, c, sample_shape, dt) -> MemoryEstimate:
    """Per-scale accounting for :class:`MultiScaleTNMF` (same resolution
    chain as its ``_initialize``)."""
    import jax

    from .. import engine
    from ..ops.modes import ConvPlan

    plans = tuple(ConvPlan.create(model._mode, sample_shape, a,
                                  precision=model._precision)
                  for a in model.atom_shapes)
    if model._backend in ('auto', 'jax'):
        # same resolution chain as MultiScaleTNMF._initialize (round 5:
        # per-scale strategies resolve like the single-scale model,
        # including the phased lowering)
        strategies = tuple(
            engine.resolve_strategy('auto', p, m, c, allow_dot=False)
            for p, m in zip(plans, model.n_atoms))
    else:
        from ..models.tnmf import _BACKEND_STRATEGY
        strategies = (_BACKEND_STRATEGY[model._backend.lower()],) * model.n_scales

    div = int(model._mesh.size) if getattr(model, '_mesh', None) is not None else 1
    est = MemoryEstimate(strategy=str(tuple(strategies)))

    def add(name, sds, scale_by_samples=True):
        _add_tensor(est, name, sds, div, scale_by_samples)

    V_s = jax.ShapeDtypeStruct((n, c) + sample_shape, dt)
    add('V (device copy)', V_s)
    for k, (m, p, s) in enumerate(zip(model.n_atoms, plans, strategies)):
        Vp_s = jax.eval_shape(
            lambda v, p=p, s=s: engine.prepare_data(v, plan=p, strategy=s), V_s)
        add(f'V prepared, scale {k}', Vp_s)
        # the loop carrier is the strategy-encoded H (phase-blocked and
        # padded for 'phased' scales — multiscale encodes canonical H
        # tuples at the kernel boundary, models/multiscale.py)
        Hc_s = jax.eval_shape(
            lambda h, p=p, s=s: engine._enc_h(h, p, s),
            jax.ShapeDtypeStruct((n, m) + p.transform_shape, dt))
        add(f'H, scale {k} (loop carrier)', Hc_s)
        add(f'W, scale {k}',
            jax.ShapeDtypeStruct((m, c) + model.atom_shapes[k], dt),
            scale_by_samples=False)
        add(f'R prepared, scale {k} (transient)', Vp_s)
        add(f'H update out, scale {k} (transient)', Hc_s)
    add('R (transient)', jax.ShapeDtypeStruct((n, c) + sample_shape, dt))
    return est


def suggest_batch_size(model, sample_shape: Tuple[int, ...],
                       n_channels: int = 1,
                       budget_bytes: Optional[int] = None,
                       safety: float = 0.85,
                       dtype=None) -> int:
    """Largest ``n_samples`` whose estimated fit peak stays within
    ``budget_bytes`` (default: the current device's memory limit when the
    runtime reports one, scaled by ``safety``).  Returns 0 when even one
    sample does not fit."""
    import jax

    if budget_bytes is None:
        stats = jax.local_devices()[0].memory_stats() or {}
        limit = stats.get('bytes_limit')
        if limit is None:
            raise ValueError('the runtime reports no device memory limit; '
                             'pass budget_bytes explicitly')
        budget_bytes = int(limit)
    budget = int(budget_bytes * safety)

    def peak(n):
        return estimate_fit_memory(
            model, (n, n_channels) + tuple(sample_shape), dtype=dtype).peak_bytes

    if peak(1) > budget:
        return 0
    lo, hi = 1, 2
    while peak(hi) <= budget:
        lo, hi = hi, hi * 2
        if hi > 2 ** 40:  # pragma: no cover - absurd budgets
            return lo
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if peak(mid) <= budget:
            lo = mid
        else:
            hi = mid
    return lo
