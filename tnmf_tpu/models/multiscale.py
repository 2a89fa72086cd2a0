"""Multi-scale Transform-Invariant NMF: atoms of different sizes, one model.

The reference's model class fixes a single ``atom_shape`` for the whole
dictionary (``/root/reference/tnmf/TransformInvariantNMF.py:110``: W is one
``(n_atoms, n_channels, *atom_shape)`` tensor, H one matching activation
tensor) — structures at different scales must share one compromise size.
:class:`MultiScaleTNMF` lifts that: the dictionary is a *tuple* of atom
banks with independent shapes,

    R = sum_k  sum_m  H_k[n, m] * W_k[m]        (k = scale, m = atom)

with one activation tensor per scale (their shift shapes differ, so this
cannot be expressed in the reference API at all).

MU derivation: the model is still linear in every factor, so the
Lee-Seung split applies per block — each scale's gradients are the plain
conv-NMF gradients *against the total reconstruction* ``R``:

    neg_Hk = corr(V, W_k)      pos_Hk = corr(R, W_k)
    neg_Wk = corr(V, H_k)      pos_Wk = corr(R, H_k)

All scales update simultaneously from the same R (a Jacobi/block update —
exactly how single-scale MU updates all H entries at once), then R is
recomputed for the W half, mirroring the reference's H-then-W ordering.

Execution: per scale this reuses the engine's strategy operators
unchanged — each scale gets its own :class:`ConvPlan` (its own padding /
FFT geometry) and its own prepared data tensor, and the whole iteration is
one jitted graph over the (W_1..W_K, H_1..H_K) pytree, run as a fused
``lax.fori_loop`` exactly like the single-scale fast path.  Masks and
beta-divergences compose through the same ``(A, B)`` factor slots as in
:mod:`tnmf_tpu.engine`.

Strategies: each scale independently resolves to 'conv' / 'fft' / 'phased'
exactly like the single-scale model (``engine.resolve_strategy``) — the
phased lowering's phase-blocked H carry lives per scale inside the
multi-scale pytree: the public kernels encode canonical H tuples on entry
and decode on exit (:func:`_enc_hs` / :func:`_dec_hs`), so the model state
and every accessor stay canonical.  The degenerate plain-NMF corner keeps
the 'conv' lowering (the 'dot' strategy's flattened views are validated
single-scale only).
"""

from __future__ import annotations

import logging
import os
from functools import partial
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .. import engine
from ..utils.validation import require as _require
from .tnmf import _trace_buf as _ms_trace_buf
from ..ops import beta as beta_ops
from ..ops.modes import ConvPlan

EPS = engine.EPS


# ---------------------------------------------------------------------------
# jitted multi-scale kernels (tuples of per-scale tensors; plans/strategies
# are static tuples)
# ---------------------------------------------------------------------------

def _reconstruct(Ws, Hs, plans, strategies):
    """Total reconstruction from *strategy-encoded* per-scale Hs."""
    R = None
    for W, H, plan, strat in zip(Ws, Hs, plans, strategies):
        r = engine.get_ops(strat).reconstruct(W, H, plan)
        R = r if R is None else R + r
    return R


def _enc_hs(Hs, plans, strategies):
    """Canonical per-scale Hs -> each strategy's loop-carried layout (the
    phase-blocked form for 'phased' scales, identity otherwise)."""
    return tuple(engine._enc_h(H, p, s)
                 for H, p, s in zip(Hs, plans, strategies))


def _dec_hs(Hs, Ws, plans, strategies):
    """Inverse of :func:`_enc_hs` (back to canonical layouts)."""
    return tuple(engine._dec_h(H, p, s, W.shape[0])
                 for H, W, p, s in zip(Hs, Ws, plans, strategies))


@partial(jax.jit, static_argnames=('plans', 'strategies'))
def ms_reconstruct(Ws, Hs, *, plans, strategies):
    """Total reconstruction from *canonical* per-scale Hs (accessor path)."""
    return _reconstruct(Ws, _enc_hs(Hs, plans, strategies), plans, strategies)


def _grad_inputs(Vd, Vps, R, mask, beta, plans, strategies):
    """Per-scale (prepared-numerator, denominator-R) pairs for the current
    total reconstruction.  beta = 2: the loop-invariant ``Vps`` carry
    ``prepare(mask*V)`` and R is masked once.  Other betas: the (A, B)
    factors are computed from the total R, masked, and prepared per scale."""
    if beta == 2.0:
        Rm = R if mask is None else R * mask.astype(R.dtype)
        return Vps, [Rm] * len(plans)
    A, B = beta_ops.factors(Vd, R, beta)
    if mask is not None:
        A = A * mask.astype(A.dtype)
        B = B * mask.astype(B.dtype)
    nums = [engine.get_ops(s).prepare_data(A, p)
            for p, s in zip(plans, strategies)]
    return nums, [B] * len(plans)


def _step(Vd, Vps, Ws, Hs, sparsities, mask, *, plans, strategies,
          update_H, update_W, beta):
    if update_H:
        R = _reconstruct(Ws, Hs, plans, strategies)
        nums, dens = _grad_inputs(Vd, Vps, R, mask, beta, plans, strategies)
        newHs = []
        for k, (W, H, plan, strat) in enumerate(zip(Ws, Hs, plans, strategies)):
            ops = engine.get_ops(strat)
            neg, pos = ops.grad_H_pair(nums[k], dens[k], W, plan)
            newHs.append((H * neg / (pos + (EPS + sparsities[k]))).astype(H.dtype))
        Hs = tuple(newHs)
    if update_W:
        R = _reconstruct(Ws, Hs, plans, strategies)
        nums, dens = _grad_inputs(Vd, Vps, R, mask, beta, plans, strategies)
        newWs = []
        for k, (W, H, plan, strat) in enumerate(zip(Ws, Hs, plans, strategies)):
            ops = engine.get_ops(strat)
            neg, pos = ops.grad_W_pair(nums[k], dens[k], H, plan)
            Wn = W * neg / (pos + EPS)
            newWs.append(engine._normalize_W(Wn, plan.ndim).astype(W.dtype))
        Ws = tuple(newWs)
    return Ws, Hs


_STATICS = ('plans', 'strategies', 'update_H', 'update_W', 'beta')


@partial(jax.jit, static_argnames=_STATICS)
def ms_update_step(Vd, Vps, Ws, Hs, sparsities, mask=None, *,
                   plans, strategies, update_H=True, update_W=True, beta=2.0):
    Ws, Hs = _step(Vd, Vps, Ws, _enc_hs(Hs, plans, strategies), sparsities,
                   mask, plans=plans, strategies=strategies,
                   update_H=update_H, update_W=update_W, beta=beta)
    return Ws, _dec_hs(Hs, Ws, plans, strategies)


@partial(jax.jit, static_argnames=_STATICS, donate_argnums=(2, 3))
def ms_fit_loop(Vd, Vps, Ws, Hs, n_iterations, sparsities, mask=None, *,
                plans, strategies, update_H=True, update_W=True, beta=2.0):
    """The whole multi-scale fit as one on-device loop (donated pytrees;
    traced iteration count — no recompile when it changes)."""
    def body(_, WH):
        return _step(Vd, Vps, WH[0], WH[1], sparsities, mask,
                     plans=plans, strategies=strategies,
                     update_H=update_H, update_W=update_W, beta=beta)

    Ws, Hs = jax.lax.fori_loop(0, n_iterations, body,
                               (Ws, _enc_hs(Hs, plans, strategies)))
    return Ws, _dec_hs(Hs, Ws, plans, strategies)


@partial(jax.jit, static_argnames=_STATICS + ('check_every', 'n_buf'),
         donate_argnums=(2, 3))
def ms_fit_loop_tol(Vd, Vps, Ws, Hs, n_max, tol, sparsities, mask=None, *,
                    check_every, n_buf=0, plans, strategies, update_H=True,
                    update_W=True, beta=2.0):
    """Adaptive multi-scale fit with on-device convergence detection — the
    single-scale semantics of :func:`tnmf_tpu.engine.fit_loop_tol`: blocks
    of ``check_every`` joint block-MU iterations inside one
    ``lax.while_loop``, stopping when the relative objective improvement
    over a block, ``(e_prev - e) / e_init``, drops below ``tol`` — or at
    ``n_max``.  ``n_max`` and ``tol`` are traced (no recompile when they
    change).  ``n_buf > 0`` (static, >= the largest possible ``n_max``)
    additionally records the per-iteration objective into an on-device
    trace (entries past ``n_done`` stay NaN).
    Returns ``(Ws, Hs, n_done, e_final, energies_or_None)``."""
    acc = jnp.promote_types(Vd.dtype, jnp.float32)
    record = n_buf > 0

    def e_of(Ws, Hs):
        R = _reconstruct(Ws, Hs, plans, strategies)
        return beta_ops.divergence(Vd, R, beta, mask).astype(acc)

    def inner(j, state):
        Ws, Hs = _step(Vd, Vps, state[0], state[1], sparsities, mask,
                       plans=plans, strategies=strategies,
                       update_H=update_H, update_W=update_W, beta=beta)
        if record:
            trace, i0 = state[2:]
            return Ws, Hs, trace.at[i0 + j].set(e_of(Ws, Hs)), i0
        return Ws, Hs

    Hs = _enc_hs(Hs, plans, strategies)
    e0 = e_of(Ws, Hs)
    scale = jnp.maximum(e0, jnp.asarray(jnp.finfo(acc).tiny, acc))

    def cond(state):
        i, rel = state[2], state[4]
        return jnp.logical_and(i < n_max, rel >= tol)

    def body(state):
        Ws, Hs, i, e_prev, _ = state[:5]
        k = jnp.minimum(check_every, n_max - i)
        carry = (Ws, Hs) + ((state[5], i) if record else ())
        carry = jax.lax.fori_loop(0, k, inner, carry)
        Ws, Hs = carry[:2]
        # when recording, the last in-block iteration already wrote this
        # objective value to the trace — reuse it
        e = carry[2][i + k - 1] if record else e_of(Ws, Hs)
        out = (Ws, Hs, i + k, e, (e_prev - e) / scale)
        return out + ((carry[2],) if record else ())

    state = (Ws, Hs, jnp.asarray(0, jnp.int32), e0, jnp.asarray(jnp.inf, acc))
    if record:
        state = state + (jnp.full((n_buf,), jnp.nan, acc),)
    state = jax.lax.while_loop(cond, body, state)
    Ws, Hs, n_done, e = state[0], state[1], state[2], state[3]
    return (Ws, _dec_hs(Hs, Ws, plans, strategies), n_done, e,
            (state[5] if record else None))


@partial(jax.jit, static_argnames=_STATICS + ('chunk',), donate_argnums=(2, 3))
def _ms_energies_chunk(Vd, Vps, Ws, Hs, k, sparsities, mask=None, *,
                       chunk, plans, strategies, update_H=True,
                       update_W=True, beta=2.0):
    acc = jnp.promote_types(Vd.dtype, jnp.float32)

    def active(WH):
        Ws, Hs = _step(Vd, Vps, WH[0], WH[1], sparsities, mask,
                       plans=plans, strategies=strategies,
                       update_H=update_H, update_W=update_W, beta=beta)
        R = _reconstruct(Ws, Hs, plans, strategies)
        return (Ws, Hs), beta_ops.divergence(Vd, R, beta, mask).astype(acc)

    def idle(WH):
        return WH, jnp.asarray(jnp.inf, acc)

    def body(WH, i):
        return jax.lax.cond(i < k, active, idle, WH)

    (Ws, Hs), es = jax.lax.scan(body, (Ws, _enc_hs(Hs, plans, strategies)),
                                jnp.arange(chunk))
    return Ws, _dec_hs(Hs, Ws, plans, strategies), es


@partial(jax.jit, static_argnames=('plans', 'strategies', 'beta'))
def ms_grad_W_stats(Vd, Vps, Ws, Hs, mask=None, *, plans, strategies,
                    beta=2.0):
    """Per-scale W-gradient ``(neg, pos)`` pairs against the current total
    reconstruction (the minibatch accumulation unit — single-scale
    counterpart: :func:`tnmf_tpu.engine.grad_W_stats`)."""
    Hs = _enc_hs(Hs, plans, strategies)
    R = _reconstruct(Ws, Hs, plans, strategies)
    nums, dens = _grad_inputs(Vd, Vps, R, mask, beta, plans, strategies)
    stats = []
    for k, (H, plan, strat) in enumerate(zip(Hs, plans, strategies)):
        ops = engine.get_ops(strat)
        stats.append(ops.grad_W_pair(nums[k], dens[k], H, plan))
    return tuple(stats)


@partial(jax.jit, static_argnames=('plans',))
def ms_apply_W_stats(Ws, stats, *, plans):
    """MU ratio + atom normalization per scale from accumulated stats."""
    out = []
    for W, (neg, pos), plan in zip(Ws, stats, plans):
        Wn = W * neg / (pos + EPS)
        out.append(engine._normalize_W(Wn, plan.ndim).astype(W.dtype))
    return tuple(out)


class MultiScaleTNMF:
    """Shift-invariant NMF with per-scale atom banks (no reference
    counterpart — the reference fixes one atom_shape per model).

    Parameters
    ----------
    n_atoms : Tuple[int, ...]
        Atoms per scale, e.g. ``(8, 4)``.
    atom_shapes : Tuple[Tuple[int, ...], ...]
        One spatial shape per scale, e.g. ``((5, 5), (13, 13))``; all must
        share the same rank.
    reconstruction_mode, backend, dtype, seed, verbose, beta_loss, precision
        As in :class:`tnmf_tpu.models.tnmf.TransformInvariantNMF` (backend
        'auto' resolves per scale, including the phased lowering —
        measured 4.5x faster than plain conv at the channel-poor
        64x256x256 two-scale config, ``benchmarks/large_scale.py``).
    mesh : jax.sharding.Mesh, optional
        Data parallelism over the sample axis: V and every per-scale H
        shard along mesh axis 0, the W banks replicate, and each scale's
        W-statistic sample reduction becomes an all-reduce — the same
        layout as the single-scale model's ``shard_axis='samples'``.
    """

    def __init__(self, n_atoms: Tuple[int, ...],
                 atom_shapes: Tuple[Tuple[int, ...], ...],
                 reconstruction_mode: str = 'valid',
                 backend: str = 'auto',
                 dtype=None,
                 seed: Optional[int] = None,
                 verbose: int = 0,
                 beta_loss=2.0,
                 precision: Optional[str] = None,
                 mesh=None,
                 logger: Optional[logging.Logger] = None,
                 w_init: str = 'random',
                 h_init: str = 'random'):
        # raw ctor args for the sklearn estimator protocol (get_params /
        # set_params / clone), captured before any processing
        self._init_params = dict(
            n_atoms=n_atoms, atom_shapes=atom_shapes,
            reconstruction_mode=reconstruction_mode, backend=backend,
            dtype=dtype, seed=seed, verbose=verbose, beta_loss=beta_loss,
            precision=precision, mesh=mesh, logger=logger, w_init=w_init,
            h_init=h_init)
        if len(n_atoms) != len(atom_shapes) or not n_atoms:
            raise ValueError('n_atoms and atom_shapes must be equal-length, '
                             'non-empty tuples (one entry per scale)')
        ranks = {len(a) for a in atom_shapes}
        if len(ranks) != 1:
            raise ValueError(f'all atom shapes must share one rank, got {atom_shapes}')
        self.n_scales = len(n_atoms)
        self.n_atoms = tuple(int(m) for m in n_atoms)
        self.atom_shapes = tuple(tuple(int(a) for a in s) for s in atom_shapes)
        self._mode = reconstruction_mode
        self._backend = backend
        self._dtype = dtype
        self._precision = precision
        self._beta = beta_ops.resolve_beta_loss(beta_loss)
        if w_init not in ('random', 'patches'):
            raise ValueError(
                "w_init must be 'random' or 'patches' for MultiScaleTNMF "
                f"(got {w_init!r}; 'nndsvd' needs the plain-NMF geometry, "
                "which is single-scale by construction)")
        self._w_init = w_init
        if h_init not in ('random', 'correlate'):
            raise ValueError(
                f"h_init must be 'random' or 'correlate', got {h_init!r}")
        self._h_init = h_init
        self._mesh = mesh
        self._rng = np.random.default_rng(seed) if seed is not None else np.random
        self._logger = logger if logger is not None else logging.getLogger(self.__class__.__name__)
        self._logger.setLevel([logging.ERROR, logging.WARNING, logging.INFO, logging.DEBUG][verbose])

        self._plans = None
        self._strategies = None
        self._Ws = None
        self._Hs = None
        self._Vd = None
        self._mask_d = None
        self.energies_ = None
        self.n_iterations_ = None
        # online-learning state (partial_fit): per-scale exponentially
        # averaged (neg, pos) W statistics, and the online step counter
        self._sag_stat_ = None
        self.n_steps_: int = 0

    # -- accessors ------------------------------------------------------

    @property
    def W(self) -> Tuple[np.ndarray, ...]:
        """Per-scale dictionaries, ``W[k]: (n_atoms[k], C, *atom_shapes[k])``."""
        return tuple(np.asarray(w) for w in self._Ws)

    @property
    def H(self) -> Tuple[np.ndarray, ...]:
        """Per-scale activations, ``H[k]: (N, n_atoms[k], *transform_k)``."""
        return tuple(np.asarray(h) for h in self._Hs)

    @property
    def R(self) -> np.ndarray:
        R = ms_reconstruct(self._Ws, self._Hs, plans=self._plans,
                           strategies=self._strategies)
        return np.asarray(R.astype(jnp.float32) if R.dtype == jnp.bfloat16 else R)

    def R_scale(self, k: int) -> np.ndarray:
        """Reconstruction contribution of scale ``k`` alone."""
        return np.asarray(engine.reconstruct(
            self._Ws[k], self._Hs[k], plan=self._plans[k],
            strategy=self._strategies[k]))

    def _energy_function(self) -> float:
        R = ms_reconstruct(self._Ws, self._Hs, plans=self._plans,
                           strategies=self._strategies)
        return float(beta_ops.divergence(self._Vd, R, self._beta, self._mask_d))

    # -- fitting --------------------------------------------------------

    def _initialize(self, V, keep_W, mask):
        V = np.asarray(V)
        _require(bool(np.all(V >= 0)),
                 'The input data V must be non-negative.')
        sample_shape = V.shape[2:]
        self._plans = tuple(
            ConvPlan.create(self._mode, sample_shape, a, precision=self._precision)
            for a in self.atom_shapes)
        if self._backend in ('auto', 'jax'):
            strategies = tuple(
                engine.resolve_strategy('auto', p, m, V.shape[1],
                                        allow_dot=False)
                for p, m in zip(self._plans, self.n_atoms))
        else:
            from .tnmf import _BACKEND_STRATEGY
            # 'auto'/'jax' are handled above; every other valid name maps to
            # a concrete strategy (unknown names raise KeyError here)
            s = _BACKEND_STRATEGY[self._backend.lower()]
            strategies = (s,) * self.n_scales
        self._strategies = strategies

        if self._dtype is not None:
            dtype = jnp.dtype(self._dtype)
        elif jax.config.jax_enable_x64 and V.dtype == np.float64:
            dtype = jnp.dtype(np.float64)
        else:
            dtype = jnp.dtype(np.float32)

        # host init, reference distribution (1 - U[0,1)); all H banks first
        # (scale order), then all W banks — one documented stream order.
        # h_init='correlate' skips the host H draw entirely (per-scale
        # matched filter, computed on device after the prepared tensors
        # exist below) — deterministic, like the single-scale model's.
        if self._h_init == 'correlate':
            Hs = None
        else:
            Hs = tuple(np.asarray(1 - self._rng.random(
                (V.shape[0], m) + p.transform_shape), dtype=V.dtype)
                for m, p in zip(self.n_atoms, self._plans))
        if keep_W and self._Ws is not None:
            Ws = tuple(np.asarray(w) for w in self._Ws)
        else:
            Ws = []
            for m, a in zip(self.n_atoms, self.atom_shapes):
                if self._w_init == 'patches':
                    # per-scale data-window warm start
                    # (tnmf_tpu.utils.initialization)
                    from ..utils.initialization import patches_init
                    Wk = patches_init(V, m, a, self._rng).astype(V.dtype)
                else:
                    Wk = np.asarray(1 - self._rng.random((m, V.shape[1]) + a),
                                    dtype=V.dtype)
                Wk /= Wk.sum(axis=tuple(range(-len(a), 0)), keepdims=True)
                Ws.append(Wk)
            Ws = tuple(Ws)

        self._Vd = jnp.asarray(V, dtype=dtype)
        self._Ws = tuple(jnp.asarray(w, dtype=dtype) for w in Ws)
        self._Hs = (None if Hs is None
                    else tuple(jnp.asarray(h, dtype=dtype) for h in Hs))
        if self._mesh is not None:
            from ..parallel.sharding import data_sharding, replicated
            if V.shape[0] % self._mesh.devices.size:
                raise ValueError(
                    f'n_samples ({V.shape[0]}) must be divisible by the mesh '
                    f'size ({self._mesh.devices.size})')
            rep = replicated(self._mesh)
            self._Vd = jax.device_put(
                self._Vd, data_sharding(self._mesh, self._Vd.ndim))
            self._Ws = tuple(jax.device_put(w, rep) for w in self._Ws)
            if self._Hs is not None:
                self._Hs = tuple(jax.device_put(
                    h, data_sharding(self._mesh, h.ndim)) for h in self._Hs)

        if mask is not None:
            mask = np.asarray(mask)
            if mask.ndim != V.ndim:
                raise ValueError(
                    f'mask must have the same rank as V ({V.ndim}), got {mask.ndim}')
            np.broadcast_shapes(mask.shape, V.shape)
            if np.any(mask < 0):
                raise ValueError('mask entries must be nonnegative')
            self._mask_d = jnp.asarray(mask, dtype=dtype)
            if self._mesh is not None:
                if mask.shape != V.shape:
                    raise ValueError(
                        'under a mesh the mask must have the full data shape '
                        f'{V.shape}, got {mask.shape}')
                self._mask_d = jax.device_put(self._mask_d, self._Vd.sharding)
        else:
            self._mask_d = None

        if self._beta != 2.0:
            self._Vps = (self._Vd,) * self.n_scales  # factors prepared per step
        else:
            Vm = (self._Vd if self._mask_d is None
                  else self._Vd * self._mask_d.astype(dtype))
            self._Vps = tuple(
                engine.prepare_data(Vm, plan=p, strategy=s)
                for p, s in zip(self._plans, self._strategies))
        if self._Hs is None:
            # per-scale matched-filter start (engine.correlate_init_H):
            # deterministic, on device; with a mask the prepared tensor
            # already carries prepare(mask*V) — the right matched filter for
            # the masked objective; for beta != 2 prepare the canonical V
            self._Hs = tuple(
                engine.correlate_init_H(
                    (engine.prepare_data(self._Vd, plan=p, strategy=s)
                     if self._beta != 2.0 else vp),
                    self._Vd, w, plan=p, strategy=s, n_atoms=w.shape[0])
                for vp, w, p, s in zip(self._Vps, self._Ws, self._plans,
                                       self._strategies))

    def get_params(self, deep: bool = True) -> dict:
        """Constructor parameters, unmodified (sklearn estimator API)."""
        del deep  # no nested estimators
        return dict(self._init_params)

    def set_params(self, **params) -> 'MultiScaleTNMF':
        """Re-configure constructor parameters in place (sklearn API);
        resets fitted state.  Unknown names raise ``ValueError``."""
        unknown = set(params) - set(self._init_params)
        if unknown:
            raise ValueError(
                f'invalid parameter(s) {sorted(unknown)} for estimator '
                f'{type(self).__name__}; valid parameters are '
                f'{sorted(self._init_params)}')
        self.__init__(**{**self._init_params, **params})
        return self

    def __sklearn_tags__(self):
        """sklearn >= 1.6 tag protocol; lazy import keeps sklearn optional
        (only sklearn meta-estimators call this)."""
        from sklearn.utils import Tags, TargetTags, TransformerTags
        return Tags(
            estimator_type='transformer',
            target_tags=TargetTags(required=False),
            transformer_tags=TransformerTags(),
            regressor_tags=None, classifier_tags=None,
            no_validation=True)

    def fit(self, V, y=None, n_iterations: int = 1000, update_H: bool = True,
            update_W: bool = True, keep_W: bool = False,
            sparsity_H=0.0, mask=None, record_energies: bool = False,
            progress_callback=None, tol: Optional[float] = None,
            tol_check_every: int = 10):
        """Full-batch multi-scale MU fit.  ``sparsity_H`` is a scalar or a
        per-scale tuple (larger atoms often want more sparsity pressure).
        ``tol`` enables sklearn-style early stopping with the single-scale
        model's semantics (relative objective improvement per
        ``tol_check_every``-iteration block below ``tol`` — one on-device
        while_loop; composes with ``record_energies``, whose trace is
        trimmed to the iterations run, but not with
        ``progress_callback``); ``n_iterations_`` then reports where the
        fit stopped.  ``y`` is accepted and ignored (sklearn unsupervised
        convention)."""
        del y
        _require(update_H or update_W,
                 'at least one of update_H / update_W must be True')
        self._sag_stat_ = None  # fresh optimization: drop partial_fit state
        if np.isscalar(sparsity_H):
            sparsity_H = (float(sparsity_H),) * self.n_scales
        sparsity_H = tuple(float(s) for s in sparsity_H)
        _require(len(sparsity_H) == self.n_scales and min(sparsity_H) >= 0,
                 'sparsity_H must give one value >= 0 per scale')
        self._initialize(V, keep_W, mask)
        dt = self._Vd.dtype
        sp = tuple(jnp.asarray(s, dt) for s in sparsity_H)
        statics = dict(plans=self._plans, strategies=self._strategies,
                       update_H=update_H, update_W=update_W, beta=self._beta)

        self.energies_ = None
        self.n_iterations_ = int(n_iterations)
        if tol is not None:
            if progress_callback is not None:
                raise ValueError(
                    'tol-based early stopping runs as one on-device '
                    'while_loop and cannot combine with progress_callback')
            _require(tol >= 0, f'tol must be >= 0, got {tol!r}')
            _require(int(tol_check_every) >= 1,
                     'tol_check_every must be >= 1')
            acc = jnp.promote_types(dt, jnp.float32)
            self._Ws, self._Hs, n_done, _, trace = ms_fit_loop_tol(
                self._Vd, self._Vps, self._Ws, self._Hs,
                jnp.asarray(int(n_iterations), jnp.int32),
                jnp.asarray(tol, acc), sp, self._mask_d,
                check_every=int(tol_check_every),
                n_buf=(_ms_trace_buf(n_iterations) if record_energies
                       else 0), **statics)
            self.n_iterations_ = int(n_done)
            if record_energies:
                self.energies_ = np.asarray(trace)[:self.n_iterations_]
            self._logger.info('MultiScale TNMF finished.')
            return self
        if record_energies and progress_callback is None:
            chunk = engine.ENERGY_CHUNK
            traces, done = [], 0
            n = int(n_iterations)
            while done < n:
                k = jnp.int32(min(chunk, n - done))
                self._Ws, self._Hs, es = _ms_energies_chunk(
                    self._Vd, self._Vps, self._Ws, self._Hs, k, sp,
                    self._mask_d, chunk=chunk, **statics)
                traces.append(np.asarray(es))
                done += chunk
            self.energies_ = np.concatenate(traces)[:n] if traces else np.zeros((0,))
        elif progress_callback is None:
            self._Ws, self._Hs = ms_fit_loop(
                self._Vd, self._Vps, self._Ws, self._Hs, n_iterations, sp,
                self._mask_d, **statics)
        else:
            energies = [] if record_energies else None
            for it in range(int(n_iterations)):
                self._Ws, self._Hs = ms_update_step(
                    self._Vd, self._Vps, self._Ws, self._Hs, sp,
                    self._mask_d, **statics)
                if record_energies:
                    energies.append(self._energy_function())
                if not progress_callback(self, it):
                    self.n_iterations_ = it + 1  # aborted early
                    break
            if record_energies:
                self.energies_ = np.asarray(energies)
        self._logger.info('MultiScale TNMF finished.')
        return self

    def fit_minibatches(self, V, algorithm=None, batch_size: int = 3,
                        n_epochs: int = 1000, sag_lambda: float = 0.2,
                        keep_W: bool = False, sparsity_H=0.0, mask=None,
                        record_energies: bool = False,
                        progress_callback=None):
        """Minibatch MU for multi-scale dictionaries: the reference's five
        epoch schedules (``MiniBatchAlgorithm`` 4-8, Serizel et al. 2016 —
        ``TransformInvariantNMF.py:350-504``) applied to the joint
        block-MU updates.  Per batch, every scale's H slice updates against
        the shared total reconstruction; the W schedules accumulate
        per-scale ``(neg, pos)`` statistics exactly like the single-scale
        driver (summed for Cyclic_MU, per-batch for ASG/GSG, exponentially
        averaged with ``sag_lambda`` for ASAG/GSAG).

        Runs as a Python loop of jitted per-batch steps (the single-scale
        model additionally offers an all-epochs-on-device scan; minibatch
        steps are small, so the dispatch overhead dominates either way).
        """
        from .tnmf import (MiniBatchAlgorithm,
                           _compute_sequential_minibatches)
        # mesh: correctness is GSPMD's (per-batch slices of the sharded
        # arrays are resharded as needed; sharded == single-device is
        # pinned in tests/test_multiscale.py).  Throughput caveat: a
        # contiguous batch slice of a block-sharded sample axis lands on
        # a device subset, so every step pays a gather — mesh minibatch
        # buys memory capacity, not speed; prefer the full-batch fit (or
        # the single-scale model's on-device scan) for throughput.
        if algorithm is None:
            algorithm = MiniBatchAlgorithm.ASG_MU
        self._sag_stat_ = None  # fresh optimization: drop partial_fit state
        if np.isscalar(sparsity_H):
            sparsity_H = (float(sparsity_H),) * self.n_scales
        sparsity_H = tuple(float(s) for s in sparsity_H)
        _require(len(sparsity_H) == self.n_scales and min(sparsity_H) >= 0,
                 'sparsity_H must give one value >= 0 per scale')
        self._initialize(V, keep_W, mask)
        dt = self._Vd.dtype
        sp = tuple(jnp.asarray(s, dt) for s in sparsity_H)
        statics = dict(plans=self._plans, strategies=self._strategies,
                       beta=self._beta)
        n = int(self._Vd.shape[0])
        batches = list(_compute_sequential_minibatches(n, batch_size))
        lam = jnp.asarray(sag_lambda, dt)

        def mask_slice(s):
            if self._mask_d is None:
                return None
            if self._mask_d.shape[0] == n:
                return self._mask_d[s]
            return self._mask_d  # broadcast mask (sample axis of 1)

        def sliced(s):
            return (self._Vd[s], tuple(vp[s] for vp in self._Vps),
                    tuple(h[s] for h in self._Hs), mask_slice(s))

        def update_H_batch(s):
            Vb, Vpb, Hb, Mb = sliced(s)
            _, Hn = ms_update_step(Vb, Vpb, self._Ws, Hb, sp, Mb,
                                   update_H=True, update_W=False, **statics)
            self._Hs = tuple(h.at[s].set(hn) for h, hn in zip(self._Hs, Hn))

        def update_W_batch(s):
            Vb, Vpb, Hb, Mb = sliced(s)
            self._Ws, _ = ms_update_step(Vb, Vpb, self._Ws, Hb, sp, Mb,
                                         update_H=False, update_W=True,
                                         **statics)

        def grad_W_batch(s):
            Vb, Vpb, Hb, Mb = sliced(s)
            return ms_grad_W_stats(Vb, Vpb, self._Ws, Hb, Mb, **statics)

        def apply_W(stats):
            self._Ws = ms_apply_W_stats(self._Ws, stats, plans=self._plans)

        def shuffled():
            idx = self._rng.permutation(len(batches))
            return [batches[i] for i in idx]

        def acc_sum(acc, stats):
            if acc is None:
                return stats
            return tuple((a[0] + s[0], a[1] + s[1])
                         for a, s in zip(acc, stats))

        def acc_avg(acc, stats):
            if acc is None:
                acc = tuple((jnp.zeros_like(s[0]), jnp.zeros_like(s[1]))
                            for s in stats)
            return tuple(engine.accumulate_gradient(*a, *s, lam)
                         for a, s in zip(acc, stats))

        A = MiniBatchAlgorithm
        inner_stat = None
        self.energies_ = [] if record_energies else None
        for epoch in range(int(n_epochs)):
            if algorithm is A.Cyclic_MU:
                acc = None
                for b in batches:
                    update_H_batch(b)
                    acc = acc_sum(acc, grad_W_batch(b))
                apply_W(acc)
            elif algorithm is A.ASG_MU:
                for b in shuffled():
                    update_H_batch(b)
                    update_W_batch(b)
            elif algorithm is A.GSG_MU:
                for b in shuffled():
                    update_H_batch(b)
                update_W_batch(b)
            elif algorithm is A.ASAG_MU:
                for b in shuffled():
                    update_H_batch(b)
                    inner_stat = acc_avg(inner_stat, grad_W_batch(b))
                    apply_W(inner_stat)
            elif algorithm is A.GSAG_MU:
                b = batches[-1]
                for b in shuffled():
                    update_H_batch(b)
                inner_stat = acc_avg(inner_stat, grad_W_batch(b))
                apply_W(inner_stat)
            else:
                raise ValueError(f'unknown algorithm {algorithm!r}')
            if record_energies:
                self.energies_.append(self._energy_function())
            if progress_callback is not None:
                if not progress_callback(self, epoch):
                    break
            else:
                self._logger.info('Epoch: %d\tEnergy function: %s',
                                  epoch, self._energy_function())
        if record_energies:
            self.energies_ = np.asarray(self.energies_)
        self._logger.info('MultiScale MiniBatch TNMF finished.')
        return self

    def fit_stream(self, V, subsample_size: int = 3,
                   max_subsamples: Optional[int] = None, **kwargs):
        """Streaming fit over an iterator of samples (reference
        ``fit_stream``, ``TransformInvariantNMF.py:506-523``): each
        subsample refits with ``keep_W=True`` so the dictionary banks
        carry across chunks while the activations re-solve per chunk."""
        from itertools import count, islice
        for isub in count(0):
            subsample = list(islice(V, subsample_size))
            if not subsample:
                self._logger.info('Sample iterator exhausted.')
                return self
            self._logger.info('Processing subsample %d.', isub)
            self.fit(np.asarray(subsample), keep_W=True, **kwargs)
            if max_subsamples is not None and isub == max_subsamples - 1:
                self._logger.info('Processed %d subsamples.', max_subsamples)
                return self

    def partial_fit(self, V, y=None, sag_lambda: float = 0.2,
                    sparsity_H=0.0, mask=None) -> 'MultiScaleTNMF':
        """Update the model with ONE minibatch (online learning) — the
        multi-scale counterpart of
        :meth:`TransformInvariantNMF.partial_fit` (sklearn ``MiniBatchNMF``
        protocol).  Each call draws fresh per-scale activations for the
        batch, updates them once jointly against the shared total
        reconstruction, then updates every scale's dictionary from
        exponentially averaged ``(neg, pos)`` statistics carried across
        calls (``sag_lambda``; ``sag_lambda=1`` is memoryless and a first
        call equals one ``fit`` iteration).  Any ``fit*`` call starts a
        fresh optimization and clears the averaged state."""
        del y
        if np.isscalar(sparsity_H):
            sparsity_H = (float(sparsity_H),) * self.n_scales
        sparsity_H = tuple(float(s) for s in sparsity_H)
        _require(len(sparsity_H) == self.n_scales and min(sparsity_H) >= 0,
                 'sparsity_H must give one value >= 0 per scale')
        self._initialize(V, keep_W=True, mask=mask)
        dt = self._Vd.dtype
        sp = tuple(jnp.asarray(s, dt) for s in sparsity_H)
        statics = dict(plans=self._plans, strategies=self._strategies,
                       beta=self._beta)
        _, self._Hs = ms_update_step(
            self._Vd, self._Vps, self._Ws, self._Hs, sp, self._mask_d,
            update_H=True, update_W=False, **statics)
        stats = ms_grad_W_stats(self._Vd, self._Vps, self._Ws, self._Hs,
                                self._mask_d, **statics)
        if sag_lambda == 1.0 or self._sag_stat_ is None:
            stat = stats  # the batch's own statistics (see single-scale)
        else:
            lam = jnp.asarray(sag_lambda, dt)
            stat = tuple(engine.accumulate_gradient(*a, *s, lam)
                         for a, s in zip(self._sag_stat_, stats))
        self._sag_stat_ = None if sag_lambda == 1.0 else stat
        self._Ws = ms_apply_W_stats(self._Ws, stat, plans=self._plans)
        self.n_steps_ += 1
        return self

    def transform(self, V, n_iterations: int = 100, **kwargs) -> Tuple[np.ndarray, ...]:
        """Encode new data against the frozen multi-scale dictionary."""
        if self._Ws is None:
            raise RuntimeError('transform() requires a fitted model')
        self.fit(V, n_iterations=n_iterations, update_W=False, keep_W=True,
                 **kwargs)
        return self.H

    def inverse_transform(self) -> np.ndarray:
        return self.R

    def export_serving(self, path: Optional[str] = None, **kwargs) -> bytes:
        """Serialize the multi-scale encoding step (per-scale matched-filter
        init + joint frozen-dictionary block MU updates) as one
        self-contained StableHLO artifact; the loaded artifact's
        ``transform`` returns the per-scale activation tuple.  See
        :func:`tnmf_tpu.serving.export_serving`."""
        from ..serving import export_serving
        return export_serving(self, path=path, **kwargs)

    # -- checkpointing ---------------------------------------------------

    def save(self, path: str, include_H: bool = False):
        """Atomic ``.npz`` checkpoint of the per-scale banks."""
        if self._Ws is None:
            raise ValueError('nothing to save: the model has not been fit yet')
        payload = dict(
            n_scales=self.n_scales,
            n_atoms=np.asarray(self.n_atoms),
            reconstruction_mode=self._mode,
            dtype=str(self._Ws[0].dtype),
            version=1,
        )
        for k in range(self.n_scales):
            payload[f'atom_shape_{k}'] = np.asarray(self.atom_shapes[k])
            payload[f'W_{k}'] = np.asarray(self._Ws[k], dtype=np.float32) \
                if jnp.dtype(self._Ws[k].dtype).itemsize < 4 else np.asarray(self._Ws[k])
            if include_H and self._Hs is not None:
                payload[f'H_{k}'] = np.asarray(self._Hs[k], dtype=np.float32) \
                    if jnp.dtype(self._Hs[k].dtype).itemsize < 4 else np.asarray(self._Hs[k])
        final = path if path.endswith('.npz') else path + '.npz'
        tmp = final + '.tmp'
        with open(tmp, 'wb') as f:
            np.savez(f, **payload)
        os.replace(tmp, final)

    @classmethod
    def load(cls, path: str, **kwargs) -> 'MultiScaleTNMF':
        with np.load(path, allow_pickle=False) as data:
            K = int(data['n_scales'])
            cfg = dict(
                n_atoms=tuple(int(m) for m in data['n_atoms']),
                atom_shapes=tuple(tuple(int(a) for a in data[f'atom_shape_{k}'])
                                  for k in range(K)),
                reconstruction_mode=str(data['reconstruction_mode']),
            )
            cfg.update(kwargs)
            model = cls(**cfg)
            dtype = jnp.dtype(str(data['dtype']))
            model._Ws = tuple(jnp.asarray(data[f'W_{k}'], dtype=dtype)
                              for k in range(K))
            if 'H_0' in data:
                # checkpoints written with include_H restore the activations
                # and the execution plans, so R / R_scale work immediately
                # (same convention as the single-scale load)
                model._Hs = tuple(jnp.asarray(data[f'H_{k}'], dtype=dtype)
                                  for k in range(K))
                model._restore_plans_from_h()
        return model

    def _restore_plans_from_h(self):
        """Rebuild per-scale plans/strategies from restored H geometry."""
        t0 = self._Hs[0].shape[2:]
        a0 = self.atom_shapes[0]
        mode = self._mode
        if mode == 'valid':
            sample = tuple(t - a + 1 for t, a in zip(t0, a0))
        elif mode == 'full':
            sample = tuple(t + a - 1 for t, a in zip(t0, a0))
        else:
            sample = tuple(t0)
        self._plans = tuple(
            ConvPlan.create(mode, sample, a, precision=self._precision)
            for a in self.atom_shapes)
        n_channels = int(self._Ws[0].shape[1])
        self._strategies = tuple(
            engine.resolve_strategy('auto', p, m, n_channels,
                                    allow_dot=False)
            for p, m in zip(self._plans, self.n_atoms))

    def save_sharded(self, path: str, include_H: bool = True,
                     block: bool = True):
        """Distributed checkpoint of the per-scale banks (orbax): every
        device/host writes its own shards with shardings preserved — the
        multi-scale counterpart of the single-scale model's
        :meth:`~TransformInvariantNMF.save_sharded`, including the
        ``block=False`` asynchronous mode (drain with
        :meth:`wait_for_checkpoints`)."""
        import json
        import orbax.checkpoint as ocp

        if self._Ws is None:
            raise ValueError('nothing to save: the model has not been fit yet')
        self.wait_for_checkpoints()
        path = os.path.abspath(path)
        state = {f'W_{k}': w for k, w in enumerate(self._Ws)}
        if include_H and self._Hs is not None:
            state.update({f'H_{k}': h for k, h in enumerate(self._Hs)})
        ckptr = ocp.StandardCheckpointer()
        ckptr.save(os.path.join(path, 'state'), state)
        if block:
            ckptr.wait_until_finished()
        else:
            self._async_checkpointer = ckptr
        meta = dict(
            n_scales=self.n_scales,
            n_atoms=list(self.n_atoms),
            atom_shapes=[list(a) for a in self.atom_shapes],
            reconstruction_mode=self._mode,
            dtype=str(self._Ws[0].dtype),
            w_shapes=[list(w.shape) for w in self._Ws],
            h_shapes=([list(h.shape) for h in self._Hs]
                      if include_H and self._Hs is not None else None),
            version=1,
        )
        if jax.process_index() == 0:
            # with block=False orbax creates ``path`` in its background
            # thread, so the sidecar write must not rely on it existing yet
            os.makedirs(path, exist_ok=True)
            with open(os.path.join(path, 'tnmf_config.json'), 'w') as f:
                json.dump(meta, f)

    def wait_for_checkpoints(self):
        """Drain any in-flight :meth:`save_sharded` ``block=False`` write."""
        ckptr = getattr(self, '_async_checkpointer', None)
        if ckptr is not None:
            ckptr.wait_until_finished()
            self._async_checkpointer = None

    @classmethod
    def load_sharded(cls, path: str, mesh=None, **kwargs) -> 'MultiScaleTNMF':
        """Restore a :meth:`save_sharded` checkpoint; with ``mesh`` the
        state restores directly into its distributed layout (H banks
        sample-sharded, W banks replicated — each device reads only its
        own shards)."""
        import json
        import orbax.checkpoint as ocp

        path = os.path.abspath(path)
        with open(os.path.join(path, 'tnmf_config.json')) as f:
            meta = json.load(f)
        cfg = dict(
            n_atoms=tuple(meta['n_atoms']),
            atom_shapes=tuple(tuple(a) for a in meta['atom_shapes']),
            reconstruction_mode=meta['reconstruction_mode'],
            mesh=mesh,
        )
        cfg.update(kwargs)
        model = cls(**cfg)

        dtype = jnp.dtype(meta['dtype'])
        if mesh is not None:
            from ..parallel.sharding import data_sharding, replicated
            w_sh = {k: replicated(mesh) for k in range(model.n_scales)}
            h_sh = {k: data_sharding(mesh, len(s))
                    for k, s in enumerate(meta['h_shapes'] or [])}
        else:
            single = jax.sharding.SingleDeviceSharding(jax.devices()[0])
            w_sh = {k: single for k in range(model.n_scales)}
            h_sh = {k: single for k in range(model.n_scales)}
        target = {f'W_{k}': jax.ShapeDtypeStruct(tuple(s), dtype, sharding=w_sh[k])
                  for k, s in enumerate(meta['w_shapes'])}
        if meta['h_shapes'] is not None:
            target.update({
                f'H_{k}': jax.ShapeDtypeStruct(tuple(s), dtype, sharding=h_sh[k])
                for k, s in enumerate(meta['h_shapes'])})
        ckptr = ocp.StandardCheckpointer()
        state = ckptr.restore(os.path.join(path, 'state'), target)
        model._Ws = tuple(state[f'W_{k}'] for k in range(model.n_scales))
        if meta['h_shapes'] is not None:
            model._Hs = tuple(state[f'H_{k}'] for k in range(model.n_scales))
            model._restore_plans_from_h()
        return model
