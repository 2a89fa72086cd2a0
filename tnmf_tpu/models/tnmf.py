"""Transform-Invariant Non-Negative Matrix Factorization in JAX.

Public API compatible with the reference implementation
(``/root/reference/tnmf/TransformInvariantNMF.py``): the
:class:`TransformInvariantNMF` class keeps the constructor signature, the
``fit`` / ``fit_batch`` / ``fit_minibatches`` / ``fit_stream`` entry points,
the ``W`` / ``H`` / ``V`` / ``R`` accessors, ``R_partial``, the
``(model, iteration) -> bool`` progress-callback abort protocol and the
multiplicative-update semantics (Lee-Seung MU with sparsity, same-atom and
cross-atom lateral inhibition; minibatch algorithms 4-8 of Serizel, Essid &
Richard 2016).

What changed relative to the reference:

* The five interchangeable single-process backends (NumPy, NumPy_FFT,
  NumPy_CachingFFT, PyTorch, PyTorch_FFT) collapse into one jit-compiled
  XLA engine with internal strategies ('fft', 'conv', 'dot' and the
  phase-decomposed 'phased' lowering); the reference
  backend names are still accepted and mapped onto it.
* When no progress callback and no per-iteration logging are requested, the
  whole fit runs as a single fused on-device loop
  (:func:`tnmf_tpu.engine.fit_loop`).
* Optional data parallelism: pass ``mesh=`` (a ``jax.sharding.Mesh``) and
  samples/activations are sharded over its first axis, with the W-gradient
  sample reduction turning into an XLA all-reduce between devices.

References
----------
.. [1] D.D. Lee, H.S. Seung, 2000. Algorithms for Non-negative Matrix
   Factorization, NeurIPS 13.
.. [2] R. Serizel, S. Essid, G. Richard, 2016. Mini-batch stochastic
   approaches for accelerated multiplicative updates in nonnegative matrix
   factorisation with beta-divergence, MLSP 26.
"""

from __future__ import annotations

import logging
import math
import os
from enum import Enum
from itertools import count, islice
from typing import Callable, Iterable, Iterator, Optional, Tuple, Union

import numpy as np
import jax
import jax.numpy as jnp

from .. import engine
from .. import engine_hals
from ..ops import beta as beta_ops
from ..ops.inhibition import inhibition_kernels, resolve_inhibition_range
from ..ops.modes import ConvPlan
from ..utils.validation import require as _require, require_nonneg as _require_nonneg

sliceNone = slice(None)

#: program geometries already announced at DEBUG (the operational analogue
#: of the reference CachingFFT backend's per-miss cache logging,
#: ``NumPy_CachingFFT.py:93-117``: recompiles are the "cache misses" of the
#: XLA dataflow design, and they are otherwise silent)
_SEEN_PROGRAM_GEOMETRIES = set()


def _assert_nonnegative(V):
    """Reference precondition (TransformInvariantNMF.py:326); checked on
    device for jax arrays (one scalar transfer instead of copying V to
    host — device-resident inputs, e.g. prefetched batches, stay put).
    Raises ``ValueError`` (not a bare ``assert``, which would vanish under
    ``python -O``)."""
    if isinstance(V, jax.Array):
        ok = bool(jnp.all(V >= 0))
    else:
        ok = bool(np.all(np.asarray(V) >= 0))
    if not ok:
        raise ValueError('The input data V must be non-negative.')


def _trace_buf(n_iterations: int) -> int:
    """Static trace-buffer length for the ``tol``/``extrapolate`` +
    ``record_energies`` composition: the next power of two (min 64), so
    nearby ``n_iterations`` values share ONE compiled program instead of
    every distinct count triggering a fresh compile (compiles here cost
    30s-5min).  Entries past ``n_done`` stay NaN and are trimmed before
    they reach ``energies_``, so the padding is free of correctness
    impact."""
    return max(64, 1 << max(int(n_iterations) - 1, 0).bit_length())


def _validate_tol(tol, tol_check_every):
    """Public-API validation (``ValueError``, not ``assert`` — survives
    ``python -O``)."""
    if not tol >= 0:
        raise ValueError(f'tol must be >= 0, got {tol!r}')
    if not int(tol_check_every) >= 1:
        raise ValueError(
            f'tol_check_every must be >= 1, got {tol_check_every!r}')


def _compute_sequential_minibatches(length: int, batch_size: Optional[int]) -> Iterable[slice]:
    """Contiguous sample slices of at most ``batch_size``
    (reference ``TransformInvariantNMF.py:29-37``)."""
    if batch_size is None:
        yield sliceNone
    else:
        start = 0
        while start < length:
            end = min(length, start + batch_size)
            yield slice(start, end)
            start = end


class MiniBatchAlgorithm(Enum):
    """Minibatch MU schemes (algorithm numbers from Serizel et al. 2016;
    reference ``TransformInvariantNMF.py:47-55``)."""
    Cyclic_MU = 4   # H per batch; W from gradient summed over the epoch
    ASG_MU = 5      # shuffled batches; H then W update per batch
    GSG_MU = 6      # H per shuffled batch; single W update from the last batch
    ASAG_MU = 7     # per batch: H update + exp-averaged W gradient + W update
    GSAG_MU = 8     # H per batch; one exp-averaged W gradient + update per epoch


# reference backend names (accepted for drop-in compatibility) and native ones
_BACKEND_STRATEGY = {
    'auto': 'auto',
    'jax': 'auto',
    'jax_fft': 'fft',
    'jax_conv': 'conv',
    # reference names (tnmf/TransformInvariantNMF.py:168-176): the FFT family
    # maps to the fft strategy, the coordinate-space family to direct conv.
    'numpy': 'conv',
    'numpy_fft': 'fft',
    'numpy_caching_fft': 'fft',
    'pytorch': 'conv',
    'pytorch_fft': 'fft',
}


class TransformInvariantNMF:
    r"""Shift-invariant NMF via multiplicative updates, on XLA.

    Parameters
    ----------
    n_atoms : int
        Number of dictionary atoms; ``W`` has shape
        ``(n_atoms, n_channels, *atom_shape)``.
    atom_shape : Tuple[int, ...]
        Spatial shape of the atoms (1-D, 2-D, ... signals).
    inhibition_range : int | Tuple[int, ...], optional
        Lateral inhibition range per shift axis; defaults to
        ``atom_shape - 1`` (atoms cannot overlap without penalty).
    backend : str, default 'auto'
        ``'auto'`` / ``'jax'`` selects the strategy by a FLOPs heuristic;
        ``'jax_fft'`` / ``'jax_conv'`` force it.  The reference backend names
        (``'numpy'``, ``'numpy_fft'``, ``'numpy_caching_fft'``, ``'pytorch'``,
        ``'pytorch_fft'``) are accepted for drop-in compatibility.
    logger : logging.Logger, optional
    verbose : {0, 1, 2, 3}, default 0
        0 errors, 1 warnings, 2 info, 3 debug.
    reconstruction_mode : {'valid', 'full', 'circular', 'reflect'}, default 'valid'
    dtype : optional
        Compute dtype. Defaults to float32 (float64 when jax x64 is enabled
        and the input is float64).
    mesh : jax.sharding.Mesh, optional
        If given, V and H are sharded along ``mesh`` axis 0 (data
        parallelism); W stays replicated and its gradient reduction becomes
        an XLA ``psum`` over the interconnect.
    seed : int, optional
        If given, W/H initialization and batch shuffling use a private
        ``np.random.Generator`` instead of the global NumPy RNG.  The default
        (None) consumes the *global* NumPy stream in the exact same order as
        the reference, so ``np.random.seed(42)``-seeded runs are directly
        comparable.
    fft_policy : {'5-smooth', 'pow2'}, default '5-smooth'
        FFT padded-length policy for the fft strategy.
    init : {'host', 'device'}, default 'host'
        'host' draws W/H with NumPy (reference RNG parity). 'device' draws
        them on the accelerator from a JAX PRNG key (seeded by ``seed``) —
        required at scales where H exceeds host memory, and materializes H
        directly in its sharded layout under ``mesh``.
    shard_axis : {'samples', 'spatial', 'both', 'atoms', 'samples+atoms'}, default 'samples'
        With ``mesh``: 'samples' is data parallelism over the sample axis;
        'spatial' shards the first spatial axis of V/H instead — for very
        large individual images, with conv halo exchange inserted by the
        SPMD partitioner (use with the 'conv' strategy); 'both' combines the
        two on a 2-D mesh from ``tnmf_tpu.parallel.make_mesh_2d``. 'atoms'
        is model (tensor) parallelism over the dictionary — W and the atom
        axis of H shard, for atom counts too large for one device;
        'samples+atoms' combines data and atom parallelism on a 2-D mesh
        from ``tnmf_tpu.parallel.make_mesh_2d_atoms``.
    beta_loss : float or str, optional
        Reconstruction objective: the beta-divergence D_beta(V || R).
        ``2.0`` / ``'frobenius'`` (default) is the reference's squared
        Euclidean energy; ``1.0`` / ``'kullback-leibler'`` and ``0.0`` /
        ``'itakura-saito'`` (or any float) generalize it — a capability the
        reference cites (Serizel et al. 2016) but does not implement.  All
        fit drivers, strategies, regularizers, meshes and the serving API
        honor it; ``energies_`` and ``tol`` then track the divergence.
        ``beta_loss <= 0`` requires strictly positive data.
    precision : {None, 'default', 'high', 'highest'}, optional
        Multiply precision of convolutions and matmuls. On a GPU the
        default runs float32 products in TF32 with float32 accumulation
        (fastest); 'highest' forces full float32 multiplies for tighter
        float32 trajectories.
    transform_type : {'shift', 'shift+flip', 'shift+rot90', 'shift+rot90+flip'}, default 'shift'
        The invariance transform set.  ``'shift'`` is the reference's model
        (shift invariance only; other transform types are explicitly
        deferred there, ``TransformInvariantNMF.py:65-69``).  The extended
        types additionally match every atom under mirror flips
        (``2**ndim`` transforms), quarter-turn rotations (4; requires
        square atoms in the last two axes), or both (the dihedral group
        D4, 8) — each canonical atom is learned once and tied across its
        transformed copies, with one activation map per (atom, transform):
        ``H`` gains a transform axis, ``(n_samples, n_atoms, n_transforms,
        *shift)``.  Lateral inhibition then acts per activation map, and
        cross-atom inhibition spans all ``n_atoms * n_transforms`` maps.
        A custom ``tnmf_tpu.ops.transforms.TransformGroup`` is also
        accepted.  See :mod:`tnmf_tpu.ops.transforms`.
    w_init : {'random', 'patches', 'nndsvd'}, default 'random'
        Dictionary initialization scheme (the reference only has uniform
        random, ``_Backend.py:83-98``).  ``'patches'`` starts every atom as
        an atom-shaped window cut from the data at a random (sample,
        position) — the dictionary-learning warm start; any geometry.
        ``'nndsvd'`` is sklearn's deterministic ``NMF(init='nndsvda')``
        scheme (Boutsidis & Gallopoulos 2008; zeros filled with the data
        mean so MU can move them) initializing W *and* H — plain-NMF
        geometry only (``'full'`` mode with atom-sized samples).  Both are
        data-dependent host-side schemes (require ``init='host'``); seeded
        cross-library RNG parity applies to ``'random'`` only.  See
        :mod:`tnmf_tpu.utils.initialization`.
    h_init : {'random', 'correlate'}, default 'random'
        Activation initialization.  ``'correlate'`` is the matched-filter
        start ``H0 = c * (V star W)`` with the least-squares-optimal scale
        ``c`` (:func:`tnmf_tpu.engine.correlate_init_H`): deterministic
        (no RNG consumed for H), computed entirely on device (no host
        draw or H-sized upload — it also makes ``transform`` serving
        fully deterministic for a fixed dictionary), and typically
        reaches a given energy in fewer iterations than the reference's
        uniform draw.  Applies wherever H would be freshly drawn
        (``keep_H=True`` still wins).
    """

    def __init__(
            self,
            n_atoms: int,
            atom_shape: Tuple[int, ...],
            inhibition_range: Union[int, Tuple[int, ...], None] = None,
            backend: str = 'auto',
            logger: Optional[logging.Logger] = None,
            verbose: int = 0,
            reconstruction_mode: str = 'valid',
            dtype=None,
            mesh=None,
            seed: Optional[int] = None,
            fft_policy: str = '5-smooth',
            init: str = 'host',
            shard_axis: str = 'samples',
            precision: Optional[str] = None,
            beta_loss: Union[float, str] = 2.0,
            transform_type: str = 'shift',
            w_init: str = 'random',
            h_init: str = 'random',
    ):
        # raw constructor arguments, captured before any processing — the
        # sklearn estimator protocol (get_params/set_params/clone) hands
        # these back unmodified
        self._init_params = dict(
            n_atoms=n_atoms, atom_shape=atom_shape,
            inhibition_range=inhibition_range, backend=backend,
            logger=logger, verbose=verbose,
            reconstruction_mode=reconstruction_mode, dtype=dtype, mesh=mesh,
            seed=seed, fft_policy=fft_policy,
            init=init, shard_axis=shard_axis, precision=precision,
            beta_loss=beta_loss, transform_type=transform_type,
            w_init=w_init, h_init=h_init)
        self.atom_shape = tuple(int(a) for a in atom_shape)
        self.n_atoms = int(n_atoms)
        from ..ops.transforms import make_group
        self._group = make_group(transform_type, self.atom_shape)
        self.transform_type = (transform_type if isinstance(transform_type, str)
                               else self._group.name)
        self.n_transforms = 1 if self._group is None else self._group.size
        self._inhibition_range = resolve_inhibition_range(inhibition_range, self.atom_shape)
        self._inhibition_kernels_1D = inhibition_kernels(self._inhibition_range)
        self._axes_W_normalization = tuple(range(-len(self.atom_shape), 0))
        self.eps = engine.EPS
        self._beta = beta_ops.resolve_beta_loss(beta_loss)

        try:
            self._strategy_request = _BACKEND_STRATEGY[backend.lower()]
        except KeyError as e:
            raise KeyError(
                f'unknown backend {backend!r}; choose one of {sorted(_BACKEND_STRATEGY)}') from e
        self._reconstruction_mode = reconstruction_mode
        self._fft_policy = fft_policy
        self._dtype = dtype
        self._mesh = mesh
        self._shard_axis = shard_axis
        self._precision = precision
        if init not in ('host', 'device'):
            raise ValueError(f"init must be 'host' or 'device', got {init!r}")
        self._init = init
        if w_init not in ('random', 'patches', 'nndsvd'):
            raise ValueError(
                f"w_init must be 'random', 'patches' or 'nndsvd', got {w_init!r}")
        if w_init != 'random' and init == 'device':
            raise ValueError(
                f"w_init={w_init!r} is a data-dependent host-side scheme; "
                "it requires init='host'")
        if w_init == 'nndsvd' and self._group is not None:
            raise ValueError(
                "w_init='nndsvd' applies to the plain-NMF geometry only and "
                "does not combine with transform groups")
        self._w_init = w_init
        if h_init not in ('random', 'correlate'):
            raise ValueError(
                f"h_init must be 'random' or 'correlate', got {h_init!r}")
        if h_init == 'correlate' and w_init == 'nndsvd':
            raise ValueError(
                "w_init='nndsvd' already initializes H from the SVD; it "
                "does not combine with h_init='correlate'")
        self._h_init = h_init
        self._device_key = jax.random.PRNGKey(seed if seed is not None else 0)
        self._rng = np.random.default_rng(seed) if seed is not None else np.random

        self._logger = logger if logger is not None else logging.getLogger(self.__class__.__name__)
        self._logger.setLevel([logging.ERROR, logging.WARNING, logging.INFO, logging.DEBUG][verbose])
        self._logger.debug('Using %s backend (strategy request: %s).', backend, self._strategy_request)

        # fit-time state
        self._plan: Optional[ConvPlan] = None
        self._strategy: Optional[str] = None
        self._W = None
        self._H = None
        self._V = None      # host copy (possibly shuffled) for the V property
        self._Vp = None     # device-side prepared (transformed/extended) data
        self._mask_d = None  # device-side per-entry mask/weights (or None)
        self._kernels = None
        self._shuffle_idx = None
        # iteration stamp of the checkpoint this model was loaded from
        # (None unless load() found one; see save(completed_iterations=...))
        self.last_checkpoint_iteration_: Optional[int] = None
        # iterations actually run by the last fit_batch (sklearn n_iter_
        # semantics: < n_iterations when tol or a callback stopped early)
        self.n_iterations_: Optional[int] = None
        # online-learning state (partial_fit): exponentially averaged
        # (neg, pos) W statistics carried across calls, and the number of
        # partial_fit steps taken (sklearn MiniBatchNMF n_steps_ semantics)
        self._sag_stat_ = None
        self.n_steps_: int = 0
        # per-(mini)batch regularizer scalars for the Python batch-step
        # helpers (set by fit_minibatches / partial_fit; None = absent)
        self._mb_l2 = None
        self._mb_ortho = None

    # ------------------------------------------------------------------
    # accessors (reference TransformInvariantNMF.py:188-215)
    # ------------------------------------------------------------------

    @property
    def n_iter_(self) -> Optional[int]:
        """sklearn-style alias of ``n_iterations_`` (iterations the last
        fit actually ran — relevant under ``tol`` / callback abort)."""
        return self.n_iterations_

    @property
    def reconstruction_err_(self) -> float:
        """sklearn ``NMF``-compatible reconstruction error of the last fit:
        ``sqrt(2 * D_beta(V || R))`` for every beta (exactly
        ``sklearn.decomposition._nmf._beta_divergence(..., square_root=True)``;
        for the Frobenius case this is ‖V−R‖_F since the internal objective
        is ½‖V−R‖², ``_Backend.py:127-130``).  Computed lazily (one
        reconstruction) on first access after a fit."""
        if self._plan is None:
            raise RuntimeError('reconstruction_err_ requires a fitted model')
        return float(np.sqrt(max(2.0 * self._energy_function(), 0.0)))

    @property
    def W(self) -> np.ndarray:
        return np.asarray(self._W)

    @property
    def H(self) -> np.ndarray:
        """Activations ``(n_samples, n_atoms, *shift)``; with a non-trivial
        ``transform_type``, ``(n_samples, n_atoms, n_transforms, *shift)``
        (one shift map per tied transformed copy of each atom)."""
        H = self._H_flat()
        if self.n_transforms > 1:
            H = H.reshape((H.shape[0], self.n_atoms, self.n_transforms)
                          + H.shape[2:])
        return H

    def _H_flat(self) -> np.ndarray:
        """De-shuffled activations in the internal m-major flat layout
        ``(n_samples, n_atoms * n_transforms, *shift)``."""
        H = np.asarray(self._H)
        if self._shuffle_idx is None:
            return H
        return H[np.argsort(self._shuffle_idx)]

    @property
    def V(self) -> np.ndarray:
        if self._V is None:
            raise RuntimeError(
                'V is not host-addressable under a process-spanning mesh; '
                'access the per-process shards of the global array instead')
        if self._shuffle_idx is None:
            return np.asarray(self._V)
        return np.asarray(self._V)[np.argsort(self._shuffle_idx)]

    @property
    def R(self) -> np.ndarray:
        return np.asarray(self._reconstruct())

    def R_partial(self, i_atom: int) -> np.ndarray:
        return np.asarray(engine.partial_reconstruct(
            self._W, self._H, plan=self._plan, strategy=self._strategy, i_atom=int(i_atom)))

    def _reconstruct(self):
        return engine.reconstruct(self._W, self._H, plan=self._plan, strategy=self._strategy)

    def _assert_beta_domain(self, V, mask=None):
        """``beta_loss <= 0`` (Itakura-Saito family) needs strictly positive
        data: D_beta(v || r) diverges as v -> 0 for beta <= 0 (same contract
        as sklearn.decomposition.NMF).  Masked-out entries are exempt —
        they never enter the objective."""
        if self._beta > 0:
            return
        if isinstance(V, jax.Array) and not V.is_fully_addressable:
            if mask is not None and isinstance(mask, jax.Array):
                ok = bool(jnp.all(jnp.where(mask > 0, V > 0, True)))
            else:
                ok = bool(jnp.all(V > 0))
        elif mask is not None:
            Vc = np.asarray(V)
            observed = np.broadcast_to(np.asarray(mask), Vc.shape) > 0
            ok = bool(np.all(Vc[observed] > 0))
        else:
            ok = bool(np.all(np.asarray(V) > 0))
        if not ok:
            raise ValueError(
                f'beta_loss = {self._beta} (Itakura-Saito family) requires '
                'strictly positive data, but V contains zeros')

    def _energy_function(self) -> float:
        # _Vd is stored in fit order, matching the device-side H
        return float(engine.energy(self._Vd, self._W, self._H,
                                   getattr(self, '_mask_d', None),
                                   plan=self._plan, strategy=self._strategy,
                                   beta=self._beta))

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------

    def _resolve_dtype(self, V: np.ndarray):
        if self._dtype is not None:
            return jnp.dtype(self._dtype)
        if jax.config.jax_enable_x64 and V.dtype == np.float64:
            return jnp.dtype(np.float64)
        return jnp.dtype(np.float32)

    def _prepare_mask(self, mask, V, dtype):
        """Validate / device-place a per-entry mask (missing-data zeros or
        nonnegative float weights), broadcastable to V's shape."""
        if mask is None:
            self._mask_d = None
            return
        if self._global_input:
            # process-spanning fits: the mask must be distributed exactly
            # like V (each host wraps its local slice with
            # parallel.distributed.distribute_samples) — no host ever holds
            # the full mask, mirroring the V contract
            if not (isinstance(mask, jax.Array)
                    and not mask.is_fully_addressable):
                raise ValueError(
                    'under a process-spanning global V the mask must itself '
                    'be a process-spanning global array of the same shape; '
                    'wrap the per-host slice with '
                    'parallel.distributed.distribute_samples(mesh, mask_local)')
            if tuple(mask.shape) != tuple(V.shape):
                raise ValueError(
                    f'global mask of shape {tuple(mask.shape)} must match V '
                    f'{tuple(V.shape)} (broadcasting is not supported across '
                    f'process-spanning shards)')
            if bool(jnp.any(mask < 0)):  # device-side: one replicated scalar
                raise ValueError('mask entries must be nonnegative '
                                 '(0/1 for missing data, floats for weights)')
            self._mask_d = mask.astype(dtype)
            return
        mask = np.asarray(mask)
        if mask.ndim != np.ndim(V):
            raise ValueError(
                f'mask must have the same rank as V ({np.ndim(V)}), got '
                f'{mask.ndim}; use singleton axes to broadcast')
        try:
            np.broadcast_shapes(mask.shape, np.shape(V))
        except ValueError as e:
            raise ValueError(
                f'mask of shape {mask.shape} does not broadcast to V '
                f'{np.shape(V)}') from e
        if np.any(mask < 0):
            raise ValueError('mask entries must be nonnegative '
                             '(0/1 for missing data, floats for weights)')
        md = jnp.asarray(mask, dtype=dtype)
        if self._mesh is not None:
            if mask.shape != np.shape(V):
                raise ValueError(
                    'under a mesh the mask must have the full data shape '
                    f'{np.shape(V)} (broadcasting across shards is not '
                    f'supported), got {mask.shape}')
            md = jax.device_put(md, self._Vd.sharding)
        self._mask_d = md

    def _mask_slice(self, s):
        """Mask rows for a sample slice (broadcast masks serve every batch)."""
        if self._mask_d is None:
            return None
        return self._mask_d[s] if self._mask_d.shape[0] != 1 else self._mask_d

    def _initialize_matrices(self, V: np.ndarray, keep_W: bool, shuffle_input: bool = False,
                             allow_phased: bool = True, keep_H: bool = False,
                             mask=None):
        # multi-host path: a process-spanning global jax.Array (from
        # parallel.distributed.distribute_samples) is used as-is — no host
        # copy exists or is ever materialized
        global_input = isinstance(V, jax.Array) and not V.is_fully_addressable
        if global_input:
            if self._mesh is None or self._init != 'device':
                raise ValueError(
                    "a process-spanning global array requires mesh=... and "
                    "init='device' (no host ever holds the full batch)")
            if shuffle_input:
                raise ValueError('input shuffling is unavailable for global arrays')
            self._shuffle_idx = None
            self._V = None  # V property raises; per-shard access via jax APIs
        elif isinstance(V, jax.Array) and not shuffle_input:
            # device-resident input (e.g. a batch from
            # utils.pipeline.prefetch_to_device): keep it on device — no
            # host round trip; the V property materializes lazily
            self._shuffle_idx = None
            self._V = V
        else:
            V = np.asarray(V)
            if shuffle_input:
                self._shuffle_idx = self._rng.permutation(len(V))
                V = V[self._shuffle_idx]
                if mask is not None and np.shape(mask)[0] == len(V):
                    mask = np.asarray(mask)[self._shuffle_idx]
            else:
                self._shuffle_idx = None
            self._V = V
        self._global_input = global_input

        sample_shape = V.shape[2:]
        self._plan = ConvPlan.create(self._reconstruction_mode, sample_shape, self.atom_shape,
                                     self._fft_policy, precision=self._precision)
        # the lowering policy (engine.resolve_strategy) picks conv or fft
        # and may upgrade to the phase-decomposed or matmul lowerings.  Excluded:
        # spatially-sharded meshes (halo exchange is validated on the
        # canonical grid only).
        canonical_layout_ok = not (self._mesh is not None
                                   and self._shard_axis in ('spatial', 'both'))
        allow_phased = allow_phased and canonical_layout_ok
        # under a transform group H carries n_atoms * n_transforms maps —
        # that is the channel count the phased-applicability cost model sees.
        # allow_dot tracks only the canonical-layout gate: the matmul
        # lowering wins at every batch size
        strategy = engine.resolve_strategy(
            self._strategy_request, self._plan,
            self.n_atoms * self.n_transforms, V.shape[1], allow_phased,
            allow_dot=canonical_layout_ok)
        if self._group is not None:
            # transform-group adapter: the base strategy runs on the tied
            # expanded dictionary (tnmf_tpu.ops.transforms).  Sample/atom
            # meshes compose: W shards along its canonical atom axis and the
            # m-major expansion keeps every atom's G tied copies (and H's
            # m-major maps, sharded the same way) on that atom's shard, so
            # the expand/tie-back ops are shard-local and the only
            # collective stays the reconstruction's atom all-reduce
            # (validated vs single-device in tests/test_transforms.py and
            # the driver dryrun).  Spatial meshes shard the conv grid and
            # remain unvalidated with groups.
            if self._mesh is not None and self._shard_axis in ('spatial', 'both'):
                raise ValueError(
                    f"transform_type={self.transform_type!r} supports "
                    f"shard_axis='samples', 'atoms' or 'samples+atoms' "
                    f"under a mesh (got {self._shard_axis!r})")
            strategy = (strategy, self._group)
        self._strategy = strategy
        dtype = self._resolve_dtype(V)

        keep = keep_W and self._W is not None
        if keep:
            expected = (self.n_atoms, V.shape[1]) + self.atom_shape
            if tuple(self._W.shape) != expected:
                raise ValueError(
                    f'keep_W: existing dictionary of shape {tuple(self._W.shape)} '
                    f'does not match the new data (expected {expected}); '
                    f'the channel count must stay constant across fits')
        n_maps = self.n_atoms * self.n_transforms  # atom channels of H
        keep_h = keep_H and self._H is not None
        if keep_h:
            expected_h = (V.shape[0], n_maps) + self._plan.transform_shape
            if tuple(self._H.shape) != expected_h:
                raise ValueError(
                    f'keep_H: existing activations of shape {tuple(self._H.shape)} '
                    f'do not match the new data (expected {expected_h}); '
                    f'exact resume requires the same batch')
        if self._init == 'device':
            # At-scale path: W/H drawn on device from a JAX PRNG key — with a
            # mesh, H is constrained to its sharded layout inside the init
            # program, so it is materialized directly across the devices and
            # never exists unsharded anywhere (it can exceed any single
            # device's memory for large fits).
            self._device_key, sub = jax.random.split(self._device_key)
            h_shape = (V.shape[0], n_maps) + self._plan.transform_shape
            shardings = {}
            if self._mesh is not None:
                from ..parallel.sharding import h_sharding, w_sharding
                shardings = dict(
                    h_sharding=h_sharding(self._mesh, len(h_shape), self._shard_axis),
                    w_sharding=w_sharding(self._mesh, 2 + self._plan.ndim, self._shard_axis))
            Wd, Hd = engine.init_matrices(
                sub,
                w_shape=(self.n_atoms, V.shape[1]) + self.atom_shape,
                h_shape=h_shape,
                n_shift_axes=self._plan.ndim, dtype=dtype, init_W=not keep,
                **shardings)
            if keep:
                Wd = jnp.asarray(self._W, dtype=dtype)
            if keep_h:
                Hd = jnp.asarray(self._H, dtype=dtype)
        else:
            # Host-side init replicating the reference RNG stream exactly
            # (H then W, 1 - U[0,1); _Backend.py:83-98) so seeded runs match.
            # (np.random.random and Generator.random share this signature.)
            # keep_H (exact resume) skips the H draw — RNG-stream parity
            # with the reference is moot when resuming from a checkpoint.
            if keep_h:
                H = np.asarray(self._H)
            elif self._h_init == 'correlate':
                H = None  # matched-filter init, computed on device below —
                # no host draw and no host->device upload of an H-sized array
            else:
                H = np.asarray(
                    1 - self._rng.random((V.shape[0], n_maps) + self._plan.transform_shape),
                    dtype=V.dtype)
            if keep:
                W = np.asarray(self._W)
            elif self._w_init == 'patches':
                # data-dependent warm start: atoms begin as data windows
                # (tnmf_tpu.utils.initialization); consumes the RNG stream
                # differently from the reference, so seeded cross-library
                # parity applies to w_init='random' only
                from ..utils.initialization import patches_init
                W = patches_init(np.asarray(V), self.n_atoms,
                                 self.atom_shape, self._rng).astype(V.dtype)
                W /= W.sum(axis=self._axes_W_normalization, keepdims=True)
            elif self._w_init == 'nndsvd':
                if math.prod(self._plan.transform_shape) != 1:
                    raise ValueError(
                        "w_init='nndsvd' applies to the plain-NMF geometry "
                        "only (reconstruction_mode='full' with atom_shape =="
                        ' sample_shape); use w_init=\'patches\' for '
                        'transform-invariant problems')
                from ..utils.initialization import nndsvda_init
                X = np.asarray(V, dtype=np.float64).reshape(V.shape[0], -1)
                A, B = nndsvda_init(X, self.n_atoms)
                W = B.reshape((self.n_atoms, V.shape[1]) + self.atom_shape)
                s = W.sum(axis=self._axes_W_normalization, keepdims=True)
                W = (W / s).astype(V.dtype)
                if not keep_h:
                    # rescale H so the product A @ B is preserved under the
                    # model's sum-normalized-atoms invariant
                    H = (A * s.reshape(1, self.n_atoms)).reshape(
                        (V.shape[0], n_maps)
                        + self._plan.transform_shape).astype(V.dtype)
            else:
                W = np.asarray(
                    1 - self._rng.random((self.n_atoms, V.shape[1]) + self.atom_shape),
                    dtype=V.dtype)
                W /= W.sum(axis=self._axes_W_normalization, keepdims=True)
            Wd = jnp.asarray(W, dtype=dtype)
            Hd = (jnp.zeros((V.shape[0], n_maps) + self._plan.transform_shape,
                            dtype)
                  if H is None else jnp.asarray(H, dtype=dtype))

        self._kernels = tuple(jnp.asarray(k, dtype=dtype) for k in self._inhibition_kernels_1D)

        self._W = Wd
        self._H = Hd
        if global_input:
            if jnp.dtype(V.dtype) != dtype:
                raise ValueError(
                    f'global array dtype {V.dtype} must match the compute dtype {dtype}')
            Vd = V  # already sharded across the process-spanning mesh
            from ..parallel.sharding import replicated
            self._W = jax.device_put(self._W, replicated(self._mesh))
        else:
            Vd = jnp.asarray(V, dtype=dtype)
            if self._mesh is not None:
                from ..parallel.sharding import shard_model_state
                Vd, self._W, self._H = shard_model_state(
                    self._mesh, Vd, self._W, self._H, axis=self._shard_axis)
        self._Vd = Vd
        self._prepare_mask(mask, V, dtype)
        # beta != 2: the gradient factors A = V * R**(beta-2), B = R**(beta-1)
        # depend on R.  For the strategies whose prepared domain is
        # elementwise-compatible (conv/phased/dot: engine.beta_prepares_data)
        # the loop-invariant prepare(V) is still passed and the factors are
        # computed directly on prepared tensors — no per-iteration
        # re-preparation; the fft strategy (spectral prepared domain) and
        # masked beta fits receive the canonical data tensor instead
        # (engine._beta_factors docstring).  With a mask (beta = 2) the
        # loop-invariant transform is prepare(mask * V): both gradient
        # halves of the weighted objective correlate mask-weighted
        # V-shaped streams (engine._mu_H docstring).
        if self._beta != 2.0:
            if self._mask_d is None and engine.beta_prepares_data(self._strategy):
                self._Vp = engine.prepare_data(Vd, plan=self._plan,
                                               strategy=self._strategy)
            else:
                self._Vp = Vd
        elif self._mask_d is not None:
            self._Vp = engine.prepare_data(Vd * self._mask_d.astype(Vd.dtype),
                                           plan=self._plan, strategy=self._strategy)
        else:
            self._Vp = engine.prepare_data(Vd, plan=self._plan, strategy=self._strategy)
        if self._h_init == 'correlate' and not keep_h:
            # matched-filter start (engine.correlate_init_H): deterministic,
            # on device, sharded inputs yield sharded H.  With a mask the
            # prepared tensor already carries prepare(mask*V) — the right
            # matched filter for the masked objective; only the masked /
            # fft beta != 2 configurations hold the canonical V in the
            # prepared slot, so prepare it here for those.
            Vp0 = self._Vp
            if self._beta != 2.0 and (
                    self._mask_d is not None
                    or not engine.beta_prepares_data(self._strategy)):
                Vp0 = engine.prepare_data(Vd, plan=self._plan,
                                          strategy=self._strategy)
            self._H = engine.correlate_init_H(
                Vp0, Vd, self._W, plan=self._plan, strategy=self._strategy,
                n_atoms=self.n_atoms)

        # compile observability: announce first-seen program geometries at
        # DEBUG.  Each new (plan, strategy, batch, dtype) combination means
        # the next dispatches trigger XLA compiles (seconds to minutes);
        # repeats of a seen geometry are compile-cache hits.
        geo_key = (self._plan, str(self._strategy), V.shape[0], str(dtype))
        if geo_key not in _SEEN_PROGRAM_GEOMETRIES:
            _SEEN_PROGRAM_GEOMETRIES.add(geo_key)
            self._logger.debug(
                'new program geometry: strategy=%s mode=%s sample=%s atom=%s '
                'n_samples=%d dtype=%s — first dispatches will compile; '
                'later fits with this geometry hit the compile cache',
                self._strategy, self._plan.mode, self._plan.sample_shape,
                self._plan.atom_shape, V.shape[0], dtype)

    # ------------------------------------------------------------------
    # batch fitting (reference fit_batch, TransformInvariantNMF.py:282-348)
    # ------------------------------------------------------------------

    def fit_batch(
            self,
            V: np.ndarray,
            n_iterations: int = 1000,
            update_H: bool = True,
            update_W: bool = True,
            keep_W: bool = False,
            sparsity_H: float = 0.,
            inhibition_strength: float = 0.,
            cross_atom_inhibition_strength: float = 0.,
            l2_H: float = 0.,
            ortho_W: float = 0.,
            progress_callback: Optional[Callable[['TransformInvariantNMF', int], bool]] = None,
            callback_interval: int = 1,
            record_energies: bool = False,
            keep_H: bool = False,
            checkpoint_every: Optional[int] = None,
            checkpoint_path: Optional[str] = None,
            tol: Optional[float] = None,
            tol_check_every: int = 10,
            mask=None,
            revive_every: Optional[int] = None,
            revive_threshold: float = 1e-4,
            extrapolate=False,
            solver: str = 'mu',
            hals_inner='auto',
            sparsity_W: float = 0.,
            l2_W: float = 0.,
    ):
        r"""Full-batch multiplicative-update factorization of ``V``.

        Parameters follow the reference (``TransformInvariantNMF.py:282-325``):
        ``V`` has shape ``(n_samples, n_channels, *sample_shape)``;
        ``n_iterations`` bounds the number of H+W updates; ``update_H`` /
        ``update_W`` freeze a factor; ``keep_W`` warm-starts from the current
        dictionary; ``sparsity_H``, ``inhibition_strength`` and
        ``cross_atom_inhibition_strength`` weight the regularizers; and
        ``progress_callback(model, iteration) -> bool`` is invoked after
        every iteration, aborting the fit when it returns False.

        Extensions over the reference:

        * ``callback_interval > 1`` invokes the callback only every k-th
          iteration, running fully fused on-device chunks in between —
          recommended where per-iteration dispatch is expensive.
        * ``record_energies=True`` stores the per-iteration energy trace and
          exposes it afterwards as ``self.energies_`` at the cost of one
          extra reconstruction per iteration.  Without a callback the trace
          is accumulated fully on device; with one, it is recorded alongside
          the callback protocol.
        * ``checkpoint_every=k`` with ``checkpoint_path=...`` writes an
          atomic full checkpoint (W + H + iteration stamp) every ``k``
          iterations, running fully fused on-device chunks in between — one
          host round trip per ``k`` instead of per iteration.  After a
          crash, exact resume is
          ``m = load(path); m.fit_batch(V, n_iterations=total -
          m.last_checkpoint_iteration_, keep_W=True, keep_H=True)`` —
          multiplicative updates are deterministic in (V, W, H), so the
          resumed trajectory is identical to an uninterrupted run.
        * ``keep_H=True`` continues from the current activations instead of
          re-initializing them (requires matching batch geometry; the
          resume half of the checkpointing protocol).
        * ``tol`` enables sklearn-style early stopping: every
          ``tol_check_every`` iterations the relative energy improvement
          ``(e_prev - e) / e_init`` is evaluated *on device* (the whole
          adaptive fit is one dispatch — no host round trip per check) and
          the fit stops once it drops below ``tol`` or at ``n_iterations``.
          The actual iteration count lands in ``self.n_iterations_``.
          Composes with ``record_energies`` (the trace is accumulated
          inside the same on-device loop and trimmed to the iterations
          actually run); incompatible with callbacks.
        * ``mask`` enables masked / weighted factorization (no reference
          counterpart): an array broadcastable to ``V`` whose entries
          weight the objective per data point — zeros mark *missing*
          values that neither gradients nor the energy ever see (fit on
          incomplete data, then ``inverse_transform`` imputes them), and
          general nonnegative floats give per-entry confidence weights.
          Exact MU semantics: both gradient halves are correlations of
          mask-weighted V-shaped streams, so the masked objective's
          update costs one extra elementwise multiply per iteration.
        * ``l2_H`` adds a ridge penalty ``(l2_H/2)*||H||_2^2`` to the
          objective (sklearn's ``alpha_H`` L2 term; the reference only has
          the L1 ``sparsity_H``): its gradient joins the positive MU part,
          shrinking activations smoothly instead of sparsifying them.
        * ``ortho_W`` adds a cross-atom orthogonality (dictionary
          diversity) penalty ``(ortho_W/2)*sum_{m != m'} <W_m, W_m'>``
          (Choi-style orthogonal NMF; no reference counterpart): entries
          where *other* atoms carry mass are multiplicatively shrunk, which
          suppresses duplicate atoms — the common MU pathology that
          :func:`tnmf_tpu.utils.atoms.find_dead_atoms` revival cannot fix
          (two atoms converged onto the same feature are both alive).
          Recorded/logged energies remain the pure reconstruction
          divergence, like the reference's.
        * ``extrapolate=True`` (or a float initial momentum weight in
          ``(0, 1)``; True means 0.5) accelerates the fit with
          Ang & Gillis 2019-style extrapolation with restarts: each MU
          update is computed at ``Y = X_new + beta_k (X_new - X_old)``
          projected to the nonnegative orthant, with an on-device
          safeguard every ``tol_check_every`` iterations that halves
          ``beta_k`` and resets ``Y = X`` whenever the energy increased —
          typically reaching a given tolerance in substantially fewer
          iterations at ~zero extra per-iteration cost (the reference's
          plain Lee-Seung MU has no acceleration).  Composes with ``tol``
          (recommended: that is where fewer-iterations pays off), all
          regularizers/masks/strategies/meshes, and ``record_energies``
          (the accepted-iterate energy trace is accumulated inside the
          on-device loop, so the acceleration is observable at the usual
          one-extra-reconstruction-per-iteration cost); incompatible with
          callbacks, ``checkpoint_every`` and ``revive_every`` (the
          accelerated loop runs as one on-device ``while_loop``, no host
          round trips).  The trajectory differs from plain MU by
          design; energies land within the same converged basin
          (``tests/test_extrapolation.py``).
        * ``solver='hals'`` replaces the multiplicative updates with exact
          block coordinate descent (fast HALS, Cichocki & Phan 2009 — the
          algorithm behind sklearn's ``NMF(solver='cd')``; no reference
          counterpart, the reference is MU-only): each component is
          solved exactly per pass, so a given tolerance is typically
          reached in far fewer iterations, and zero is *not* absorbing
          (collapsed atoms re-enter on their own — ``revive_every`` is
          unnecessary and rejected).  Two geometries apply: the
          degenerate plain-NMF corner (``prod(transform_shape) == 1``,
          any mode — :mod:`tnmf_tpu.engine_hals`), and the full
          shift-invariant problem under ``reconstruction_mode='full'``,
          where exact H coordinate descent runs via phase-blocked sweeps
          (activations spaced one atom apart have disjoint footprints,
          so each phase solves independent shared-Gram HALS problems;
          W steps stay multiplicative — :mod:`tnmf_tpu.engine_hals_conv`;
          ``sparsity_W``/``l2_W`` are plain-NMF-only there).  Other
          modes' boundary-clipped footprints are rejected.
          ``hals_inner`` sets how many component sweeps reuse each pair of
          Gram matrices (the accelerated variant of Gillis & Glineur
          2012); ``'auto'`` scales it with the feature/component cost
          ratio.  Composes with ``sparsity_H`` (L1), ``l2_H``,
          ``sparsity_W``/``l2_W`` (dictionary-side L1/L2 — sklearn's
          ``alpha_H`` under the name swap; HALS-only, since MU
          sum-normalizes atoms which makes W penalties ill-posed),
          ``update_H/update_W``, ``keep_W/keep_H``, ``tol``,
          ``record_energies``, callbacks/checkpointing, bfloat16, and
          ``shard_axis='samples'`` meshes.  MU-only features are rejected:
          inhibition, ``ortho_W``, masks, ``beta_loss != 2``, transform
          groups, ``extrapolate``.  Unlike MU (which sum-normalizes atoms
          every update, reference ``_Backend.py:75-77``) HALS leaves the
          dictionary un-normalized during the fit — sklearn's convention;
          the exact coordinate minimization is incompatible with a
          per-iteration rescaling (:mod:`tnmf_tpu.engine_hals`).
        * ``revive_every=k`` makes the fit self-healing against MU's
          absorbing zero state (atoms collapsed under sparsity pressure can
          never recover on their own): every ``k`` fused on-device
          iterations, atoms whose activation mass fell below
          ``revive_threshold`` times the mean are re-drawn from the model's
          RNG (:func:`tnmf_tpu.utils.atoms.revive_dead_atoms`) and the fit
          continues with the full dictionary live.  Requires both factor
          updates.  Works under single-process meshes (revival preserves
          the factor shardings); multi-process global arrays are rejected.
        """
        _assert_nonnegative(V)
        self._assert_beta_domain(V, mask)
        self._sag_stat_ = None  # fresh optimization: drop partial_fit state
        _require(update_H or update_W,
                 'at least one of update_H / update_W must be True')
        _require_nonneg(sparsity_H=sparsity_H,
                        inhibition_strength=inhibition_strength,
                        cross_atom_inhibition_strength=cross_atom_inhibition_strength,
                        l2_H=l2_H, ortho_W=ortho_W, sparsity_W=sparsity_W,
                        l2_W=l2_W)
        _require(callback_interval >= 1, 'callback_interval must be >= 1')
        if solver not in ('mu', 'hals'):
            raise ValueError(f"solver must be 'mu' or 'hals', got {solver!r}")
        if solver == 'mu' and (sparsity_W > 0 or l2_W > 0):
            raise ValueError(
                'sparsity_W / l2_W regularize the un-normalized HALS '
                'dictionary; MU sum-normalizes atoms every update '
                '(reference _Backend.py:75-77), which makes W penalties '
                "ill-posed — use solver='hals'")
        if solver == 'hals':
            if (inhibition_strength > 0 or cross_atom_inhibition_strength > 0
                    or ortho_W > 0):
                raise ValueError(
                    "solver='hals' minimizes the plain (L1/L2-regularized) "
                    'Frobenius objective exactly; inhibition and ortho_W '
                    'are MU-only regularizers')
            if self._beta != 2.0:
                raise ValueError(
                    "solver='hals' requires beta_loss=2 (Frobenius); the "
                    'closed-form coordinate minimizer does not exist for '
                    'other beta divergences — use the MU solver')
            if mask is not None:
                raise ValueError(
                    'masked/weighted fits are MU-only (the masked Gram '
                    'matrices are no longer shared across components)')
            if extrapolate:
                raise ValueError(
                    'extrapolate accelerates MU; HALS takes exact '
                    'coordinate steps and does not compose with it')
            if revive_every is not None:
                raise ValueError(
                    'revive_every is unnecessary under HALS: zero is not '
                    'absorbing (a zeroed atom re-enters a later sweep when '
                    'its partial residual correlation turns positive)')
            if self._group is not None:
                raise ValueError(
                    "transform groups are MU-only (solver='hals' applies "
                    'to the degenerate plain-NMF geometry)')
            if self._mesh is not None and self._shard_axis != 'samples':
                raise ValueError(
                    "solver='hals' supports shard_axis='samples' meshes "
                    '(Grams become all-reduces); atom/spatial sharding '
                    'would serialize the Gauss-Seidel sweep')
        if (checkpoint_every is None) != (checkpoint_path is None):
            raise ValueError(
                'checkpoint_every and checkpoint_path must be given together')
        if tol is not None and checkpoint_every is not None:
            raise ValueError(
                'tol-based early stopping runs as one on-device while_loop '
                'and cannot combine with checkpoint_every (the periodic '
                'checkpoint needs host round trips)')
        if extrapolate:
            if (progress_callback is not None
                    or checkpoint_every is not None
                    or revive_every is not None):
                raise ValueError(
                    'extrapolate runs as one on-device while_loop and '
                    'cannot combine with progress_callback, '
                    'checkpoint_every or revive_every')
            xtr_beta0 = 0.5 if extrapolate is True else float(extrapolate)
            if not 0.0 < xtr_beta0 < 1.0:
                raise ValueError('extrapolate must be True or an initial '
                                 'momentum weight in (0, 1)')
        if checkpoint_every is not None:
            _require(checkpoint_every >= 1, 'checkpoint_every must be >= 1')
            if progress_callback is not None:
                raise ValueError(
                    'checkpoint_every uses the chunked fused loop and cannot '
                    'combine with progress_callback; call save() from your '
                    'callback instead')
            ckpt_path = checkpoint_path

            def progress_callback(model, iteration):  # noqa: F811
                model.save(ckpt_path, include_H=True,
                           completed_iterations=iteration + 1)
                return True

            callback_interval = int(checkpoint_every)
        if revive_every is not None:
            _require(revive_every >= 1, 'revive_every must be >= 1')
            if progress_callback is not None or tol is not None:
                raise ValueError(
                    'revive_every uses the chunked fused loop and cannot '
                    'combine with progress_callback / checkpoint_every / '
                    'tol; call utils.atoms.revive_dead_atoms from your own '
                    'callback instead')
            if not (update_H and update_W):
                raise ValueError('revive_every requires update_H and '
                                 'update_W (revival re-draws both factors)')
            if isinstance(V, jax.Array) and not V.is_fully_addressable:
                raise ValueError(
                    'revive_every re-draws atoms host-side and needs fully '
                    'addressable factors; with multi-process global arrays, '
                    'run utils.atoms.revive_dead_atoms between fits from '
                    'gathered copies instead')
            from ..utils.atoms import revive_dead_atoms
            thr = float(revive_threshold)

            def progress_callback(model, iteration):  # noqa: F811
                revived = revive_dead_atoms(model, thr)
                if revived.size:
                    model._logger.info('Revived %d dead atom(s) at '
                                       'iteration %d.', revived.size,
                                       iteration + 1)
                return True

            callback_interval = int(revive_every)

        self._initialize_matrices(V, keep_W, keep_H=keep_H, mask=mask)
        if solver == 'hals':
            if math.prod(self._plan.transform_shape) != 1:
                from .. import engine_hals_conv
                if not engine_hals_conv.applicable(self._plan):
                    raise ValueError(
                        "solver='hals' requires the degenerate plain-NMF "
                        "geometry (prod(transform_shape) == 1, any mode) "
                        "or reconstruction_mode='full' (shift-invariant "
                        'exact CD via phase-blocked sweeps, '
                        ':mod:`tnmf_tpu.engine_hals_conv`); other modes '
                        'have boundary-clipped atom footprints whose '
                        'position-dependent Grams break the shared-Gram '
                        'phase blocks — use the MU solver there')
                if sparsity_W > 0 or l2_W > 0:
                    raise ValueError(
                        'sparsity_W / l2_W apply to the plain-NMF HALS '
                        'W sweeps; the shift-invariant solver updates W '
                        'multiplicatively (engine_hals_conv) where W '
                        'penalties are ill-posed')
                self._fit_batch_hals_conv(
                    n_iterations, update_H=update_H, update_W=update_W,
                    l1=sparsity_H, l2=l2_H, hals_inner=hals_inner,
                    progress_callback=progress_callback,
                    callback_interval=callback_interval,
                    record_energies=record_energies,
                    tol=tol, tol_check_every=tol_check_every)
                return
            self._fit_batch_hals(
                n_iterations, update_H=update_H, update_W=update_W,
                l1=sparsity_H, l2=l2_H, l1w=sparsity_W, l2w=l2_W,
                hals_inner=hals_inner,
                progress_callback=progress_callback,
                callback_interval=callback_interval,
                record_energies=record_energies,
                tol=tol, tol_check_every=tol_check_every)
            return
        statics = dict(
            plan=self._plan, strategy=self._strategy,
            update_H=update_H, update_W=update_W,
            use_inhibition=inhibition_strength > 0,
            use_cross=cross_atom_inhibition_strength > 0,
            beta=self._beta,
        )
        scalars = (jnp.asarray(sparsity_H, self._W.dtype),
                   jnp.asarray(inhibition_strength, self._W.dtype),
                   jnp.asarray(cross_atom_inhibition_strength, self._W.dtype))
        # zero strength -> None: the default graphs stay bit-identical
        regs = dict(
            l2_H=(jnp.asarray(l2_H, self._W.dtype) if l2_H > 0 else None),
            ortho_W=(jnp.asarray(ortho_W, self._W.dtype) if ortho_W > 0
                     else None))

        log_each = self._logger.isEnabledFor(logging.INFO)
        self.energies_ = None
        if extrapolate:
            acc = jnp.promote_types(self._W.dtype, jnp.float32)
            self._W, self._H, n_done, _, trace = engine.fit_loop_extrapolated(
                self._Vp, self._Vd, self._W, self._H,
                jnp.asarray(int(n_iterations), jnp.int32),
                jnp.asarray(0.0 if tol is None else tol, acc),
                jnp.asarray(xtr_beta0, acc), *scalars, self._kernels,
                mask=self._mask_d, **regs,
                check_every=int(tol_check_every),
                n_buf=_trace_buf(n_iterations) if record_energies else 0,
                **statics)
            self.n_iterations_ = int(n_done)
            if record_energies:
                # on-device accepted-iterate trace; entries past n_done are
                # the NaN fill of early-stopped buffers — trim them
                self.energies_ = np.asarray(trace)[:self.n_iterations_]
            self._logger.info('TNMF finished.')
            return
        if tol is not None:
            if progress_callback is not None:
                raise ValueError(
                    'tol-based early stopping runs as one on-device '
                    'while_loop and cannot combine with progress_callback')
            _validate_tol(tol, tol_check_every)
            acc = jnp.promote_types(self._W.dtype, jnp.float32)
            self._W, self._H, n_done, _, trace = engine.fit_loop_tol(
                self._Vp, self._Vd, self._W, self._H,
                jnp.asarray(int(n_iterations), jnp.int32),
                jnp.asarray(tol, acc), *scalars, self._kernels,
                mask=self._mask_d, **regs,
                check_every=int(tol_check_every),
                n_buf=_trace_buf(n_iterations) if record_energies else 0,
                **statics)
            self.n_iterations_ = int(n_done)
            if record_energies:
                self.energies_ = np.asarray(trace)[:self.n_iterations_]
            self._logger.info('TNMF finished.')
            return
        self.n_iterations_ = int(n_iterations)  # sklearn n_iter_ semantics;
        # callback-aborted paths below overwrite with the actual count
        if record_energies and progress_callback is None:
            # fused loop with an on-device per-iteration energy trace
            self._W, self._H, energies = engine.fit_loop_energies(
                self._Vp, self._Vd, self._W, self._H, *scalars, self._kernels,
                self._mask_d, n_iterations=int(n_iterations), **regs, **statics)
            self.energies_ = np.asarray(energies)
            if log_each:
                for i, e in enumerate(self.energies_):
                    self._logger.info('Iteration: %d\tEnergy function: %s', i, e)
        elif progress_callback is None and not log_each:
            # fused on-device loop
            self._W, self._H = engine.fit_loop(
                self._Vp, self._W, self._H, n_iterations, *scalars,
                self._kernels, self._mask_d, **regs, **statics)
        elif progress_callback is not None and callback_interval > 1:
            # chunked callbacks: fused on-device chunks between Python calls.
            # The callback sees the model after iterations k-1, 2k-1, ... —
            # a deliberate relaxation of the every-iteration protocol for
            # dispatch-latency-bound setups (opt-in via callback_interval).
            # record_energies still yields the full per-iteration trace (the
            # energy-recording chunk loop runs between callbacks).
            traces = [] if record_energies else None
            done = 0
            while done < n_iterations:
                chunk = min(callback_interval, n_iterations - done)
                if record_energies:
                    self._W, self._H, es = engine.fit_loop_energies(
                        self._Vp, self._Vd, self._W, self._H, *scalars, self._kernels,
                        self._mask_d, n_iterations=chunk, **regs, **statics)
                    traces.append(np.asarray(es))
                else:
                    self._W, self._H = engine.fit_loop(
                        self._Vp, self._W, self._H, chunk, *scalars,
                        self._kernels, self._mask_d, **regs, **statics)
                done += chunk
                if not progress_callback(self, done - 1):
                    break
            self.n_iterations_ = done
            if record_energies:
                self.energies_ = np.concatenate(traces) if traces else np.zeros((0,))
        else:
            energies = [] if record_energies else None
            for iteration in range(n_iterations):
                self._W, self._H = engine.update_step(
                    self._Vp, self._W, self._H, *scalars, self._kernels,
                    self._mask_d, **regs, **statics)
                self.n_iterations_ = iteration + 1
                if record_energies:
                    energies.append(self._energy_function())
                if progress_callback is not None:
                    if not progress_callback(self, iteration):
                        break
                else:
                    self._logger.info('Iteration: %d\tEnergy function: %s',
                                      iteration, self._energy_function())
            if record_energies:
                self.energies_ = np.asarray(energies)
        self._logger.info('TNMF finished.')

    def _run_cd_loops(self, n_iterations, *, loop_tol, loop_energies,
                      loop_plain, step, progress_callback,
                      callback_interval, record_energies, tol,
                      tol_check_every):
        """Shared loop dispatch for the coordinate-descent solvers
        (plain-NMF and shift-invariant HALS): tol while_loop / fused loop
        / on-device energy trace / chunked or per-iteration callbacks —
        the same matrix as the MU block in fit_batch.  The callables
        close over their engine module, the data tensor and the
        regularizer scalars, and read ``self._W`` / ``self._H`` at call
        time (the chunked paths reassign them between calls):

        * ``loop_tol(n_max, tol, check_every, n_buf)``
          -> ``(W, H, n_done, e, trace_or_None)``
        * ``loop_energies(n)`` -> ``(W, H, energies)``
        * ``loop_plain(n)`` -> ``(W, H)``
        * ``step()`` -> ``(W, H)``
        """
        log_each = self._logger.isEnabledFor(logging.INFO)
        self.energies_ = None
        if tol is not None:
            if progress_callback is not None:
                raise ValueError(
                    'tol-based early stopping runs as one on-device '
                    'while_loop and cannot combine with progress_callback')
            _validate_tol(tol, tol_check_every)
            self._W, self._H, n_done, _, trace = loop_tol(
                int(n_iterations), tol, int(tol_check_every),
                _trace_buf(n_iterations) if record_energies else 0)
            self.n_iterations_ = int(n_done)
            if record_energies:
                self.energies_ = np.asarray(trace)[:self.n_iterations_]
            self._logger.info('TNMF finished.')
            return
        self.n_iterations_ = int(n_iterations)
        if record_energies and progress_callback is None:
            self._W, self._H, energies = loop_energies(int(n_iterations))
            self.energies_ = np.asarray(energies)
            if log_each:
                for i, e in enumerate(self.energies_):
                    self._logger.info('Iteration: %d\tEnergy function: %s',
                                      i, e)
        elif progress_callback is None and not log_each:
            self._W, self._H = loop_plain(n_iterations)
        elif progress_callback is not None and callback_interval > 1:
            traces = [] if record_energies else None
            done = 0
            while done < n_iterations:
                chunk = min(callback_interval, n_iterations - done)
                if record_energies:
                    self._W, self._H, es = loop_energies(chunk)
                    traces.append(np.asarray(es))
                else:
                    self._W, self._H = loop_plain(chunk)
                done += chunk
                if not progress_callback(self, done - 1):
                    break
            self.n_iterations_ = done
            if record_energies:
                self.energies_ = (np.concatenate(traces) if traces
                                  else np.zeros((0,)))
        else:
            energies = [] if record_energies else None
            for iteration in range(n_iterations):
                self._W, self._H = step()
                self.n_iterations_ = iteration + 1
                if record_energies:
                    energies.append(self._energy_function())
                if progress_callback is not None:
                    if not progress_callback(self, iteration):
                        break
                else:
                    self._logger.info('Iteration: %d\tEnergy function: %s',
                                      iteration, self._energy_function())
            if record_energies:
                self.energies_ = np.asarray(energies)
        self._logger.info('TNMF finished.')

    def _fit_batch_hals_conv(self, n_iterations, *, update_H, update_W,
                             l1, l2, hals_inner, progress_callback,
                             callback_interval, record_energies, tol,
                             tol_check_every):
        """Loop dispatch for the shift-invariant HALS solver
        (:mod:`tnmf_tpu.engine_hals_conv`: exact phase-blocked H
        coordinate descent + multiplicative W steps)."""
        from .. import engine_hals_conv as ehc
        # inner = Gauss-Seidel passes per phase block; the Gram is shared
        # across all positions of a phase, so extra passes are cheap
        # matvecs — but fresh phases see fresher residuals, so 1 is the
        # measured default (benchmarks/hals_conv.py)
        inner = 1 if hals_inner in (None, 'auto') else int(hals_inner)
        if inner < 1:
            raise ValueError('hals_inner must be >= 1 or "auto"')
        statics = dict(inner=inner, update_H=update_H, update_W=update_W,
                       plan=self._plan)
        acc = jnp.promote_types(self._W.dtype, jnp.float32)
        l1 = jnp.asarray(l1, acc)
        l2 = jnp.asarray(l2, acc)
        self._run_cd_loops(
            n_iterations,
            loop_tol=lambda n, t, ce, nb: ehc.fit_loop_tol(
                self._Vd, self._W, self._H, jnp.asarray(n, jnp.int32),
                jnp.asarray(t, acc), l1, l2, check_every=ce, n_buf=nb,
                **statics),
            loop_energies=lambda n: ehc.fit_loop_energies(
                self._Vd, self._W, self._H, l1, l2, n_iterations=n,
                **statics),
            loop_plain=lambda n: ehc.fit_loop(
                self._Vd, self._W, self._H, n, l1, l2, **statics),
            step=lambda: ehc.update_step(
                self._Vd, self._W, self._H, l1, l2, **statics),
            progress_callback=progress_callback,
            callback_interval=callback_interval,
            record_energies=record_energies, tol=tol,
            tol_check_every=tol_check_every)

    def _fit_batch_hals(self, n_iterations, *, update_H, update_W, l1, l2,
                        l1w, l2w, hals_inner, progress_callback,
                        callback_interval,
                        record_energies, tol, tol_check_every):
        """Loop dispatch for ``solver='hals'`` on the degenerate plain-NMF
        geometry (:mod:`tnmf_tpu.engine_hals`)."""
        inner = engine_hals.auto_inner(
            self._W.shape[0], int(np.prod(self._W.shape[1:])), hals_inner,
            n_samples=int(self._H.shape[0]))
        statics = dict(inner=inner, update_H=update_H, update_W=update_W,
                       plan=self._plan)
        acc = jnp.promote_types(self._W.dtype, jnp.float32)
        l1 = jnp.asarray(l1, acc)
        l2 = jnp.asarray(l2, acc)
        l1w = jnp.asarray(l1w, acc)
        l2w = jnp.asarray(l2w, acc)
        self._run_cd_loops(
            n_iterations,
            loop_tol=lambda n, t, ce, nb: engine_hals.fit_loop_tol(
                self._Vd, self._W, self._H, jnp.asarray(n, jnp.int32),
                jnp.asarray(t, jnp.float32), l1, l2, l1w, l2w,
                check_every=ce, n_buf=nb, **statics),
            loop_energies=lambda n: engine_hals.fit_loop_energies(
                self._Vd, self._W, self._H, l1, l2, l1w, l2w,
                n_iterations=n, **statics),
            loop_plain=lambda n: engine_hals.fit_loop(
                self._Vd, self._W, self._H, n, l1, l2, l1w, l2w, **statics),
            step=lambda: engine_hals.update_step(
                self._Vd, self._W, self._H, l1, l2, l1w, l2w, **statics),
            progress_callback=progress_callback,
            callback_interval=callback_interval,
            record_energies=record_energies, tol=tol,
            tol_check_every=tol_check_every)

    def fit_minibatches(
            self,
            V: np.ndarray,
            algorithm: MiniBatchAlgorithm = MiniBatchAlgorithm.ASG_MU,
            batch_size: int = 3,
            n_epochs: int = 1000,
            sag_lambda: float = 0.2,
            keep_W: bool = False,
            sparsity_H: float = 0.,
            inhibition_strength: float = 0.,
            cross_atom_inhibition_strength: float = 0.,
            l2_H: float = 0.,
            ortho_W: float = 0.,
            progress_callback: Optional[Callable[['TransformInvariantNMF', int], bool]] = None,
            record_energies: bool = False,
            mask=None,
    ):
        _assert_nonnegative(V)
        self._assert_beta_domain(V, mask)
        self._sag_stat_ = None  # fresh optimization: drop partial_fit state
        _require_nonneg(sparsity_H=sparsity_H,
                        inhibition_strength=inhibition_strength,
                        cross_atom_inhibition_strength=cross_atom_inhibition_strength,
                        l2_H=l2_H, ortho_W=ortho_W)
        _require(isinstance(algorithm, MiniBatchAlgorithm),
                 f'algorithm must be a MiniBatchAlgorithm, got {algorithm!r}')

        # NOTE: the reference computes `algorithm in (5, 6, 7, 8)` which is
        # always False for an Enum (TransformInvariantNMF.py:410), so input
        # shuffling effectively never happens there.  We reproduce that
        # behavior for exact cross-library comparability; batch-ORDER
        # shuffling below is still active for algorithms 5-8.
        self._initialize_matrices(V, keep_W, shuffle_input=False, mask=mask)

        # sample count from the device array: under a process-spanning mesh
        # self._V is None (no host copy exists), but the global jax.Array
        # always knows its global shape
        n = int(self._Vd.shape[0])
        batches = list(_compute_sequential_minibatches(n, batch_size))

        if self._global_input and self._rng is np.random and \
                algorithm is not MiniBatchAlgorithm.Cyclic_MU:
            # stochastic algorithms draw the batch order host-side; under a
            # process-spanning mesh every process must draw the SAME order or
            # the SPMD programs diverge (deadlock), so a common seed is
            # mandatory
            raise ValueError(
                'multi-host fit_minibatches with a stochastic algorithm '
                '(ASG_MU/GSG_MU/ASAG_MU/GSAG_MU) requires seed=... so that '
                'every process draws the same batch order')

        # Fully on-device fast path: the entire multi-epoch fit as one scan
        # program (engine_minibatch).  Eligible when there is no per-epoch
        # Python interaction and the batches are equal-size; produces the
        # exact same trajectory and RNG consumption as the loop below.
        # samples are sharded over the mesh ('samples': the whole mesh;
        # 'both': its data axis) — the (nb, batch_size) reshape in the scan
        # path must respect that sharding or every step pays a resharding
        # gather, so require batch_size to divide the sample-axis mesh extent
        if self._mesh is None:
            sample_mesh_extent = 1
        elif self._shard_axis == 'samples':
            sample_mesh_extent = self._mesh.devices.size
        elif self._shard_axis in ('both', 'samples+atoms'):
            from ..parallel.sharding import DATA_AXIS
            sample_mesh_extent = self._mesh.shape[DATA_AXIS]
        else:  # 'spatial' / 'atoms': the sample axis is not sharded
            sample_mesh_extent = 1
        mesh_ok = batch_size is not None and batch_size % sample_mesh_extent == 0
        use_scan = (
            progress_callback is None
            and not self._logger.isEnabledFor(logging.INFO)
            and mesh_ok
            and len(batches) > 0
        )
        self.energies_ = None
        if record_energies:
            self.energies_ = []
        from ..engine_minibatch import minibatch_fit_loop
        nb = -(-n // batch_size) if batch_size else 0
        n_pad = nb * batch_size - n if batch_size else 0
        if self._global_input and n_pad:
            # zero-padding a ragged final batch would concatenate a
            # process-local array onto the global one; the Python loop path
            # below handles the short final slice correctly instead
            use_scan = False
        # a ragged final batch is zero-padded on device: zero V rows and
        # zero H rows contribute exactly zero to every MU statistic (sums
        # over samples) and H = 0 is absorbing under the multiplicative
        # update, so the trajectory is identical to the reference's short
        # final batch. Under a mesh the padded total (nb*batch_size) stays
        # divisible by the sample-axis extent (mesh_ok requires batch_size
        # to divide it), so the padded arrays are re-placed explicitly.
        if use_scan and nb > 0:
            if algorithm is MiniBatchAlgorithm.Cyclic_MU:
                perms = np.tile(np.arange(nb), (n_epochs, 1))
            else:
                perms = np.stack([self._rng.permutation(nb) for _ in range(n_epochs)])
            dt = self._W.dtype
            Vp_full, H_full = self._Vp, self._H
            if n_pad:
                Vp_full = jnp.concatenate(
                    [Vp_full, jnp.zeros((n_pad,) + Vp_full.shape[1:], Vp_full.dtype)])
                H_full = jnp.concatenate(
                    [H_full, jnp.zeros((n_pad,) + H_full.shape[1:], H_full.dtype)])
                if self._mesh is not None and self._shard_axis in ('samples', 'both', 'samples+atoms'):
                    from ..parallel.sharding import data_sharding, h_sharding
                    # V has a channel (not atom) axis at position 1, so under
                    # 'samples+atoms' only its sample axis is sharded
                    v_sh = (data_sharding(self._mesh, Vp_full.ndim)
                            if self._shard_axis == 'samples+atoms'
                            else h_sharding(self._mesh, Vp_full.ndim, self._shard_axis))
                    Vp_full = jax.device_put(Vp_full, v_sh)
                    H_full = jax.device_put(
                        H_full, h_sharding(self._mesh, H_full.ndim, self._shard_axis))
            Vp_b = Vp_full.reshape((nb, batch_size) + Vp_full.shape[1:])
            H_b = H_full.reshape((nb, batch_size) + H_full.shape[1:])
            mask_b = mask_flat_d = None
            if self._mask_d is not None:
                # full-shape mask for batch indexing; zero rows for the
                # ragged padding (double-absorbing: V, H and the mask are
                # all zero there)
                Mfull = jnp.broadcast_to(
                    self._mask_d, self._Vd.shape).astype(self._mask_d.dtype)
                if n_pad:
                    Mfull = jnp.concatenate(
                        [Mfull, jnp.zeros((n_pad,) + Mfull.shape[1:], Mfull.dtype)])
                    if self._mesh is not None and self._shard_axis in (
                            'samples', 'both', 'samples+atoms'):
                        from ..parallel.sharding import data_sharding
                        Mfull = jax.device_put(
                            Mfull, data_sharding(self._mesh, Mfull.ndim))
                mask_b = Mfull.reshape((nb, batch_size) + Mfull.shape[1:])
                mask_flat_d = Mfull
            V_flat = None
            if record_energies:
                # data-space samples for the on-device per-epoch energy
                V_flat = self._Vd
                if n_pad:
                    V_flat = jnp.concatenate(
                        [V_flat, jnp.zeros((n_pad,) + V_flat.shape[1:], V_flat.dtype)])
                    if self._mesh is not None and self._shard_axis in (
                            'samples', 'both', 'samples+atoms'):
                        from ..parallel.sharding import data_sharding
                        V_flat = jax.device_put(
                            V_flat, data_sharding(self._mesh, V_flat.ndim))
            W, H_b, energies = minibatch_fit_loop(
                Vp_b, self._W, H_b, jnp.asarray(perms, jnp.int32),
                jnp.asarray(sparsity_H, dt), jnp.asarray(inhibition_strength, dt),
                jnp.asarray(cross_atom_inhibition_strength, dt),
                jnp.asarray(sag_lambda, dt), self._kernels,
                plan=self._plan, strategy=self._strategy, algorithm=algorithm.value,
                use_inhibition=inhibition_strength > 0,
                use_cross=cross_atom_inhibition_strength > 0,
                record_energies=record_energies, V_flat=V_flat,
                beta=self._beta, mask_b=mask_b, mask_flat=mask_flat_d,
                l2_H=(jnp.asarray(l2_H, dt) if l2_H > 0 else None),
                ortho_W=(jnp.asarray(ortho_W, dt) if ortho_W > 0 else None))
            self._W = W
            self._H = H_b.reshape((nb * batch_size,) + H_b.shape[2:])[:n]
            if record_energies:
                self.energies_ = [float(e) for e in np.asarray(energies)]
            self._logger.info('MiniBatch TNMF finished.')
            return

        epoch_update = {
            MiniBatchAlgorithm.Cyclic_MU: self._epoch_update_algorithm_4,
            MiniBatchAlgorithm.ASG_MU: self._epoch_update_algorithm_5,
            MiniBatchAlgorithm.GSG_MU: self._epoch_update_algorithm_6,
            MiniBatchAlgorithm.ASAG_MU: self._epoch_update_algorithm_7,
            MiniBatchAlgorithm.GSAG_MU: self._epoch_update_algorithm_8,
        }

        dt = self._W.dtype
        self._mb_scalars = (jnp.asarray(sparsity_H, dt),
                            jnp.asarray(inhibition_strength, dt),
                            jnp.asarray(cross_atom_inhibition_strength, dt))
        self._mb_l2 = jnp.asarray(l2_H, dt) if l2_H > 0 else None
        self._mb_ortho = jnp.asarray(ortho_W, dt) if ortho_W > 0 else None
        self._mb_flags = dict(use_inhibition=inhibition_strength > 0,
                              use_cross=cross_atom_inhibition_strength > 0,
                              beta=self._beta)

        inner_stat = None
        for epoch in range(n_epochs):
            inner_stat = epoch_update[algorithm](inner_stat, batches, sag_lambda)
            if record_energies:
                self.energies_.append(self._energy_function())
            if progress_callback is not None:
                if not progress_callback(self, epoch):
                    break
            else:
                self._logger.info('Epoch: %d\tEnergy function: %s', epoch, self._energy_function())
        self._logger.info('MiniBatch TNMF finished.')

    def _shuffled(self, batches):
        """Shuffle the batch order consuming the RNG exactly like the
        reference's ``_random_shuffle`` (np.random.permutation over the
        list; TransformInvariantNMF.py:40-44)."""
        idx = self._rng.permutation(len(batches))
        return [batches[i] for i in idx]

    def _update_H_batch(self, s: slice):
        Hb = engine.update_H_step(
            self._Vp[s], self._W, self._H[s], *self._mb_scalars, self._kernels,
            self._mask_slice(s), self._mb_l2,
            plan=self._plan, strategy=self._strategy, **self._mb_flags)
        if s == sliceNone:
            self._H = Hb
        else:
            self._H = engine.set_H_slice(self._H, Hb, start=s.start)

    def _update_W_batch(self, s: slice):
        self._W = engine.update_W_step(
            self._Vp[s], self._W, self._H[s], self._mask_slice(s),
            self._mb_ortho,
            plan=self._plan, strategy=self._strategy, beta=self._beta)

    def _grad_W_batch(self, s: slice):
        return engine.grad_W_stats(
            self._Vp[s], self._W, self._H[s], self._mask_slice(s),
            plan=self._plan, strategy=self._strategy, beta=self._beta)

    def _apply_W_stats(self, neg, pos):
        self._W = engine.apply_W_update(self._W, neg, pos, self._mb_ortho,
                                        n_shift_axes=self._plan.ndim)

    def _epoch_update_algorithm_4(self, _, batches, __):
        """Cyclic_MU: H per batch; one W update per epoch from summed stats."""
        acc = None
        for batch in batches:
            self._update_H_batch(batch)
            neg, pos = self._grad_W_batch(batch)
            acc = (neg, pos) if acc is None else (acc[0] + neg, acc[1] + pos)
        self._apply_W_stats(*acc)

    def _epoch_update_algorithm_5(self, _, batches, __):
        """ASG_MU: shuffled batches; H then W update per batch."""
        for batch in self._shuffled(batches):
            self._update_H_batch(batch)
            self._update_W_batch(batch)

    def _epoch_update_algorithm_6(self, _, batches, __):
        """GSG_MU: H per shuffled batch; W update from the last batch."""
        for batch in self._shuffled(batches):
            self._update_H_batch(batch)
        self._update_W_batch(batch)

    def _epoch_update_algorithm_7(self, inner_stat, batches, sag_lambda):
        """ASAG_MU: per batch, exp-averaged W stats and a W update."""
        lam = jnp.asarray(sag_lambda, self._W.dtype)
        for batch in self._shuffled(batches):
            self._update_H_batch(batch)
            neg, pos = self._grad_W_batch(batch)
            if inner_stat is None:
                inner_stat = (jnp.zeros_like(neg), jnp.zeros_like(pos))
            inner_stat = engine.accumulate_gradient(*inner_stat, neg, pos, lam)
            self._apply_W_stats(*inner_stat)
        return inner_stat

    def _epoch_update_algorithm_8(self, inner_stat, batches, sag_lambda):
        """GSAG_MU: H per batch; one exp-averaged W stat + update per epoch."""
        lam = jnp.asarray(sag_lambda, self._W.dtype)
        batch = slice(0, 0)
        for batch in self._shuffled(batches):
            self._update_H_batch(batch)
        neg, pos = self._grad_W_batch(batch)
        if inner_stat is None:
            inner_stat = (jnp.zeros_like(neg), jnp.zeros_like(pos))
        inner_stat = engine.accumulate_gradient(*inner_stat, neg, pos, lam)
        self._apply_W_stats(*inner_stat)
        return inner_stat

    # ------------------------------------------------------------------
    # streaming fit (reference fit_stream, :506-523)
    # ------------------------------------------------------------------

    def fit_stream(
            self,
            V: Iterator[np.ndarray],
            subsample_size: int = 3,
            max_subsamples: Optional[int] = None,
            **kwargs,
    ):
        for isub in count(0):
            subsample = list(islice(V, subsample_size))
            if len(subsample) > 0:
                self._logger.info('Processing subsample %d.', isub)
                self.fit(np.asarray(subsample), keep_W=True, **kwargs)
                if max_subsamples is not None and isub == max_subsamples - 1:
                    self._logger.info('Processed %d subsamples. TNMF on iterator will stop.',
                                      max_subsamples)
                    return
            else:
                self._logger.info('Sample iterator exhausted. TNMF on full iterator finished.')
                return

    # ------------------------------------------------------------------
    # online / out-of-core learning (sklearn MiniBatchNMF partial_fit
    # protocol; no reference counterpart — the closest reference facility,
    # fit_stream (TransformInvariantNMF.py:506-523), needs the caller to
    # hand over an iterator up front, whereas partial_fit is caller-driven:
    # feed minibatches as they arrive, never holding the dataset)
    # ------------------------------------------------------------------

    def partial_fit(
            self,
            V: np.ndarray,
            y=None,
            sag_lambda: float = 0.2,
            sparsity_H: float = 0.,
            inhibition_strength: float = 0.,
            cross_atom_inhibition_strength: float = 0.,
            l2_H: float = 0.,
            ortho_W: float = 0.,
            mask=None,
    ) -> 'TransformInvariantNMF':
        """Update the model with ONE minibatch (online learning).

        Every call runs a single ASAG-style multiplicative-update step on
        ``V`` as a minibatch: activations ``H`` are drawn fresh for the
        batch and updated once, then the dictionary is updated from
        exponentially averaged ``(neg, pos)`` statistics carried across
        calls (forgetting factor ``sag_lambda``; Serizel et al. 2016,
        matching ``fit_minibatches(algorithm=ASAG_MU)``'s per-batch rule).
        ``sag_lambda=1`` keeps no memory — each call then uses only its own
        batch's gradient (the ASG_MU per-batch rule), making a first call
        identical to ``fit_batch(V, n_iterations=1)``.

        The first call initializes the dictionary from the batch geometry;
        later calls keep it (``keep_W`` semantics).  Batches may differ in
        sample count and even spatial size — only the channel count must
        stay constant — but each distinct geometry compiles its own update
        program, so keep batch shapes uniform in hot loops.  Any ``fit*``
        call starts a fresh optimization and clears the averaged state.

        Composes with masks, ``beta_loss`` and transform groups like the
        other drivers.  Returns ``self`` (sklearn protocol); the number of
        online steps taken is ``self.n_steps_``.
        """
        del y
        _assert_nonnegative(V)
        self._assert_beta_domain(V, mask)
        _require_nonneg(sparsity_H=sparsity_H,
                        inhibition_strength=inhibition_strength,
                        cross_atom_inhibition_strength=cross_atom_inhibition_strength,
                        l2_H=l2_H, ortho_W=ortho_W)
        # the phased lowering applies here too (see fit_minibatches for the
        # per-batch measurements); SAG statistics are W-shaped and W is
        # never phase-encoded, so they stay canonical across calls under
        # every strategy
        self._initialize_matrices(V, keep_W=True, mask=mask)
        dt = self._W.dtype
        self._mb_scalars = (jnp.asarray(sparsity_H, dt),
                            jnp.asarray(inhibition_strength, dt),
                            jnp.asarray(cross_atom_inhibition_strength, dt))
        self._mb_l2 = jnp.asarray(l2_H, dt) if l2_H > 0 else None
        self._mb_ortho = jnp.asarray(ortho_W, dt) if ortho_W > 0 else None
        self._mb_flags = dict(use_inhibition=inhibition_strength > 0,
                              use_cross=cross_atom_inhibition_strength > 0,
                              beta=self._beta)
        self._update_H_batch(sliceNone)
        neg, pos = self._grad_W_batch(sliceNone)
        if sag_lambda == 1.0 or self._sag_stat_ is None:
            # no memory (or nothing to remember yet): the batch's own
            # statistics.  NOT engine.accumulate_gradient's sag_lambda == 1
            # branch, which is a plain SUM (the reference's within-epoch
            # Cyclic_MU accumulation) — online semantics want replacement.
            stat = (neg, pos)
        else:
            lam = jnp.asarray(sag_lambda, dt)
            stat = engine.accumulate_gradient(*self._sag_stat_, neg, pos, lam)
        self._sag_stat_ = None if sag_lambda == 1.0 else stat
        self._apply_W_stats(*stat)
        self.n_steps_ += 1
        self._logger.info('partial_fit step %d done.', self.n_steps_)
        return self

    # ------------------------------------------------------------------
    # sklearn estimator protocol: get_params / set_params make the model
    # compose with sklearn.base.clone, Pipeline and the CV search tools
    # (the reference model predates this; its ctor kwargs map 1:1)
    # ------------------------------------------------------------------

    def get_params(self, deep: bool = True) -> dict:
        """Constructor parameters, unmodified (sklearn estimator API)."""
        del deep  # no nested estimators
        return dict(self._init_params)

    def __sklearn_tags__(self):
        """Estimator tags (sklearn >= 1.6 protocol).  Lazy import keeps
        sklearn an optional dependency — this is only called by sklearn
        meta-estimators (Pipeline, the CV search tools), which implies
        sklearn is importable."""
        from sklearn.utils import Tags, TargetTags, TransformerTags
        return Tags(
            estimator_type='transformer',
            target_tags=TargetTags(required=False),
            transformer_tags=TransformerTags(),
            regressor_tags=None,
            classifier_tags=None,
            non_deterministic=False,
            no_validation=True,  # V is an n-d tensor, not a 2-D X matrix
        )

    def set_params(self, **params) -> 'TransformInvariantNMF':
        """Re-configure constructor parameters in place (sklearn API).

        Resets any fitted state — call before ``fit``, like sklearn does.
        Unknown names raise ``ValueError`` (the sklearn contract for CV
        search error reporting).
        """
        unknown = set(params) - set(self._init_params)
        if unknown:
            raise ValueError(
                f'invalid parameter(s) {sorted(unknown)} for estimator '
                f'{type(self).__name__}; valid parameters are '
                f'{sorted(self._init_params)}')
        merged = {**self._init_params, **params}
        self.__init__(**merged)
        return self

    def fit(self, V, y=None, **kwargs):
        """Kwarg-dispatching front door (reference :525-531):
        ``subsample_size``/``max_subsamples`` -> fit_stream,
        ``batch_size``/``algorithm`` -> fit_minibatches, else fit_batch.
        ``y`` is accepted and ignored (sklearn unsupervised convention)."""
        del y
        if 'subsample_size' in kwargs or 'max_subsamples' in kwargs:
            self.fit_stream(iter(V), **kwargs)
        elif 'batch_size' in kwargs or 'algorithm' in kwargs:
            self.fit_minibatches(V, **kwargs)
        else:
            self.fit_batch(V, **kwargs)

    # ------------------------------------------------------------------
    # inference / serving (extension over the reference, which has no
    # frozen-dictionary encoding API)
    # ------------------------------------------------------------------

    def set_dictionary(self, W) -> 'TransformInvariantNMF':
        """Install an externally supplied dictionary (e.g. transferred from
        another model, or shipped without a checkpoint file) so that
        ``transform`` / ``fit(keep_W=True)`` can run against it.

        ``W`` must be nonnegative with shape
        ``(n_atoms, n_channels, *atom_shape)`` matching this model's
        configuration; atoms are sum-normalized like after every W update
        (reference ``_Backend.py:75-77``).  Returns ``self`` for chaining.
        """
        W = np.asarray(W)
        expected_nd = 2 + len(self.atom_shape)
        if W.ndim != expected_nd or W.shape[0] != self.n_atoms \
                or W.shape[2:] != self.atom_shape:
            raise ValueError(
                f'dictionary shape {tuple(W.shape)} does not match the '
                f'model: expected (n_atoms={self.n_atoms}, n_channels, '
                f'*atom_shape={self.atom_shape})')
        if np.any(W < 0):
            raise ValueError('dictionary entries must be nonnegative')
        s = W.sum(axis=self._axes_W_normalization, keepdims=True)
        self._W = W / np.where(s == 0, 1, s)
        # dictionary replaced: any previous fit state is inconsistent
        self._H = None
        self._plan = None
        return self

    def transform(self, V, n_iterations: int = 100,
                  batch_size: Optional[int] = None, **kwargs) -> np.ndarray:
        """Infer activations for new data with the dictionary **frozen**
        (sklearn-style encoding — the serving path: fit once, then encode
        batches against the learned atoms).

        Equivalent to ``fit_batch(V, update_W=False, keep_W=True, ...)``;
        accepts the same regularizer/callback kwargs.  Returns the
        activations ``H`` as a NumPy array.

        ``batch_size`` enables chunked (out-of-core) encoding for datasets
        whose activations don't fit device memory: samples are encoded in
        independent chunks (H has no cross-sample coupling when W is
        frozen, so chunking is exact) and the full H is assembled on host.
        Identical to encoding the chunks one ``transform`` call at a time;
        uniform chunks reuse one compiled program.  The model's own
        ``V``/``H``/``R`` accessors then refer to the *last* chunk only —
        use the returned array.  A sample-spanning ``mask`` is sliced
        along with the chunks.
        """
        if self._W is None:
            raise RuntimeError(
                'transform() requires a fitted or loaded dictionary; '
                'call fit() or load() first')
        if batch_size is None:
            self.fit_batch(V, n_iterations=n_iterations, update_W=False,
                           keep_W=True, **kwargs)
            return self.H
        V = np.asarray(V)
        mask = kwargs.pop('mask', None)
        mask_per_sample = (mask is not None
                           and np.ndim(mask) == V.ndim
                           and np.shape(mask)[0] == V.shape[0])
        out = []
        for s in _compute_sequential_minibatches(V.shape[0], batch_size):
            chunk_mask = mask[s] if mask_per_sample else mask
            self.fit_batch(V[s], n_iterations=n_iterations, update_W=False,
                           keep_W=True, mask=chunk_mask, **kwargs)
            out.append(self.H)
        return np.concatenate(out, axis=0)

    def export_serving(self, path: Optional[str] = None, **kwargs) -> bytes:
        """Serialize this model's encoding step (``transform``'s compute:
        matched-filter init + H-only MU refinement against the frozen
        dictionary) as a self-contained StableHLO artifact via
        :mod:`jax.export` — deployable without this package or any Python
        model state.  See :func:`tnmf_tpu.serving.export_serving` for the
        keyword arguments (iteration count, regularizer strengths, batch
        handling, target platforms).  Returns the artifact bytes and
        optionally writes them to ``path``."""
        from ..serving import export_serving
        return export_serving(self, path=path, **kwargs)

    def fit_transform(self, V, y=None, **kwargs) -> np.ndarray:
        """Fit the model to ``V`` and return the learned activations ``H``
        (sklearn estimator convention; ``y`` is accepted and ignored).
        Accepts every ``fit`` kwarg."""
        self.fit(V, y, **kwargs)
        return self.H

    def inverse_transform(self, H: Optional[np.ndarray] = None) -> np.ndarray:
        """Reconstruction from activations (default: the last fit's /
        transform's own activations, i.e. ``self.R``)."""
        if self._plan is None:
            raise RuntimeError(
                'inverse_transform() requires a fitted model; call fit() '
                '(or load a checkpoint that includes H) first')
        if H is None:
            return self.R
        H = np.asarray(H)
        if self.n_transforms > 1 and H.ndim == 3 + self._plan.ndim:
            # the public (n, atoms, transforms, *shift) layout -> flat m-major
            H = H.reshape((H.shape[0], self.n_atoms * self.n_transforms)
                          + H.shape[3:])
        R = engine.reconstruct(
            jnp.asarray(self._W), jnp.asarray(H, self._W.dtype),
            plan=self._plan, strategy=self._strategy)
        return np.asarray(R.astype(jnp.float32) if R.dtype == jnp.bfloat16 else R)

    # ------------------------------------------------------------------
    # checkpointing (extension over the reference, which only supports
    # in-memory keep_W warm restarts; SURVEY.md §5)
    # ------------------------------------------------------------------

    def save(self, path: str, include_H: bool = False,
             completed_iterations: Optional[int] = None):
        """Serialize the model to an ``.npz`` checkpoint (atomically).

        Stores the dictionary (and optionally the activations of the last
        fit) together with the constructor configuration, so a model can be
        resumed across processes — e.g. a streaming fit continued on fresh
        data via ``load(...)`` followed by ``fit(V, keep_W=True)``.

        The file is written to a temporary sibling and moved into place
        with ``os.replace``, so a crash mid-write never corrupts an
        existing checkpoint — the property the periodic-checkpoint fits
        (``fit_batch(checkpoint_every=...)``) rely on.
        ``completed_iterations`` stamps how many MU iterations produced
        this state; :meth:`load` exposes it as
        ``last_checkpoint_iteration_`` so a resumed run knows how many
        iterations remain.
        """
        if self._W is None:
            raise ValueError('nothing to save: the model has not been fit yet')

        def host(arr):
            # npz cannot represent bfloat16 (it round-trips as a void dtype);
            # store sub-f32 floats as float32 (lossless widening) and record
            # the original dtype for restore
            a = np.asarray(arr)
            if a.dtype.kind not in 'fiu' or (a.dtype.kind == 'f' and a.dtype.itemsize < 4):
                a = a.astype(np.float32)
            return a

        payload = dict(
            W=host(self._W),
            dtype=str(self._W.dtype),
            n_atoms=self.n_atoms,
            atom_shape=np.asarray(self.atom_shape),
            inhibition_range=np.asarray(self._inhibition_range),
            reconstruction_mode=self._reconstruction_mode,
            transform_type=self.transform_type,
            version=1,
        )
        if include_H and self._H is not None:
            # stored in the internal flat m-major layout (restore assigns it
            # back to model._H directly)
            payload['H'] = host(self._H_flat() if self._shuffle_idx is not None
                                else self._H)
        if completed_iterations is not None:
            payload['completed_iterations'] = int(completed_iterations)
        final = path if path.endswith('.npz') else path + '.npz'
        tmp = final + '.tmp'
        with open(tmp, 'wb') as f:
            np.savez(f, **payload)
        os.replace(tmp, final)

    @classmethod
    def load(cls, path: str, **kwargs) -> 'TransformInvariantNMF':
        """Restore a model from :meth:`save`.

        The returned model carries the stored dictionary; pass
        ``keep_W=True`` to subsequent ``fit`` calls to fine-tune instead of
        re-initializing. Extra ``kwargs`` override constructor arguments.
        """
        with np.load(path, allow_pickle=False) as data:
            W = data['W']
            dtype = jnp.dtype(str(data['dtype'])) if 'dtype' in data else W.dtype
            cfg = dict(
                n_atoms=int(data['n_atoms']),
                atom_shape=tuple(int(a) for a in data['atom_shape']),
                inhibition_range=tuple(int(r) for r in data['inhibition_range']),
                reconstruction_mode=str(data['reconstruction_mode']),
            )
            if 'transform_type' in data:
                cfg['transform_type'] = str(data['transform_type'])
            cfg.update(kwargs)
            model = cls(**cfg)
            model._W = jnp.asarray(W, dtype=dtype)
            if 'H' in data:
                model._H = jnp.asarray(data['H'], dtype=dtype)
                model._restore_plan()
            model.last_checkpoint_iteration_ = (
                int(data['completed_iterations'])
                if 'completed_iterations' in data else None)
        return model

    def _restore_plan(self):
        """Rebuild the execution plan from the restored W/H geometry so
        R / R_partial work immediately after loading a checkpoint."""
        tshape = self._H.shape[2:]
        atom = self.atom_shape
        mode = self._reconstruction_mode
        if mode == 'valid':
            sample = tuple(t - a + 1 for t, a in zip(tshape, atom))
        elif mode == 'full':
            sample = tuple(t + a - 1 for t, a in zip(tshape, atom))
        else:
            sample = tuple(tshape)
        self._plan = ConvPlan.create(mode, sample, atom, self._fft_policy,
                                     precision=self._precision)
        # same phased gate as _initialize_matrices: spatially-sharded meshes
        # (halo exchange is validated on the canonical grid only) keep the
        # plain lowering after a restore too
        allow_phased = not (self._mesh is not None
                            and self._shard_axis in ('spatial', 'both'))
        self._strategy = engine.resolve_strategy(
            self._strategy_request, self._plan, self.n_atoms * self.n_transforms,
            self._W.shape[1], allow_phased, allow_dot=allow_phased)
        if self._group is not None:
            self._strategy = (self._strategy, self._group)

    # ------------------------------------------------------------------
    # distributed (sharded) checkpointing via orbax — the at-scale path
    # where H may exceed any single host's memory
    # ------------------------------------------------------------------

    def save_sharded(self, path: str, include_H: bool = True,
                     block: bool = True):
        """Distributed checkpoint: every device/host writes its own shards
        of W and H (orbax/tensorstore), preserving their shardings — no
        host-side gather, so it works for mesh-sharded and process-spanning
        (multi-host) state where :meth:`save` cannot.  Needs the optional
        ``orbax-checkpoint`` package (``pip install tnmf-tpu[checkpoint]``).

        ``path`` must be a fresh directory path (absolute paths are
        normalized here). Restore with :meth:`load_sharded`.

        ``block=False`` makes the write **asynchronous**: orbax stages the
        device state synchronously (mutating W/H afterwards is safe) and
        the disk/tensorstore write overlaps further compute — the
        production pattern for periodic checkpoints of large fits.  Call
        :meth:`wait_for_checkpoints` (or the next ``save_sharded``, which
        drains the previous write first) before reading the directory.
        """
        import json
        import orbax.checkpoint as ocp

        if self._W is None:
            raise ValueError('nothing to save: the model has not been fit yet')
        self.wait_for_checkpoints()  # one in-flight async write at a time
        path = os.path.abspath(path)
        state = {'W': self._W}
        if include_H and self._H is not None:
            state['H'] = self._H
        ckptr = ocp.StandardCheckpointer()
        ckptr.save(os.path.join(path, 'state'), state)
        if block:
            ckptr.wait_until_finished()
        else:
            self._async_checkpointer = ckptr
        meta = dict(
            n_atoms=self.n_atoms,
            atom_shape=list(self.atom_shape),
            inhibition_range=list(self._inhibition_range),
            reconstruction_mode=self._reconstruction_mode,
            dtype=str(self._W.dtype),
            w_shape=list(self._W.shape),
            h_shape=list(self._H.shape) if 'H' in state else None,
            transform_type=self.transform_type,
            version=1,
        )
        if jax.process_index() == 0:
            # with block=False orbax creates ``path`` in its background
            # thread, so the sidecar write must not rely on it existing yet
            os.makedirs(path, exist_ok=True)
            with open(os.path.join(path, 'tnmf_config.json'), 'w') as f:
                json.dump(meta, f)

    def wait_for_checkpoints(self):
        """Drain any in-flight :meth:`save_sharded` ``block=False`` write
        (no-op when none is pending)."""
        ckptr = getattr(self, '_async_checkpointer', None)
        if ckptr is not None:
            ckptr.wait_until_finished()
            self._async_checkpointer = None

    @classmethod
    def load_sharded(cls, path: str, mesh=None, shard_axis: str = 'samples',
                     **kwargs) -> 'TransformInvariantNMF':
        """Restore a :meth:`save_sharded` checkpoint.

        With ``mesh`` the state is restored *directly into its distributed
        layout* (H sharded per ``shard_axis``, W atom-sharded under the
        'atoms' variants and replicated otherwise) — each device reads only
        its own shards. Extra ``kwargs`` override constructor arguments.
        """
        import json
        import orbax.checkpoint as ocp

        path = os.path.abspath(path)
        with open(os.path.join(path, 'tnmf_config.json')) as f:
            meta = json.load(f)
        cfg = dict(
            n_atoms=int(meta['n_atoms']),
            atom_shape=tuple(meta['atom_shape']),
            inhibition_range=tuple(meta['inhibition_range']),
            reconstruction_mode=meta['reconstruction_mode'],
            mesh=mesh,
            shard_axis=shard_axis,
        )
        if meta.get('transform_type', 'shift') != 'shift':
            cfg['transform_type'] = meta['transform_type']
        cfg.update(kwargs)
        model = cls(**cfg)

        dtype = jnp.dtype(meta['dtype'])
        if mesh is not None:
            from ..parallel.sharding import h_sharding, w_sharding
            w_sh = w_sharding(mesh, len(meta['w_shape']), shard_axis)
            h_sh = None
            if meta['h_shape'] is not None:
                h_sh = h_sharding(mesh, len(meta['h_shape']), shard_axis)
        else:
            w_sh = h_sh = jax.sharding.SingleDeviceSharding(jax.devices()[0])
        target = {'W': jax.ShapeDtypeStruct(tuple(meta['w_shape']), dtype, sharding=w_sh)}
        if meta['h_shape'] is not None:
            target['H'] = jax.ShapeDtypeStruct(tuple(meta['h_shape']), dtype, sharding=h_sh)
        ckptr = ocp.StandardCheckpointer()
        state = ckptr.restore(os.path.join(path, 'state'), target)
        model._W = state['W']
        if 'H' in state:
            model._H = state['H']
            model._restore_plan()
        return model


class MiniBatchTransformInvariantNMF(TransformInvariantNMF):
    """Minibatch-first variant of :class:`TransformInvariantNMF` — the
    sklearn ``MiniBatchNMF`` analogue of this package.

    The base class follows the reference's design, where minibatching is
    a *method* (``fit_minibatches``) on the one model class
    (``/root/reference/tnmf/TransformInvariantNMF.py:350``).  This
    subclass makes it a model *configuration* instead: the batch schedule
    lives in the constructor (so it rides through ``get_params`` /
    ``set_params`` / ``clone`` and CV searches over ``batch_size`` or
    ``algorithm`` work out of the box), ``fit`` runs the minibatch
    algorithm directly, and the caller-driven online protocol
    (:meth:`partial_fit <TransformInvariantNMF.partial_fit>`) is
    inherited.  Everything else — serving, checkpointing, meshes,
    regularizers — is the base class, unchanged.

    Parameters (in addition to the base class): ``batch_size``,
    ``algorithm`` (a :class:`MiniBatchAlgorithm` or its name, default
    ASG_MU — the recommended schedule of Serizel et al. 2016),
    ``n_epochs`` and ``sag_lambda``; each can still be overridden per
    ``fit`` call.
    """

    def __init__(self, n_atoms: int, atom_shape: Tuple[int, ...],
                 batch_size: int = 3,
                 algorithm: Union[MiniBatchAlgorithm, str] = MiniBatchAlgorithm.ASG_MU,
                 n_epochs: int = 1000,
                 sag_lambda: float = 0.2,
                 **kwargs):
        super().__init__(n_atoms, atom_shape, **kwargs)
        if isinstance(algorithm, str):
            algorithm = MiniBatchAlgorithm[algorithm]
        _require(isinstance(algorithm, MiniBatchAlgorithm),
                 f'algorithm must be a MiniBatchAlgorithm, got {algorithm!r}')
        self.batch_size = None if batch_size is None else int(batch_size)
        self.algorithm = algorithm
        self.n_epochs = int(n_epochs)
        self.sag_lambda = float(sag_lambda)
        self._init_params.update(batch_size=batch_size, algorithm=algorithm,
                                 n_epochs=n_epochs, sag_lambda=sag_lambda)

    def fit(self, V, y=None, **kwargs):
        """Minibatch fit with the constructor's schedule; any of
        ``batch_size`` / ``algorithm`` / ``n_epochs`` / ``sag_lambda`` may
        be overridden per call.  ``subsample_size`` / ``max_subsamples``
        still dispatch to :meth:`fit_stream
        <TransformInvariantNMF.fit_stream>` (which then runs this
        minibatch fit per subsample)."""
        del y
        if 'subsample_size' in kwargs or 'max_subsamples' in kwargs:
            self.fit_stream(iter(V), **kwargs)
            return
        kwargs.setdefault('batch_size', self.batch_size)
        kwargs.setdefault('algorithm', self.algorithm)
        kwargs.setdefault('n_epochs', self.n_epochs)
        kwargs.setdefault('sag_lambda', self.sag_lambda)
        self.fit_minibatches(V, **kwargs)
