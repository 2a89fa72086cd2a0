"""Vmapped hyperparameter sweeps: fit many independent TNMF models in ONE
compiled graph.

Dictionary learning is sensitive to the random initialization and to the
regularization strengths, so practitioners routinely fit the same data
many times (restarts over seeds, grids over sparsity / inhibition) and
keep the best model.  The reference library can only run such sweeps as a
Python loop of full fits (one ``TransformInvariantNMF.fit`` per setting,
``tnmf/TransformInvariantNMF.py:282``).  On an accelerator the natural formulation is
``jax.vmap``: the model axis becomes a leading batch dimension of W and H,
the data tensor (and its loop-invariant preparation) is shared by
broadcast, and the whole sweep — S inits, S fit loops, S final energies —
is a single XLA program in which every convolution carries ``S`` times the
batch, filling a device that a lone small problem leaves idle.

Regularization strengths are *traced* scalars in the engine
(:func:`tnmf_tpu.engine.fit_loop`), so a sweep over sparsity /
inhibition / cross-inhibition is exact: strength 0 contributes
``0 * term`` to the MU denominator — bit-for-bit the unregularized
update — and per-model strengths simply become vmapped vectors over one
shared graph.  Anything that changes graph *structure* (reconstruction
mode, beta, strategy, atom count/shape) is static and therefore one value
per sweep.

The model axis is embarrassingly parallel: under ``mesh=`` every
per-model array is sharded on its leading axis and the fit runs with zero
collectives — linear scaling across chips
(:func:`tnmf_tpu.parallel.sharding.make_mesh_models`).
"""

from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from .. import engine
from .. import engine_hals
from ..ops.inhibition import inhibition_kernels, resolve_inhibition_range
from ..ops.modes import ConvPlan

__all__ = ['SweepResult', 'sweep_fit']


@dataclass(frozen=True)
class SweepResult:
    """Outcome of :func:`sweep_fit`: per-model arrays stacked on axis 0."""

    W: jax.Array          # (S, n_atoms, n_channels, *atom_shape)
    H: jax.Array          # (S, n_samples, n_atoms * n_transforms, *transform_shape)
    energies: jax.Array   # (S,) final objective per model
    seeds: np.ndarray     # (S,) per-model seed labels used for the init keys
    energy_traces: Optional[jax.Array] = None  # (S, n_iterations) if recorded
    n_iters: Optional[jax.Array] = None  # (S,) iterations run, if tol= was set

    @property
    def n_models(self) -> int:
        return self.W.shape[0]

    @property
    def best(self) -> int:
        """Index of the model with the lowest final objective."""
        return int(jnp.argmin(self.energies))

    def model(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """``(W, H)`` of model ``i`` as NumPy arrays."""
        return np.asarray(self.W[i]), np.asarray(self.H[i])


def _per_model(x, n_models: int, name: str, dtype) -> jnp.ndarray:
    """Broadcast a scalar, or validate a length-S vector, of strengths."""
    arr = jnp.asarray(x, dtype=dtype)
    if arr.ndim == 0:
        return jnp.full((n_models,), arr, dtype=dtype)
    if arr.shape != (n_models,):
        raise ValueError(
            f'{name} must be a scalar or a vector of one value per model '
            f'(expected shape ({n_models},), got {tuple(arr.shape)})')
    return arr


@partial(jax.jit,
         static_argnames=('n_iterations', 'n_atoms',
                          'n_maps') + engine._STEP_STATICS)
def _sweep_impl(Vp, V, keys, sparsity, inhibition, cross_inhibition,
                kernels, mask, l2=None, ortho=None, *, n_iterations,
                n_atoms, n_maps, plan,
                strategy, update_H, update_W, use_inhibition, use_cross,
                beta):
    """Init + fit + final energy for all models as one program.

    ``keys`` is (S, 2) PRNG keys; W/H gain a leading model axis inside
    ``vmap``.  Data, kernels and mask are shared by broadcast; strengths
    are per-model vectors.  Under a transform group H carries ``n_maps =
    n_atoms * group.size`` activation maps per model.
    """
    w_shape = (n_atoms, V.shape[1]) + plan.atom_shape
    h_shape = (V.shape[0], n_maps) + plan.transform_shape

    def init_one(key):
        return engine.init_matrices(
            key, w_shape=w_shape, h_shape=h_shape,
            n_shift_axes=plan.ndim, dtype=V.dtype)

    W0, H0 = jax.vmap(init_one)(keys)

    def fit_one(W, H, sp, inh, cross, l2v=None, orv=None):
        return engine.fit_loop(
            Vp, W, H, n_iterations, sp, inh, cross, kernels, mask,
            l2_H=l2v, ortho_W=orv,
            plan=plan, strategy=strategy, update_H=update_H,
            update_W=update_W, use_inhibition=use_inhibition,
            use_cross=use_cross, beta=beta)

    if l2 is None:
        W, H = jax.vmap(fit_one)(W0, H0, sparsity, inhibition,
                                 cross_inhibition)
    else:
        W, H = jax.vmap(fit_one)(W0, H0, sparsity, inhibition,
                                 cross_inhibition, l2, ortho)

    def energy_one(W, H):
        return engine.energy(V, W, H, mask, plan=plan, strategy=strategy,
                             beta=beta)

    return W, H, jax.vmap(energy_one)(W, H)


@partial(jax.jit,
         static_argnames=('n_iterations', 'n_atoms',
                          'n_maps') + engine._STEP_STATICS)
def _sweep_impl_traced(Vp, V, keys, sparsity, inhibition, cross_inhibition,
                       kernels, mask, l2=None, ortho=None, *,
                       n_iterations, n_atoms, n_maps,
                       plan, strategy, update_H, update_W, use_inhibition,
                       use_cross, beta):
    """Like :func:`_sweep_impl` but records the objective after every
    iteration via a ``lax.scan`` over update steps (one extra
    reconstruction per iteration — the same cost the reference pays for
    its default per-iteration energy log)."""
    w_shape = (n_atoms, V.shape[1]) + plan.atom_shape
    h_shape = (V.shape[0], n_maps) + plan.transform_shape

    def init_one(key):
        return engine.init_matrices(
            key, w_shape=w_shape, h_shape=h_shape,
            n_shift_axes=plan.ndim, dtype=V.dtype)

    W0, H0 = jax.vmap(init_one)(keys)

    def fit_one(W, H, sp, inh, cross, l2v=None, orv=None):
        def step(WH, _):
            W, H = WH
            W, H = engine.update_step(
                Vp, W, H, sp, inh, cross, kernels, mask, l2v, orv,
                plan=plan, strategy=strategy, update_H=update_H,
                update_W=update_W, use_inhibition=use_inhibition,
                use_cross=use_cross, beta=beta)
            e = engine.energy(V, W, H, mask, plan=plan, strategy=strategy,
                              beta=beta)
            return (W, H), e

        (W, H), es = jax.lax.scan(step, (W, H), None, length=n_iterations)
        return W, H, es

    if l2 is None:
        return jax.vmap(fit_one)(W0, H0, sparsity, inhibition,
                                 cross_inhibition)
    return jax.vmap(fit_one)(W0, H0, sparsity, inhibition, cross_inhibition,
                             l2, ortho)


@partial(jax.jit,
         static_argnames=('n_atoms', 'n_maps',
                          'check_every') + engine._STEP_STATICS)
def _sweep_impl_tol(Vp, V, keys, sparsity, inhibition, cross_inhibition,
                    kernels, mask, n_max, tol, l2=None, ortho=None, *,
                    n_atoms, n_maps,
                    check_every, plan, strategy, update_H, update_W,
                    use_inhibition, use_cross, beta):
    """Like :func:`_sweep_impl` but with per-model convergence detection
    (the single-model semantics of :func:`tnmf_tpu.engine.fit_loop_tol`):
    every ``check_every`` iterations each model's relative energy
    improvement ``(e_prev - e) / e_init`` is tested against ``tol``;
    converged models freeze (their W/H stop moving, exactly as if that fit
    had returned) while the rest keep iterating, and the single
    ``lax.while_loop`` exits when every model converged or at ``n_max``.
    ``n_max`` and ``tol`` are traced — changing them never recompiles."""
    w_shape = (n_atoms, V.shape[1]) + plan.atom_shape
    h_shape = (V.shape[0], n_maps) + plan.transform_shape
    acc = jnp.promote_types(V.dtype, jnp.float32)

    def init_one(key):
        return engine.init_matrices(
            key, w_shape=w_shape, h_shape=h_shape,
            n_shift_axes=plan.ndim, dtype=V.dtype)

    W, H = jax.vmap(init_one)(keys)

    def step_one(W, H, sp, inh, cross, l2v=None, orv=None):
        return engine.update_step(
            Vp, W, H, sp, inh, cross, kernels, mask, l2v, orv,
            plan=plan, strategy=strategy, update_H=update_H,
            update_W=update_W, use_inhibition=use_inhibition,
            use_cross=use_cross, beta=beta)

    def energy_one(W, H):
        return engine.energy(V, W, H, mask, plan=plan, strategy=strategy,
                             beta=beta).astype(acc)

    vstep = jax.vmap(step_one)
    venergy = jax.vmap(energy_one)

    e0 = venergy(W, H)
    scale = jnp.maximum(e0, jnp.asarray(jnp.finfo(acc).tiny, acc))

    def lane(done, x):  # broadcast the (S,) done mask over a model tensor
        return done.reshape(done.shape + (1,) * (x.ndim - 1))

    def cond(state):
        _, _, i, _, done, _ = state
        return jnp.logical_and(i < n_max, ~jnp.all(done))

    def body(state):
        W, H, i, e_prev, done, iters = state
        k = jnp.minimum(check_every, n_max - i)

        def inner(_, WH):
            if l2 is None:
                return vstep(WH[0], WH[1], sparsity, inhibition,
                             cross_inhibition)
            return vstep(WH[0], WH[1], sparsity, inhibition,
                         cross_inhibition, l2, ortho)

        W2, H2 = jax.lax.fori_loop(0, k, inner, (W, H))
        e = venergy(W2, H2)
        rel = (e_prev - e) / scale
        # frozen lanes keep their tensors / energy / iteration count; the
        # rest adopt the block's result and re-test convergence
        W = jnp.where(lane(done, W2), W, W2)
        H = jnp.where(lane(done, H2), H, H2)
        e = jnp.where(done, e_prev, e)
        iters = jnp.where(done, iters, i + k)
        done = jnp.logical_or(done, rel < tol)
        return W, H, i + k, e, done, iters

    S = keys.shape[0]
    state = (W, H, jnp.asarray(0, jnp.int32), e0,
             jnp.zeros((S,), bool), jnp.zeros((S,), jnp.int32))
    W, H, _, e, _, iters = jax.lax.while_loop(cond, body, state)
    return W, H, e, iters


# ---------------------------------------------------------------------------
# HALS sweeps (solver='hals': exact coordinate descent on the plain-NMF
# geometry, :mod:`tnmf_tpu.engine_hals`) — the vmapped analogue of
# sklearn users' alpha grids over NMF(solver='cd')
# ---------------------------------------------------------------------------

def _hals_vmap_pieces(V, keys, *, n_atoms, inner, plan):
    """Shared vmapped init / iteration / energy closures of the HALS
    sweep impls.  The per-model iteration inlines
    :func:`engine_hals._iteration` (rather than the public jitted loops,
    whose buffer donation is meaningless under ``vmap``)."""
    w_shape = (n_atoms, V.shape[1]) + plan.atom_shape
    h_shape = (V.shape[0], n_atoms) + plan.transform_shape
    V2 = V.reshape(V.shape[0], -1)
    precision = plan.lax_precision

    def init_one(key):
        return engine.init_matrices(
            key, w_shape=w_shape, h_shape=h_shape,
            n_shift_axes=plan.ndim, dtype=V.dtype)

    def iter_one(W, H, l1v, l2v):
        W2 = W.reshape(W.shape[0], -1)
        H2 = H.reshape(H.shape[0], H.shape[1])
        zw = jnp.zeros((), l1v.dtype)
        W2, H2 = engine_hals._iteration(
            V2, W2, H2, l1v, l2v, zw, zw, inner=inner, update_H=True,
            update_W=True, precision=precision)
        return W2.reshape(W.shape), H2.reshape(H.shape)

    def energy_one(W, H):
        return engine_hals._energy(
            V2, W.reshape(W.shape[0], -1), H.reshape(H.shape[0], H.shape[1]),
            precision)

    W0, H0 = jax.vmap(init_one)(keys)
    return W0, H0, iter_one, energy_one


@partial(jax.jit,
         static_argnames=('n_iterations', 'n_atoms', 'inner', 'plan',
                          'trace'))
def _sweep_impl_hals(V, keys, l1, l2, *, n_iterations, n_atoms, inner,
                     plan, trace: bool):
    """All-model HALS fit (optionally with per-iteration energy traces)."""
    W, H, iter_one, energy_one = _hals_vmap_pieces(
        V, keys, n_atoms=n_atoms, inner=inner, plan=plan)
    viter = jax.vmap(iter_one)
    venergy = jax.vmap(energy_one)
    if trace:
        def step(WH, _):
            W, H = viter(WH[0], WH[1], l1, l2)
            return (W, H), venergy(W, H)

        (W, H), es = jax.lax.scan(step, (W, H), None, length=n_iterations)
        return W, H, es.T  # (S, n_iterations)

    def body(_, WH):
        return viter(WH[0], WH[1], l1, l2)

    W, H = jax.lax.fori_loop(0, n_iterations, body, (W, H))
    return W, H, venergy(W, H)


@partial(jax.jit,
         static_argnames=('n_atoms', 'inner', 'plan', 'check_every'))
def _sweep_impl_hals_tol(V, keys, l1, l2, n_max, tol, *, n_atoms, inner,
                         plan, check_every):
    """Per-model convergence detection for the HALS sweep — the same
    freeze-converged-lanes protocol as :func:`_sweep_impl_tol`."""
    W, H, iter_one, energy_one = _hals_vmap_pieces(
        V, keys, n_atoms=n_atoms, inner=inner, plan=plan)
    viter = jax.vmap(iter_one)
    venergy = jax.vmap(energy_one)
    acc = jnp.promote_types(V.dtype, jnp.float32)

    e0 = venergy(W, H).astype(acc)
    scale = jnp.maximum(e0, jnp.asarray(jnp.finfo(acc).tiny, acc))
    tol = tol.astype(acc)

    def lane(done, x):
        return done.reshape(done.shape + (1,) * (x.ndim - 1))

    def cond(state):
        _, _, i, _, done, _ = state
        return jnp.logical_and(i < n_max, ~jnp.all(done))

    def body(state):
        W, H, i, e_prev, done, iters = state
        k = jnp.minimum(check_every, n_max - i)
        W2, H2 = jax.lax.fori_loop(
            0, k, lambda _, WH: viter(WH[0], WH[1], l1, l2), (W, H))
        e = venergy(W2, H2).astype(acc)
        rel = (e_prev - e) / scale
        W = jnp.where(lane(done, W2), W, W2)
        H = jnp.where(lane(done, H2), H, H2)
        e = jnp.where(done, e_prev, e)
        iters = jnp.where(done, iters, i + k)
        done = jnp.logical_or(done, rel < tol)
        return W, H, i + k, e, done, iters

    S = keys.shape[0]
    state = (W, H, jnp.asarray(0, jnp.int32), e0,
             jnp.zeros((S,), bool), jnp.zeros((S,), jnp.int32))
    W, H, _, e, _, iters = jax.lax.while_loop(cond, body, state)
    return W, H, e, iters


def sweep_fit(
    V,
    n_atoms: int,
    atom_shape: Tuple[int, ...],
    *,
    n_models: Optional[int] = None,
    seed: Union[int, np.ndarray] = 0,
    n_iterations: int = 100,
    sparsity=0.0,
    inhibition=0.0,
    cross_inhibition=0.0,
    l2=0.0,
    ortho=0.0,
    inhibition_range: Optional[Tuple[int, ...]] = None,
    reconstruction_mode: str = 'valid',
    strategy: str = 'auto',
    beta_loss: float = 2.0,
    transform_type: str = 'shift',
    mask=None,
    dtype=None,
    precision: Optional[str] = None,
    mesh=None,
    record_energies: bool = False,
    tol: Optional[float] = None,
    tol_check_every: int = 10,
    solver: str = 'mu',
    hals_inner='auto',
) -> SweepResult:
    """Fit ``n_models`` independent TNMF models on the same data in one
    compiled graph and return all of them with their final objectives.

    Each model gets its own device-side random initialization (derived from
    ``seed``: an int, split into per-model keys — or an explicit vector of
    per-model integer seeds) and its own regularization strengths:
    ``sparsity`` / ``inhibition`` / ``cross_inhibition`` / ``l2`` (ridge
    on H) / ``ortho`` (cross-atom dictionary orthogonality — the model
    class's ``l2_H`` / ``ortho_W``) may each be a scalar (shared) or a
    length-``n_models`` vector (a grid).  When every hyperparameter is
    scalar this is a pure multi-restart; mixed vectors give seed x
    strength grids by construction (build the vectors accordingly).

    Static per-sweep (they change the compiled graph, not a traced value):
    ``reconstruction_mode``, ``strategy``, ``beta_loss``, ``n_atoms``,
    ``atom_shape``, ``inhibition_range``.

    With ``mesh=`` (a 1-D ``jax.sharding.Mesh``, e.g.
    :func:`tnmf_tpu.parallel.sharding.make_mesh_models`) the model axis is
    sharded across devices — the sweep is embarrassingly parallel (zero
    collectives), so ``n_models`` must be divisible by the mesh size.

    ``transform_type`` ties each atom across flip/rotation copies exactly
    like the model class (H then carries ``n_atoms * n_transforms`` maps
    per model, m-major).

    ``tol`` enables per-model early stopping (the model's
    ``fit_batch(tol=...)`` semantics, checked every ``tol_check_every``
    iterations): converged models freeze in place while the rest keep
    iterating, and the sweep's single on-device while_loop exits as soon
    as every model converged (or at ``n_iterations``).  The result then
    carries ``n_iters`` (iterations each model actually ran).  Mutually
    exclusive with ``record_energies`` (traces need a static length).

    ``solver='hals'`` runs every model with exact block coordinate
    descent instead of MU (the model class's ``fit(solver='hals')``,
    :mod:`tnmf_tpu.engine_hals`) — the vmapped analogue of sklearn
    users' alpha grids over ``NMF(solver='cd')``.  Requires the
    degenerate plain-NMF geometry and composes with ``sparsity`` (L1 on
    H) and ``l2`` grids, ``tol``, ``record_energies`` and ``mesh``;
    MU-only knobs (inhibition, ortho, masks, ``beta_loss != 2``,
    transform groups) are rejected.  ``hals_inner`` as in the model
    class (time-based ``'auto'`` by default).

    Unsupported here (use
    :class:`~tnmf_tpu.models.tnmf.TransformInvariantNMF` per model
    instead): minibatch/stream drivers, callbacks, host-RNG
    reference-parity init.
    """
    V = jnp.asarray(V)
    if dtype is not None:
        V = V.astype(dtype)
    if V.dtype == jnp.float64:
        V = V.astype(jnp.float32)
    if not bool(jnp.all(V >= 0)):
        raise ValueError('sweep_fit requires nonnegative data '
                         '(reference precondition, '
                         'TransformInvariantNMF.py:326)')
    if float(beta_loss) <= 0 and not bool(jnp.all(V > 0)) and mask is None:
        raise ValueError('beta_loss <= 0 (Itakura-Saito family) requires '
                         'strictly positive data (or a mask excluding the '
                         'zeros): D_beta(v || r) diverges as v -> 0')

    if n_models is None:
        seeds = np.atleast_1d(np.asarray(seed, dtype=np.uint32))
        if np.ndim(seed) == 0:
            raise ValueError('pass n_models (or a vector of per-model '
                             'seeds) to size the sweep')
        n_models = int(seeds.shape[0])
        keys = jnp.stack([jax.random.PRNGKey(int(s)) for s in seeds])
    else:
        if np.ndim(seed) != 0:
            raise ValueError('pass either n_models with a scalar seed, or a '
                             'vector of per-model seeds without n_models')
        keys = jax.random.split(jax.random.PRNGKey(int(seed)), n_models)
        seeds = np.arange(n_models, dtype=np.uint32)  # positional labels

    n_atoms = int(n_atoms)
    atom_shape = tuple(int(a) for a in atom_shape)
    from ..ops.transforms import make_group
    group = make_group(transform_type, atom_shape)
    n_maps = n_atoms * (group.size if group is not None else 1)
    plan = ConvPlan.create(reconstruction_mode, tuple(V.shape[2:]),
                           atom_shape, precision=precision)
    if solver not in ('mu', 'hals'):
        raise ValueError(f"solver must be 'mu' or 'hals', got {solver!r}")
    if solver == 'hals':
        if group is not None:
            raise ValueError("transform groups are MU-only under "
                             "solver='hals' (plain-NMF geometry)")
        if float(beta_loss) != 2.0:
            raise ValueError("solver='hals' requires beta_loss=2 "
                             '(Frobenius) — no closed-form coordinate '
                             'minimizer exists for other divergences')
        if mask is not None:
            raise ValueError("masked/weighted sweeps are MU-only under "
                             "solver='hals'")
        if np.any(np.asarray(inhibition, np.float64) > 0) or \
                np.any(np.asarray(cross_inhibition, np.float64) > 0) or \
                np.any(np.asarray(ortho, np.float64) > 0):
            raise ValueError("inhibition / cross_inhibition / ortho are "
                             "MU-only regularizers under solver='hals' "
                             '(the exact sweep minimizes the L1/L2-'
                             'regularized Frobenius objective)')
        if int(np.prod(plan.transform_shape)) != 1:
            raise ValueError(
                "solver='hals' requires the degenerate plain-NMF geometry "
                "(mode 'full' with atom_shape == sample_shape)")
        sdt = V.dtype
        acc = jnp.promote_types(sdt, jnp.float32)
        l1v = _per_model(sparsity, n_models, 'sparsity', acc)
        l2v = _per_model(l2, n_models, 'l2', acc)
        inner = engine_hals.auto_inner(
            n_atoms, int(V.shape[1] * np.prod(atom_shape)), hals_inner,
            n_samples=int(V.shape[0]))
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            n_dev = int(np.prod(mesh.devices.shape))
            if n_models % n_dev:
                raise ValueError(
                    f'n_models ({n_models}) must be divisible by the mesh '
                    f'size ({n_dev}) for the model axis')
            model_sh = NamedSharding(mesh, P(mesh.axis_names[0]))
            rep = NamedSharding(mesh, P())
            keys, l1v, l2v = (jax.device_put(x, model_sh)
                              for x in (keys, l1v, l2v))
            V = jax.device_put(V, rep)
        statics = dict(n_atoms=n_atoms, inner=inner, plan=plan)
        if tol is not None:
            if record_energies:
                raise ValueError('tol= and record_energies are mutually '
                                 'exclusive (per-iteration traces need a '
                                 'static iteration count)')
            if tol < 0 or int(tol_check_every) < 1:
                raise ValueError('tol must be >= 0 and tol_check_every >= 1')
            W, H, E, iters = _sweep_impl_hals_tol(
                V, keys, l1v, l2v, jnp.asarray(int(n_iterations), jnp.int32),
                jnp.asarray(tol, acc), check_every=int(tol_check_every),
                **statics)
            return SweepResult(W=W, H=H, energies=E, seeds=seeds,
                               n_iters=iters)
        W, H, E = _sweep_impl_hals(
            V, keys, l1v, l2v, n_iterations=int(n_iterations),
            trace=bool(record_energies), **statics)
        if record_energies:
            return SweepResult(W=W, H=H, energies=E[:, -1], seeds=seeds,
                               energy_traces=E)
        return SweepResult(W=W, H=H, energies=E, seeds=seeds)
    strategy = engine.resolve_strategy(strategy, plan, n_maps, V.shape[1])
    if group is not None:
        strategy = (strategy, group)

    sdt = V.dtype  # strengths ride in the storage dtype, like the model
    sp = _per_model(sparsity, n_models, 'sparsity', sdt)
    inh = _per_model(inhibition, n_models, 'inhibition', sdt)
    cross = _per_model(cross_inhibition, n_models, 'cross_inhibition', sdt)
    # zero is exact under MU (pos + 0*X == pos), so when either term is
    # active both ride as per-model vectors; all-zero -> None keeps the
    # unregularized graphs
    if np.any(np.asarray(l2, np.float64) > 0) or \
            np.any(np.asarray(ortho, np.float64) > 0):
        l2v = _per_model(l2, n_models, 'l2', sdt)
        orv = _per_model(ortho, n_models, 'ortho', sdt)
    else:
        l2v = orv = None
    use_inh = bool(np.any(np.asarray(inh, np.float32) > 0))
    use_cross = bool(np.any(np.asarray(cross, np.float32) > 0))
    rng_range = resolve_inhibition_range(inhibition_range, atom_shape)
    kernels = tuple(jnp.asarray(k, dtype=sdt)
                    for k in inhibition_kernels(rng_range))

    if mask is not None:
        mask = jnp.broadcast_to(jnp.asarray(mask), V.shape).astype(V.dtype)
    Vc = V if mask is None or beta_loss != 2.0 else V * mask
    if beta_loss == 2.0 or (mask is None
                            and engine.beta_prepares_data(strategy)):
        Vp = engine.prepare_data(Vc, plan=plan, strategy=strategy)
    else:
        # fft beta losses / masked beta losses consume the canonical tensor
        # (engine._beta_factors docstring)
        Vp = Vc

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        n_dev = int(np.prod(mesh.devices.shape))
        if n_models % n_dev:
            raise ValueError(
                f'n_models ({n_models}) must be divisible by the mesh size '
                f'({n_dev}) for the embarrassingly-parallel model axis')
        model_sh = NamedSharding(mesh, P(mesh.axis_names[0]))
        rep = NamedSharding(mesh, P())
        keys, sp, inh, cross = (jax.device_put(x, model_sh)
                                for x in (keys, sp, inh, cross))
        if l2v is not None:
            l2v, orv = (jax.device_put(x, model_sh) for x in (l2v, orv))
        Vp = jax.device_put(Vp, rep)
        V = jax.device_put(V, rep)
        if mask is not None:
            mask = jax.device_put(mask, rep)

    statics = dict(
        n_iterations=int(n_iterations), n_atoms=n_atoms, n_maps=n_maps,
        plan=plan, strategy=strategy, update_H=True, update_W=True,
        use_inhibition=use_inh, use_cross=use_cross, beta=float(beta_loss))
    if tol is not None:
        if record_energies:
            raise ValueError('tol= and record_energies are mutually '
                             'exclusive (per-iteration traces need a '
                             'static iteration count)')
        if tol < 0 or int(tol_check_every) < 1:
            raise ValueError('tol must be >= 0 and tol_check_every >= 1')
        tol_statics = dict(statics)
        n_max = tol_statics.pop('n_iterations')
        acc = jnp.promote_types(V.dtype, jnp.float32)
        W, H, E, iters = _sweep_impl_tol(
            Vp, V, keys, sp, inh, cross, kernels, mask,
            jnp.asarray(n_max, jnp.int32), jnp.asarray(tol, acc),
            l2v, orv,
            check_every=int(tol_check_every), **tol_statics)
        return SweepResult(W=W, H=H, energies=E, seeds=seeds, n_iters=iters)
    if record_energies:
        # per-iteration objective traces (one extra reconstruction per
        # iteration — what the reference pays for its default energy log)
        W, H, traces = _sweep_impl_traced(
            Vp, V, keys, sp, inh, cross, kernels, mask, l2v, orv, **statics)
        return SweepResult(W=W, H=H, energies=traces[:, -1], seeds=seeds,
                           energy_traces=traces)
    W, H, E = _sweep_impl(
        Vp, V, keys, sp, inh, cross, kernels, mask, l2v, orv, **statics)
    return SweepResult(W=W, H=H, energies=E, seeds=seeds)
