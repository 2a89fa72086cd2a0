"""Vmapped hyperparameter sweeps (tnmf_tpu.models.sweep).

The defining property: a sweep is *exactly* S independent fits — the
vmapped graph must reproduce, model by model, what the engine produces
when each (key, strengths) pair is initialized and fitted on its own.
The reference library has no counterpart (sweeps there are a Python loop
of ``fit`` calls); the per-model strength vectors are exact because the
engine treats strengths as traced scalars and strength 0 contributes
``0 * term`` to the MU denominator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tnmf_tpu import engine, sweep_fit
from tnmf_tpu.models.sweep import SweepResult
from tnmf_tpu.ops.inhibition import inhibition_kernels, resolve_inhibition_range
from tnmf_tpu.ops.modes import ConvPlan
from tnmf_tpu.parallel import MODEL_AXIS, make_mesh_models

needs_8_devices = pytest.mark.skipif(
    jax.device_count() < 8, reason='needs 8 (virtual) devices')


def _make_V(n=4, c=1, s=12):
    rng = np.random.default_rng(7)
    return rng.random((n, c, s, s)).astype(np.float32)


def _fit_one_by_hand(V, key, n_atoms, atom_shape, n_iter, sp, inh, cross,
                     mode='valid', strategy=None, beta=2.0):
    """One model through the engine directly — the sweep's ground truth."""
    plan = ConvPlan.create(mode, V.shape[2:], atom_shape)
    if strategy is None:
        strategy = engine.resolve_strategy('auto', plan, n_atoms, V.shape[1])
    kernels = tuple(jnp.asarray(k, dtype=V.dtype) for k in inhibition_kernels(
        resolve_inhibition_range(None, atom_shape)))
    Vd = jnp.asarray(V)
    Vp = engine.prepare_data(Vd, plan=plan, strategy=strategy)
    W0, H0 = engine.init_matrices(
        key, w_shape=(n_atoms, V.shape[1]) + atom_shape,
        h_shape=(V.shape[0], n_atoms) + plan.transform_shape,
        n_shift_axes=plan.ndim, dtype=Vd.dtype)
    W, H = engine.fit_loop(
        Vp, W0, H0, n_iter, jnp.float32(sp), jnp.float32(inh),
        jnp.float32(cross), kernels, plan=plan, strategy=strategy,
        use_inhibition=True, use_cross=True,  # strength 0 is an exact no-op
        beta=beta)
    E = engine.energy(Vd, W, H, plan=plan, strategy=strategy, beta=beta)
    return np.asarray(W), np.asarray(H), float(E)


def test_sweep_matches_individual_fits():
    V = _make_V()
    sp = np.array([0.0, 0.1, 0.5], np.float32)
    inh = np.array([0.1, 0.0, 0.2], np.float32)
    res = sweep_fit(V, 3, (3, 3), n_models=3, seed=11, n_iterations=5,
                    sparsity=sp, inhibition=inh, cross_inhibition=0.05)
    assert isinstance(res, SweepResult)
    assert res.W.shape == (3, 3, 1, 3, 3)
    assert res.H.shape[0] == 3

    keys = jax.random.split(jax.random.PRNGKey(11), 3)
    for s in range(3):
        W, H, E = _fit_one_by_hand(V, keys[s], 3, (3, 3), 5,
                                   sp[s], inh[s], 0.05)
        np.testing.assert_allclose(np.asarray(res.W[s]), W, rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(np.asarray(res.H[s]), H, rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(float(res.energies[s]), E, rtol=1e-5)


def test_sweep_regularization_vector_actually_differs():
    V = _make_V()
    res = sweep_fit(V, 2, (3, 3), n_models=2, seed=0, n_iterations=6,
                    sparsity=np.array([0.0, 2.0], np.float32))
    # identical keys would make the models equal; different sparsity and
    # different keys must separate both H and the objective
    l1 = np.sum(np.abs(np.asarray(res.H)), axis=tuple(range(1, res.H.ndim)))
    assert l1[1] < l1[0]  # sparsity shrinks activations
    assert res.best in (0, 1)
    W0, H0 = res.model(0)
    assert isinstance(W0, np.ndarray) and isinstance(H0, np.ndarray)
    assert res.n_models == 2


def test_sweep_seed_vector_reproducible():
    V = _make_V(n=2, s=10)
    a = sweep_fit(V, 2, (3, 3), seed=np.array([3, 9]), n_iterations=3)
    b = sweep_fit(V, 2, (3, 3), seed=np.array([3, 9]), n_iterations=3)
    np.testing.assert_array_equal(np.asarray(a.W), np.asarray(b.W))
    np.testing.assert_array_equal(a.seeds, np.array([3, 9], np.uint32))
    # different seeds give different models
    assert not np.allclose(np.asarray(a.W[0]), np.asarray(a.W[1]))


@needs_8_devices
def test_sweep_mesh_parity_and_layout():
    V = _make_V()
    mesh = make_mesh_models(8)
    kw = dict(n_models=8, seed=5, n_iterations=4,
              sparsity=np.linspace(0, 1, 8).astype(np.float32))
    plain = sweep_fit(V, 2, (3, 3), **kw)
    sharded = sweep_fit(V, 2, (3, 3), mesh=mesh, **kw)
    np.testing.assert_allclose(np.asarray(sharded.W), np.asarray(plain.W),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(np.asarray(sharded.energies),
                               np.asarray(plain.energies), rtol=1e-6)
    spec = sharded.H.sharding.spec
    assert spec[0] == MODEL_AXIS  # model axis is really distributed


def test_sweep_phased_strategy_matches_individual(monkeypatch):
    monkeypatch.setattr(engine, '_phased_device', lambda: True)
    V = _make_V()
    res = sweep_fit(V, 2, (3, 3), n_models=2, seed=4, n_iterations=4,
                    strategy='conv', sparsity=0.1)
    # the channel-poor geometry upgrades to the phased lowering
    keys = jax.random.split(jax.random.PRNGKey(4), 2)
    for s in range(2):
        W, H, E = _fit_one_by_hand(V, keys[s], 2, (3, 3), 4, 0.1, 0.0, 0.0,
                                   strategy=engine.resolve_strategy(
                                       'conv', ConvPlan.create(
                                           'valid', V.shape[2:], (3, 3)),
                                       2, 1))
        np.testing.assert_allclose(np.asarray(res.W[s]), W, rtol=1e-5,
                                   atol=1e-7)


def test_sweep_transform_group_matches_individual():
    """Sweeps compose with tied transform-invariant dictionaries: each
    model's trajectory equals a standalone engine fit under the same
    (strategy, group) tuple."""
    from tnmf_tpu.ops.transforms import make_group
    V = _make_V(n=2, s=10)
    res = sweep_fit(V, 2, (3, 3), n_models=2, seed=6, n_iterations=3,
                    sparsity=0.1, transform_type='shift+flip')
    group = make_group('shift+flip', (3, 3))
    assert res.H.shape[2] == 2 * group.size  # m-major tied maps
    plan = ConvPlan.create('valid', V.shape[2:], (3, 3))
    base = engine.resolve_strategy('auto', plan, 2 * group.size, 1)
    keys = jax.random.split(jax.random.PRNGKey(6), 2)
    for s in range(2):
        Vd = jnp.asarray(V)
        Vp = engine.prepare_data(Vd, plan=plan, strategy=(base, group))
        W0, H0 = engine.init_matrices(
            keys[s], w_shape=(2, 1, 3, 3),
            h_shape=(2, 2 * group.size) + plan.transform_shape,
            n_shift_axes=plan.ndim, dtype=Vd.dtype)
        kernels = tuple(jnp.asarray(k, dtype=Vd.dtype)
                        for k in inhibition_kernels(
                            resolve_inhibition_range(None, (3, 3))))
        W, H = engine.fit_loop(
            Vp, W0, H0, 3, jnp.float32(0.1), jnp.float32(0),
            jnp.float32(0), kernels, plan=plan, strategy=(base, group),
            use_inhibition=False, use_cross=False)
        np.testing.assert_allclose(np.asarray(res.W[s]), np.asarray(W),
                                   rtol=1e-5, atol=1e-7)


def test_sweep_beta_and_mask_smoke():
    V = _make_V(n=2, s=10) + 0.05
    res = sweep_fit(V, 2, (3, 3), n_models=2, seed=1, n_iterations=3,
                    beta_loss=1.0)
    E = np.asarray(res.energies)
    assert np.all(np.isfinite(E)) and np.all(E >= 0)
    assert np.all(np.asarray(res.W) >= 0)

    mask = np.ones(V.shape, np.float32)
    mask[:, :, :3] = 0.0
    Vg = V.copy()
    Vg[:, :, :3] = 77.0  # garbage under the mask must not matter
    r1 = sweep_fit(V, 2, (3, 3), n_models=2, seed=2, n_iterations=3,
                   mask=mask)
    r2 = sweep_fit(Vg, 2, (3, 3), n_models=2, seed=2, n_iterations=3,
                   mask=mask)
    np.testing.assert_allclose(np.asarray(r1.W), np.asarray(r2.W),
                               rtol=1e-6, atol=1e-8)


def test_sweep_energy_traces():
    """record_energies: per-iteration objective traces per model.  MU is
    monotone for the Euclidean loss, the last trace entry is the reported
    final energy, and the fitted state matches the untraced path."""
    V = _make_V(n=2, s=10)
    kw = dict(n_models=2, seed=7, n_iterations=6,
              sparsity=np.array([0.0, 0.3], np.float32))
    traced = sweep_fit(V, 2, (3, 3), record_energies=True, **kw)
    plain = sweep_fit(V, 2, (3, 3), **kw)
    assert traced.energy_traces.shape == (2, 6)
    t = np.asarray(traced.energy_traces)
    assert np.all(np.diff(t[0]) <= 1e-6)  # unregularized: monotone descent
    np.testing.assert_allclose(np.asarray(traced.energies), t[:, -1])
    np.testing.assert_allclose(np.asarray(traced.W), np.asarray(plain.W),
                               rtol=1e-5, atol=1e-7)
    assert plain.energy_traces is None


def test_sweep_tol_matches_fit_loop_tol_per_model():
    """tol= early stopping is exactly S independent ``fit_loop_tol`` runs:
    per model the stop iteration, final tensors and final objective must
    match the engine's single-model adaptive loop (converged lanes freeze
    while the others keep iterating)."""
    V = _make_V()
    sp = np.array([0.0, 0.8], np.float32)
    res = sweep_fit(V, 3, (3, 3), n_models=2, seed=13, n_iterations=40,
                    sparsity=sp, tol=2e-3, tol_check_every=4)
    assert res.n_iters is not None and res.n_iters.shape == (2,)
    keys = jax.random.split(jax.random.PRNGKey(13), 2)
    plan = ConvPlan.create('valid', V.shape[2:], (3, 3))
    strategy = engine.resolve_strategy('auto', plan, 3, 1)
    kernels = tuple(jnp.asarray(k, dtype=V.dtype) for k in inhibition_kernels(
        resolve_inhibition_range(None, (3, 3))))
    Vd = jnp.asarray(V)
    Vp = engine.prepare_data(Vd, plan=plan, strategy=strategy)
    for s in range(2):
        W0, H0 = engine.init_matrices(
            keys[s], w_shape=(3, 1, 3, 3),
            h_shape=(V.shape[0], 3) + plan.transform_shape,
            n_shift_axes=plan.ndim, dtype=Vd.dtype)
        W, H, n_done, E, _ = engine.fit_loop_tol(
            Vp, Vd, W0, H0, jnp.int32(40), jnp.float32(2e-3),
            jnp.float32(sp[s]), jnp.float32(0), jnp.float32(0), kernels,
            check_every=4, plan=plan, strategy=strategy)
        assert int(res.n_iters[s]) == int(n_done)
        np.testing.assert_allclose(np.asarray(res.W[s]), np.asarray(W),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(np.asarray(res.H[s]), np.asarray(H),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(float(res.energies[s]), float(E),
                                   rtol=1e-5)


def test_sweep_tol_zero_runs_to_n_iterations():
    """tol=0 never triggers (the single-model semantics: continue while
    rel >= tol) — the result equals the fixed-iteration sweep exactly."""
    V = _make_V(n=2, s=10)
    kw = dict(n_models=2, seed=3, n_iterations=12,
              sparsity=np.array([0.0, 0.4], np.float32))
    fixed = sweep_fit(V, 2, (3, 3), **kw)
    tolled = sweep_fit(V, 2, (3, 3), tol=0.0, tol_check_every=5, **kw)
    np.testing.assert_array_equal(np.asarray(tolled.n_iters), [12, 12])
    np.testing.assert_allclose(np.asarray(tolled.W), np.asarray(fixed.W),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(np.asarray(tolled.energies),
                               np.asarray(fixed.energies), rtol=1e-6)


def test_sweep_tol_error_paths():
    V = _make_V(n=2, s=10)
    with pytest.raises(ValueError, match='mutually exclusive'):
        sweep_fit(V, 2, (3, 3), n_models=2, seed=0, tol=1e-3,
                  record_energies=True)
    with pytest.raises(ValueError, match='tol must be'):
        sweep_fit(V, 2, (3, 3), n_models=2, seed=0, tol=-1.0)
    with pytest.raises(ValueError, match='tol must be'):
        sweep_fit(V, 2, (3, 3), n_models=2, seed=0, tol=1e-3,
                  tol_check_every=0)


def test_sweep_bfloat16_runs():
    V = _make_V(n=2, s=10)
    res = sweep_fit(V, 2, (3, 3), n_models=2, seed=0, n_iterations=3,
                    dtype='bfloat16')
    assert str(res.W.dtype) == 'bfloat16'
    assert np.all(np.isfinite(np.asarray(res.energies, np.float32)))


def test_sweep_error_paths():
    V = _make_V(n=2, s=10)
    with pytest.raises(ValueError, match='nonnegative'):
        sweep_fit(V - 1.0, 2, (3, 3), n_models=2, seed=0)
    with pytest.raises(ValueError, match='strictly positive'):
        Vz = V.copy()
        Vz[0, 0, 0, 0] = 0.0
        sweep_fit(Vz, 2, (3, 3), n_models=2, seed=0, beta_loss=0.0)
    with pytest.raises(ValueError, match='n_models'):
        sweep_fit(V, 2, (3, 3), seed=0)  # scalar seed without n_models
    with pytest.raises(ValueError, match='either n_models'):
        sweep_fit(V, 2, (3, 3), n_models=2, seed=np.array([1, 2]))
    with pytest.raises(ValueError, match='sparsity'):
        sweep_fit(V, 2, (3, 3), n_models=3, seed=0,
                  sparsity=np.array([0.1, 0.2], np.float32))
    if jax.device_count() >= 8:
        with pytest.raises(ValueError, match='divisible'):
            sweep_fit(V, 2, (3, 3), n_models=3, seed=0,
                      mesh=make_mesh_models(8))


# ---------------------------------------------------------------------------
# solver='hals' (exact coordinate descent, plain-NMF geometry)
# ---------------------------------------------------------------------------

def _make_V_plain(n=6, c=1, F=20, rank=3, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.random((n, rank)) @ rng.random((rank, c * F))
    return X.reshape(n, c, F).astype(np.float32)


def _hals_fit_one_by_hand(V, key, n_atoms, n_iter, l1, l2, inner):
    """One HALS model through the engine directly — the sweep's oracle."""
    from tnmf_tpu import engine_hals
    plan = ConvPlan.create('full', V.shape[2:], V.shape[2:])
    W0, H0 = engine.init_matrices(
        key, w_shape=(n_atoms,) + V.shape[1:],
        h_shape=(V.shape[0], n_atoms) + plan.transform_shape,
        n_shift_axes=plan.ndim, dtype=jnp.float32)
    z = jnp.float32(0.0)
    W, H = engine_hals.fit_loop(
        jnp.asarray(V), W0, H0, n_iter, jnp.float32(l1), jnp.float32(l2),
        z, z, inner=inner, update_H=True, update_W=True, plan=plan)
    return np.asarray(W), np.asarray(H)


def test_sweep_hals_matches_individual_fits():
    """The vmapped HALS sweep reproduces, model by model, the standalone
    engine_hals fit from the same per-model keys and strength grid."""
    V = _make_V_plain()
    l1 = np.array([0.0, 0.05, 0.3], np.float32)
    l2 = np.array([0.2, 0.0, 0.1], np.float32)
    res = sweep_fit(V, 3, V.shape[2:], n_models=3, seed=11, n_iterations=7,
                    sparsity=l1, l2=l2, reconstruction_mode='full',
                    solver='hals', hals_inner=2)
    keys = jax.random.split(jax.random.PRNGKey(11), 3)
    for i in range(3):
        W_i, H_i = _hals_fit_one_by_hand(V, keys[i], 3, 7, l1[i], l2[i],
                                         inner=2)
        np.testing.assert_allclose(np.asarray(res.W[i]), W_i, rtol=1e-5,
                                   atol=1e-7, err_msg=f'model {i} W')
        np.testing.assert_allclose(np.asarray(res.H[i]), H_i, rtol=1e-5,
                                   atol=1e-7, err_msg=f'model {i} H')


def test_sweep_hals_traces_and_tol():
    V = _make_V_plain(n=8, F=24, rank=4)
    res = sweep_fit(V, 4, V.shape[2:], n_models=4, seed=0, n_iterations=20,
                    reconstruction_mode='full', solver='hals',
                    record_energies=True)
    assert res.energy_traces.shape == (4, 20)
    tr = np.asarray(res.energy_traces, np.float64)
    assert np.all(np.diff(tr, axis=1) <= 1e-6 * tr[:, :1])  # monotone
    np.testing.assert_allclose(np.asarray(res.energies), tr[:, -1])
    # tol: converged models freeze; every n_iters is a check multiple
    res_tol = sweep_fit(V, 4, V.shape[2:], n_models=4, seed=0,
                        n_iterations=500, reconstruction_mode='full',
                        solver='hals', tol=1e-6, tol_check_every=5)
    iters = np.asarray(res_tol.n_iters)
    assert np.all(iters % 5 == 0) and np.all(iters <= 500)
    assert np.all(np.isfinite(np.asarray(res_tol.energies)))


def test_sweep_hals_rejections():
    V = _make_V_plain(n=2)
    kw = dict(n_models=2, seed=0, reconstruction_mode='full',
              solver='hals')
    with pytest.raises(ValueError, match='MU-only regularizers'):
        sweep_fit(V, 2, V.shape[2:], inhibition=0.1, **kw)
    with pytest.raises(ValueError, match='MU-only regularizers'):
        sweep_fit(V, 2, V.shape[2:], ortho=0.1, **kw)
    with pytest.raises(ValueError, match='beta_loss=2'):
        sweep_fit(V, 2, V.shape[2:], beta_loss=1.0, **kw)
    with pytest.raises(ValueError, match='MU-only'):
        sweep_fit(V, 2, V.shape[2:], mask=np.ones_like(V), **kw)
    with pytest.raises(ValueError, match='transform groups'):
        sweep_fit(V, 2, V.shape[2:], transform_type='shift+flip', **kw)
    with pytest.raises(ValueError, match='degenerate'):
        sweep_fit(V, 2, (5,), **kw)  # shift-invariant geometry
    with pytest.raises(ValueError, match="solver must be"):
        sweep_fit(V, 2, V.shape[2:], n_models=2, seed=0, solver='nope',
                  reconstruction_mode='full')


@needs_8_devices
def test_sweep_hals_mesh_parity():
    V = _make_V_plain(n=8, F=16, rank=3)
    l1 = np.linspace(0, 0.4, 8).astype(np.float32)
    kw = dict(n_models=8, seed=4, n_iterations=6, sparsity=l1,
              reconstruction_mode='full', solver='hals')
    res = sweep_fit(V, 3, V.shape[2:], mesh=make_mesh_models(8), **kw)
    assert res.H.sharding.spec[0] == MODEL_AXIS
    res1 = sweep_fit(V, 3, V.shape[2:], **kw)
    # the model axis is embarrassingly parallel, but partitioning changes
    # the f32 Gram accumulation order and the CD clip nonlinearity
    # amplifies last-ulp differences over iterations — factor agreement is
    # loose-tolerance, the objectives must match tightly
    np.testing.assert_allclose(np.asarray(res.W), np.asarray(res1.W),
                               rtol=5e-3, atol=1e-5)
    np.testing.assert_allclose(np.asarray(res.energies),
                               np.asarray(res1.energies), rtol=1e-4)
