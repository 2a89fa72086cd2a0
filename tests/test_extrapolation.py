"""Extrapolated (accelerated) MU: fit(extrapolate=...).

The reference's plain Lee-Seung MU has no acceleration of any kind
(``TransformInvariantNMF.py:217-238``); the engine's extrapolated loop
(Ang & Gillis 2019-style heuristic extrapolation with restarts, with
MULTIPLICATIVE momentum — additive momentum clips at zero and zeros are
absorbing under MU) reaches a given tolerance in substantially fewer
iterations.  These tests pin the defining behaviors: acceleration on a
seeded fixture, safeguard restarts, guard rails, and composition with
strategies/regularizers/masks/meshes.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tnmf_tpu import TransformInvariantNMF


@pytest.fixture
def force_phased(monkeypatch):
    from tnmf_tpu import engine
    monkeypatch.setattr(engine, '_phased_device', lambda: True)


def _V(shape=(4, 2, 32, 32), seed=3):
    return np.random.default_rng(seed).random(shape)


def _fit(V, extrapolate=False, tol=1e-5, n_iterations=2000, **kw):
    np.random.seed(42)
    m = TransformInvariantNMF(n_atoms=5, atom_shape=(5, 5),
                              **{k: kw.pop(k) for k in ('backend', 'mesh')
                                 if k in kw})
    m.fit(V, n_iterations=n_iterations, tol=tol, tol_check_every=10,
          extrapolate=extrapolate, **kw)
    return m


def test_extrapolation_accelerates_tol_fit():
    """The headline behavior: same seeded start, same tol — the
    extrapolated fit stops in at most half the iterations and at an
    energy no worse than plain MU's."""
    V = _V()
    plain = _fit(V)
    xtr = _fit(V, extrapolate=True)
    assert xtr.n_iterations_ <= 0.6 * plain.n_iterations_
    assert float(xtr._energy_function()) <= float(plain._energy_function())
    # the dictionary keeps its invariants (per-atom-channel sum norm)
    np.testing.assert_allclose(
        np.asarray(xtr.W, np.float64).sum(axis=(-2, -1)), 1.0, rtol=1e-5)
    assert (np.asarray(xtr.H) >= 0).all()


def test_extrapolation_fixed_iteration_count():
    """Without tol the loop runs exactly n_iterations and still ends at
    an energy no worse than plain MU after the same count."""
    V = _V()
    plain = _fit(V, tol=None, n_iterations=60)
    xtr = _fit(V, extrapolate=True, tol=None, n_iterations=60)
    assert xtr.n_iterations_ == 60
    assert (float(xtr._energy_function())
            <= 1.05 * float(plain._energy_function()))


def test_extrapolation_momentum_weight_sweep():
    """Any valid initial momentum weight converges to a sane solution
    (the safeguard handles aggressive weights)."""
    V = _V()
    plain = _fit(V)
    for b in (0.2, 0.8):
        x = _fit(V, extrapolate=b)
        assert float(x._energy_function()) <= float(plain._energy_function())
        assert np.isfinite(np.asarray(x.W, np.float64)).all()


def test_extrapolation_guard_rails():
    V = _V()
    m = TransformInvariantNMF(n_atoms=5, atom_shape=(5, 5))
    with pytest.raises(ValueError, match='extrapolate'):
        m.fit(V, extrapolate=True, progress_callback=lambda a, b: True)
    with pytest.raises(ValueError, match='extrapolate'):
        m.fit(V, extrapolate=True, revive_every=5)
    with pytest.raises(ValueError, match='momentum'):
        m.fit(V, extrapolate=1.5)
    with pytest.raises(ValueError, match='momentum'):
        m.fit(V, extrapolate=-0.1)


def test_extrapolation_composes_with_regularizers_and_masks():
    """Sparsity + l2 + mask: the accelerated loop reaches the tolerance
    with every gradient term active, nonnegative factors, unit norms."""
    V = _V()
    mask = (np.random.default_rng(7).random(V.shape) > 0.3).astype(V.dtype)
    x = _fit(V, extrapolate=True, sparsity_H=0.05, l2_H=0.01, mask=mask)
    assert np.isfinite(float(x._energy_function()))
    assert (np.asarray(x.H) >= 0).all()
    np.testing.assert_allclose(
        np.asarray(x.W, np.float64).sum(axis=(-2, -1)), 1.0, rtol=1e-5)


def test_extrapolation_composes_with_beta_divergence():
    """KL objective (beta=1): the accelerated loop respects the positive
    domain and improves on plain MU at equal iteration count."""
    V = _V() + 0.05  # strictly positive for KL
    np.random.seed(42)
    plain = TransformInvariantNMF(n_atoms=4, atom_shape=(5, 5), beta_loss=1.0)
    plain.fit(V, n_iterations=80)
    np.random.seed(42)
    xtr = TransformInvariantNMF(n_atoms=4, atom_shape=(5, 5), beta_loss=1.0)
    xtr.fit(V, n_iterations=80, extrapolate=True)
    assert (float(xtr._energy_function())
            <= 1.05 * float(plain._energy_function()))


def test_extrapolation_phased_strategy(force_phased):
    """The accelerated loop carries the phase-blocked H through the
    while_loop: phased ≡ conv trajectories (same extrapolation path)."""
    V = np.random.default_rng(5).random((2, 1, 16, 14))

    def run(backend):
        np.random.seed(42)
        m = TransformInvariantNMF(n_atoms=3, atom_shape=(5, 9),
                                  backend=backend)
        m.fit(V, n_iterations=30, extrapolate=True)
        return m

    ph, conv = run('jax_conv'), run('jax_fft')
    assert ph._strategy == 'phased' and conv._strategy == 'fft'
    np.testing.assert_allclose(ph.W, conv.W, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(ph.H, conv.H, rtol=1e-7, atol=1e-9)


def test_extrapolation_sharded_matches_single_device():
    """Mesh-sharded extrapolated fit reproduces the single-device
    trajectory (the momentum is elementwise, the safeguard energy is a
    psum — nothing order-dependent beyond the usual reductions)."""
    import jax
    from tnmf_tpu.parallel import make_mesh
    if jax.device_count() < 8:
        pytest.skip('needs 8 (virtual) devices')
    V = _V(shape=(8, 1, 16, 16))
    single = _fit(V, extrapolate=True, tol=None, n_iterations=25)
    sharded = _fit(V, extrapolate=True, tol=None, n_iterations=25,
                   mesh=make_mesh(8))
    np.testing.assert_allclose(sharded.W, single.W, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(sharded.H, single.H, rtol=1e-8, atol=1e-10)


def test_extrapolation_transform_only():
    """update_W=False (serving-style H inference) extrapolates H only."""
    V = _V()
    base = _fit(V, tol=None, n_iterations=40)
    np.random.seed(42)
    m = TransformInvariantNMF(n_atoms=5, atom_shape=(5, 5))
    m.fit(V, n_iterations=40)
    W_frozen = m.W.copy()
    m.fit(V, n_iterations=200, keep_W=True, update_W=False,
          extrapolate=True, tol=1e-6, tol_check_every=10)
    np.testing.assert_array_equal(m.W, W_frozen)  # dictionary untouched
    assert np.isfinite(float(m._energy_function()))
    del base
