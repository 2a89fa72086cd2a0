"""Edge/error-path coverage of the model layer beyond test_robustness."""

import numpy as np
import pytest

from tnmf_tpu import TransformInvariantNMF


def _V(n=3, c=2, s=(10, 10)):
    return np.random.default_rng(0).random((n, c) + s)


def test_keep_w_shape_mismatch_raises():
    np.random.seed(0)
    nmf = TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3))
    nmf.fit(_V(c=2), n_iterations=1)
    with pytest.raises(ValueError, match='channel count'):
        nmf.fit(_V(c=3), n_iterations=1, keep_W=True)


def test_invalid_init_raises():
    with pytest.raises(ValueError, match="init must be"):
        TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3), init='nope')


def test_callback_interval_with_update_w_only():
    V = _V()
    np.random.seed(1)
    a = TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3))
    a.fit(V, n_iterations=6, update_H=False)
    np.random.seed(1)
    b = TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3))
    b.fit(V, n_iterations=6, update_H=False,
          progress_callback=lambda nmf, it: True, callback_interval=3)
    np.testing.assert_allclose(a.W, b.W, rtol=1e-12)


def test_global_array_requires_device_init():
    """A sharded jax.Array that is fully addressable is fine; the
    multi-host preconditions only trigger for non-addressable input."""
    import jax
    import jax.numpy as jnp
    V = jnp.asarray(_V(n=4))
    np.random.seed(0)
    nmf = TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3))
    nmf.fit(np.asarray(V), n_iterations=1)  # addressable path unchanged
    assert np.isfinite(nmf._energy_function())


def test_verbose_logging_path(caplog):
    import logging
    V = _V(n=2, s=(8, 8))
    np.random.seed(0)
    nmf = TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3), verbose=2)
    with caplog.at_level(logging.INFO, logger='TransformInvariantNMF'):
        nmf.fit(V, n_iterations=3)
    msgs = [r.message for r in caplog.records]
    assert any('Energy function' in m for m in msgs)
    assert any('TNMF finished' in m for m in msgs)


def test_record_energies_with_logging():
    """record_energies + INFO logging: fused energy loop logs each value."""
    V = _V(n=2, s=(8, 8))
    np.random.seed(0)
    nmf = TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3), verbose=2)
    nmf._logger.disabled = True
    nmf.fit(V, n_iterations=4, record_energies=True)
    nmf._logger.disabled = False
    assert nmf.energies_.shape == (4,)


def test_r_partial_sums_to_r():
    V = _V()
    np.random.seed(0)
    nmf = TransformInvariantNMF(n_atoms=3, atom_shape=(3, 3))
    nmf.fit(V, n_iterations=3)
    total = sum(nmf.R_partial(i) for i in range(3))
    np.testing.assert_allclose(total, nmf.R, rtol=1e-10, atol=1e-12)


def test_fit_loop_energies_zero_iterations():
    """n_iterations=0 yields an empty on-device energy trace (no chunk is
    ever dispatched)."""
    import jax.numpy as jnp
    from tnmf_tpu import engine
    from tnmf_tpu.ops.modes import ConvPlan
    plan = ConvPlan.create('valid', (8, 8), (3, 3))
    rng = np.random.default_rng(0)
    V = jnp.asarray(rng.random((2, 1, 8, 8)), jnp.float32)
    W = jnp.asarray(rng.random((2, 1, 3, 3)), jnp.float32)
    H = jnp.asarray(rng.random((2, 2, 10, 10)), jnp.float32)
    Vp = engine.prepare_data(V, plan=plan, strategy='conv')
    z = jnp.float32(0.0)
    Wn, Hn, es = engine.fit_loop_energies(
        Vp, V, W, H, z, z, z, (), n_iterations=0, plan=plan, strategy='conv')
    assert es.shape == (0,)
    np.testing.assert_allclose(np.asarray(Wn), np.asarray(W))


def test_negative_v_raises_valueerror():
    """Input validation raises ValueError (not a bare assert, which
    ``python -O`` strips — tests/test_optimized_mode.py runs this file
    under -O)."""
    V = _V()
    V.flat[0] = -1.0
    nmf = TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3))
    with pytest.raises(ValueError, match='non-negative'):
        nmf.fit(V, n_iterations=1)
    with pytest.raises(ValueError, match='non-negative'):
        nmf.fit_minibatches(V, batch_size=2, n_epochs=1)


def test_negative_params_raise_valueerror():
    nmf = TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3))
    with pytest.raises(ValueError, match='sparsity_H'):
        nmf.fit(_V(), n_iterations=1, sparsity_H=-0.1)
    with pytest.raises(ValueError, match='inhibition_strength'):
        nmf.fit(_V(), n_iterations=1, inhibition_strength=-1)
    with pytest.raises(ValueError, match='tol must be'):
        nmf.fit(_V(), n_iterations=1, tol=-1e-3)
    with pytest.raises(ValueError, match='tol_check_every'):
        nmf.fit(_V(), n_iterations=1, tol=1e-3, tol_check_every=0)
    with pytest.raises(ValueError, match='update_H'):
        nmf.fit(_V(), n_iterations=1, update_H=False, update_W=False)


def test_tol_trace_zero_iterations():
    """fit(n_iterations=0, tol=..., record_energies=True) returns an empty
    trace instead of crashing (round-4 advisor finding: np.asarray(None)
    on the unrecorded buffer)."""
    np.random.seed(0)
    nmf = TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3))
    nmf.fit(_V(), n_iterations=0, tol=1e-6, record_energies=True)
    assert nmf.n_iterations_ == 0
    assert nmf.energies_.shape == (0,)
