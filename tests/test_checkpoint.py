"""Checkpoint save/load and profiling-hook tests."""

import os

import numpy as np
import pytest

from tnmf_tpu import TransformInvariantNMF
from tnmf_tpu.utils.profiling import IterationTimer


def test_save_load_roundtrip(tmp_path):
    V = np.random.default_rng(0).random((3, 2, 12, 12))
    np.random.seed(1)
    nmf = TransformInvariantNMF(n_atoms=4, atom_shape=(3, 3),
                                reconstruction_mode='circular', inhibition_range=2)
    nmf.fit(V, n_iterations=3)
    path = os.path.join(tmp_path, 'model.npz')
    nmf.save(path, include_H=True)

    loaded = TransformInvariantNMF.load(path)
    np.testing.assert_array_equal(loaded.W, nmf.W)
    np.testing.assert_array_equal(np.asarray(loaded._H), nmf.H)
    assert loaded.n_atoms == 4
    assert loaded.atom_shape == (3, 3)
    assert loaded._reconstruction_mode == 'circular'
    assert loaded._inhibition_range == (2, 2)


def test_load_then_continue(tmp_path):
    """A restored dictionary must continue training exactly like keep_W."""
    V = np.random.default_rng(0).random((3, 2, 12, 12))
    np.random.seed(1)
    a = TransformInvariantNMF(n_atoms=4, atom_shape=(3, 3))
    a.fit(V, n_iterations=3)
    path = os.path.join(tmp_path, 'model.npz')
    a.save(path)

    np.random.seed(2)
    a.fit(V, n_iterations=2, keep_W=True)

    b = TransformInvariantNMF.load(path)
    np.random.seed(2)
    b.fit(V, n_iterations=2, keep_W=True)
    np.testing.assert_allclose(a.W, b.W, rtol=1e-12)
    np.testing.assert_allclose(a.H, b.H, rtol=1e-12)


def test_save_unfitted_raises(tmp_path):
    nmf = TransformInvariantNMF(n_atoms=2, atom_shape=(3,))
    with pytest.raises(ValueError, match='not been fit'):
        nmf.save(os.path.join(tmp_path, 'x.npz'))


def test_iteration_timer():
    V = np.random.default_rng(0).random((2, 1, 10, 10))
    timer = IterationTimer(record_energy=True)
    nmf = TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3))
    nmf.fit(V, n_iterations=5, progress_callback=timer)
    assert len(timer.times) == 5
    assert len(timer.energies) == 5
    assert timer.energies[-1] <= timer.energies[0]


def test_iteration_timer_wraps_abort():
    V = np.random.default_rng(0).random((2, 1, 10, 10))
    timer = IterationTimer(inner=lambda nmf, it: it < 2)
    nmf = TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3))
    nmf.fit(V, n_iterations=100, progress_callback=timer)
    assert len(timer.times) == 3


def test_save_load_bfloat16(tmp_path):
    """bfloat16 checkpoints must round-trip (npz cannot hold bf16 natively)."""
    import jax.numpy as jnp
    V = np.random.default_rng(0).random((2, 1, 12, 12))
    np.random.seed(1)
    nmf = TransformInvariantNMF(n_atoms=3, atom_shape=(3, 3), dtype='bfloat16')
    nmf.fit(V, n_iterations=2)
    path = os.path.join(tmp_path, 'bf16.npz')
    nmf.save(path, include_H=True)
    loaded = TransformInvariantNMF.load(path)
    assert loaded._W.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(loaded._W, dtype=np.float32),
                                  np.asarray(nmf._W, dtype=np.float32))


def test_load_with_H_enables_reconstruction(tmp_path):
    V = np.random.default_rng(0).random((2, 2, 10, 12))
    np.random.seed(1)
    nmf = TransformInvariantNMF(n_atoms=3, atom_shape=(3, 4), reconstruction_mode='full')
    nmf.fit(V, n_iterations=2)
    path = os.path.join(tmp_path, 'm.npz')
    nmf.save(path, include_H=True)
    loaded = TransformInvariantNMF.load(path)
    np.testing.assert_allclose(loaded.R, nmf.R, rtol=1e-10)
    np.testing.assert_allclose(loaded.R_partial(1), nmf.R_partial(1), rtol=1e-10)


def test_sharded_checkpoint_roundtrip(tmp_path):
    """orbax-backed distributed checkpoint: every device writes its own
    shards; restore lands directly in the distributed layout (or on one
    device without a mesh) with identical values."""
    import jax
    import pytest
    if jax.device_count() < 8:
        pytest.skip('needs 8 (virtual) devices')
    from tnmf_tpu.parallel import DATA_AXIS, make_mesh

    V = np.random.default_rng(5).random((8, 2, 16, 16))
    mesh = make_mesh(8)
    np.random.seed(42)
    nmf = TransformInvariantNMF(n_atoms=4, atom_shape=(3, 3), mesh=mesh,
                                init='device', seed=0)
    nmf.fit(V, n_iterations=3, sparsity_H=0.1)
    W0, H0 = np.asarray(nmf._W), np.asarray(nmf._H)

    path = str(tmp_path / 'ckpt')
    nmf.save_sharded(path)

    resharded = TransformInvariantNMF.load_sharded(path, mesh=mesh)
    assert resharded._H.sharding.spec[0] == DATA_AXIS
    np.testing.assert_array_equal(np.asarray(resharded._W), W0)
    np.testing.assert_array_equal(np.asarray(resharded._H), H0)

    local = TransformInvariantNMF.load_sharded(path)
    np.testing.assert_array_equal(np.asarray(local._W), W0)
    assert local.R.shape == V.shape  # plan restored -> reconstruction works

    # warm-restart from the restored dictionary
    local.fit(V, n_iterations=2, keep_W=True)
    assert np.isfinite(local._energy_function())


def test_save_sharded_unfitted_raises(tmp_path):
    nmf = TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3))
    with pytest.raises(ValueError, match='has not been fit'):
        nmf.save_sharded(str(tmp_path / 'nope'))


def test_restore_keeps_phased_gate_under_spatial_mesh(tmp_path, monkeypatch):
    """The restore path applies the same phased-strategy exclusions as
    fit-time _initialize_matrices: a phased-eligible geometry restored onto
    a spatially-sharded mesh must keep the plain conv lowering (halo
    exchange is validated on the canonical grid only)."""
    import jax
    if jax.device_count() < 8:
        pytest.skip('needs 8 (virtual) devices')
    from tnmf_tpu import engine
    from tnmf_tpu.parallel import make_mesh

    monkeypatch.setattr(engine, '_phased_device', lambda: True)
    V = np.random.default_rng(5).random((8, 1, 24, 24)).astype(np.float32)
    np.random.seed(42)
    nmf = TransformInvariantNMF(n_atoms=4, atom_shape=(9, 9))
    nmf.fit(V, n_iterations=2, sparsity_H=0.1)
    assert nmf._strategy == 'phased'  # eligible geometry, phased forced on
    path = str(tmp_path / 'ckpt.npz')
    nmf.save(path, include_H=True)

    spatial = TransformInvariantNMF.load(path, mesh=make_mesh(8),
                                         shard_axis='spatial')
    assert spatial._strategy == 'conv'
    plain = TransformInvariantNMF.load(path)
    assert plain._strategy == 'phased'


def test_periodic_checkpoint_and_exact_resume(tmp_path):
    """fit_batch(checkpoint_every=...) writes atomic stamped checkpoints
    from fused on-device chunks; after a simulated crash, load + keep_W +
    keep_H resumes the EXACT uninterrupted trajectory (MU updates are
    deterministic in (V, W, H))."""
    V = np.random.default_rng(7).random((3, 2, 12, 10)).astype(np.float32)
    kw = dict(sparsity_H=0.1, inhibition_strength=0.2)

    np.random.seed(42)
    ref = TransformInvariantNMF(n_atoms=3, atom_shape=(3, 3))
    ref.fit(V, n_iterations=8, **kw)

    path = str(tmp_path / 'periodic.npz')
    np.random.seed(42)
    crashed = TransformInvariantNMF(n_atoms=3, atom_shape=(3, 3))
    crashed.fit(V, n_iterations=5, checkpoint_every=2, checkpoint_path=path, **kw)
    assert not os.path.exists(path + '.tmp')  # atomic replace, no leftovers

    resumed = TransformInvariantNMF.load(path)
    assert resumed.last_checkpoint_iteration_ == 5
    resumed.fit(V, n_iterations=8 - resumed.last_checkpoint_iteration_,
                keep_W=True, keep_H=True, **kw)
    np.testing.assert_array_equal(np.asarray(resumed._W), np.asarray(ref._W))
    np.testing.assert_array_equal(np.asarray(resumed._H), np.asarray(ref._H))


def test_checkpoint_kwarg_validation(tmp_path):
    V = np.random.default_rng(7).random((2, 1, 8, 8)).astype(np.float32)
    nmf = TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3))
    with pytest.raises(ValueError, match='given together'):
        nmf.fit(V, n_iterations=2, checkpoint_every=1)
    with pytest.raises(ValueError, match='given together'):
        nmf.fit(V, n_iterations=2, checkpoint_path='x.npz')
    with pytest.raises(ValueError, match='cannot\\s+combine'):
        nmf.fit(V, n_iterations=2, checkpoint_every=1,
                checkpoint_path=str(tmp_path / 'c.npz'),
                progress_callback=lambda m, i: True)
    nmf.fit(V, n_iterations=2)
    with pytest.raises(ValueError, match='keep_H'):
        V2 = np.random.default_rng(8).random((4, 1, 8, 8)).astype(np.float32)
        nmf.fit(V2, n_iterations=1, keep_W=True, keep_H=True)


def test_save_sharded_async(tmp_path):
    """block=False overlaps the tensorstore write with further compute;
    wait_for_checkpoints (or the next save) drains it.  State mutated
    right after the call must not leak into the staged snapshot."""
    V = np.random.default_rng(0).random((4, 1, 8, 8))
    nmf = TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3), seed=0)
    nmf.fit(V, n_iterations=2)
    W0, H0 = nmf.W.copy(), np.asarray(nmf._H).copy()

    p1 = str(tmp_path / 'async_ckpt')
    nmf.save_sharded(p1, block=False)
    nmf.fit(V, n_iterations=3, keep_W=True)  # mutate state while writing
    nmf.wait_for_checkpoints()
    nmf.wait_for_checkpoints()  # idempotent no-op

    restored = TransformInvariantNMF.load_sharded(p1)
    np.testing.assert_array_equal(np.asarray(restored._W), W0)
    np.testing.assert_array_equal(np.asarray(restored._H), H0)

    # a second async save drains the first implicitly
    p2 = str(tmp_path / 'async_ckpt_2')
    nmf.save_sharded(p2, block=False)
    nmf.save_sharded(str(tmp_path / 'async_ckpt_3'))
    np.testing.assert_array_equal(
        np.asarray(TransformInvariantNMF.load_sharded(p2)._W), nmf.W)
