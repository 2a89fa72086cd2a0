"""Data-parallel execution tests on a virtual 8-device CPU mesh.

The reference has no distributed mode (SURVEY.md §2.3); these tests pin the
new capability: a mesh-sharded fit must reproduce the single-device
trajectory (the W statistics are exact sums over samples, so psum-reduced
shards are mathematically identical), and the sharded arrays must actually
be distributed.
"""

import jax
import numpy as np
import pytest

from tnmf_tpu import TransformInvariantNMF
from tnmf_tpu.parallel import DATA_AXIS, SPATIAL_AXIS, make_mesh, make_mesh_2d

needs_8_devices = pytest.mark.skipif(
    jax.device_count() < 8, reason='needs 8 (virtual) devices')


def _make_V():
    rng = np.random.default_rng(5)
    return rng.random((8, 2, 16, 16))


@needs_8_devices
@pytest.mark.parametrize('backend', ['jax_fft', 'jax_conv'])
def test_sharded_fit_matches_single_device(backend):
    V = _make_V()

    np.random.seed(42)
    single = TransformInvariantNMF(n_atoms=4, atom_shape=(3, 3), backend=backend)
    single.fit(V, n_iterations=5, sparsity_H=0.1)

    np.random.seed(42)
    mesh = make_mesh(8)
    sharded = TransformInvariantNMF(n_atoms=4, atom_shape=(3, 3), backend=backend, mesh=mesh)
    sharded.fit(V, n_iterations=5, sparsity_H=0.1)

    np.testing.assert_allclose(sharded.W, single.W, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(sharded.H, single.H, rtol=1e-8, atol=1e-10)


@needs_8_devices
def test_activations_actually_sharded():
    V = _make_V()
    mesh = make_mesh(8)
    nmf = TransformInvariantNMF(n_atoms=4, atom_shape=(3, 3), backend='jax_fft', mesh=mesh)
    nmf.fit(V, n_iterations=2)
    sharding = nmf._H.sharding
    assert sharding.spec[0] == DATA_AXIS
    assert len(nmf._H.devices()) == 8


@needs_8_devices
def test_sharded_minibatch_scan_path():
    """batch_size divisible by the mesh: the on-device scan path engages
    under data parallelism and matches the single-device result."""
    from tnmf_tpu import MiniBatchAlgorithm
    V = np.random.default_rng(5).random((16, 2, 12, 12))

    np.random.seed(42)
    single = TransformInvariantNMF(n_atoms=3, atom_shape=(3, 3))
    single.fit_minibatches(V, algorithm=MiniBatchAlgorithm.ASG_MU, batch_size=8, n_epochs=3)

    np.random.seed(42)
    sharded = TransformInvariantNMF(n_atoms=3, atom_shape=(3, 3), mesh=make_mesh(8))
    sharded.fit_minibatches(V, algorithm=MiniBatchAlgorithm.ASG_MU, batch_size=8, n_epochs=3)

    np.testing.assert_allclose(sharded.W, single.W, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(sharded.H, single.H, rtol=1e-8, atol=1e-10)


@needs_8_devices
def test_sharded_minibatch():
    """Minibatch slices cut across shard boundaries; GSPMD must resolve the
    resharding transparently and keep results correct."""
    from tnmf_tpu import MiniBatchAlgorithm
    V = _make_V()

    np.random.seed(42)
    single = TransformInvariantNMF(n_atoms=4, atom_shape=(3, 3))
    single.fit_minibatches(V, algorithm=MiniBatchAlgorithm.ASG_MU, batch_size=4, n_epochs=2)

    np.random.seed(42)
    sharded = TransformInvariantNMF(n_atoms=4, atom_shape=(3, 3), mesh=make_mesh(8))
    sharded.fit_minibatches(V, algorithm=MiniBatchAlgorithm.ASG_MU, batch_size=4, n_epochs=2)

    np.testing.assert_allclose(sharded.W, single.W, rtol=1e-8, atol=1e-10)


@needs_8_devices
@pytest.mark.parametrize('with_inhibition', [False, True])
def test_spatial_sharding_matches_single_device(with_inhibition):
    """'spatial' shard axis: one large image split across devices; the SPMD
    partitioner's conv halo exchange must reproduce single-device results."""
    # valid mode: T = 60 + 5 - 1 = 64, divisible by the 4-device mesh
    V = np.random.default_rng(5).random((1, 2, 60, 48))
    kw = dict(n_iterations=4, sparsity_H=0.1)
    if with_inhibition:
        kw['inhibition_strength'] = 0.2

    np.random.seed(42)
    single = TransformInvariantNMF(n_atoms=4, atom_shape=(5, 5), backend='jax_conv')
    single.fit(V, **kw)

    np.random.seed(42)
    sharded = TransformInvariantNMF(n_atoms=4, atom_shape=(5, 5), backend='jax_conv',
                                    mesh=make_mesh(4), shard_axis='spatial')
    sharded.fit(V, **kw)

    assert sharded._H.sharding.spec[2] == DATA_AXIS
    np.testing.assert_allclose(sharded.W, single.W, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(sharded.H, single.H, rtol=1e-8, atol=1e-10)


@needs_8_devices
def test_spatial_sharding_divisibility_error():
    V = np.random.default_rng(0).random((1, 1, 64, 64))  # T = 68, not / 8
    nmf = TransformInvariantNMF(n_atoms=2, atom_shape=(5, 5), backend='jax_conv',
                                mesh=make_mesh(8), shard_axis='spatial')
    with pytest.raises(ValueError, match='first spatial axis'):
        nmf.fit(V, n_iterations=1)


@needs_8_devices
def test_2d_mesh_data_x_spatial():
    """Combined data + spatial parallelism on a 2x4 mesh must reproduce the
    single-device trajectory."""
    V = np.random.default_rng(5).random((4, 2, 60, 40))  # T = 64 divides 4

    np.random.seed(42)
    single = TransformInvariantNMF(n_atoms=3, atom_shape=(5, 5), backend='jax_conv')
    single.fit(V, n_iterations=4, sparsity_H=0.1)

    np.random.seed(42)
    both = TransformInvariantNMF(n_atoms=3, atom_shape=(5, 5), backend='jax_conv',
                                 mesh=make_mesh_2d(2, 4), shard_axis='both')
    both.fit(V, n_iterations=4, sparsity_H=0.1)

    assert both._H.sharding.spec[0] == DATA_AXIS
    assert both._H.sharding.spec[2] == SPATIAL_AXIS
    np.testing.assert_allclose(both.W, single.W, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(both.H, single.H, rtol=1e-8, atol=1e-10)


@needs_8_devices
def test_spatial_sharding_helper_on_2d_mesh():
    """spatial_sharding must place the 'space' axis name on a 2-D mesh (it
    used to place the data axis name there, silently wrong)."""
    from tnmf_tpu.parallel.sharding import spatial_sharding
    mesh2 = make_mesh_2d(2, 4)
    sh = spatial_sharding(mesh2, 4)
    assert sh.spec[2] == SPATIAL_AXIS
    # 1-D mesh: the single axis is used, whatever its name
    sh1 = spatial_sharding(make_mesh(4), 4)
    assert sh1.spec[2] == DATA_AXIS


@needs_8_devices
def test_device_init_materializes_sharded_H():
    """init='device' under a mesh: H comes out of the init program already
    sharded (no unsharded intermediate on a single device)."""
    V = _make_V()
    mesh = make_mesh(8)
    nmf = TransformInvariantNMF(n_atoms=4, atom_shape=(3, 3), mesh=mesh,
                                init='device', seed=0)
    nmf.fit(V, n_iterations=2)
    assert nmf._H.sharding.spec[0] == DATA_AXIS
    assert len(nmf._H.devices()) == 8

    from tnmf_tpu import engine
    from tnmf_tpu.parallel.sharding import h_sharding, replicated
    W, H = engine.init_matrices(
        jax.random.PRNGKey(0), w_shape=(4, 2, 3, 3), h_shape=(8, 4, 14, 14),
        n_shift_axes=2, dtype=np.float32,
        h_sharding=h_sharding(mesh, 4, 'samples'), w_sharding=replicated(mesh))
    assert H.sharding.spec[0] == DATA_AXIS
    assert len(H.devices()) == 8


@needs_8_devices
def test_both_axis_minibatch_scan_gating():
    """shard_axis='both': the scan fast path must engage only when
    batch_size divides the data-axis extent, and both paths must match the
    single-device trajectory."""
    from tnmf_tpu import MiniBatchAlgorithm
    V = np.random.default_rng(5).random((4, 2, 28, 28))  # T = 32 divides 4

    np.random.seed(42)
    single = TransformInvariantNMF(n_atoms=3, atom_shape=(5, 5), backend='jax_conv')
    single.fit_minibatches(V, algorithm=MiniBatchAlgorithm.ASG_MU, batch_size=2, n_epochs=2)

    np.random.seed(42)
    both = TransformInvariantNMF(n_atoms=3, atom_shape=(5, 5), backend='jax_conv',
                                 mesh=make_mesh_2d(2, 4), shard_axis='both')
    both.fit_minibatches(V, algorithm=MiniBatchAlgorithm.ASG_MU, batch_size=2, n_epochs=2)
    np.testing.assert_allclose(both.W, single.W, rtol=1e-8, atol=1e-10)

    # batch_size=1 does not divide the 2-wide data axis: falls back to the
    # Python loop and still matches
    np.random.seed(42)
    s1 = TransformInvariantNMF(n_atoms=3, atom_shape=(5, 5), backend='jax_conv')
    s1.fit_minibatches(V, algorithm=MiniBatchAlgorithm.ASG_MU, batch_size=1, n_epochs=2)
    np.random.seed(42)
    b1 = TransformInvariantNMF(n_atoms=3, atom_shape=(5, 5), backend='jax_conv',
                               mesh=make_mesh_2d(2, 4), shard_axis='both')
    b1.fit_minibatches(V, algorithm=MiniBatchAlgorithm.ASG_MU, batch_size=1, n_epochs=2)
    np.testing.assert_allclose(b1.W, s1.W, rtol=1e-8, atol=1e-10)


@needs_8_devices
def test_sharded_ragged_minibatch_scan():
    """Ragged final batch under a mesh: the zero-padded scan path engages
    (batch_size divides the mesh) and matches the single-device result."""
    from tnmf_tpu import MiniBatchAlgorithm
    V = np.random.default_rng(5).random((40, 2, 12, 12))  # 40 = 2x16 + 8

    np.random.seed(42)
    single = TransformInvariantNMF(n_atoms=3, atom_shape=(3, 3))
    single.fit_minibatches(V, algorithm=MiniBatchAlgorithm.ASG_MU, batch_size=16, n_epochs=3)

    np.random.seed(42)
    sharded = TransformInvariantNMF(n_atoms=3, atom_shape=(3, 3), mesh=make_mesh(8))
    sharded.fit_minibatches(V, algorithm=MiniBatchAlgorithm.ASG_MU, batch_size=16, n_epochs=3)

    assert sharded.H.shape[0] == 40
    np.testing.assert_allclose(sharded.W, single.W, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(sharded.H, single.H, rtol=1e-8, atol=1e-10)


def test_mesh_divisibility_error():
    V = np.random.default_rng(0).random((5, 1, 8, 8))
    mesh = make_mesh(min(8, jax.device_count()))
    nmf = TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3), mesh=mesh)
    if mesh.devices.size > 1:
        with pytest.raises(ValueError, match='divisible'):
            nmf.fit(V, n_iterations=1)


@needs_8_devices
@pytest.mark.parametrize('with_cross', [False, True])
def test_atom_sharding_matches_single_device(with_cross):
    """'atoms' shard axis (model/tensor parallelism over the dictionary):
    W and the atom axis of H shard; the reconstruction's atom sum becomes
    an all-reduce. Cross-atom inhibition adds a second atom-axis reduction.
    Both must reproduce the single-device trajectory."""
    from tnmf_tpu.parallel import ATOM_AXIS, make_mesh_atoms
    V = _make_V()
    kw = dict(n_iterations=4, sparsity_H=0.1, inhibition_strength=0.1)
    if with_cross:
        kw['cross_atom_inhibition_strength'] = 0.2

    np.random.seed(42)
    single = TransformInvariantNMF(n_atoms=8, atom_shape=(3, 3), backend='jax_conv')
    single.fit(V, **kw)

    np.random.seed(42)
    sharded = TransformInvariantNMF(n_atoms=8, atom_shape=(3, 3), backend='jax_conv',
                                    mesh=make_mesh_atoms(8), shard_axis='atoms')
    sharded.fit(V, **kw)

    assert sharded._W.sharding.spec[0] == ATOM_AXIS
    assert sharded._H.sharding.spec[1] == ATOM_AXIS
    np.testing.assert_allclose(sharded.W, single.W, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(sharded.H, single.H, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(sharded.R, single.R, rtol=1e-8, atol=1e-10)


@needs_8_devices
def test_2d_mesh_data_x_atoms():
    """'samples+atoms': combined data + model parallelism on a 2x4 mesh.

    conv strategy: the XLA *CPU* runtime's fft thunk RET_CHECKs on the
    layout-permuted local shards the partitioner produces here (a platform
    limitation of the virtual test mesh, not of the sharding)."""
    from tnmf_tpu.parallel import ATOM_AXIS, make_mesh_2d_atoms
    V = _make_V()

    np.random.seed(42)
    single = TransformInvariantNMF(n_atoms=4, atom_shape=(3, 3), backend='jax_conv')
    single.fit(V, n_iterations=4, sparsity_H=0.1)

    np.random.seed(42)
    sharded = TransformInvariantNMF(n_atoms=4, atom_shape=(3, 3), backend='jax_conv',
                                    mesh=make_mesh_2d_atoms(2, 4),
                                    shard_axis='samples+atoms')
    sharded.fit(V, n_iterations=4, sparsity_H=0.1)

    assert sharded._W.sharding.spec[0] == ATOM_AXIS
    assert sharded._H.sharding.spec[:2] == (DATA_AXIS, ATOM_AXIS)
    np.testing.assert_allclose(sharded.W, single.W, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(sharded.H, single.H, rtol=1e-8, atol=1e-10)


@needs_8_devices
def test_2d_mesh_data_x_atoms_fft_strategy():
    """'samples+atoms' x fft strategy on jnp.fft: the partitioned program
    must match the single-device fit (ops/fft._leading_flat keeps the
    FFT operands row-major, which XLA:CPU's FFT requires under this
    mesh)."""
    from tnmf_tpu.parallel import ATOM_AXIS, make_mesh_2d_atoms
    V = _make_V()

    np.random.seed(42)
    single = TransformInvariantNMF(n_atoms=4, atom_shape=(3, 3), backend='jax_fft')
    single.fit(V, n_iterations=4, sparsity_H=0.1)

    np.random.seed(42)
    sharded = TransformInvariantNMF(n_atoms=4, atom_shape=(3, 3), backend='jax_fft',
                                    mesh=make_mesh_2d_atoms(2, 4),
                                    shard_axis='samples+atoms')
    sharded.fit(V, n_iterations=4, sparsity_H=0.1)

    assert sharded._W.sharding.spec[0] == ATOM_AXIS
    np.testing.assert_allclose(sharded.W, single.W, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(sharded.H, single.H, rtol=1e-8, atol=1e-10)


@needs_8_devices
def test_atom_sharding_minibatch_and_device_init():
    """'samples+atoms' under the minibatch scan path and device init: H is
    created directly in its 2-D-sharded layout, and the minibatch
    trajectory matches single-device."""
    from tnmf_tpu import MiniBatchAlgorithm
    from tnmf_tpu.parallel import ATOM_AXIS, make_mesh_2d_atoms
    V = np.random.default_rng(5).random((8, 2, 12, 12))

    np.random.seed(42)
    single = TransformInvariantNMF(n_atoms=4, atom_shape=(3, 3))
    single.fit_minibatches(V, algorithm=MiniBatchAlgorithm.ASG_MU, batch_size=4, n_epochs=2)

    np.random.seed(42)
    sharded = TransformInvariantNMF(n_atoms=4, atom_shape=(3, 3),
                                    mesh=make_mesh_2d_atoms(2, 4),
                                    shard_axis='samples+atoms')
    sharded.fit_minibatches(V, algorithm=MiniBatchAlgorithm.ASG_MU, batch_size=4, n_epochs=2)
    np.testing.assert_allclose(sharded.W, single.W, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(sharded.H, single.H, rtol=1e-8, atol=1e-10)

    dev = TransformInvariantNMF(n_atoms=4, atom_shape=(3, 3), init='device', seed=0,
                                mesh=make_mesh_2d_atoms(2, 4),
                                shard_axis='samples+atoms')
    dev.fit(V, n_iterations=2)
    assert dev._H.sharding.spec[:2] == (DATA_AXIS, ATOM_AXIS)
    assert dev._W.sharding.spec[0] == ATOM_AXIS


@needs_8_devices
def test_atom_sharding_divisibility_error():
    from tnmf_tpu.parallel import make_mesh_atoms
    V = np.random.default_rng(0).random((4, 1, 8, 8))
    nmf = TransformInvariantNMF(n_atoms=3, atom_shape=(3, 3),
                                mesh=make_mesh_atoms(8), shard_axis='atoms')
    with pytest.raises(ValueError, match='n_atoms'):
        nmf.fit(V, n_iterations=1)


@needs_8_devices
def test_tol_fit_under_data_parallel_mesh():
    """tol-based early stopping composes with data parallelism: the
    on-device while_loop runs on sharded V/H (the energy reduction becomes
    a psum over the data axis) and reproduces the single-device adaptive
    trajectory, including the stopping iteration."""
    V = _make_V()

    np.random.seed(42)
    single = TransformInvariantNMF(n_atoms=4, atom_shape=(3, 3))
    single.fit(V, n_iterations=200, sparsity_H=0.1, tol=1e-3, tol_check_every=5)

    np.random.seed(42)
    sharded = TransformInvariantNMF(n_atoms=4, atom_shape=(3, 3), mesh=make_mesh(8))
    sharded.fit(V, n_iterations=200, sparsity_H=0.1, tol=1e-3, tol_check_every=5)

    assert single.n_iterations_ is not None and single.n_iterations_ < 200
    assert sharded.n_iterations_ == single.n_iterations_
    np.testing.assert_allclose(sharded.W, single.W, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(sharded.H, single.H, rtol=1e-8, atol=1e-10)
