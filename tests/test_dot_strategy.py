"""The 'dot' strategy: plain-matmul lowering of the degenerate
single-transform problem (mode 'full' with atom_shape == sample_shape,
i.e. classic Lee-Seung NMF; tnmf_tpu/ops/dot.py).

Pinned: operator parity against the conv strategy at f64 roundoff,
auto-resolution into 'dot' on every driver (batch, minibatch scan,
partial_fit), trajectory equality with the conv lowering, composition
with masks / beta losses / transform groups, and solution quality
matching sklearn's NMF(solver='mu') on the identical objective.
Reference role: the degenerate corner of every backend
(``_Backend.py:60-73``: 'full' -> sample - atom + 1 = 1).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from tnmf_tpu import TransformInvariantNMF, engine
from tnmf_tpu.ops import conv, dot
from tnmf_tpu.ops.modes import ConvPlan


@pytest.mark.parametrize('shape', [(13,), (7, 9), (4, 5, 6)])
def test_ops_match_conv(shape):
    plan = ConvPlan.create('full', shape, shape)
    assert plan.transform_shape == (1,) * len(shape)
    rng = np.random.default_rng(0)
    n, m, c = 5, 4, 2
    V = jnp.asarray(rng.random((n, c) + shape))
    W = jnp.asarray(rng.random((m, c) + shape))
    H = jnp.asarray(rng.random((n, m) + plan.transform_shape))
    Rc, Rd = conv.reconstruct(W, H, plan), dot.reconstruct(W, H, plan)
    np.testing.assert_allclose(Rd, Rc, rtol=1e-12)
    gH_c = conv.grad_H_pair(conv.prepare_data(V, plan), Rc, W, plan)
    gH_d = dot.grad_H_pair(dot.prepare_data(V, plan), Rd, W, plan)
    gW_c = conv.grad_W_pair(conv.prepare_data(V, plan), Rc, H, plan)
    gW_d = dot.grad_W_pair(dot.prepare_data(V, plan), Rd, H, plan)
    for got, want in [*zip(gH_d, gH_c), *zip(gW_d, gW_c)]:
        np.testing.assert_allclose(got, want, rtol=1e-12)


def test_auto_resolves_to_dot_only_for_single_transform():
    plan1 = ConvPlan.create('full', (16, 16), (16, 16))
    assert engine.resolve_strategy('conv', plan1, 4, 1) == 'dot'
    # non-degenerate problems keep their lowering
    plan2 = ConvPlan.create('full', (16, 16), (5, 5))
    assert engine.resolve_strategy('conv', plan2, 4, 1) == 'conv'
    # explicit strategies are never overridden
    assert engine.resolve_strategy('fft', plan1, 4, 1) == 'fft'
    # the gate
    assert engine.resolve_strategy('conv', plan1, 4, 1, allow_dot=False) == 'conv'
    # choose_strategy routes the degenerate geometry through 'conv', so
    # 'auto' lowers it to 'dot'
    assert engine.choose_strategy(plan1) == 'conv'
    assert engine.resolve_strategy('auto', plan1, 4, 1) == 'dot'


def _fit(V, force_conv=False, **kw):
    m = TransformInvariantNMF(n_atoms=3, atom_shape=V.shape[2:], seed=5,
                              reconstruction_mode='full')
    if force_conv:
        orig = engine.resolve_strategy
        engine.resolve_strategy = lambda s, *a, **k: 'conv'
        try:
            m.fit(V, **kw)
        finally:
            engine.resolve_strategy = orig
    else:
        m.fit(V, **kw)
    return m


def test_fit_trajectory_matches_conv_lowering():
    rng = np.random.default_rng(1)
    V = rng.random((8, 2, 12, 12))
    a = _fit(V, n_iterations=25, sparsity_H=0.1)
    b = _fit(V, force_conv=True, n_iterations=25, sparsity_H=0.1)
    assert a._strategy == 'dot' and b._strategy == 'conv'
    np.testing.assert_allclose(a.W, b.W, rtol=1e-10)
    np.testing.assert_allclose(a.H, b.H, rtol=1e-10)


def test_minibatch_scan_runs_on_dot():
    rng = np.random.default_rng(2)
    V = rng.random((12, 1, 10, 10))
    a = _fit(V, batch_size=4, n_epochs=3)
    assert a._strategy == 'dot'
    b = _fit(V, force_conv=True, batch_size=4, n_epochs=3)
    np.testing.assert_allclose(a.W, b.W, rtol=1e-10)


def test_composes_with_mask_beta_and_group():
    rng = np.random.default_rng(3)
    V = rng.random((6, 1, 8, 8)) + 0.01
    mask = (np.arange(V.size).reshape(V.shape) % 4 != 0).astype(float)
    m = TransformInvariantNMF(n_atoms=2, atom_shape=(8, 8), seed=1,
                              reconstruction_mode='full')
    m.fit(V, n_iterations=10, mask=mask)
    assert m._strategy == 'dot' and np.isfinite(m.W).all()
    kl = TransformInvariantNMF(n_atoms=2, atom_shape=(8, 8), seed=1,
                               reconstruction_mode='full',
                               beta_loss='kullback-leibler')
    kl.fit(V, n_iterations=10)
    assert kl._strategy == 'dot' and np.isfinite(kl.W).all()
    grp = TransformInvariantNMF(n_atoms=2, atom_shape=(8, 8), seed=1,
                                reconstruction_mode='full',
                                transform_type='shift+flip')
    grp.fit(V, n_iterations=10)
    assert grp._strategy == ('dot', grp._group) and np.isfinite(grp.W).all()


def test_solution_quality_matches_sklearn_mu():
    sklearn = pytest.importorskip('sklearn')
    del sklearn
    from sklearn.decomposition import NMF
    rng = np.random.default_rng(4)
    X = rng.random((64, 128))
    sk = NMF(n_components=8, init='random', solver='mu', max_iter=200,
             tol=0, random_state=0).fit(X)
    err_sk = 0.5 * np.sum((X - sk.transform(X) @ sk.components_) ** 2)
    m = TransformInvariantNMF(n_atoms=8, atom_shape=(128,), seed=1,
                              reconstruction_mode='full')
    m.fit(X[:, np.newaxis, :], n_iterations=200)
    err = 0.5 * float(np.sum((X[:, np.newaxis, :] - m.inverse_transform()) ** 2))
    # identical objective + identical (MU) update family: final quality must
    # match within a few percent despite different random inits
    assert err <= err_sk * 1.05


@pytest.mark.skipif(__import__('jax').device_count() < 8,
                    reason='needs 8 (virtual) devices')
@pytest.mark.parametrize('shard_axis', ['samples', 'atoms'])
def test_dot_under_mesh_matches_single_device(shard_axis):
    """Plain NMF shards too: the matmul contractions become psum-reduced
    shards (samples: grad_W sums over n; atoms: reconstruct sums over m)."""
    from tnmf_tpu.parallel import make_mesh, make_mesh_atoms
    rng = np.random.default_rng(7)
    V = rng.random((8, 1, 16, 16))
    mesh = make_mesh(8) if shard_axis == 'samples' else make_mesh_atoms(8)

    def run(mesh_arg):
        m = TransformInvariantNMF(n_atoms=8, atom_shape=(16, 16), seed=3,
                                  reconstruction_mode='full', mesh=mesh_arg,
                                  shard_axis=shard_axis)
        m.fit(V, n_iterations=5, sparsity_H=0.1)
        return m

    single, sharded = run(None), run(mesh)
    assert single._strategy == 'dot' and sharded._strategy == 'dot'
    np.testing.assert_allclose(sharded.W, single.W, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(sharded.H, single.H, rtol=1e-8, atol=1e-10)


def test_dot_composes_with_bf16_and_tol():
    rng = np.random.default_rng(0)
    V = rng.random((6, 1, 16, 16))
    d = TransformInvariantNMF(n_atoms=3, atom_shape=(16, 16), seed=1,
                              reconstruction_mode='full', dtype='bfloat16')
    d.fit(V, n_iterations=10)
    assert d._strategy == 'dot' and str(d.W.dtype) == 'bfloat16'
    assert np.isfinite(np.asarray(d.W, np.float32)).all()
    t = TransformInvariantNMF(n_atoms=3, atom_shape=(16, 16), seed=1,
                              reconstruction_mode='full')
    t.fit(V, n_iterations=200, tol=1e-3, tol_check_every=10)
    assert t._strategy == 'dot' and 0 < t.n_iterations_ <= 200


@pytest.mark.skipif(__import__('jax').device_count() < 8,
                    reason='needs 8 (virtual) devices')
def test_partial_fit_under_mesh_matches_single_device():
    from tnmf_tpu.parallel import make_mesh
    rng = np.random.default_rng(0)
    V = rng.random((8, 1, 12, 12)).astype(np.float32)

    def run(mesh):
        m = TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3), seed=1,
                                  mesh=mesh)
        return m.partial_fit(V).partial_fit(V)

    single, sharded = run(None), run(make_mesh(8))
    # psum reduction order: f32 parity to a few ulp
    np.testing.assert_allclose(sharded.W, single.W, rtol=5e-6)
    np.testing.assert_allclose(sharded.H, single.H, rtol=5e-6)


def test_rank4_plain_nmf_runs_on_dot():
    # >3 spatial dims: no lax-conv path exists, but matmuls have no rank cap
    rng = np.random.default_rng(5)
    V = rng.random((4, 1, 3, 4, 5, 6))
    m = TransformInvariantNMF(n_atoms=2, atom_shape=(3, 4, 5, 6), seed=1,
                              reconstruction_mode='full', backend='auto')
    m.fit(V, n_iterations=5)
    assert m._strategy == 'dot'
    assert np.isfinite(m.W).all() and (m.W >= 0).all()
