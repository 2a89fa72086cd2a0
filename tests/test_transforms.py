"""Transform groups beyond shift: flip / rot90 invariant dictionaries.

The reference supports shift invariance only and defers other transform
types to future work (``/root/reference/tnmf/TransformInvariantNMF.py:65-69``);
``tnmf_tpu.ops.transforms`` supplies them.  Pinned here:

* group algebra: ``apply_inverse`` inverts ``apply`` for every element,
* the W-gradient tie-back against ``jax.grad`` of the tied reconstruction
  energy (the adjoint/permutation argument in the module docstring),
* full fit trajectories against an independent NumPy oracle MU driver that
  expands/ties with ``np.rot90``/``np.flip`` (both strategies, all modes),
* that a trivial (identity-only) group reproduces plain 'shift' exactly,
* model-level invariants: H shape, R_partial additivity, save/load,
  inverse_transform, minibatch scan≡loop, mesh parity, error paths,
* the capability itself: a flip-invariant single-atom model explains
  mirror-image data that a shift-only single-atom model cannot.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tnmf_tpu import engine
from tnmf_tpu.models.tnmf import MiniBatchAlgorithm, TransformInvariantNMF
from tnmf_tpu.ops import oracle
from tnmf_tpu.ops import transforms as tr
from tnmf_tpu.ops.modes import ConvPlan

EPS = 1e-9


# ---------------------------------------------------------------------------
# NumPy mirrors of expand/tie (independent implementation for cross-checks)
# ---------------------------------------------------------------------------

def _np_apply(x, elem, first_axis, ndim):
    k, flips = elem
    if k % 4:
        x = np.rot90(x, k, axes=(first_axis + ndim - 2, first_axis + ndim - 1))
    if flips:
        x = np.flip(x, axis=tuple(first_axis + a for a in flips))
    return x


def _np_apply_inv(x, elem, first_axis, ndim):
    k, flips = elem
    if flips:
        x = np.flip(x, axis=tuple(first_axis + a for a in flips))
    if k % 4:
        x = np.rot90(x, -k, axes=(first_axis + ndim - 2, first_axis + ndim - 1))
    return x


def _np_expand(W, group):
    copies = [_np_apply(W, e, 2, group.ndim) for e in group.elements]
    We = np.stack(copies, axis=1)
    return We.reshape((W.shape[0] * group.size,) + W.shape[1:])


def _np_tie(G, group):
    g = group.size
    Gm = G.reshape((G.shape[0] // g, g) + G.shape[1:])
    return sum(_np_apply_inv(Gm[:, i], e, 2, group.ndim)
               for i, e in enumerate(group.elements))


def _oracle_group_fit(V, n_atoms, atom_shape, mode, group, n_iterations, seed,
                      sparsity=0.0):
    """NumPy MU driver with a tied transformed dictionary, replicating the
    model's host init RNG stream (H then W, ``_Backend.py:83-98``)."""
    rng = np.random.default_rng(seed)
    tshape = oracle.transform_shape(mode, V.shape[2:], atom_shape)
    g = group.size
    H = 1 - rng.random((V.shape[0], n_atoms * g) + tshape)
    W = 1 - rng.random((n_atoms, V.shape[1]) + atom_shape)
    W /= W.sum(axis=tuple(range(-len(atom_shape), 0)), keepdims=True)
    axes = tuple(range(-len(atom_shape), 0))
    for _ in range(n_iterations):
        We = _np_expand(W, group)
        R = oracle.reconstruct(We, H, mode)
        neg = oracle.corr_H(V, We, mode)
        pos = oracle.corr_H(R, We, mode)
        H = H * neg / (pos + EPS + sparsity)
        R = oracle.reconstruct(_np_expand(W, group), H, mode)
        neg = _np_tie(oracle.corr_W(V, H, mode, atom_shape), group)
        pos = _np_tie(oracle.corr_W(R, H, mode, atom_shape), group)
        W = W * neg / (pos + EPS)
        s = W.sum(axis=axes, keepdims=True)
        W = W / np.where(s == 0, 1, s)
    return W, H


def _data(seed=0, n=3, c=2, sample=(13,), dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.random((n, c) + sample) + 0.05).astype(dtype)


ALL_TYPES_1D = ('shift+flip',)
ALL_TYPES_2D = ('shift+flip', 'shift+rot90', 'shift+rot90+flip')


# ---------------------------------------------------------------------------
# group algebra + gradient tie-back
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('ttype,atom', [
    ('shift+flip', (5,)), ('shift+flip', (4, 3)), ('shift+flip', (3, 4, 2)),
    ('shift+rot90', (4, 4)), ('shift+rot90+flip', (4, 4)),
    ('shift+rot90', (2, 5, 5)),
])
def test_apply_inverse_inverts(ttype, atom):
    group = tr.make_group(ttype, atom)
    x = jnp.asarray(np.random.default_rng(1).random((2, 3) + atom))
    for e in group.elements:
        y = tr.apply_inverse(tr.apply(x, e, 2, group.ndim), e, 2, group.ndim)
        np.testing.assert_array_equal(np.asarray(y), np.asarray(x))


@pytest.mark.parametrize('ttype,atom', [
    ('shift+flip', (5,)), ('shift+rot90+flip', (4, 4)),
])
def test_group_identity_first_and_sizes(ttype, atom):
    group = tr.make_group(ttype, atom)
    assert group.elements[0] == (0, ())
    expected = {('shift+flip', 1): 2, ('shift+flip', 2): 4,
                ('shift+rot90', 2): 4, ('shift+rot90+flip', 2): 8}
    assert group.size == expected[(ttype, len(atom))]
    # no duplicate transforms: all images of an asymmetric probe differ
    probe = jnp.asarray(np.arange(np.prod((1, 1) + atom)).reshape((1, 1) + atom))
    images = {np.asarray(tr.apply(probe, e, 2, group.ndim)).tobytes()
              for e in group.elements}
    assert len(images) == group.size


@pytest.mark.parametrize('strategy', ['conv', 'fft'])
@pytest.mark.parametrize('mode', ['valid', 'full', 'circular'])
@pytest.mark.parametrize('ttype,sample,atom', [
    ('shift+flip', (12,), (4,)),
    ('shift+rot90+flip', (9, 9), (3, 3)),
])
def test_tie_back_matches_autodiff(strategy, mode, ttype, sample, atom):
    """(pos - neg) from the grouped grad_W_pair must equal the autodiff
    gradient of the tied reconstruction energy — the exactness of the
    permutation pull-back."""
    rng = np.random.default_rng(3)
    group = tr.make_group(ttype, atom)
    plan = ConvPlan.create(mode, sample, atom, precision='highest')
    V = jnp.asarray(rng.random((2, 2) + sample))
    W = jnp.asarray(rng.random((2, 2) + atom))
    H = jnp.asarray(rng.random((2, 2 * group.size) + plan.transform_shape))
    gops = engine.get_ops((strategy, group))

    def energy(W):
        R = gops.reconstruct(W, H, plan)
        return 0.5 * jnp.sum((V - R) ** 2)

    g_auto = jax.grad(energy)(W)
    Vp = gops.prepare_data(V, plan)
    R = gops.reconstruct(W, H, plan)
    neg, pos = gops.grad_W_pair(Vp, R, H, plan)
    np.testing.assert_allclose(np.asarray(pos - neg), np.asarray(g_auto),
                               rtol=1e-8, atol=1e-10)


# ---------------------------------------------------------------------------
# full-fit trajectory parity vs the NumPy oracle driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('backend', ['jax_conv', 'jax_fft'])
@pytest.mark.parametrize('mode', ['valid', 'full', 'circular'])
def test_fit_matches_oracle_1d_flip(backend, mode):
    V = _data(seed=5, sample=(13,))
    m = TransformInvariantNMF(n_atoms=2, atom_shape=(4,), backend=backend,
                              transform_type='shift+flip', seed=7,
                              reconstruction_mode=mode, precision='highest')
    m.fit_batch(V, n_iterations=6)
    group = tr.make_group('shift+flip', (4,))
    W_ref, H_ref = _oracle_group_fit(V, 2, (4,), mode, group, 6, seed=7)
    np.testing.assert_allclose(m.W, W_ref, rtol=1e-7)
    np.testing.assert_allclose(m._H_flat(), H_ref, rtol=1e-7)


@pytest.mark.parametrize('ttype', ALL_TYPES_2D)
def test_fit_matches_oracle_2d(ttype):
    V = _data(seed=6, n=2, c=1, sample=(9, 9))
    m = TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3), backend='jax_conv',
                              transform_type=ttype, seed=8, precision='highest')
    m.fit_batch(V, n_iterations=5, sparsity_H=0.05)
    group = tr.make_group(ttype, (3, 3))
    W_ref, H_ref = _oracle_group_fit(V, 2, (3, 3), 'valid', group, 5, seed=8,
                                     sparsity=0.05)
    np.testing.assert_allclose(m.W, W_ref, rtol=1e-7)
    np.testing.assert_allclose(m._H_flat(), H_ref, rtol=1e-7)


def test_identity_group_equals_shift():
    """A custom one-element group must reproduce the plain shift model
    bit-for-bit (same shapes, same RNG stream, same updates)."""
    V = _data(seed=9)
    ident = tr.TransformGroup(name='identity', ndim=1, elements=((0, ()),))
    m1 = TransformInvariantNMF(n_atoms=3, atom_shape=(4,), seed=3,
                               backend='jax_conv', transform_type=ident)
    m2 = TransformInvariantNMF(n_atoms=3, atom_shape=(4,), seed=3,
                               backend='jax_conv')
    m1.fit_batch(V, n_iterations=5)
    m2.fit_batch(V, n_iterations=5)
    assert m1.n_transforms == 1
    np.testing.assert_array_equal(m1.W, m2.W)
    np.testing.assert_array_equal(m1.H, m2.H)


# ---------------------------------------------------------------------------
# the capability: mirror-invariant data needs half the atoms
# ---------------------------------------------------------------------------

def test_flip_invariance_explains_mirrored_data():
    """Data built from one asymmetric pulse occurring in both orientations:
    a single flip-invariant atom must fit it far better than a single
    shift-only atom (which can represent one orientation only)."""
    rng = np.random.default_rng(0)
    pulse = np.array([0.1, 0.4, 1.0, 0.2, 0.05])  # asymmetric
    V = np.zeros((6, 1, 40))
    for i in range(6):
        p = pulse if i % 2 == 0 else pulse[::-1]
        at = rng.integers(0, 40 - 5)
        V[i, 0, at:at + 5] = p
    fits = {}
    for ttype in ('shift', 'shift+flip'):
        m = TransformInvariantNMF(n_atoms=1, atom_shape=(5,), seed=1,
                                  transform_type=ttype, backend='jax_conv')
        m.fit_batch(V, n_iterations=150)
        fits[ttype] = m._energy_function()
    assert fits['shift+flip'] < 0.25 * fits['shift']


# ---------------------------------------------------------------------------
# model-level invariants
# ---------------------------------------------------------------------------

def _fit_small(ttype='shift+flip', **kw):
    V = _data(seed=11, n=4, c=1, sample=(12,))
    m = TransformInvariantNMF(n_atoms=2, atom_shape=(4,),
                              transform_type=ttype, seed=2, **kw)
    m.fit_batch(V, n_iterations=4)
    return m, V


def test_h_shape_and_partial_additivity():
    m, V = _fit_small()
    assert m.H.shape == (4, 2, 2, 15)
    R = m.R
    np.testing.assert_allclose(
        m.R_partial(0) + m.R_partial(1), R, rtol=1e-10)
    np.testing.assert_allclose(m.inverse_transform(m.H), R, rtol=1e-12)


def test_save_load_roundtrip(tmp_path):
    m, V = _fit_small()
    p = str(tmp_path / 'ckpt')
    m.save(p, include_H=True)
    m2 = TransformInvariantNMF.load(p + '.npz')
    assert m2.transform_type == 'shift+flip'
    assert m2.n_transforms == 2
    np.testing.assert_allclose(m2.W, m.W)
    np.testing.assert_allclose(m2.H, m.H)
    np.testing.assert_allclose(m2.R, m.R, rtol=1e-12)


def test_minibatch_scan_matches_python_loop():
    V = _data(seed=13, n=6, c=1, sample=(12,))
    res = {}
    for use_cb in (False, True):
        m = TransformInvariantNMF(n_atoms=2, atom_shape=(4,), seed=4,
                                  transform_type='shift+flip',
                                  backend='jax_conv')
        kw = {}
        if use_cb:  # a callback forces the per-batch Python path
            kw['progress_callback'] = lambda *_: True
        m.fit_minibatches(V, algorithm=MiniBatchAlgorithm.ASG_MU,
                          batch_size=2, n_epochs=3, **kw)
        res[use_cb] = (m.W, m.H)
    np.testing.assert_allclose(res[True][0], res[False][0], rtol=1e-7)
    np.testing.assert_allclose(res[True][1], res[False][1], rtol=1e-7)


def test_mesh_parity():
    from tnmf_tpu.parallel import make_mesh
    V = _data(seed=15, n=8, c=1, sample=(12,))
    m1 = TransformInvariantNMF(n_atoms=2, atom_shape=(4,), seed=5,
                               transform_type='shift+flip')
    m1.fit_batch(V, n_iterations=5)
    m2 = TransformInvariantNMF(n_atoms=2, atom_shape=(4,), seed=5,
                               transform_type='shift+flip',
                               mesh=make_mesh())
    m2.fit_batch(V, n_iterations=5)
    np.testing.assert_allclose(m1.W, m2.W, rtol=1e-7)
    np.testing.assert_allclose(m1.H, m2.H, rtol=1e-7)


def test_atom_mesh_parity():
    """Tensor (atom) parallelism composes with tied-transform dictionaries:
    W shards along its canonical atom axis, the m-major expansion keeps
    every atom's tied copies shard-local, and the fit reproduces the
    single-device trajectory.  Groups multiply the effective dictionary by
    up to 8 (D4) — exactly when atom sharding matters."""
    import jax
    if jax.device_count() < 8:
        pytest.skip('needs 8 (virtual) devices')
    from tnmf_tpu.parallel import make_mesh_atoms
    V = _data(seed=21, n=4, c=1, sample=(10, 10))
    kw = dict(n_atoms=8, atom_shape=(3, 3), seed=9,
              transform_type='shift+rot90+flip')
    m1 = TransformInvariantNMF(**kw)
    m1.fit_batch(V, n_iterations=4, sparsity_H=0.05)
    m2 = TransformInvariantNMF(**kw, mesh=make_mesh_atoms(8),
                               shard_axis='atoms')
    m2.fit_batch(V, n_iterations=4, sparsity_H=0.05)
    np.testing.assert_allclose(m1.W, m2.W, rtol=1e-7)
    np.testing.assert_allclose(m1.H, m2.H, rtol=1e-7)


def test_data_x_atoms_mesh_parity():
    """2-D data x atoms mesh: tied D4 dictionary, samples
    sharded over 'data', W/H atom axes over 'atoms'; trajectory matches
    single-device."""
    import jax
    if jax.device_count() < 8:
        pytest.skip('needs 8 (virtual) devices')
    from tnmf_tpu.parallel import make_mesh_2d_atoms
    V = _data(seed=22, n=4, c=2, sample=(9, 9))
    kw = dict(n_atoms=4, atom_shape=(3, 3), seed=11,
              transform_type='shift+rot90+flip')
    m1 = TransformInvariantNMF(**kw)
    m1.fit_batch(V, n_iterations=4)
    m2 = TransformInvariantNMF(**kw, mesh=make_mesh_2d_atoms(2, 4),
                               shard_axis='samples+atoms')
    m2.fit_batch(V, n_iterations=4)
    np.testing.assert_allclose(m1.W, m2.W, rtol=1e-7)
    np.testing.assert_allclose(m1.H, m2.H, rtol=1e-7)


def test_transform_serving_roundtrip():
    m, V = _fit_small()
    H = m.transform(V, n_iterations=5)
    assert H.shape == (4, 2, 2, 15)
    np.testing.assert_allclose(m.inverse_transform(H), m.R, rtol=1e-12)


@pytest.mark.parametrize('mode', ['valid', 'full', 'circular', 'reflect'])
def test_phased_lowering_composes_with_groups(monkeypatch, mode):
    """The phase-decomposed lowering must produce the same grouped
    trajectory as the plain conv strategy (H rides in the phase-blocked
    layout; the adapter expands W / ties gradients around it)."""
    V = _data(seed=31, n=2, c=1, sample=(12, 12))
    results = {}
    for phased_on in (False, True):
        monkeypatch.setattr(engine, '_phased_device', lambda: phased_on)
        m = TransformInvariantNMF(n_atoms=2, atom_shape=(5, 5), seed=12,
                                  transform_type='shift+flip',
                                  backend='jax_conv', precision='highest',
                                  reconstruction_mode=mode)
        m.fit_batch(V, n_iterations=4, sparsity_H=0.05,
                    inhibition_strength=0.1,
                    cross_atom_inhibition_strength=0.05)
        assert m._strategy == (('phased' if phased_on else 'conv'), m._group)
        results[phased_on] = (m.W, m.H, m.R_partial(0),
                              m._energy_function())
    for a, b in zip(results[False][:3], results[True][:3]):
        np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(results[False][3], results[True][3], rtol=1e-7)


def test_beta_divergence_composes_with_groups():
    """beta != 2 computes the MU factors in the prepared domain
    (engine._beta_factors fast path on conv); the group adapter must tie
    those statistics identically — pinned against the NumPy oracle for
    generalized KL."""
    from tnmf_tpu.ops import beta as beta_ops
    V = _data(seed=21, n=2, c=1, sample=(11,))
    beta = 1.0
    m = TransformInvariantNMF(n_atoms=2, atom_shape=(4,), seed=6,
                              transform_type='shift+flip',
                              backend='jax_conv', beta_loss=beta,
                              precision='highest')
    m.fit_batch(V, n_iterations=5)
    group = tr.make_group('shift+flip', (4,))
    rng = np.random.default_rng(6)
    tshape = oracle.transform_shape('valid', V.shape[2:], (4,))
    H = 1 - rng.random((V.shape[0], 2 * group.size) + tshape)
    W = 1 - rng.random((2, V.shape[1], 4))
    W /= W.sum(axis=-1, keepdims=True)
    for _ in range(5):
        We = _np_expand(W, group)
        R = oracle.reconstruct(We, H, 'valid')
        A, B = beta_ops.np_factors(V, R, beta)
        H = H * oracle.corr_H(A, We, 'valid') / (
            oracle.corr_H(B, We, 'valid') + EPS)
        R = oracle.reconstruct(_np_expand(W, group), H, 'valid')
        A, B = beta_ops.np_factors(V, R, beta)
        neg = _np_tie(oracle.corr_W(A, H, 'valid', (4,)), group)
        pos = _np_tie(oracle.corr_W(B, H, 'valid', (4,)), group)
        W = W * neg / (pos + EPS)
        s = W.sum(axis=-1, keepdims=True)
        W = W / np.where(s == 0, 1, s)
    np.testing.assert_allclose(m.W, W, rtol=1e-7)
    np.testing.assert_allclose(m._H_flat(), H, rtol=1e-7)


def test_tol_early_stopping_grouped():
    V = _data(seed=23, n=4, c=1, sample=(12,))
    m = TransformInvariantNMF(n_atoms=2, atom_shape=(4,), seed=8,
                              transform_type='shift+flip')
    m.fit_batch(V, n_iterations=500, tol=1e-3, tol_check_every=5)
    assert m.n_iterations_ is not None and m.n_iterations_ < 500
    # the stopped state must equal an exact fixed-count fit
    m2 = TransformInvariantNMF(n_atoms=2, atom_shape=(4,), seed=8,
                               transform_type='shift+flip')
    m2.fit_batch(V, n_iterations=m.n_iterations_)
    np.testing.assert_allclose(m.W, m2.W, rtol=1e-9)
    np.testing.assert_allclose(m.H, m2.H, rtol=1e-9)


def test_record_energies_grouped_decreasing():
    V = _data(seed=24, n=3, c=1, sample=(12,))
    m = TransformInvariantNMF(n_atoms=2, atom_shape=(4,), seed=9,
                              transform_type='shift+flip')
    m.fit_batch(V, n_iterations=20, record_energies=True)
    e = np.asarray(m.energies_)
    assert e.shape == (20,)
    assert e[-1] < e[0]
    np.testing.assert_allclose(e[-1], m._energy_function(), rtol=1e-6)


def test_fit_stream_grouped():
    V = _data(seed=25, n=9, c=1, sample=(12,))
    m = TransformInvariantNMF(n_atoms=2, atom_shape=(4,), seed=10,
                              transform_type='shift+flip')
    m.fit(iter(V), subsample_size=3, n_iterations=3)
    assert m.W.shape == (2, 1, 4)
    assert m.H.shape == (3, 2, 2, 15)  # last subsample's activations


def test_bfloat16_grouped_smoke():
    import jax.numpy as jnp
    V = _data(seed=26, n=3, c=1, sample=(12,), dtype=np.float32)
    m = TransformInvariantNMF(n_atoms=2, atom_shape=(4,), seed=11,
                              transform_type='shift+flip', dtype='bfloat16')
    m.fit_batch(V, n_iterations=5)
    assert m._W.dtype == jnp.bfloat16
    assert np.isfinite(m._energy_function())


def test_error_paths():
    with pytest.raises(ValueError, match='square atoms'):
        TransformInvariantNMF(2, (3, 4), transform_type='shift+rot90')
    with pytest.raises(ValueError, match='2 shift dimensions'):
        TransformInvariantNMF(2, (5,), transform_type='shift+rot90')
    with pytest.raises(ValueError, match='unknown transform type'):
        TransformInvariantNMF(2, (5,), transform_type='shift+warp')
    from tnmf_tpu.parallel import make_mesh
    m = TransformInvariantNMF(2, (5,), transform_type='shift+flip',
                              mesh=make_mesh(), shard_axis='spatial')
    with pytest.raises(ValueError, match="shard_axis='samples'"):
        m.fit_batch(_data(seed=1, n=8, c=1, sample=(16,)), n_iterations=1)
