"""Beta-divergence MU updates: oracle parity, loss correctness, behavior.

The reference implements only the Euclidean objective (beta = 2;
``/root/reference/tnmf/backends/_Backend.py:127-130``); its minibatch
algorithms cite the beta-divergence setting of Serizel et al. 2016 without
implementing it (``TransformInvariantNMF.py:136-139``).  Here the full
family is a first-class capability, so these tests pin it three ways:

* the jitted strategies against a NumPy oracle MU driver (trajectories),
* the divergence values against sklearn's ``_beta_divergence``,
* qualitative MU guarantees (monotone descent for H-only updates).
"""

import numpy as np
import pytest

from tnmf_tpu.models.tnmf import TransformInvariantNMF
from tnmf_tpu.ops import beta as beta_ops
from tnmf_tpu.ops import oracle

BETAS = (0.0, 0.5, 1.0, 1.5, 2.0)


@pytest.fixture
def force_phased(monkeypatch):
    from tnmf_tpu import engine
    monkeypatch.setattr(engine, '_phased_device', lambda: True)


def _toy(mode, seed=0, n=3, c=2, sample=(12,), atom=(4,)):
    rng = np.random.default_rng(seed)
    V = rng.random((n, c) + sample).astype(np.float64) + 0.05
    return V


def _oracle_fit(V, n_atoms, atom_shape, mode, beta, n_iterations, seed,
                update_W=True, sparsity=0.0):
    """Host-RNG-parity NumPy MU driver for any beta (the cross-check
    anchor, mirroring the reference's cross-backend test pattern)."""
    rng = np.random.default_rng(seed)
    tshape = oracle.transform_shape(mode, V.shape[2:], atom_shape)
    H = 1 - rng.random((V.shape[0], n_atoms) + tshape)
    W = 1 - rng.random((n_atoms, V.shape[1]) + atom_shape)
    W /= W.sum(axis=tuple(range(-len(atom_shape), 0)), keepdims=True)
    axes = tuple(range(-len(atom_shape), 0))
    for _ in range(n_iterations):
        R = oracle.reconstruct(W, H, mode)
        A, B = beta_ops.np_factors(V, R, beta)
        neg = oracle.corr_H(A, W, mode)
        pos = oracle.corr_H(B, W, mode)
        H = H * neg / (pos + 1e-9 + sparsity)
        if update_W:
            R = oracle.reconstruct(W, H, mode)
            A, B = beta_ops.np_factors(V, R, beta)
            neg = oracle.corr_W(A, H, mode, atom_shape)
            pos = oracle.corr_W(B, H, mode, atom_shape)
            W = W * neg / (pos + 1e-9)
            s = W.sum(axis=axes, keepdims=True)
            W = W / np.where(s == 0, 1, s)
    return W, H


@pytest.mark.parametrize('beta', BETAS)
@pytest.mark.parametrize('mode', ('valid', 'full', 'circular', 'reflect'))
@pytest.mark.parametrize('backend', ('jax_conv', 'jax_fft'))
def test_beta_matches_oracle_1d(beta, mode, backend):
    V = _toy(mode)
    Wo, Ho = _oracle_fit(V, n_atoms=3, atom_shape=(4,), mode=mode, beta=beta,
                         n_iterations=5, seed=7)
    nmf = TransformInvariantNMF(3, (4,), backend=backend, seed=7,
                                reconstruction_mode=mode, beta_loss=beta)
    nmf.fit_batch(V.astype(np.float32), n_iterations=5)
    np.testing.assert_allclose(nmf.W, Wo, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(nmf.H, Ho, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize('beta', (1.0, 1.5))
def test_beta_matches_oracle_2d_phased(beta, force_phased):
    """The phase-decomposed lowering serves every beta unchanged."""
    rng = np.random.default_rng(3)
    V = rng.random((2, 1, 12, 12)).astype(np.float64) + 0.05
    Wo, Ho = _oracle_fit(V, n_atoms=2, atom_shape=(3, 3), mode='valid',
                         beta=beta, n_iterations=4, seed=11)
    nmf = TransformInvariantNMF(2, (3, 3), backend='jax_conv', seed=11,
                                beta_loss=beta)
    nmf.fit_batch(V.astype(np.float32), n_iterations=4)
    assert nmf._strategy == 'phased'
    np.testing.assert_allclose(nmf.W, Wo, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(nmf.H, Ho, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize('beta', BETAS)
def test_divergence_matches_sklearn(beta):
    sklearn_nmf = pytest.importorskip('sklearn.decomposition._nmf')
    rng = np.random.default_rng(0)
    V = rng.random((40,)) + 0.01
    R = rng.random((40,)) + 0.01
    ours = float(beta_ops.divergence(V.astype(np.float32), R.astype(np.float32), beta))
    # trivial factorization X = W @ H with W = R column, H = [[1]]
    ref = float(sklearn_nmf._beta_divergence(
        V.reshape(-1, 1), R.reshape(-1, 1), np.ones((1, 1)), beta))
    assert ours == pytest.approx(ref, rel=1e-4)
    assert beta_ops.np_divergence(V, R, beta) == pytest.approx(ref, rel=1e-6)


@pytest.mark.parametrize('beta,name', [(2.0, 'frobenius'),
                                       (1.0, 'kullback-leibler'),
                                       (0.0, 'itakura-saito')])
def test_named_beta_losses(beta, name):
    assert beta_ops.resolve_beta_loss(name) == beta
    assert beta_ops.resolve_beta_loss(beta) == beta
    with pytest.raises(ValueError, match='beta_loss'):
        beta_ops.resolve_beta_loss('gaussian')


@pytest.mark.parametrize('beta', (1.0, 0.5))
def test_h_update_monotone_descent(beta):
    """H-only MU descends the beta-divergence for beta in [0, 2] (the
    provable MU regime); checked through the recorded on-device trace."""
    V = _toy('valid', seed=5, sample=(16,))
    nmf = TransformInvariantNMF(3, (5,), backend='jax_conv', seed=5,
                                beta_loss=beta, dtype=np.float64)
    nmf.fit_batch(V, n_iterations=15, update_W=False, record_energies=True)
    e = nmf.energies_
    assert np.all(np.diff(e) <= 1e-8 * max(1.0, e[0]))


def test_beta2_trajectory_unchanged():
    """beta_loss=2 is bit-identical to the default Euclidean path."""
    V = _toy('valid').astype(np.float32)
    a = TransformInvariantNMF(3, (4,), backend='jax_conv', seed=1)
    a.fit_batch(V, n_iterations=6)
    b = TransformInvariantNMF(3, (4,), backend='jax_conv', seed=1,
                              beta_loss='frobenius')
    b.fit_batch(V, n_iterations=6)
    np.testing.assert_array_equal(a.W, b.W)
    np.testing.assert_array_equal(a.H, b.H)


def test_beta_energy_trace_and_tol():
    """energies_ records the beta-divergence; tol early stopping runs on it."""
    V = _toy('valid', seed=9)
    nmf = TransformInvariantNMF(3, (4,), backend='jax_conv', seed=9,
                                beta_loss=1.0, dtype=np.float64)
    nmf.fit_batch(V, n_iterations=8, record_energies=True)
    R = nmf.R
    expected = beta_ops.np_divergence(nmf.V, R, 1.0)
    assert nmf.energies_[-1] == pytest.approx(expected, rel=1e-6)

    nmf2 = TransformInvariantNMF(3, (4,), backend='jax_conv', seed=9,
                                 beta_loss=1.0, dtype=np.float64)
    nmf2.fit_batch(V, n_iterations=500, tol=1e-3, tol_check_every=5)
    assert nmf2.n_iterations_ < 500


def test_beta_minibatch_matches_oracle_schedule():
    """ASG_MU with beta = 1: the scan path equals a hand-rolled oracle
    epoch schedule (H then W per batch, sequential order)."""
    from tnmf_tpu.models.tnmf import MiniBatchAlgorithm
    rng = np.random.default_rng(2)
    V = rng.random((6, 1, 10)).astype(np.float64) + 0.05
    mode, atom, n_atoms, bs = 'valid', (3,), 2, 3

    # oracle: replicate init + Cyclic batch order (seeded, ASG shuffles -> use
    # algorithm Cyclic_MU which visits batches in order and updates W per epoch)
    nmf = TransformInvariantNMF(n_atoms, atom, backend='jax_conv', seed=4,
                                beta_loss=1.0, dtype=np.float64)
    nmf.fit_minibatches(V, algorithm=MiniBatchAlgorithm.Cyclic_MU,
                        batch_size=bs, n_epochs=3)

    rng2 = np.random.default_rng(4)
    tshape = oracle.transform_shape(mode, V.shape[2:], atom)
    H = 1 - rng2.random((V.shape[0], n_atoms) + tshape)
    W = 1 - rng2.random((n_atoms, V.shape[1]) + atom)
    W /= W.sum(axis=(-1,), keepdims=True)
    for _ in range(3):
        acc_n = np.zeros_like(W)
        acc_p = np.zeros_like(W)
        for b0 in range(0, len(V), bs):
            s = slice(b0, b0 + bs)
            R = oracle.reconstruct(W, H[s], mode)
            A, B = beta_ops.np_factors(V[s], R, 1.0)
            neg = oracle.corr_H(A, W, mode)
            pos = oracle.corr_H(B, W, mode)
            H[s] = H[s] * neg / (pos + 1e-9)
            R = oracle.reconstruct(W, H[s], mode)
            A, B = beta_ops.np_factors(V[s], R, 1.0)
            acc_n += oracle.corr_W(A, H[s], mode, atom)
            acc_p += oracle.corr_W(B, H[s], mode, atom)
        W = W * acc_n / (acc_p + 1e-9)
        s = W.sum(axis=(-1,), keepdims=True)
        W = W / np.where(s == 0, 1, s)
    np.testing.assert_allclose(nmf.W, W, rtol=1e-8)
    np.testing.assert_allclose(nmf.H, H, rtol=1e-8)


@pytest.mark.parametrize('beta', (0.0, 0.5, 1.0, 1.5))
@pytest.mark.parametrize('mode', ('valid', 'full', 'circular', 'reflect'))
def test_beta_fast_path_matches_generic(beta, mode):
    """The prepared-domain factor fast path (no in-loop prepare_data;
    batch-1 KL denominators) equals the generic canonical formulation to
    float64 roundoff, per gradient half."""
    import jax.numpy as jnp
    from tnmf_tpu import engine
    from tnmf_tpu.ops import conv as conv_ops
    from tnmf_tpu.ops.modes import ConvPlan

    rng = np.random.default_rng(0)
    V = rng.random((3, 2, 11)) + 0.05
    W = rng.random((2, 2, 4))
    W /= W.sum(-1, keepdims=True)
    plan = ConvPlan.create(mode, (11,), (4,))
    H = rng.random((3, 2) + plan.transform_shape)
    Vd, Wd, Hd = map(jnp.asarray, (V, W, H))
    R = conv_ops.reconstruct(Wd, Hd, plan)
    Vp = conv_ops.prepare_data(Vd, plan)

    assert engine.beta_prepares_data('conv')
    assert not engine.beta_prepares_data('fft')

    fast = engine._beta_grad_H(conv_ops, Vp, R, Wd, plan, beta)
    generic = engine._beta_grad_pair(conv_ops, conv_ops.grad_H_pair,
                                     Vd, R, Wd, plan, beta)
    for f, g in zip(fast, generic):
        g = np.asarray(g)
        np.testing.assert_allclose(np.broadcast_to(np.asarray(f), g.shape),
                                   g, rtol=1e-10, atol=1e-12)

    fast = engine._beta_grad_W(conv_ops, Vp, R, Hd, plan, beta, n_channels=2)
    generic = engine._beta_grad_pair(conv_ops, conv_ops.grad_W_pair,
                                     Vd, R, Hd, plan, beta)
    for f, g in zip(fast, generic):
        g = np.asarray(g)
        np.testing.assert_allclose(np.broadcast_to(np.asarray(f), g.shape),
                                   g, rtol=1e-10, atol=1e-12)


def test_beta_group_fast_path_matches_oracle():
    """Transform-group adapter + KL: the tied-dictionary beta fit matches a
    NumPy oracle running the expanded-dictionary MU with tie-back."""
    from tnmf_tpu.ops import transforms as tr
    rng = np.random.default_rng(8)
    V = rng.random((2, 1, 9, 9)).astype(np.float64) + 0.05
    n_atoms, atom = 2, (3, 3)
    group = tr.make_group('shift+flip', atom)

    nmf = TransformInvariantNMF(n_atoms, atom, backend='jax_conv', seed=3,
                                beta_loss=1.0, dtype=np.float64,
                                transform_type='shift+flip')
    nmf.fit_batch(V, n_iterations=3)

    rng2 = np.random.default_rng(3)
    tshape = oracle.transform_shape('valid', V.shape[2:], atom)
    H = 1 - rng2.random((V.shape[0], n_atoms * group.size) + tshape)
    W = 1 - rng2.random((n_atoms, V.shape[1]) + atom)
    W /= W.sum(axis=(-2, -1), keepdims=True)

    def expand(W):
        return np.concatenate(
            [np.asarray(tr.apply(W[m:m + 1], e, 2, 2))
             for m in range(n_atoms) for e in group.elements])

    def tie(G):
        Gm = G.reshape((n_atoms, group.size) + G.shape[1:])
        return sum(np.asarray(tr.apply_inverse(Gm[:, i], e, 2, 2))
                   for i, e in enumerate(group.elements))

    for _ in range(3):
        We = expand(W)
        R = oracle.reconstruct(We, H, 'valid')
        A, B = beta_ops.np_factors(V, R, 1.0)
        H = H * oracle.corr_H(A, We, 'valid') / (
            oracle.corr_H(B, We, 'valid') + 1e-9)
        We = expand(W)
        R = oracle.reconstruct(We, H, 'valid')
        A, B = beta_ops.np_factors(V, R, 1.0)
        neg = tie(oracle.corr_W(A, H, 'valid', atom))
        pos = tie(oracle.corr_W(B, H, 'valid', atom))
        W = W * neg / (pos + 1e-9)
        s = W.sum(axis=(-2, -1), keepdims=True)
        W = W / np.where(s == 0, 1, s)
    np.testing.assert_allclose(nmf.W, W, rtol=1e-8)
    np.testing.assert_allclose(nmf.H.reshape(H.shape), H, rtol=1e-8)


def test_is_divergence_zero_data_guard():
    V = np.zeros((2, 1, 8), np.float32)
    nmf = TransformInvariantNMF(2, (3,), backend='jax_conv', beta_loss=0.0)
    with pytest.raises(ValueError, match='zeros'):
        nmf.fit_batch(V, n_iterations=2)


def test_beta_transform_serving():
    """transform() (frozen dictionary) honors the model's beta_loss."""
    V = _toy('valid', seed=13).astype(np.float32)
    nmf = TransformInvariantNMF(3, (4,), backend='jax_conv', seed=13,
                                beta_loss=1.0)
    nmf.fit_batch(V, n_iterations=10)
    H = nmf.transform(V, n_iterations=10)
    assert H.shape == nmf.H.shape
    assert np.all(H >= 0)


def test_beta_sharded_matches_single_device():
    """A data-parallel KL fit reproduces the single-device trajectory (the
    beta statistics are still exact sums over samples, so the psum-reduced
    shards are mathematically identical)."""
    import jax
    if jax.device_count() < 8:
        pytest.skip('needs 8 (virtual) devices')
    from tnmf_tpu.parallel import make_mesh
    rng = np.random.default_rng(6)
    V = rng.random((8, 2, 12, 12)) + 0.05

    np.random.seed(42)
    single = TransformInvariantNMF(4, (3, 3), backend='jax_conv', beta_loss=1.0)
    single.fit(V, n_iterations=5)

    np.random.seed(42)
    sharded = TransformInvariantNMF(4, (3, 3), backend='jax_conv', beta_loss=1.0,
                                    mesh=make_mesh(8))
    sharded.fit(V, n_iterations=5)

    np.testing.assert_allclose(sharded.W, single.W, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(sharded.H, single.H, rtol=1e-8, atol=1e-10)
