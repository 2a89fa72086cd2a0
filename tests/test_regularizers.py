"""Ridge (``l2_H``) and cross-atom orthogonality (``ortho_W``) regularizers.

Both are extensions over the reference, whose regularizer set is L1
sparsity plus lateral inhibition on H only
(``/root/reference/tnmf/TransformInvariantNMF.py:246-271``):

* ``l2_H`` — sklearn's ``alpha_H`` L2 term: gradient ``l2 * H`` joins the
  positive MU part.
* ``ortho_W`` — dictionary diversity (Choi-style orthogonal NMF): gradient
  ``ortho * sum_{m' != m} W_m'`` joins the positive part of the W update,
  multiplicatively shrinking entries where *other* atoms carry mass.

Pinned here: trajectories against a NumPy oracle MU driver across modes
and strategies (incl. the phased lowering), bitwise no-op at zero
strength, the defining behavioral effects, and composition with the
minibatch scan/loop drivers and partial_fit.
"""

import numpy as np
import pytest

from tnmf_tpu.models.tnmf import TransformInvariantNMF
from tnmf_tpu.ops import oracle


@pytest.fixture
def force_phased(monkeypatch):
    from tnmf_tpu import engine
    monkeypatch.setattr(engine, '_phased_device', lambda: True)


def _toy(seed=0, n=3, c=2, sample=(12,)):
    rng = np.random.default_rng(seed)
    return rng.random((n, c) + sample).astype(np.float64) + 0.05


def _oracle_fit(V, n_atoms, atom_shape, mode, n_iterations, seed,
                sparsity=0.0, l2=0.0, ortho=0.0):
    """Host-RNG-parity NumPy MU driver with the new regularizer terms."""
    rng = np.random.default_rng(seed)
    tshape = oracle.transform_shape(mode, V.shape[2:], atom_shape)
    H = 1 - rng.random((V.shape[0], n_atoms) + tshape)
    W = 1 - rng.random((n_atoms, V.shape[1]) + atom_shape)
    axes = tuple(range(-len(atom_shape), 0))
    W /= W.sum(axis=axes, keepdims=True)
    for _ in range(n_iterations):
        R = oracle.reconstruct(W, H, mode)
        neg = oracle.corr_H(V, W, mode)
        pos = oracle.corr_H(R, W, mode) + l2 * H
        H = H * neg / (pos + 1e-9 + sparsity)
        R = oracle.reconstruct(W, H, mode)
        neg = oracle.corr_W(V, H, mode, atom_shape)
        pos = oracle.corr_W(R, H, mode, atom_shape)
        pos = pos + ortho * (W.sum(axis=0, keepdims=True) - W)
        W = W * neg / (pos + 1e-9)
        s = W.sum(axis=axes, keepdims=True)
        W = W / np.where(s == 0, 1, s)
    return W, H


@pytest.mark.parametrize('l2,ortho', ((0.3, 0.0), (0.0, 0.2), (0.3, 0.2)))
@pytest.mark.parametrize('mode', ('valid', 'full', 'circular', 'reflect'))
@pytest.mark.parametrize('backend', ('jax_conv', 'jax_fft'))
def test_matches_oracle_1d(l2, ortho, mode, backend):
    V = _toy()
    Wo, Ho = _oracle_fit(V, n_atoms=3, atom_shape=(4,), mode=mode,
                         n_iterations=6, seed=7, sparsity=0.05, l2=l2,
                         ortho=ortho)
    nmf = TransformInvariantNMF(3, (4,), backend=backend, seed=7,
                                reconstruction_mode=mode)
    nmf.fit_batch(V.astype(np.float32), n_iterations=6, sparsity_H=0.05,
                  l2_H=l2, ortho_W=ortho)
    np.testing.assert_allclose(nmf.W, Wo, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(nmf.H, Ho, rtol=2e-3, atol=2e-4)


def test_matches_oracle_2d_phased(force_phased):
    """The phase-decomposed lowering carries both terms unchanged
    (l2 is elementwise in the phased layout; ortho acts on canonical W)."""
    rng = np.random.default_rng(3)
    V = rng.random((2, 1, 12, 10)) + 0.05
    Wo, Ho = _oracle_fit(V, n_atoms=4, atom_shape=(3, 3), mode='circular',
                         n_iterations=5, seed=11, l2=0.2, ortho=0.1)
    nmf = TransformInvariantNMF(4, (3, 3), seed=11,
                                reconstruction_mode='circular')
    nmf.fit_batch(V.astype(np.float32), n_iterations=5, l2_H=0.2,
                  ortho_W=0.1)
    assert nmf._strategy == 'phased'
    np.testing.assert_allclose(nmf.W, Wo, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(nmf.H, Ho, rtol=2e-3, atol=2e-4)


def test_zero_strength_is_bitwise_noop():
    """l2_H=0 / ortho_W=0 resolve to None and reuse the default graphs."""
    V = _toy().astype(np.float32)
    a = TransformInvariantNMF(3, (4,), seed=1)
    a.fit(V, n_iterations=5)
    b = TransformInvariantNMF(3, (4,), seed=1)
    b.fit(V, n_iterations=5, l2_H=0.0, ortho_W=0.0)
    assert np.array_equal(a.W, b.W) and np.array_equal(a.H, b.H)


def test_ortho_reduces_atom_overlap():
    """The defining effect: the cross-atom overlap sum_{m != m'}
    <W_m, W_m'> drops under the penalty (duplicate atoms are suppressed;
    W stays sum-normalized so the comparison is scale-fair)."""
    rng = np.random.default_rng(0)
    # two ground-truth pulses, four atoms -> duplicates without pressure
    t = np.arange(24.0)
    gt = np.stack([np.exp(-0.5 * (t - 8) ** 2), np.exp(-0.2 * (t - 15) ** 2)])
    V = (rng.random((6, 1, 2)) @ gt[None, :, :]).reshape(6, 1, 24) + 0.01

    def overlap(W):
        F = W.reshape(W.shape[0], -1)
        G = F @ F.T
        return float(G.sum() - np.trace(G))

    base = TransformInvariantNMF(4, (5,), seed=5)
    base.fit(V.astype(np.float32), n_iterations=40)
    reg = TransformInvariantNMF(4, (5,), seed=5)
    reg.fit(V.astype(np.float32), n_iterations=40, ortho_W=1.0)
    assert overlap(reg.W) < overlap(base.W)
    assert np.isfinite(reg.H).all()


def test_l2_shrinks_activations():
    V = _toy().astype(np.float32)
    base = TransformInvariantNMF(3, (4,), seed=5)
    base.fit(V, n_iterations=30)
    reg = TransformInvariantNMF(3, (4,), seed=5)
    reg.fit(V, n_iterations=30, l2_H=5.0)
    assert np.linalg.norm(reg.H) < np.linalg.norm(base.H)
    assert np.isfinite(reg.H).all()


def test_minibatch_scan_matches_python_loop():
    """The fully on-device minibatch scan applies both terms exactly like
    the per-batch Python path (ASG_MU: W updated per batch from the
    current dictionary's ortho term)."""
    V = _toy(n=4).astype(np.float32)
    np.random.seed(42)
    scan = TransformInvariantNMF(3, (4,))
    scan.fit(V, batch_size=2, n_epochs=3, l2_H=0.2, ortho_W=0.1)
    np.random.seed(42)
    loop = TransformInvariantNMF(3, (4,))
    loop.fit(V, batch_size=2, n_epochs=3, l2_H=0.2, ortho_W=0.1,
             progress_callback=lambda m, e: True)  # forces the Python path
    np.testing.assert_allclose(scan.W, loop.W, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(scan.H, loop.H, rtol=1e-5, atol=1e-7)


def test_partial_fit_first_call_matches_fit_batch():
    """sag_lambda=1 partial_fit with the new terms is pinned identical to
    one regularized fit_batch iteration (the existing identity extends)."""
    V = _toy(n=4).astype(np.float32)
    a = TransformInvariantNMF(3, (4,), seed=3)
    a.partial_fit(V, sag_lambda=1.0, l2_H=0.2, ortho_W=0.1)
    b = TransformInvariantNMF(3, (4,), seed=3)
    b.fit_batch(V, n_iterations=1, l2_H=0.2, ortho_W=0.1)
    np.testing.assert_allclose(np.asarray(a.W), np.asarray(b.W), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(a.H), np.asarray(b.H), rtol=1e-6)


def test_transform_accepts_l2():
    """l2_H flows through the frozen-dictionary encoding path (transform
    delegates to fit_batch; ortho_W is irrelevant there — W is frozen)."""
    V = _toy().astype(np.float32)
    nmf = TransformInvariantNMF(3, (4,), seed=2)
    nmf.fit(V, n_iterations=10)
    h_plain = nmf.transform(V, n_iterations=5)
    h_l2 = nmf.transform(V, n_iterations=5, l2_H=5.0)
    assert np.linalg.norm(h_l2) < np.linalg.norm(h_plain)


def test_tol_loop_composes():
    V = _toy().astype(np.float32)
    nmf = TransformInvariantNMF(3, (4,), seed=2)
    nmf.fit(V, n_iterations=50, tol=1e-3, l2_H=0.2, ortho_W=0.1)
    assert nmf.n_iterations_ <= 50
    assert np.isfinite(nmf.W).all()


def test_negative_strength_rejected():
    V = _toy().astype(np.float32)
    nmf = TransformInvariantNMF(3, (4,))
    with pytest.raises(ValueError, match='l2_H'):
        nmf.fit_batch(V, n_iterations=1, l2_H=-1.0)
    with pytest.raises(ValueError, match='ortho_W'):
        nmf.fit_batch(V, n_iterations=1, ortho_W=-0.5)


def test_sweep_per_model_vectors():
    """sweep_fit grids over l2/ortho; a zero entry is exact (bitwise equal
    to the unregularized sweep lane, since pos + 0*X == pos)."""
    from tnmf_tpu.models.sweep import sweep_fit
    V = _toy().astype(np.float32)
    plain = sweep_fit(V, n_atoms=3, atom_shape=(4,), n_models=2, seed=0,
                      n_iterations=15)
    reg = sweep_fit(V, n_atoms=3, atom_shape=(4,), n_models=2, seed=0,
                    n_iterations=15, l2=np.array([0.0, 5.0]),
                    ortho=np.array([0.0, 0.5]))
    assert np.array_equal(np.asarray(plain.W[0]), np.asarray(reg.W[0]))
    assert np.array_equal(np.asarray(plain.H[0]), np.asarray(reg.H[0]))
    assert (np.linalg.norm(np.asarray(reg.H[1]))
            < np.linalg.norm(np.asarray(plain.H[1])))


def test_matches_oracle_grouped():
    """Composition with transform groups: l2 acts elementwise on the
    (atom, transform)-map H, ortho on the CANONICAL atom bank (the tied
    copies are deterministic functions of it, so diversity pressure on the
    canonical atoms is the whole penalty)."""
    from tests.test_transforms import (_np_expand, _np_tie, _data)
    from tnmf_tpu.ops.transforms import make_group

    l2, ortho = 0.3, 0.2
    V = _data(sample=(13,))
    atom_shape, n_atoms, mode, iters, seed = (4,), 2, 'valid', 5, 9
    group = make_group('shift+flip', atom_shape)

    # grouped oracle MU with the new terms (mirrors _oracle_group_fit)
    rng = np.random.default_rng(seed)
    tshape = oracle.transform_shape(mode, V.shape[2:], atom_shape)
    H = 1 - rng.random((V.shape[0], n_atoms * group.size) + tshape)
    W = 1 - rng.random((n_atoms, V.shape[1]) + atom_shape)
    axes = tuple(range(-len(atom_shape), 0))
    W /= W.sum(axis=axes, keepdims=True)
    for _ in range(iters):
        We = _np_expand(W, group)
        R = oracle.reconstruct(We, H, mode)
        neg = oracle.corr_H(V, We, mode)
        pos = oracle.corr_H(R, We, mode) + l2 * H
        H = H * neg / (pos + 1e-9)
        R = oracle.reconstruct(_np_expand(W, group), H, mode)
        neg = _np_tie(oracle.corr_W(V, H, mode, atom_shape), group)
        pos = _np_tie(oracle.corr_W(R, H, mode, atom_shape), group)
        pos = pos + ortho * (W.sum(axis=0, keepdims=True) - W)
        W = W * neg / (pos + 1e-9)
        s = W.sum(axis=axes, keepdims=True)
        W = W / np.where(s == 0, 1, s)

    nmf = TransformInvariantNMF(n_atoms, atom_shape, seed=seed,
                                reconstruction_mode=mode,
                                transform_type='shift+flip')
    nmf.fit_batch(V.astype(np.float32), n_iterations=iters, l2_H=l2,
                  ortho_W=ortho)
    np.testing.assert_allclose(nmf.W, W, rtol=2e-3, atol=2e-4)
    H_flat = np.asarray(nmf.H).reshape(
        (V.shape[0], n_atoms * group.size) + tshape)
    np.testing.assert_allclose(H_flat, H, rtol=2e-3, atol=2e-4)
