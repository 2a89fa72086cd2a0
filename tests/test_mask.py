"""Masked / weighted factorization (``mask=`` on the fit drivers).

No reference counterpart: the reference's objective always sums over every
data entry.  Here a per-entry mask (zeros = missing values, nonnegative
floats = confidence weights) multiplies the objective, and the MU updates
weight both gradient halves accordingly (``engine._mu_H`` docstring).
Pinned:

* trajectories against a NumPy oracle masked-MU driver (strategies, modes,
  beta in {2, 1}),
* the defining invariance: values at masked-out positions NEVER influence
  the fit,
* all-ones mask == no mask (including the phased lowering),
* composition with minibatch scan/loop, tol, energy traces, meshes,
  transform groups, and the serving path (masked encoding -> imputation),
* the capability: a dictionary learned from incomplete data imputes the
  held-out block far better than the column mean.
"""

import numpy as np
import pytest

from tnmf_tpu import engine
from tnmf_tpu.models.tnmf import MiniBatchAlgorithm, TransformInvariantNMF
from tnmf_tpu.ops import beta as beta_ops
from tnmf_tpu.ops import oracle

EPS = 1e-9


def _oracle_masked_fit(V, M, n_atoms, atom_shape, mode, beta, n_iterations,
                       seed, sparsity=0.0):
    """NumPy masked-MU driver replicating the model's host init stream."""
    rng = np.random.default_rng(seed)
    tshape = oracle.transform_shape(mode, V.shape[2:], atom_shape)
    H = 1 - rng.random((V.shape[0], n_atoms) + tshape)
    W = 1 - rng.random((n_atoms, V.shape[1]) + atom_shape)
    axes = tuple(range(-len(atom_shape), 0))
    W /= W.sum(axis=axes, keepdims=True)
    Mb = np.broadcast_to(M, V.shape)
    for _ in range(n_iterations):
        R = oracle.reconstruct(W, H, mode)
        A, B = beta_ops.np_factors(V, R, beta)
        A, B = A * Mb, B * Mb
        H = H * oracle.corr_H(A, W, mode) / (
            oracle.corr_H(B, W, mode) + EPS + sparsity)
        R = oracle.reconstruct(W, H, mode)
        A, B = beta_ops.np_factors(V, R, beta)
        A, B = A * Mb, B * Mb
        W = W * oracle.corr_W(A, H, mode, atom_shape) / (
            oracle.corr_W(B, H, mode, atom_shape) + EPS)
        s = W.sum(axis=axes, keepdims=True)
        W = W / np.where(s == 0, 1, s)
    return W, H


def _data(seed=0, n=3, c=2, sample=(13,)):
    rng = np.random.default_rng(seed)
    V = (rng.random((n, c) + sample) + 0.05)
    M = (rng.random(V.shape) > 0.3).astype(np.float64)
    return V, M


@pytest.mark.parametrize('backend', ['jax_conv', 'jax_fft'])
@pytest.mark.parametrize('mode', ['valid', 'full', 'circular', 'reflect'])
@pytest.mark.parametrize('beta', [2.0, 1.0])
def test_fit_matches_masked_oracle(backend, mode, beta):
    V, M = _data(seed=5)
    m = TransformInvariantNMF(n_atoms=2, atom_shape=(4,), backend=backend,
                              seed=7, reconstruction_mode=mode,
                              beta_loss=beta, precision='highest')
    m.fit_batch(V, n_iterations=6, mask=M, sparsity_H=0.02)
    W_ref, H_ref = _oracle_masked_fit(V, M, 2, (4,), mode, beta, 6, seed=7,
                                      sparsity=0.02)
    np.testing.assert_allclose(m.W, W_ref, rtol=1e-6)
    np.testing.assert_allclose(m.H, H_ref, rtol=1e-6)


def test_float_weights_match_oracle_2d():
    rng = np.random.default_rng(9)
    V, _ = _data(seed=9, n=2, c=1, sample=(9, 9))
    Wts = rng.random(V.shape) * 2.0  # general nonnegative weights
    m = TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3), seed=4,
                              backend='jax_conv', precision='highest')
    m.fit_batch(V, n_iterations=5, mask=Wts)
    W_ref, H_ref = _oracle_masked_fit(V, Wts, 2, (3, 3), 'valid', 2.0, 5, seed=4)
    np.testing.assert_allclose(m.W, W_ref, rtol=1e-6)
    np.testing.assert_allclose(m.H, H_ref, rtol=1e-6)


def test_masked_values_never_leak():
    """The defining property: arbitrary garbage at masked-out positions
    must produce the bit-identical trajectory."""
    V, M = _data(seed=11)
    V2 = V.copy()
    V2[M == 0] = 1e6
    res = []
    for data in (V, V2):
        m = TransformInvariantNMF(n_atoms=2, atom_shape=(4,), seed=2)
        m.fit_batch(data, n_iterations=8, mask=M, record_energies=True)
        res.append((m.W, m.H, np.asarray(m.energies_)))
    np.testing.assert_array_equal(res[0][0], res[1][0])
    np.testing.assert_array_equal(res[0][1], res[1][1])
    np.testing.assert_array_equal(res[0][2], res[1][2])


def test_ones_mask_equals_no_mask(monkeypatch):
    V, _ = _data(seed=12, n=2, c=1, sample=(12, 12))
    for phased_on in (False, True):
        monkeypatch.setattr(engine, '_phased_device', lambda: phased_on)
        m1 = TransformInvariantNMF(n_atoms=2, atom_shape=(5, 5), seed=3)
        m1.fit_batch(V, n_iterations=5)
        m2 = TransformInvariantNMF(n_atoms=2, atom_shape=(5, 5), seed=3)
        m2.fit_batch(V, n_iterations=5, mask=np.ones_like(V))
        if phased_on:
            assert m2._strategy == 'phased'
        np.testing.assert_allclose(m1.W, m2.W, rtol=1e-12)
        np.testing.assert_allclose(m1.H, m2.H, rtol=1e-12)


def test_broadcast_mask_channel_axis():
    """A (n, 1, *S) mask broadcasts over channels, matching the full mask."""
    V, M = _data(seed=13, c=3)
    Mc = M[:, :1]  # single-channel mask
    m1 = TransformInvariantNMF(n_atoms=2, atom_shape=(4,), seed=5)
    m1.fit_batch(V, n_iterations=5, mask=Mc)
    m2 = TransformInvariantNMF(n_atoms=2, atom_shape=(4,), seed=5)
    m2.fit_batch(V, n_iterations=5, mask=np.broadcast_to(Mc, V.shape).copy())
    np.testing.assert_allclose(m1.W, m2.W, rtol=1e-12)
    np.testing.assert_allclose(m1.H, m2.H, rtol=1e-12)


@pytest.mark.parametrize('algorithm', [MiniBatchAlgorithm.Cyclic_MU,
                                       MiniBatchAlgorithm.ASG_MU,
                                       MiniBatchAlgorithm.ASAG_MU,
                                       MiniBatchAlgorithm.GSG_MU,
                                       MiniBatchAlgorithm.GSAG_MU])
def test_minibatch_scan_matches_python_loop(algorithm):
    V, M = _data(seed=15, n=7, c=1)  # 7 samples, bs=3 -> ragged final batch
    res = {}
    for use_cb in (False, True):
        m = TransformInvariantNMF(n_atoms=2, atom_shape=(4,), seed=6)
        kw = {'progress_callback': (lambda *_: True)} if use_cb else {}
        m.fit_minibatches(V, algorithm=algorithm, batch_size=3, n_epochs=3,
                          mask=M, **kw)
        res[use_cb] = (m.W, m.H)
    np.testing.assert_allclose(res[True][0], res[False][0], rtol=1e-7)
    np.testing.assert_allclose(res[True][1], res[False][1], rtol=1e-7)


def test_minibatch_energy_trace_masked():
    V, M = _data(seed=16, n=6, c=1)
    m = TransformInvariantNMF(n_atoms=2, atom_shape=(4,), seed=6)
    m.fit_minibatches(V, algorithm=MiniBatchAlgorithm.ASG_MU, batch_size=3,
                      n_epochs=3, mask=M, record_energies=True)
    # the recorded trace is the masked objective
    expected = beta_ops.np_divergence(V, m.inverse_transform(), 2.0, M)
    np.testing.assert_allclose(m.energies_[-1], expected, rtol=1e-6)


def test_mesh_parity_masked():
    from tnmf_tpu.parallel import make_mesh
    V, M = _data(seed=17, n=8, c=1)
    m1 = TransformInvariantNMF(n_atoms=2, atom_shape=(4,), seed=7)
    m1.fit_batch(V, n_iterations=5, mask=M)
    m2 = TransformInvariantNMF(n_atoms=2, atom_shape=(4,), seed=7,
                               mesh=make_mesh())
    m2.fit_batch(V, n_iterations=5, mask=M)
    np.testing.assert_allclose(m1.W, m2.W, rtol=1e-7)
    np.testing.assert_allclose(m1.H, m2.H, rtol=1e-7)


def test_tol_and_groups_compose():
    V, M = _data(seed=18, n=4, c=1)
    m = TransformInvariantNMF(n_atoms=2, atom_shape=(4,), seed=8,
                              transform_type='shift+flip')
    m.fit_batch(V, n_iterations=300, mask=M, tol=1e-3, tol_check_every=5)
    assert m.n_iterations_ < 300
    m2 = TransformInvariantNMF(n_atoms=2, atom_shape=(4,), seed=8,
                               transform_type='shift+flip')
    m2.fit_batch(V, n_iterations=m.n_iterations_, mask=M)
    np.testing.assert_allclose(m.W, m2.W, rtol=1e-9)
    np.testing.assert_allclose(m.H, m2.H, rtol=1e-9)


def test_inpainting_beats_corrupted_fit():
    """The capability: with 40% of the pixels missing (zeroed), a
    mask-aware fit imputes the TRUE values at the missing positions far
    better than a fit that treats the corrupted zeros as real data (which
    actively pulls the reconstruction to zero there)."""
    rng = np.random.default_rng(0)
    pulse = np.array([0.2, 0.8, 1.0, 0.5, 0.1])
    V_true = np.zeros((8, 1, 50))
    for i in range(8):
        for at in rng.integers(0, 45, size=6):
            V_true[i, 0, at:at + 5] += pulse
    M = (rng.random(V_true.shape) > 0.4).astype(np.float64)
    V_corrupt = V_true * M
    miss = M == 0
    errs = {}
    for masked in (True, False):
        m = TransformInvariantNMF(n_atoms=1, atom_shape=(5,), seed=1)
        m.fit_batch(V_corrupt, n_iterations=300, sparsity_H=0.05,
                    mask=M if masked else None)
        R = m.inverse_transform()
        errs[masked] = np.mean((R[miss] - V_true[miss]) ** 2)
    assert errs[True] < 0.65 * errs[False]


def test_serving_with_mask():
    """Masked encoding against a frozen dictionary (inpaint new data)."""
    V, M = _data(seed=19, n=4, c=1)
    m = TransformInvariantNMF(n_atoms=2, atom_shape=(4,), seed=9)
    m.fit_batch(V, n_iterations=10)
    V2, M2 = _data(seed=20, n=2, c=1)
    H = m.transform(V2, n_iterations=5, mask=M2)
    assert H.shape[0] == 2
    assert np.isfinite(m._energy_function())


def test_itakura_saito_masked_domain():
    """beta <= 0 requires positive data only at OBSERVED entries."""
    V, M = _data(seed=21)
    V = V.copy()
    V[M == 0] = 0.0  # zeros allowed where masked out
    m = TransformInvariantNMF(n_atoms=2, atom_shape=(4,), seed=10,
                              beta_loss=0.0)
    m.fit_batch(V, n_iterations=3, mask=M)
    assert np.isfinite(m._energy_function())
    # ... but not at observed ones
    with pytest.raises(ValueError, match='strictly positive'):
        m2 = TransformInvariantNMF(n_atoms=2, atom_shape=(4,), seed=10,
                                   beta_loss=0.0)
        m2.fit_batch(V * 0, n_iterations=1, mask=M)


def test_error_paths():
    V, M = _data(seed=22)
    m = TransformInvariantNMF(n_atoms=2, atom_shape=(4,), seed=11)
    with pytest.raises(ValueError, match='nonnegative'):
        m.fit_batch(V, n_iterations=1, mask=-M)
    with pytest.raises(ValueError, match='same rank'):
        m.fit_batch(V, n_iterations=1, mask=M[0])
    with pytest.raises(ValueError, match='does not broadcast'):
        m.fit_batch(V, n_iterations=1, mask=M[:, :, :-1])
    from tnmf_tpu.parallel import make_mesh
    V8, M8 = _data(seed=23, n=8)
    m2 = TransformInvariantNMF(n_atoms=2, atom_shape=(4,), seed=11,
                               mesh=make_mesh())
    with pytest.raises(ValueError, match='full data shape'):
        m2.fit_batch(V8, n_iterations=1, mask=M8[:, :1])
