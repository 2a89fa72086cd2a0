"""Property tests: the fast JAX strategies must reproduce the NumPy oracle
bit-for-bit-ish (float64 allclose) for every reconstruction mode and rank.

This is the JAX build's analogue of the reference's cross-backend equivalence
tests (tnmf/tests/test_backends.py) — the oracle plays the anchor role.
"""

import numpy as np
import pytest

from tnmf_tpu.ops import conv, fft, oracle
from tnmf_tpu.ops.modes import ConvPlan, fast_fft_len, transform_shape

CASES = [
    (1, (13,), (4,)),
    (1, (16,), (1,)),
    (2, (9, 11), (3, 4)),
    (2, (8, 8), (8, 8)),       # atom as large as the sample
    (3, (7, 6, 8), (2, 3, 2)),
    (4, (5, 6, 4, 7), (2, 2, 3, 2)),   # rank > 3: fft strategy only
]
MODES = ['valid', 'full', 'circular', 'reflect']
STRATEGIES = {'fft': fft, 'conv': conv}


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('case', CASES, ids=lambda c: f'{c[0]}d-{c[1]}x{c[2]}')
@pytest.mark.parametrize('strategy', list(STRATEGIES))
def test_strategy_matches_oracle(mode, case, strategy):
    ndim, S, A = case
    if strategy == 'conv' and ndim > 3:
        pytest.skip('direct-conv strategy is capped at 3 shift dims (engine routes to fft)')
    if mode == 'full' and any(s < a for s, a in zip(S, A)):
        pytest.skip('atom does not fit sample in full mode')
    if mode == 'reflect' and any(s < a for s, a in zip(S, A)):
        pytest.skip('reflect padding needs sample >= atom')
    rng = np.random.default_rng(ndim * 100 + len(mode))
    N, C, M = 2, 3, 4
    plan = ConvPlan.create(mode, S, A)
    V = rng.random((N, C) + S)
    W = rng.random((M, C) + A)
    H = rng.random((N, M) + plan.transform_shape)

    mod = STRATEGIES[strategy]
    Vp = mod.prepare_data(V, plan)
    R = np.asarray(mod.reconstruct(W, H, plan))
    np.testing.assert_allclose(R, oracle.reconstruct(W, H, mode), rtol=1e-10, atol=1e-10)

    gh = mod.grad_H_pair(Vp, R, W, plan)
    gh0 = oracle.reconstruction_gradient_H(V, W, H, mode)
    for a, b in zip(gh, gh0):
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-10, atol=1e-10)

    gw = mod.grad_W_pair(Vp, R, H, plan)
    gw0 = oracle.reconstruction_gradient_W(V, W, H, mode)
    for a, b in zip(gw, gw0):
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-10, atol=1e-10)


def test_rank4_fit_smoke():
    """A tiny 4-D (e.g. volumetric+time) fit must run end to end: 'auto'
    routes ndim>3 to the fft strategy (engine.choose_strategy), matching the
    reference NumPy backends' arbitrary-rank support
    (/root/reference/tnmf/backends/NumPy_FFT.py:16-40)."""
    from tnmf_tpu import TransformInvariantNMF
    rng = np.random.default_rng(0)
    V = rng.random((2, 1, 5, 6, 4, 7))
    np.random.seed(0)
    nmf = TransformInvariantNMF(n_atoms=2, atom_shape=(2, 2, 3, 2))
    nmf.fit(V, n_iterations=3, record_energies=True)
    assert nmf._strategy == 'fft'
    assert nmf.W.shape == (2, 1, 2, 2, 3, 2)
    assert np.all(np.isfinite(nmf.energies_))
    assert nmf.energies_[-1] <= nmf.energies_[0]
    np.testing.assert_allclose(nmf.W.sum(axis=(-4, -3, -2, -1)), 1.0, rtol=1e-12)


def test_transform_shapes():
    assert transform_shape('valid', (10, 12), (3, 5)) == (12, 16)
    assert transform_shape('full', (10, 12), (3, 5)) == (8, 8)
    assert transform_shape('circular', (10, 12), (3, 5)) == (10, 12)
    assert transform_shape('reflect', (10, 12), (3, 5)) == (10, 12)
    with pytest.raises(ValueError):
        transform_shape('same', (10,), (3,))
    with pytest.raises(ValueError):
        transform_shape('full', (4,), (6,))


def test_fast_fft_len():
    for n in range(1, 300):
        m = fast_fft_len(n)
        assert m >= n
        k = m
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        assert k == 1, f'{m} is not 5-smooth'
    assert fast_fft_len(17, 'pow2') == 32
    assert fast_fft_len(128) == 128


@pytest.mark.parametrize('shape,ranges,axes', [
    ((2, 3, 12, 14), (2, 3), (-2, -1)),    # small path: single-channel conv
    ((4, 4, 40, 40), (2, 3), (-2, -1)),    # fused full-band einsum path
    ((8, 4, 700), (8,), (-1,)),            # blocked band path (long axis)
    ((2, 2, 5, 300, 6), (1, 8, 2), (-3, -2, -1)),  # mixed blocked + fused
], ids=['small-conv', 'full-band', 'blocked', 'mixed'])
def test_inhibition_matches_scipy(shape, ranges, axes):
    """All three dispatch tiers of convolve_multi_1d (small single-channel
    conv, fused full-band einsum, windowed blocked band) must match scipy's
    zero-padded convolve1d."""
    from scipy.ndimage import convolve1d
    from tnmf_tpu.ops.inhibition import convolve_multi_1d, inhibition_kernels
    rng = np.random.default_rng(0)
    H = rng.random(shape)
    kernels = inhibition_kernels(ranges)
    got = np.asarray(convolve_multi_1d(H, kernels, axes))
    want = H
    for ax, k in zip(axes, kernels):
        want = convolve1d(want, k, axis=ax, mode='constant', cval=0.0)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
