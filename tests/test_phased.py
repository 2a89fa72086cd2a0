"""The phase-decomposed conv lowering (tnmf_tpu.ops.phased).

On a GPU the engine upgrades the 'conv' strategy to the phased lowering
for channel-poor problems of rank 1-3 in every reconstruction mode
(engine.resolve_strategy); these tests force the device half of that
policy on and pin the phased operators to the oracle and the phased
end-to-end trajectories to the plain conv strategy, on CPU in float64.
"""

from unittest import mock

import numpy as np
import pytest

from tnmf_tpu import engine
from tnmf_tpu.ops import conv, oracle, phased
from tnmf_tpu.ops.modes import ConvPlan

import jax.numpy as jnp


CASES = [
    ((24, 24), (9, 9), 1, 4),    # divisible, the flagship geometry family
    ((17, 23), (9, 9), 2, 3),    # absorbing padding on both axes
    ((19, 21), (7, 7), 3, 5),    # (a-1) % 4 != 0 -> phase factor 2
    ((16, 14), (5, 9), 1, 2),    # mixed factors
    ((300,), (9,), 2, 3),        # 1-D (long enough for the (64,) blocking)
    ((10, 9, 11), (3, 5, 3), 1, 4),  # 3-D volumetric
]


@pytest.mark.parametrize('mode', ['valid', 'full', 'circular', 'reflect'])
@pytest.mark.parametrize('case', CASES, ids=lambda c: f'{c[0]}x{c[1]}c{c[2]}m{c[3]}')
def test_phased_ops_match_oracle(case, mode):
    S, A, C, M = case
    N = 2
    plan = ConvPlan.create(mode, S, A)
    if not phased.applicable(plan, C, M):
        # e.g. circular with no phase-divisible transform axis
        assert mode == 'circular'
        pytest.skip('geometry not applicable for this mode/shape')
    rng = np.random.default_rng(sum(S) + sum(A))
    V = rng.random((N, C) + S)
    W = rng.random((M, C) + A)
    H = rng.random((N, M) + plan.transform_shape)

    Hph = phased.encode_h(jnp.asarray(H), plan)
    np.testing.assert_array_equal(
        np.asarray(phased.decode_h(Hph, plan, M)), H)

    Vs = phased.prepare_data(jnp.asarray(V), plan)
    R = np.asarray(phased.reconstruct(jnp.asarray(W), Hph, plan))
    np.testing.assert_allclose(R, oracle.reconstruct(W, H, mode),
                               rtol=1e-10, atol=1e-10)

    neg, pos = phased.grad_H_pair(Vs, jnp.asarray(R), jnp.asarray(W), plan)
    on, op = oracle.reconstruction_gradient_H(V, W, H, mode)
    np.testing.assert_allclose(np.asarray(phased.decode_h(neg, plan, M)), on,
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(np.asarray(phased.decode_h(pos, plan, M)), op,
                               rtol=1e-10, atol=1e-10)

    gn, gp = phased.grad_W_pair(Vs, jnp.asarray(R), Hph, plan)
    ogn, ogp = oracle.reconstruction_gradient_W(V, W, H, mode)
    np.testing.assert_allclose(np.asarray(gn), ogn, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(np.asarray(gp), ogp, rtol=1e-10, atol=1e-10)


def test_applicable_gating():
    p_valid = ConvPlan.create('valid', (24, 24), (9, 9))
    assert phased.applicable(p_valid, 1, 16)
    assert not phased.applicable(p_valid, 16, 16)       # channel-rich: plain conv
    # circular applies when the transform axes are phase-divisible ...
    assert phased.applicable(ConvPlan.create('circular', (24, 24), (9, 9)), 1, 16)
    # ... and falls back otherwise (the wrap concat needs r | T)
    assert not phased.applicable(ConvPlan.create('circular', (17, 23), (9, 9)), 1, 16)
    assert phased.applicable(ConvPlan.create('full', (24, 24), (9, 9)), 1, 16)
    # reflect's boundary reversal is block-aligned after the phase
    # permutation q -> (r-q) % r ...
    assert phased.applicable(ConvPlan.create('reflect', (24, 24), (9, 9)), 1, 16)
    # ... but its sources H[1..a-1] must exist canonically (a <= T)
    assert not phased.applicable(ConvPlan.create('reflect', (8, 8), (9, 9)), 1, 16)
    assert not phased.applicable(ConvPlan.create('valid', (24,), (9,)), 1, 16)
    # even atoms on both axes leave no phase structure
    assert not phased.applicable(ConvPlan.create('valid', (24, 24), (8, 8)), 1, 16)


def test_rec_block_channel_adaptive():
    """The reconstruction blocking doubles its minormost block exactly when
    the rec conv would under-fill the 128 vector lanes (C*prod(s) < 128)
    AND the dtype is narrow (bf16; for f32 the doubling measured a net
    loss) — and the doubled blocking reconstructs identically (it is
    purely local to the rec conv; the carried H layout keeps the
    base-``s`` shape)."""
    g2 = phased.geometry(ConvPlan.create('valid', (64, 64), (9, 9)))
    assert g2['s'] == (8, 8)
    assert phased._rec_block(g2, 1, 2) == (8, 16)  # 64 lanes, bf16 -> double
    assert phased._rec_block(g2, 1, 4) == (8, 8)   # f32: keep base
    assert phased._rec_block(g2, 2, 2) == (8, 8)   # 128 lanes already full
    assert phased._rec_block(g2, 3, 2) == (8, 8)
    g1 = phased.geometry(ConvPlan.create('valid', (300,), (9,)))
    assert phased._rec_block(g1, 1, 2) == (128,)   # (64,) -> 128 lanes
    g3 = phased.geometry(ConvPlan.create('valid', (12, 12, 12), (3, 5, 3)))
    assert phased._rec_block(g3, 1, 2) == (4, 4, 8)
    # resource-cap fallback: the 64^3 volume geometry is phased-applicable
    # at the base blocking (BASELINE.md's 24.6x row) but its doubled
    # placement tensor busts the cap — bf16 keeps base instead of
    # kicking the whole config out of the phased strategy
    vplan = ConvPlan.create('valid', (64, 64, 64), (5, 5, 5))
    assert phased.applicable(vplan, 1, 8)
    gv = phased.geometry(vplan)
    assert phased._rec_block(gv, 1, 2, n_atoms=8) == gv['s']
    # numerical equivalence of the doubled rec conv, pinned in float64 on
    # a non-congruent grid (force the doubling — f64 alone would keep the
    # base blocking and the comparison would be vacuous)
    plan = ConvPlan.create('valid', (65, 70), (9, 9))
    rng = np.random.default_rng(0)
    W = jnp.asarray(rng.random((5, 1, 9, 9)))
    H = jnp.asarray(rng.random((2, 5) + plan.transform_shape))
    Hph = phased.encode_h(H, plan)
    orig = phased._rec_block
    try:
        phased._rec_block = lambda g, c, *a, **k: (g['s'][:-1]
                                                   + (2 * g['s'][-1],))
        R_doubled = np.asarray(phased.reconstruct(W, Hph, plan))
        phased._rec_block = lambda g, c, *a, **k: g['s']
        R_base = np.asarray(phased.reconstruct(W, Hph, plan))
    finally:
        phased._rec_block = orig
    np.testing.assert_allclose(R_doubled, R_base, rtol=1e-12, atol=1e-12)


def test_resolve_strategy_platform_gate(monkeypatch):
    plan = ConvPlan.create('valid', (24, 24), (9, 9))
    assert engine.resolve_strategy('conv', plan, 16, 1) == 'conv'  # CPU: off
    monkeypatch.setattr(engine, '_phased_device', lambda: True)
    assert engine.resolve_strategy('conv', plan, 16, 1) == 'phased'
    assert engine.resolve_strategy('fft', plan, 16, 1) == 'fft'
    assert engine.resolve_strategy('conv', plan, 16, 1, allow_phased=False) == 'conv'


@pytest.fixture
def force_phased(monkeypatch):
    monkeypatch.setattr(engine, '_phased_device', lambda: True)


def _fit_pair(fit_kwargs, backend_pair=('jax_conv', 'jax_conv'), V=None,
              n_atoms=4, atom_shape=(5, 9), ctor=()):
    """Fit the same problem with and without the phased upgrade."""
    from tnmf_tpu import TransformInvariantNMF
    if V is None:
        V = np.random.default_rng(5).random((4, 1, 16, 14))
    out = []
    for allow, backend in zip((False, True), backend_pair):
        np.random.seed(42)
        nmf = TransformInvariantNMF(n_atoms=n_atoms, atom_shape=atom_shape,
                                    backend=backend, **dict(ctor))
        # the lowering policy decides at fit time: off for the plain run
        with mock.patch.object(engine, '_phased_device', lambda: allow):
            nmf.fit(V, **fit_kwargs)
        out.append(nmf)
    return out


@pytest.mark.parametrize('kw', [
    dict(n_iterations=5, sparsity_H=0.1),
    dict(n_iterations=5, inhibition_strength=0.2,
         cross_atom_inhibition_strength=0.1),
    dict(n_iterations=5, record_energies=True),
], ids=['sparsity', 'inhibition', 'energies'])
def test_phased_fit_matches_conv(force_phased, kw):
    plain, ph = _fit_pair(kw)
    assert plain._strategy == 'conv' and ph._strategy == 'phased'
    np.testing.assert_allclose(ph.W, plain.W, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ph.H, plain.H, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ph.R, plain.R, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ph.R_partial(1), plain.R_partial(1),
                               rtol=1e-10, atol=1e-12)
    if kw.get('record_energies'):
        np.testing.assert_allclose(ph.energies_, plain.energies_, rtol=1e-10)


@pytest.mark.parametrize('mode', ['full', 'circular', 'reflect'])
def test_phased_fit_matches_conv_modes(force_phased, mode):
    """End-to-end trajectory parity for the non-valid phased modes
    (V 16x14, atoms 5x9: full T=(12,6); circular/reflect T=(16,14),
    r=(4,2))."""
    kw = dict(n_iterations=5, sparsity_H=0.1,
              inhibition_strength=0.2)
    plain, ph = _fit_pair(kw, ctor=(('reconstruction_mode', mode),))
    assert plain._strategy == 'conv' and ph._strategy == 'phased'
    np.testing.assert_allclose(ph.W, plain.W, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ph.H, plain.H, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ph.R, plain.R, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ph.R_partial(1), plain.R_partial(1),
                               rtol=1e-10, atol=1e-12)
    if kw.get('record_energies'):
        np.testing.assert_allclose(ph.energies_, plain.energies_, rtol=1e-10)


def test_minibatch_upgrades_to_phased(force_phased):
    """Policy: minibatch fitting upgrades to the phased lowering like
    fit_batch."""
    from tnmf_tpu import MiniBatchAlgorithm, TransformInvariantNMF
    V = np.random.default_rng(5).random((6, 1, 16, 14))
    np.random.seed(42)
    nmf = TransformInvariantNMF(n_atoms=3, atom_shape=(5, 9), backend='jax_conv')
    nmf.fit_minibatches(V, algorithm=MiniBatchAlgorithm.ASG_MU, batch_size=2,
                        n_epochs=1)
    assert nmf._strategy == 'phased'
    nmf.fit_batch(V, n_iterations=1)
    assert nmf._strategy == 'phased'


def test_phased_minibatch_and_callback_paths(force_phased, monkeypatch):
    """The engine minibatch paths stay phased-capable (encode/decode in the
    scan loop and the per-batch step functions): force the resolver past
    the minibatch policy and pin parity with the conv lowering."""
    from tnmf_tpu import MiniBatchAlgorithm, TransformInvariantNMF
    V = np.random.default_rng(5).random((6, 1, 16, 14))
    orig = engine.resolve_strategy

    def run(phased, algorithm, callback):
        if phased:
            monkeypatch.setattr(
                engine, 'resolve_strategy',
                lambda s, p, c, m, allow_phased=True, **kw: orig(s, p, c, m, True, **kw))
        else:
            monkeypatch.setattr(
                engine, 'resolve_strategy',
                lambda s, p, c, m, allow_phased=True, **kw: s)
        np.random.seed(42)
        nmf = TransformInvariantNMF(n_atoms=3, atom_shape=(5, 9),
                                    backend='jax_conv', seed=0)
        nmf.fit_minibatches(V, algorithm=algorithm, batch_size=2,
                            n_epochs=2, sparsity_H=0.1,
                            progress_callback=callback)
        return nmf

    # scan fast path
    plain = run(False, MiniBatchAlgorithm.ASG_MU, None)
    ph = run(True, MiniBatchAlgorithm.ASG_MU, None)
    assert ph._strategy == 'phased' and plain._strategy == 'conv'
    np.testing.assert_allclose(ph.W, plain.W, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ph.H, plain.H, rtol=1e-10, atol=1e-12)

    # Python per-batch path (callback forces it) exercises
    # update_H_step/update_W_step/grad_W_stats with encode/decode
    plain = run(False, MiniBatchAlgorithm.ASAG_MU, lambda n, e: True)
    ph = run(True, MiniBatchAlgorithm.ASAG_MU, lambda n, e: True)
    np.testing.assert_allclose(ph.W, plain.W, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ph.H, plain.H, rtol=1e-10, atol=1e-12)


def test_phased_sharded_fit(force_phased):
    """Phased lowering under the data-parallel mesh: same trajectory as
    single-device."""
    import jax
    from tnmf_tpu import TransformInvariantNMF
    from tnmf_tpu.parallel import make_mesh
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 virtual devices')
    V = np.random.default_rng(5).random((8, 1, 16, 14))
    np.random.seed(42)
    single = TransformInvariantNMF(n_atoms=3, atom_shape=(5, 9), backend='jax_conv')
    single.fit(V, n_iterations=4, sparsity_H=0.1)
    assert single._strategy == 'phased'
    np.random.seed(42)
    sharded = TransformInvariantNMF(n_atoms=3, atom_shape=(5, 9), backend='jax_conv',
                                    mesh=make_mesh(8))
    sharded.fit(V, n_iterations=4, sparsity_H=0.1)
    assert sharded._strategy == 'phased'
    np.testing.assert_allclose(sharded.W, single.W, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(sharded.H, single.H, rtol=1e-8, atol=1e-10)


def test_phased_random_geometry_fuzz():
    """Seeded random sweep across modes/ranks/shapes: every applicable
    geometry's phased operators must match the f64 oracle; inapplicable
    geometries must be rejected by the gate, never crash."""
    rng = np.random.default_rng(20260817)
    modes = ['valid', 'full', 'circular', 'reflect']
    checked = 0
    for trial in range(40):
        nd = int(rng.integers(1, 4))
        if nd == 1:
            S = (int(rng.integers(256, 400)),)
        else:
            S = tuple(int(rng.integers(8, 30)) for _ in range(nd))
        A = tuple(int(rng.integers(2, min(10, s + 1))) for s in S)
        mode = modes[trial % 4]
        try:
            plan = ConvPlan.create(mode, S, A)
        except ValueError:
            continue  # e.g. full mode with atom > sample
        C, M = int(rng.integers(1, 4)), int(rng.integers(1, 5))
        if not phased.applicable(plan, C, M):
            assert phased.geometry(plan) is None or True  # gate only
            continue
        N = 2
        V = rng.random((N, C) + S)
        W = rng.random((M, C) + A)
        H = rng.random((N, M) + plan.transform_shape)
        Hph = phased.encode_h(jnp.asarray(H), plan)
        Vs = phased.prepare_data(jnp.asarray(V), plan)
        R = np.asarray(phased.reconstruct(jnp.asarray(W), Hph, plan))
        np.testing.assert_allclose(R, oracle.reconstruct(W, H, mode),
                                   rtol=1e-9, atol=1e-9)
        # the narrow-dtype doubled rec blocking, forced in f64 wherever
        # its caps allow: must reconstruct identically
        g = phased.geometry(plan)
        doubled = g['s'][:-1] + (2 * g['s'][-1],)
        if phased._rec_caps_ok(g, doubled, M):
            orig_rb = phased._rec_block
            try:
                phased._rec_block = lambda gg, c, *a, **k: doubled
                R2 = np.asarray(phased.reconstruct(jnp.asarray(W), Hph, plan))
            finally:
                phased._rec_block = orig_rb
            np.testing.assert_allclose(R2, R, rtol=1e-9, atol=1e-9)
        neg, pos = phased.grad_H_pair(Vs, jnp.asarray(R), jnp.asarray(W), plan)
        on, op = oracle.reconstruction_gradient_H(V, W, H, mode)
        np.testing.assert_allclose(np.asarray(phased.decode_h(neg, plan, M)),
                                   on, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(np.asarray(phased.decode_h(pos, plan, M)),
                                   op, rtol=1e-9, atol=1e-9)
        gn, gp = phased.grad_W_pair(Vs, jnp.asarray(R), Hph, plan)
        ogn, ogp = oracle.reconstruction_gradient_W(V, W, H, mode)
        np.testing.assert_allclose(np.asarray(gn), ogn, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(np.asarray(gp), ogp, rtol=1e-9, atol=1e-9)
        checked += 1
    assert checked >= 8  # the sweep must actually exercise the operators


def test_phased_tol_fit_matches_conv(force_phased):
    """tol-based early stopping under the phased lowering: same stopping
    iteration and trajectory as the plain conv strategy (the while_loop
    carries the phase-blocked H; the energy is computed on the decoded
    reconstruction either way)."""
    kw = dict(n_iterations=300, sparsity_H=0.1, tol=1e-3, tol_check_every=5)
    plain, ph = _fit_pair(kw)
    assert plain._strategy == 'conv' and ph._strategy == 'phased'
    assert plain.n_iterations_ is not None and plain.n_iterations_ < 300
    assert ph.n_iterations_ == plain.n_iterations_
    np.testing.assert_allclose(ph.W, plain.W, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ph.H, plain.H, rtol=1e-10, atol=1e-12)


def test_phased_spatial_mesh_replicates():
    """Measured justification of the spatial-mesh gate: the
    phased update step under a spatially sharded layout compiles and is
    numerically correct, but GSPMD cannot propagate the sharding through
    the phase encode (pad + space-to-depth reshape + channels-last
    transpose) and REPLICATES the result — the plain conv step, by
    contrast, stays partitioned via halo exchange.  If this pin ever flips
    (a future GSPMD partitions the phased program), reconsider lifting the
    gate in models/tnmf.py (ops/phased.py docstring)."""
    import jax
    from functools import partial
    if jax.device_count() < 8:
        pytest.skip('needs 8 (virtual) devices')
    from tnmf_tpu.parallel.sharding import make_mesh, shard_model_state

    rng = np.random.default_rng(0)
    sample, atom = (60, 28), (5, 5)
    plan = ConvPlan.create('valid', sample, atom)
    V = rng.random((1, 1) + sample)
    W = rng.random((4, 1) + atom)
    W /= W.sum(axis=(-2, -1), keepdims=True)
    H = rng.random((1, 4) + plan.transform_shape)
    z = jnp.float64(0.0)

    # single-device reference trajectory
    Vp1 = engine.prepare_data(jnp.asarray(V), plan=plan, strategy='phased')
    W1, H1 = engine.update_step(Vp1, jnp.asarray(W), jnp.asarray(H),
                                jnp.float64(0.1), z, z, (),
                                plan=plan, strategy='phased')

    mesh = make_mesh(8)
    Vs, Ws, Hs = shard_model_state(mesh, jnp.asarray(V), jnp.asarray(W),
                                   jnp.asarray(H), axis='spatial')
    shardings = {}
    for strat in ('conv', 'phased'):
        Vp = engine.prepare_data(Vs, plan=plan, strategy=strat)
        fn = jax.jit(partial(engine.update_step, plan=plan, strategy=strat))
        _, Hn = fn(Vp, Ws, Hs, jnp.float64(0.1), z, z, ())
        shardings[strat] = Hn.sharding.spec
        if strat == 'phased':  # correct, just replicated
            np.testing.assert_allclose(np.asarray(Hn), np.asarray(H1),
                                       rtol=1e-10, atol=1e-12)
    # conv stays spatially partitioned; phased collapses to replication
    assert any(s is not None for s in shardings['conv'])
    assert all(s is None for s in shardings['phased'])


# ---------------------------------------------------------------------------
# fused reconstruction -> gradient path (round 5)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('geom', [
    ((16, 16), (9, 9), 1, 3),   # t_pad == t (the flagship congruence)
    ((16, 16), (9, 9), 2, 4),   # multi-channel
    ((320,), (9,), 1, 3),       # 1-D: s=64 congruence, T=328 % 4 == 0
    ((20, 20), (9, 9), 1, 3),   # ragged (t_pad > t) but r | S: slice path
    ((76, 102), (7, 7), 3, 10),  # the 2-D driver fixture geometry
])
def test_fused_rec_grad_pairs_match_plain(geom, mode='valid'):
    """grad_{H,W}_pair_fused (raw s=r rec blocks + border-as-conv-padding)
    reproduce the canonical reconstruct->extend->phase path exactly."""
    S, A, C, M = geom
    plan = ConvPlan.create(mode, S, A, precision='highest')
    if not phased.fused_rec_supported(plan):
        pytest.skip('geometry not fused-supported')
    rng = np.random.default_rng(sum(S))
    V = rng.random((2, C) + S)
    W = rng.random((M, C) + A)
    H = rng.random((2, M) + plan.transform_shape)
    Hph = phased.encode_h(jnp.asarray(H), plan)
    Vs = phased.prepare_data(jnp.asarray(V), plan)
    R = phased.reconstruct(jnp.asarray(W), Hph, plan)

    # the clean raw blocks ARE the phased extended R minus its zero border
    g = phased.geometry(plan)
    Rext = phased._extend_phased(R, plan)
    Rb0 = phased.rec_blocks(jnp.asarray(W), Hph, plan)
    Rb, L, right = phased._clean_blocks(Rb0, plan, g)
    core = Rext[(slice(None),) + tuple(
        slice(l, l + b) for l, b in zip(L, Rb.shape[1:-1])) + (slice(None),)]
    np.testing.assert_allclose(np.asarray(Rb), np.asarray(core),
                               rtol=1e-10, atol=1e-12)
    # and the rest of the extended stream really is zero (the
    # padding-as-extension claim)
    total = np.asarray(Rext).copy()
    total[(slice(None),) + tuple(slice(l, l + b) for l, b in
                                 zip(L, Rb.shape[1:-1]))] = 0.0
    assert np.max(np.abs(total)) == 0.0

    ng, pg = phased.grad_H_pair(Vs, R, jnp.asarray(W), plan)
    nf, pf = phased.grad_H_pair_fused(Vs, jnp.asarray(W), Hph, plan)
    np.testing.assert_allclose(np.asarray(nf), np.asarray(ng),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(pf), np.asarray(pg),
                               rtol=1e-10, atol=1e-12)

    ngw, pgw = phased.grad_W_pair(Vs, R, Hph, plan)
    nfw, pfw = phased.grad_W_pair_fused(Vs, jnp.asarray(W), Hph, plan)
    np.testing.assert_allclose(np.asarray(nfw), np.asarray(ngw),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(pfw), np.asarray(pgw),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize('geom', [
    ((16, 16), (5, 5), 1, 3),    # T=(12,12); t_pad ragged is fine in full
    ((21, 19), (9, 9), 2, 3),    # ragged everything
    ((330,), (9,), 1, 3),        # 1-D
])
def test_fused_rec_grad_pairs_match_plain_full_mode(geom):
    """Mode 'full' is unconditionally fused-exact: the raw overhang reads
    only absorbing H zeros (no slicing needed)."""
    test_fused_rec_grad_pairs_match_plain(geom, mode='full')


def test_fused_rec_gate():
    # ragged t_pad with r | S: the whole-block slice path applies
    assert phased.fused_rec_supported(ConvPlan.create('valid', (20, 20), (9, 9)))
    # r does not divide S and t_pad > t: raw overhang would leak real
    # right-edge activations mid-block -> canonical path
    assert not phased.fused_rec_supported(ConvPlan.create('valid', (21, 21), (9, 9)))
    # mode 'full' is unconditionally supported; circular/reflect are not
    assert phased.fused_rec_supported(ConvPlan.create('full', (16, 16), (9, 9)))
    assert not phased.fused_rec_supported(
        ConvPlan.create('circular', (16, 16), (9, 9)))
    # narrow dtypes keep the lane-filling doubled blocking
    import jax.numpy as _jnp
    assert not phased.fused_rec_supported(
        ConvPlan.create('valid', (16, 16), (9, 9)), _jnp.bfloat16)
