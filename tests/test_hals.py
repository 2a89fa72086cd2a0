"""HALS (exact block coordinate descent) solver for the plain-NMF geometry
(``fit(solver='hals')``, :mod:`tnmf_tpu.engine_hals`) — no reference
counterpart (the reference is MU-only, ``TransformInvariantNMF.py:136-179``).

Pinned: trajectory equality with a float64 NumPy Gauss-Seidel oracle,
trajectory equality with sklearn's ``NMF(solver='cd', shuffle=False)`` (the
same algorithm), monotone objective decrease (each component update is the
exact 1-D minimizer), faster convergence than MU from the same start,
regularizer semantics, tol/energies/callback loop dispatch, factor-freeze
flags, dead-component safety (sklearn's ``hess != 0`` skip), bfloat16, and
sample-sharded execution matching single-device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tnmf_tpu import TransformInvariantNMF, engine_hals
from tnmf_tpu.parallel import make_mesh

needs_8_devices = pytest.mark.skipif(
    jax.device_count() < 8, reason='needs 8 (virtual) devices')


def _problem(n=12, c=1, F=30, m=4, seed=0, rank=None):
    """Low-rank nonnegative data (n, c, F) plus its flat (n, c*F) view."""
    rng = np.random.default_rng(seed)
    r = rank or m
    V2 = rng.random((n, r)) @ rng.random((r, c * F))
    return V2.reshape(n, c, F), V2


def _model(m=4, F=30, **kw):
    return TransformInvariantNMF(n_atoms=m, atom_shape=(F,),
                                 reconstruction_mode='full', verbose=0, **kw)


def _fit_pair(V, m, n_iterations, seed=42, **fit_kw):
    """Same seeded init, one HALS fit and the raw (W0, H0) it started from."""
    np.random.seed(seed)
    model = _model(m=m, F=V.shape[-1] * 0 + int(np.prod(V.shape[2:])))
    # capture the exact initial factors by running 0 iterations first
    model.fit(V, n_iterations=0, solver='hals')
    W0, H0 = model.W.copy(), model.H.copy()
    model.fit(V, keep_W=True, keep_H=True, solver='hals',
              n_iterations=n_iterations, **fit_kw)
    return model, W0, H0


@pytest.mark.parametrize('inner', [1, 3])
@pytest.mark.parametrize('regs', [(0.0, 0.0), (0.05, 0.2)])
def test_hals_matches_numpy_oracle(inner, regs):
    """The jitted fused loop reproduces the float64 Gauss-Seidel oracle
    exactly (x64 is enabled in tests)."""
    l1, l2 = regs
    V, V2 = _problem()
    model, W0, H0 = _fit_pair(V, m=4, n_iterations=7, sparsity_H=l1,
                              l2_H=l2, hals_inner=inner)
    W2 = W0.reshape(4, -1).astype(np.float64)
    H2 = H0.reshape(V.shape[0], 4).astype(np.float64)
    for _ in range(7):
        W2, H2 = engine_hals.np_hals_iteration(V2, W2, H2, l1=l1, l2=l2,
                                               inner=inner)
    np.testing.assert_allclose(model.W.reshape(4, -1), W2, rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(model.H.reshape(V.shape[0], 4), H2,
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize('inner', [1, 3])
@pytest.mark.parametrize('regs', [(0.0, 0.0), (0.05, 0.2)])
def test_hals_blocked_matches_numpy_oracle(inner, regs):
    """At n_atoms >= 2 * _BLOCK the engine switches to the delayed-update
    blocked sweeps (cross-block coupling carried by the maintained
    ``C = H @ G`` running product); the update *sequence* is algebraically
    identical to plain Gauss-Seidel, so the float64 oracle trajectory must
    still be reproduced (reassociation-level tolerance)."""
    l1, l2 = regs
    m = 16
    assert m >= 2 * engine_hals._BLOCK and m % engine_hals._BLOCK == 0
    V, V2 = _problem(n=9, F=40, m=m, rank=6)
    model, W0, H0 = _fit_pair(V, m=m, n_iterations=6, sparsity_H=l1,
                              l2_H=l2, hals_inner=inner)
    W2 = W0.reshape(m, -1).astype(np.float64)
    H2 = H0.reshape(V.shape[0], m).astype(np.float64)
    for _ in range(6):
        W2, H2 = engine_hals.np_hals_iteration(V2, W2, H2, l1=l1, l2=l2,
                                               inner=inner)
    np.testing.assert_allclose(model.W.reshape(m, -1), W2, rtol=1e-8,
                               atol=1e-11)
    np.testing.assert_allclose(model.H.reshape(V.shape[0], m), H2,
                               rtol=1e-8, atol=1e-11)


def test_hals_blocked_sweeps_equal_plain():
    """The blocked sweeps ARE the plain sweeps (same sequence of exact
    coordinate minimizers), including multi-sweep reuse of the running
    product and the dead-component guards."""
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    n, m, F = 11, 24, 30
    V2 = rng.random((n, 5)) @ rng.random((5, F))
    W2 = rng.random((m, F))
    W2[5] = 0.0  # dead dictionary row: zero curvature in the H sweep
    H2 = rng.random((n, m))
    H2[:, 9] = 0.0  # unused component: zero curvature in the W sweep
    G, P = W2 @ W2.T, V2 @ W2.T
    A, B = H2.T @ H2, H2.T @ V2
    l1, l2 = jnp.float64(0.03), jnp.float64(0.1)
    for inner in (1, 4):
        Hp = jnp.asarray(H2)
        for _ in range(inner):
            Hp = engine_hals._sweep_H(Hp, jnp.asarray(G), jnp.asarray(P),
                                      l1, l2)
        Hb = engine_hals._sweep_H_blocked(
            jnp.asarray(H2), jnp.asarray(G), jnp.asarray(P), l1, l2, inner)
        np.testing.assert_allclose(np.asarray(Hb), np.asarray(Hp),
                                   rtol=1e-9, atol=1e-12)
        Wp = jnp.asarray(W2)
        for _ in range(inner):
            Wp = engine_hals._sweep_W(Wp, jnp.asarray(A), jnp.asarray(B),
                                      l1, l2)
        Wb = engine_hals._sweep_W_blocked(jnp.asarray(W2), jnp.asarray(A),
                                          jnp.asarray(B), l1, l2, inner)
        np.testing.assert_allclose(np.asarray(Wb), np.asarray(Wp),
                                   rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize('m', [4, 16])  # plain and blocked-size paths
def test_hals_w_regularizers_match_oracle(m):
    """``sparsity_W`` / ``l2_W`` regularize the un-normalized dictionary
    (sklearn's ``alpha_H`` side): L1 shifts the correlation, L2 joins the
    curvature — pinned against the float64 Gauss-Seidel oracle."""
    V, V2 = _problem(n=9, F=40, m=m, rank=4)
    l1, l2, l1w, l2w = 0.02, 0.1, 0.3, 0.5
    model, W0, H0 = _fit_pair(V, m=m, n_iterations=6, sparsity_H=l1,
                              l2_H=l2, sparsity_W=l1w, l2_W=l2w,
                              hals_inner=2)
    W2 = W0.reshape(m, -1).astype(np.float64)
    H2 = H0.reshape(V.shape[0], m).astype(np.float64)
    for _ in range(6):
        W2, H2 = engine_hals.np_hals_iteration(V2, W2, H2, l1=l1, l2=l2,
                                               l1w=l1w, l2w=l2w, inner=2)
    np.testing.assert_allclose(model.W.reshape(m, -1), W2, rtol=1e-8,
                               atol=1e-11)
    np.testing.assert_allclose(model.H.reshape(V.shape[0], m), H2,
                               rtol=1e-8, atol=1e-11)


def test_hals_w_regularizers_match_sklearn_alphas():
    """Full regularized parity with sklearn CD: NMF(alpha_W, alpha_H,
    l1_ratio) maps to this model's raw per-coordinate constants as
    l1 = F*alpha_W*r, l2 = F*alpha_W*(1-r) (H side — sklearn's W) and
    l1w = n*alpha_H*r, l2w = n*alpha_H*(1-r) (dictionary side)."""
    sklearn = pytest.importorskip('sklearn.decomposition')
    n, F, k = 10, 24, 3
    V, V2 = _problem(n=n, F=F, m=k, seed=3)
    aW, aH, r = 0.004, 0.002, 0.6
    model, W0, H0 = _fit_pair(
        V, m=k, n_iterations=6, hals_inner=1,
        sparsity_H=F * aW * r, l2_H=F * aW * (1 - r),
        sparsity_W=n * aH * r, l2_W=n * aH * (1 - r))
    nmf = sklearn.NMF(n_components=k, solver='cd', init='custom', tol=0.0,
                      max_iter=6, shuffle=False, alpha_W=aW, alpha_H=aH,
                      l1_ratio=r)
    Wsk = nmf.fit_transform(V2, W=H0.reshape(n, k).astype(np.float64),
                            H=W0.reshape(k, -1).astype(np.float64))
    np.testing.assert_allclose(model.H.reshape(n, k), Wsk, rtol=1e-7,
                               atol=1e-10)
    np.testing.assert_allclose(model.W.reshape(k, -1), nmf.components_,
                               rtol=1e-7, atol=1e-10)


def test_hals_w_regularizers_mu_rejected():
    V, _ = _problem()
    model = _model()
    for kw in (dict(sparsity_W=0.1), dict(l2_W=0.1)):
        with pytest.raises(ValueError, match='ill-posed'):
            model.fit(V, n_iterations=2, **kw)


def test_hals_matches_sklearn_cd():
    """With inner=1 and no regularization, the update IS sklearn's
    coordinate-descent NMF (shuffle=False): identical factors after the
    same number of outer iterations from the same custom init.  Mapping:
    sklearn ``X = W H`` with W (n, k), H (k, F) — sklearn's W is this
    model's H and vice versa; sklearn updates its W first, as does this
    model (H first)."""
    sklearn = pytest.importorskip('sklearn.decomposition')
    V, V2 = _problem(n=10, F=24, m=3, seed=3)
    model, W0, H0 = _fit_pair(V, m=3, n_iterations=6, hals_inner=1)
    nmf = sklearn.NMF(n_components=3, solver='cd', init='custom', tol=0.0,
                      max_iter=6, shuffle=False)
    Wsk = nmf.fit_transform(V2, W=H0.reshape(10, 3).astype(np.float64),
                            H=W0.reshape(3, -1).astype(np.float64))
    np.testing.assert_allclose(model.H.reshape(10, 3), Wsk, rtol=1e-7,
                               atol=1e-10)
    np.testing.assert_allclose(model.W.reshape(3, -1), nmf.components_,
                               rtol=1e-7, atol=1e-10)


def test_hals_monotone_energy():
    """Each component update is the exact minimizer, so the unregularized
    objective never increases."""
    V, _ = _problem(seed=7, rank=6)
    np.random.seed(0)
    model = _model()
    model.fit(V, n_iterations=40, solver='hals', record_energies=True)
    e = model.energies_
    assert e.shape == (40,)
    assert np.all(np.diff(e) <= 1e-12 * e[0])


def test_hals_regularized_objective_monotone():
    """With L1/L2 on H the *regularized* objective (not the recorded pure
    reconstruction energy) is what each sweep minimizes — verify it
    decreases across a fit."""
    V, V2 = _problem(seed=11)
    l1, l2 = 0.3, 0.5

    def objective(model):
        H2 = model.H.reshape(V.shape[0], -1)
        R = H2 @ model.W.reshape(model.W.shape[0], -1)
        return (0.5 * np.sum((V2 - R) ** 2) + l1 * np.sum(H2)
                + 0.5 * l2 * np.sum(H2 ** 2))

    np.random.seed(1)
    model = _model()
    obj = []
    model.fit(V, n_iterations=15, solver='hals', sparsity_H=l1, l2_H=l2,
              progress_callback=lambda mdl, it: obj.append(objective(mdl))
              or True)
    assert np.all(np.diff(obj) <= 1e-12 * obj[0])


def test_hals_beats_mu_convergence():
    """From the same seeded start, HALS reaches a (much) lower energy than
    MU in the same number of outer iterations — the point of shipping a
    second solver."""
    V, _ = _problem(n=16, F=40, m=5, seed=2, rank=5)
    np.random.seed(42)
    hals = _model(m=5, F=40)
    hals.fit(V, n_iterations=30, solver='hals', record_energies=True)
    np.random.seed(42)
    mu = _model(m=5, F=40)
    mu.fit(V, n_iterations=30, record_energies=True)
    assert hals.energies_[-1] < 0.25 * mu.energies_[-1]
    # extra inner sweeps buy further decrease per outer iteration (the
    # time-based auto picks 1 here; explicit counts remain available)
    np.random.seed(42)
    hals4 = _model(m=5, F=40)
    hals4.fit(V, n_iterations=30, solver='hals', record_energies=True,
              hals_inner=4)
    assert hals4.energies_[-1] < 0.05 * mu.energies_[-1]


def test_hals_tol_early_stop():
    V, _ = _problem(seed=5)
    np.random.seed(0)
    model = _model()
    model.fit(V, n_iterations=500, solver='hals', tol=1e-8,
              tol_check_every=5)
    n_done = model.n_iterations_
    assert n_done < 500
    assert n_done % 5 == 0
    # the adaptive while_loop is deterministic: a plain fused fit of the
    # same length lands on the identical factors
    np.random.seed(0)
    plain = _model()
    plain.fit(V, n_iterations=n_done, solver='hals')
    np.testing.assert_allclose(model.W, plain.W, rtol=1e-12)
    np.testing.assert_allclose(model.H, plain.H, rtol=1e-12)


def test_hals_update_flags():
    V, _ = _problem(seed=9)
    model, W0, H0 = _fit_pair(V, m=4, n_iterations=3, update_W=False)
    np.testing.assert_array_equal(model.W, W0)
    assert not np.allclose(model.H, H0)
    model2, W0b, H0b = _fit_pair(V, m=4, n_iterations=3, update_H=False)
    np.testing.assert_array_equal(model2.H, H0b)
    assert not np.allclose(model2.W, W0b)


def test_hals_dead_component_safe():
    """A zeroed dictionary atom has zero curvature: its H column must be
    skipped (sklearn's ``hess != 0`` rule) — no inf/nan — and the atom
    re-enters through the positive H column (zero is not absorbing)."""
    V, _ = _problem(seed=13, rank=6)
    np.random.seed(3)
    model = _model()
    model.fit(V, n_iterations=0, solver='hals')
    W = model.W.copy()
    W[2] = 0.0
    model._W = jnp.asarray(W)
    model.fit(V, keep_W=True, keep_H=True, n_iterations=10, solver='hals')
    assert np.all(np.isfinite(model.W)) and np.all(np.isfinite(model.H))
    assert model.W[2].sum() > 0  # revived without revive_every


def test_hals_callback_paths_match_fused():
    """Per-iteration callbacks, chunked callbacks and the fused loop all
    produce the same trajectory."""
    V, _ = _problem(seed=4)
    results = []
    for kw in (dict(),
               dict(progress_callback=lambda m, i: True),
               dict(progress_callback=lambda m, i: True,
                    callback_interval=4)):
        np.random.seed(7)
        model = _model()
        model.fit(V, n_iterations=9, solver='hals', **kw)
        results.append((model.W.copy(), model.H.copy()))
    for W, H in results[1:]:
        # the three dispatch paths jit different graphs (update_step vs
        # fit_loop), so XLA may reassociate the unrolled sweep chain at
        # the last ulp — trajectory-tight, not bitwise
        np.testing.assert_allclose(W, results[0][0], rtol=1e-9)
        np.testing.assert_allclose(H, results[0][1], rtol=1e-9)


def test_hals_callback_abort():
    V, _ = _problem(seed=4)
    np.random.seed(7)
    model = _model()
    model.fit(V, n_iterations=50, solver='hals',
              progress_callback=lambda m, i: i < 3)
    assert model.n_iterations_ == 4


def test_hals_bfloat16():
    """bfloat16 storage runs with float32 Gram accumulation and still
    decreases the energy."""
    V, _ = _problem(seed=8, rank=4)  # rank == n_atoms: ~zero residual floor
    np.random.seed(0)
    model = _model(dtype=jnp.bfloat16)
    model.fit(V, n_iterations=25, solver='hals', record_energies=True)
    e = np.asarray(model.energies_, np.float64)
    assert np.isfinite(e).all()
    assert e[-1] < 0.1 * e[0]


def test_hals_auto_inner():
    # FLOP-ratio rule when the sample count is unknown
    assert engine_hals.auto_inner(4, 30) == 4          # 0.5 * 30 / 4
    assert engine_hals.auto_inner(256, 16384) == 8     # clamped high
    assert engine_hals.auto_inner(64, 64) == 1         # clamped low
    assert engine_hals.auto_inner(4, 30, inner=2) == 2
    with pytest.raises(ValueError):
        engine_hals.auto_inner(4, 30, inner=0)


def _fake_device(monkeypatch, kind):
    class Dev:
        platform, device_kind = 'gpu', kind
    monkeypatch.setattr(engine_hals.jax, 'devices', lambda *a: [Dev()])


def test_hals_auto_inner_device_table(monkeypatch):
    # a device outside the table (here: this CPU) falls back to the FLOP
    # rule, which assumes no rate
    assert engine_hals.auto_inner(256, 4096, n_samples=16384) == 8
    _fake_device(monkeypatch, 'unlisted')
    assert engine_hals.auto_inner(256, 4096, n_samples=16384) == 8
    h100 = 'NVIDIA H100 80GB HBM3'
    assert h100 in engine_hals.HALS_COSTS
    _fake_device(monkeypatch, h100)
    # time model: at the latency-bound production scale a sweep pair costs
    # far more than a Gram refresh, so every sweep gets fresh Grams (the
    # FLOP rule would pick 8 here)
    assert engine_hals.auto_inner(256, 4096, n_samples=16384) == 1
    # Gram-bound regime (huge F, small m): extra sweeps are bought
    assert engine_hals.auto_inner(4, 262144, n_samples=65536) == 8
    # without the sample count the FLOP rule applies on any device
    assert engine_hals.auto_inner(4, 30) == 4


def test_hals_rejections():
    V, _ = _problem()
    model = _model()
    for kw in (dict(inhibition_strength=0.1),
               dict(cross_atom_inhibition_strength=0.1),
               dict(ortho_W=0.1),
               dict(mask=np.ones_like(V)),
               dict(extrapolate=True),
               dict(revive_every=5)):
        with pytest.raises(ValueError):
            model.fit(V, n_iterations=2, solver='hals', **kw)
    with pytest.raises(ValueError):
        model.fit(V, n_iterations=2, solver='nope')
    kl = _model(beta_loss=1.0)
    with pytest.raises(ValueError):
        kl.fit(V, n_iterations=2, solver='hals')
    grouped = TransformInvariantNMF(n_atoms=2, atom_shape=(30,),
                                    reconstruction_mode='full',
                                    transform_type='shift+flip', verbose=0)
    with pytest.raises(ValueError):
        grouped.fit(V, n_iterations=2, solver='hals')
    shift = TransformInvariantNMF(n_atoms=2, atom_shape=(5,), verbose=0)
    with pytest.raises(ValueError, match='degenerate'):
        shift.fit(V, n_iterations=2, solver='hals')


def test_hals_checkpoint_resume(tmp_path):
    """checkpoint_every composes with solver='hals' through the chunked
    callback machinery: a crash-resumed fit lands on the exact trajectory
    of the uninterrupted fit."""
    V, _ = _problem(seed=19)
    path = str(tmp_path / 'hals.npz')
    np.random.seed(3)
    full = _model()
    full.fit(V, n_iterations=12, solver='hals')
    np.random.seed(3)
    crashed = _model()
    crashed.fit(V, n_iterations=8, solver='hals', checkpoint_every=4,
                checkpoint_path=path)  # "crashes" after 8 of 12
    resumed = TransformInvariantNMF.load(path)
    assert resumed.last_checkpoint_iteration_ == 8
    resumed.fit(V, n_iterations=4, solver='hals', keep_W=True, keep_H=True)
    np.testing.assert_allclose(resumed.W, full.W, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(resumed.H, full.H, rtol=1e-9, atol=1e-12)


def test_hals_nndsvd_init():
    """sklearn's canonical CD pairing: deterministic NNDSVDA init +
    coordinate descent — composes through the init layer untouched."""
    V, _ = _problem(seed=17, rank=4)
    np.random.seed(0)
    model = TransformInvariantNMF(n_atoms=4, atom_shape=(30,),
                                  reconstruction_mode='full',
                                  w_init='nndsvd', verbose=0)
    model.fit(V, n_iterations=15, solver='hals', record_energies=True)
    e = model.energies_
    assert np.all(np.diff(e) <= 1e-12 * e[0])
    assert e[-1] < 0.05 * e[0]


def test_hals_transform_encoding():
    """``transform(solver='hals')`` composes through the kwargs
    passthrough: frozen-dictionary encoding by exact H coordinate sweeps.
    Chunked encoding is exact (no cross-sample coupling), and the exact
    sweeps reach a lower residual than MU at the same iteration count."""
    V, _ = _problem(n=12, F=30, m=4, seed=21, rank=4)
    np.random.seed(5)
    model = _model()
    model.fit(V, n_iterations=40, solver='hals')
    V_new, _ = _problem(n=8, F=30, m=4, seed=22, rank=4)

    def residual(H):
        R = H.reshape(8, -1) @ model.W.reshape(4, -1)
        return float(np.sum((V_new.reshape(8, -1) - R) ** 2))

    np.random.seed(9)
    H_hals = model.transform(V_new, n_iterations=30, solver='hals')
    np.random.seed(9)
    H_chunked = model.transform(V_new, n_iterations=30, solver='hals',
                                batch_size=3)
    np.testing.assert_allclose(H_chunked, H_hals, rtol=1e-9, atol=1e-12)
    np.random.seed(9)
    H_mu = model.transform(V_new, n_iterations=30)
    assert residual(H_hals) < residual(H_mu)
    assert np.asarray(model.W).sum() > 0  # dictionary untouched


@needs_8_devices
def test_hals_sharded_matches_single():
    """Sample-sharded HALS equals single-device: the Grams are per-sample
    sums (GSPMD all-reduces), the sweep is sample-parallel."""
    V, _ = _problem(n=16, F=24, m=3, seed=6)
    np.random.seed(42)
    single = _model(m=3, F=24)
    single.fit(V, n_iterations=6, solver='hals', sparsity_H=0.01)
    np.random.seed(42)
    sharded = _model(m=3, F=24, mesh=make_mesh(8))
    sharded.fit(V, n_iterations=6, solver='hals', sparsity_H=0.01)
    np.testing.assert_allclose(sharded.W, single.W, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(sharded.H, single.H, rtol=1e-9, atol=1e-12)
    assert len(sharded._H.devices()) == 8


def test_hals_tol_with_trace():
    """tol + record_energies compose under solver='hals' (round 5: HALS
    mirrors the MU driver's composition matrix, engine_hals.fit_loop_tol
    n_buf trace): the recorded trace equals the plain record_energies
    trace over the executed prefix, and the factors match the equivalent
    fixed-length fit exactly."""
    V, _ = _problem(seed=5)
    np.random.seed(0)
    model = _model()
    model.fit(V, n_iterations=500, solver='hals', tol=1e-8,
              tol_check_every=5, record_energies=True)
    n_done = model.n_iterations_
    assert 0 < n_done < 500
    assert model.energies_.shape == (n_done,)
    assert np.all(np.isfinite(model.energies_))
    np.random.seed(0)
    plain = _model()
    plain.fit(V, n_iterations=n_done, solver='hals', record_energies=True)
    np.testing.assert_allclose(model.energies_, plain.energies_, rtol=1e-10)
    np.testing.assert_allclose(model.W, plain.W, rtol=1e-12)
    np.testing.assert_allclose(model.H, plain.H, rtol=1e-12)


def test_hals_tol_trace_zero_iterations():
    V, _ = _problem(seed=5)
    np.random.seed(0)
    model = _model()
    model.fit(V, n_iterations=0, solver='hals', tol=1e-8,
              record_energies=True)
    assert model.n_iterations_ == 0
    assert model.energies_.shape == (0,)
