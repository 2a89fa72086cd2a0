"""Card check: drive the system's main path on an NVIDIA GPU and check it.

    JAX_PLATFORMS=cuda python chip_smoke.py             # one card
    JAX_PLATFORMS=cuda python chip_smoke.py --chips 4   # data parallelism on four

With one card the phases are

(a) the flagship fit at full width: ``TransformInvariantNMF(n_atoms=16,
    atom_shape=(9, 9))`` on 64 x 1 x 256 x 256 images, mode 'valid',
    through ``fit(record_energies=True)`` in float32 and bfloat16;
(b) operator parity at real widths: ``reconstruct`` and both gradient
    pairs of every strategy the card can select, against the float64
    NumPy oracle (:mod:`tnmf_tpu.ops.oracle`);
(c) an fft-strategy fit at a geometry the chooser sends to fft, and the
    plain-NMF HALS solver at 16384 x 4096 with 256 components;
(d) a serving artifact exported, loaded and run on the card;
(e) the feature checks (strategies, masks, beta losses, transform groups,
    regularizers, minibatch, multiscale, sweeps, tol stopping,
    extrapolation, HALS, checkpoints, memory estimate) at small sizes.

With ``--chips 4`` it runs only the data-parallel fit on a four-card mesh
against the same fit on one card, then every sharded layout of
``__graft_entry__.check_layouts`` on the real cards.

Every phase must pass; any failure raises and the script exits non-zero
before its last line.  The last line of standard output is one JSON object
naming the device.  Without a GPU the script exits non-zero and prints no
result.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

#: relative max-error bounds of the operator parity phase, per precision:
#: 'highest' runs true float32 products; the GPU's default float32
#: precision is TF32 (10-bit mantissa, ~5e-4 per product on these positive
#: sums); bfloat16 storage adds the inputs' and the output's 8-bit rounding
PARITY_BOUNDS = {'highest': 1e-5, 'default': 5e-3, 'bfloat16': 2e-2}


def log(msg):
    print(msg, flush=True)


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _check_energies(e, label):
    e = np.asarray(e, np.float64)
    assert np.all(np.isfinite(e)), (label, e)
    rise = np.diff(e) / np.abs(e[:-1])
    assert np.all(rise <= 1e-4), (label, float(rise.max()))
    return e


def _check_factors(model, atol, label):
    W = np.asarray(model.W, np.float64)
    H = np.asarray(model.H, np.float64)
    assert np.all(np.isfinite(W)) and np.all(np.isfinite(H)), label
    sums = W.sum(axis=tuple(range(2, W.ndim)))
    assert np.all(np.abs(sums - 1.0) <= atol), (label, sums.min(), sums.max())


# ---------------------------------------------------------------------------
# (a) flagship fit
# ---------------------------------------------------------------------------

def flagship_data(n=64, side=256, seed=0):
    return np.random.default_rng(seed).random(
        (n, 1, side, side), dtype=np.float32)


def phase_flagship(n=64, side=256, n_atoms=16, atom=9, iters=50):
    """The flagship fit in float32 and bfloat16.

    Each dtype fits twice from the same seed.  With ``sparsity_H=0`` the
    multiplicative updates descend the reconstruction energy itself, so the
    recorded trace (the fused on-device loop) must not rise.  With
    ``sparsity_H=0.1`` they descend the penalised objective ``energy +
    0.1 * sum(H)``; the energy alone rightly rises while H thins out in the
    first iterations.  That fit reads the objective after every iteration
    through ``progress_callback``, and the objective must not rise."""
    import jax.numpy as jnp
    from tnmf_tpu import TransformInvariantNMF
    V = flagship_data(n, side)
    for dtype, atol in (('float32', 1e-5), ('bfloat16', 1e-2)):
        for sparsity in (0.0, 0.1):
            m = TransformInvariantNMF(n_atoms=n_atoms, atom_shape=(atom, atom),
                                      reconstruction_mode='valid',
                                      dtype=dtype, seed=0)
            objective = []

            def penalised(model, _):
                l1 = jnp.sum(model._H.astype(jnp.float32))
                objective.append(model._energy_function()
                                 + sparsity * float(l1))
                return True

            t0 = time.perf_counter()
            m.fit(V, n_iterations=iters, sparsity_H=sparsity,
                  record_energies=True,
                  progress_callback=penalised if sparsity else None)
            wall = time.perf_counter() - t0
            e = np.asarray(m.energies_, np.float64)
            assert e.shape == (iters,), e.shape
            assert np.all(np.isfinite(e)) and e[-1] < e[0], (dtype, e)
            trace = _check_energies(objective if sparsity else e,
                                    f'{dtype} sparsity_H={sparsity}')
            _check_factors(m, atol, dtype)
            log(f'  {dtype} sparsity_H={sparsity}: strategy={m._strategy} '
                f'wall (host clock, compile included) {wall:.1f} s; '
                f'{"penalised objective" if sparsity else "energy"} every '
                f'10th iteration and the last: '
                f'{[float(x) for x in trace[::10]] + [float(trace[-1])]}')


# ---------------------------------------------------------------------------
# (b) operator parity
# ---------------------------------------------------------------------------

def card_strategies(plan, n_atoms, n_channels):
    """Every strategy the card can select for ``plan``: conv and fft by the
    chooser, and whatever ``resolve_strategy`` upgrades conv to."""
    from tnmf_tpu import engine
    out = ['conv', 'fft']
    up = engine.resolve_strategy('conv', plan, n_atoms, n_channels)
    if up not in out:
        out.append(up)
    return out


def _oracle_ops(V, W, H, mode):
    from tnmf_tpu.ops import oracle
    V, W, H = (np.asarray(x, np.float64) for x in (V, W, H))
    R = oracle.reconstruct(W, H, mode)
    return {'reconstruct': (R,),
            'grad_H_pair': (oracle.corr_H(V, W, mode), oracle.corr_H(R, W, mode)),
            'grad_W_pair': (oracle.corr_W(V, H, mode, W.shape[2:]),
                            oracle.corr_W(R, H, mode, W.shape[2:]))}


def _dot_oracle_ops(V, W, H):
    """The oracle's operators on the plain-NMF geometry (mode 'full', atom
    == sample, one shift): R = H W and its two gradient pairs, as float64
    matmuls (the oracle's per-shift loop would run 65,536 iterations)."""
    V, W, H = (np.asarray(x, np.float64) for x in (V, W, H))
    n, m, c = V.shape[0], W.shape[0], W.shape[1]
    V2, W2, H2 = V.reshape(n, -1), W.reshape(m, -1), H.reshape(n, m)
    R2 = H2 @ W2
    ghs = [(X @ W2.T).reshape(H.shape) for X in (V2, R2)]
    gws = [(H2.T @ X).reshape(W.shape) for X in (V2, R2)]
    return {'reconstruct': (R2.reshape(V.shape),),
            'grad_H_pair': tuple(ghs), 'grad_W_pair': tuple(gws)}


def _engine_ops(strategy, plan, V, W, H, dtype):
    import jax
    import jax.numpy as jnp
    from tnmf_tpu import engine
    ops = engine.get_ops(strategy)
    dt = jnp.dtype(dtype)
    Vd, Wd, Hd = (jnp.asarray(x, dt) for x in (V, W, H))

    @jax.jit
    def run(Vd, Wd, Hd):
        Vp = ops.prepare_data(Vd, plan)
        He = engine._enc_h(Hd, plan, strategy)
        R = ops.reconstruct(Wd, He, plan)
        gh = ops.grad_H_pair(Vp, R, Wd, plan)
        gw = ops.grad_W_pair(Vp, R, He, plan)
        gh = tuple(engine._dec_h(g, plan, strategy, Wd.shape[0]) for g in gh)
        return {'reconstruct': (R,), 'grad_H_pair': gh, 'grad_W_pair': gw}

    return jax.tree.map(np.asarray, run(Vd, Wd, Hd))


def phase_parity(n=8, side=256, n_atoms=16, atom=9, seed=1):
    """Returns {(geometry, strategy, precision): worst relative error}."""
    from tnmf_tpu.ops.modes import ConvPlan
    rng = np.random.default_rng(seed)
    V = flagship_data(n, side, seed)
    W = rng.random((n_atoms, 1, atom, atom), dtype=np.float32)
    W /= W.sum(axis=(2, 3), keepdims=True)
    base = ConvPlan.create('valid', (side, side), (atom, atom))
    H = rng.random((n, n_atoms) + base.transform_shape, dtype=np.float32)
    t0 = time.perf_counter()
    geometries = [('image', 'valid', V, W, H, _oracle_ops(V, W, H, 'valid'))]
    # plain NMF (one shift): the geometry the 'dot' lowering takes
    Wd = rng.random((n_atoms, 1, side, side), dtype=np.float32)
    Hd = rng.random((n, n_atoms, 1, 1), dtype=np.float32)
    geometries.append(('plain-NMF', 'full', V, Wd, Hd,
                       _dot_oracle_ops(V, Wd, Hd)))
    log(f'  float64 oracle: {time.perf_counter() - t0:.1f} s (host)')
    errors = {}
    for geo, mode, Vg, Wg, Hg, want in geometries:
        for prec, dtype in (('highest', 'float32'), ('default', 'float32'),
                            ('bfloat16', 'bfloat16')):
            plan = ConvPlan.create(mode, (side, side), Wg.shape[2:],
                                   precision=None if prec == 'bfloat16'
                                   else prec)
            strategies = card_strategies(plan, n_atoms, 1)
            if geo == 'plain-NMF':
                strategies = [s for s in strategies if s == 'dot']
            for strategy in strategies:
                got = _engine_ops(strategy, plan, Vg, Wg, Hg, dtype)
                worst = max(_rel(g, r) for op in want
                            for g, r in zip(got[op], want[op]))
                errors[(geo, strategy, prec)] = worst
                log(f'  {geo:9s} {strategy:6s} {prec:8s} worst relative '
                    f'max error {worst:.3e} (bound {PARITY_BOUNDS[prec]:.0e})')
    bad = {k: v for k, v in errors.items() if not v < PARITY_BOUNDS[k[2]]}
    assert not bad, bad
    assert any(k[1] == 'dot' for k in errors), 'dot lowering not selected'
    return errors


# ---------------------------------------------------------------------------
# (c) fft strategy and HALS at production size
# ---------------------------------------------------------------------------

def phase_fft_and_hals(n=64, side=256, atom=33, iters=20, hals_n=16384,
                       hals_f=4096, hals_m=256, hals_iters=10):
    from tnmf_tpu import TransformInvariantNMF
    V = flagship_data(n, side, seed=2)
    for dtype, atol in (('float32', 1e-5), ('bfloat16', 1e-2)):
        m = TransformInvariantNMF(n_atoms=16, atom_shape=(atom, atom),
                                  dtype=dtype, seed=0)
        m.fit(V, n_iterations=iters, record_energies=True)
        assert m._strategy == 'fft', m._strategy
        e = _check_energies(m.energies_, f'fft {dtype}')
        _check_factors(m, atol, f'fft {dtype}')
        log(f'  fft {dtype} {side}x{side} atoms {atom}x{atom}: '
            f'energy[0]={e[0]!r} energy[-1]={e[-1]!r}')
    rng = np.random.default_rng(3)
    Vh = rng.random((hals_n, 1, hals_f), dtype=np.float32)
    h = TransformInvariantNMF(n_atoms=hals_m, atom_shape=(hals_f,),
                              reconstruction_mode='full', seed=0)
    h.fit(Vh, n_iterations=hals_iters, solver='hals', record_energies=True)
    e = _check_energies(h.energies_, 'hals')
    assert np.all(np.isfinite(np.asarray(h.W))), 'hals W'
    assert np.all(np.isfinite(np.asarray(h.H))), 'hals H'
    log(f'  HALS {hals_n}x{hals_f}/{hals_m}: energy[0]={e[0]!r} '
        f'energy[-1]={e[-1]!r}')


# ---------------------------------------------------------------------------
# (d) serving
# ---------------------------------------------------------------------------

def phase_serving(n=64, side=256, n_atoms=16, atom=9, n_new=8, iters=10):
    """Export the encoder of a flagship-width model, load it and encode new
    images on the card; it must agree with ``model.transform``.  The model
    starts H from the matched filter (``h_init='correlate'``), as the
    artifact does, so both sides run the same computation."""
    from tnmf_tpu import TransformInvariantNMF, load_serving
    model = TransformInvariantNMF(n_atoms=n_atoms, atom_shape=(atom, atom),
                                  h_init='correlate', seed=0)
    model.fit(flagship_data(n, side), n_iterations=5, sparsity_H=0.1)
    V_new = flagship_data(n_new, side, seed=9)
    srv = load_serving(model.export_serving(
        n_iterations=iters, sparsity_H=0.1, include_decoder=True))
    H = np.asarray(srv(V_new))
    H_ref = np.asarray(model.transform(V_new, n_iterations=iters,
                                       sparsity_H=0.1))
    err = _rel(H, H_ref.astype(np.float64))
    assert err < 1e-6, err
    R = np.asarray(srv.inverse_transform(H))
    assert R.shape == V_new.shape and np.all(np.isfinite(R)), R.shape
    log(f'  artifact vs model.transform on {n_new} new images: relative max '
        f'error {err:.2e}')


# ---------------------------------------------------------------------------
# (e) feature checks at small sizes
# ---------------------------------------------------------------------------

FEATURES = {}


def feature(fn):
    FEATURES[fn.__name__] = fn
    return fn


def _data(n=3, c=1, shape=(20, 18), seed=0):
    return np.random.default_rng(seed).random((n, c) + shape).astype(np.float32)


@feature
def fit_f32_bf16():
    from tnmf_tpu import TransformInvariantNMF
    V = _data()
    out = []
    for dtype in ('float32', 'bfloat16'):
        m = TransformInvariantNMF(n_atoms=4, atom_shape=(5, 5), seed=0,
                                  dtype=dtype)
        m.fit(V, n_iterations=5, sparsity_H=0.1)
        e5 = m._energy_function()
        m.fit(V, n_iterations=25, sparsity_H=0.1)
        e25 = m._energy_function()
        assert np.isfinite(e25) and e25 < e5, (dtype, e5, e25)
        out.append(f'{dtype}:{m._strategy}')
    return ' '.join(out)


@feature
def correlate_init_all_strategies():
    from tnmf_tpu import TransformInvariantNMF
    V = _data()
    for backend, dtype in (('auto', 'float32'), ('jax_conv', 'bfloat16'),
                           ('jax_fft', 'bfloat16')):
        m = TransformInvariantNMF(n_atoms=3, atom_shape=(5, 5), seed=0,
                                  h_init='correlate', backend=backend,
                                  dtype=dtype)
        m.fit(V, n_iterations=3)
        assert np.isfinite(m._energy_function()), (backend, dtype)


@feature
def mask_beta_groups():
    from tnmf_tpu import TransformInvariantNMF
    V = _data() + 0.1
    mask = (np.random.default_rng(2).random(V.shape) > 0.3).astype(np.float32)
    m = TransformInvariantNMF(n_atoms=3, atom_shape=(5, 5), seed=0)
    m.fit(V, n_iterations=5, mask=mask)
    b = TransformInvariantNMF(n_atoms=3, atom_shape=(5, 5), seed=0,
                              beta_loss='kullback-leibler')
    b.fit(V, n_iterations=5)
    g = TransformInvariantNMF(n_atoms=2, atom_shape=(5, 5), seed=0,
                              transform_type='shift+rot90+flip')
    g.fit(V, n_iterations=3)
    assert g.H.shape[2] == 8  # D4 transform maps
    assert np.isfinite(m._energy_function())
    assert np.isfinite(b._energy_function())


@feature
def l2_and_ortho_regularizers():
    from tnmf_tpu import TransformInvariantNMF
    V = _data()
    base = TransformInvariantNMF(n_atoms=3, atom_shape=(5, 5), seed=0)
    base.fit(V, n_iterations=8)
    reg = TransformInvariantNMF(n_atoms=3, atom_shape=(5, 5), seed=0)
    reg.fit(V, n_iterations=8, l2_H=2.0, ortho_W=0.5)
    assert np.linalg.norm(reg.H) < np.linalg.norm(base.H)  # ridge shrinks

    def overlap(W):
        F = np.asarray(W).reshape(W.shape[0], -1)
        G = F @ F.T
        return float(G.sum() - np.trace(G))

    assert overlap(reg.W) < overlap(base.W)  # diversity suppresses overlap
    assert np.isfinite(reg.W).all() and np.isfinite(reg.H).all()


@feature
def minibatch_scan_and_partial_fit():
    from tnmf_tpu import MiniBatchAlgorithm, TransformInvariantNMF
    V = _data(n=8)
    m = TransformInvariantNMF(n_atoms=3, atom_shape=(5, 5), seed=0,
                              init='device')
    m.fit_minibatches(V, algorithm=MiniBatchAlgorithm.ASG_MU, batch_size=4,
                      n_epochs=3, sparsity_H=0.1)
    p = TransformInvariantNMF(n_atoms=3, atom_shape=(5, 5), seed=0)
    for i in range(3):
        p.partial_fit(_data(n=4, seed=i))
    assert np.isfinite(m._energy_function()) and p.n_steps_ == 3


@feature
def multiscale_and_sweep():
    from tnmf_tpu import MultiScaleTNMF, sweep_fit
    V = _data()
    ms = MultiScaleTNMF(n_atoms=(2, 2), atom_shapes=((3, 3), (7, 7)), seed=0,
                        h_init='correlate')
    ms.fit(V, n_iterations=4, sparsity_H=(0.1, 0.0))
    res = sweep_fit(V, 3, (5, 5), n_models=4, seed=0, n_iterations=4,
                    sparsity=np.linspace(0, 0.3, 4, dtype=np.float32))
    assert np.isfinite(ms._energy_function())
    assert np.all(np.isfinite(np.asarray(res.energies)))
    return f'multiscale strategies={"+".join(ms._strategies)}'


@feature
def tol_and_revive():
    from tnmf_tpu import TransformInvariantNMF
    V = _data()
    m = TransformInvariantNMF(n_atoms=3, atom_shape=(5, 5), seed=0)
    m.fit(V, n_iterations=400, tol=1e-3, tol_check_every=5)
    assert m.n_iterations_ <= 400
    r = TransformInvariantNMF(n_atoms=3, atom_shape=(5, 5), seed=0)
    r.fit(V, n_iterations=10, revive_every=5, sparsity_H=0.5)
    assert np.isfinite(r._energy_function())
    return f'tol stopped at {m.n_iterations_}'


@feature
def extrapolated_mu():
    from tnmf_tpu import TransformInvariantNMF
    V = _data()
    x = TransformInvariantNMF(n_atoms=3, atom_shape=(5, 5), seed=0)
    x.fit(V, n_iterations=400, tol=1e-3, tol_check_every=5,
          extrapolate=True, record_energies=True)
    assert x.energies_.shape == (x.n_iterations_,)
    assert np.isfinite(x.energies_).all()
    p = TransformInvariantNMF(n_atoms=3, atom_shape=(5, 5), seed=0)
    p.fit(V, n_iterations=int(x.n_iterations_))
    # no worse than plain MU at the same iteration count
    assert float(x._energy_function()) <= 1.05 * float(p._energy_function())
    return f'stopped at {x.n_iterations_}'


@feature
def hals_solver():
    from tnmf_tpu import TransformInvariantNMF
    rng = np.random.default_rng(0)
    V = (rng.random((16, 4)) @ rng.random((4, 96))
         ).reshape(16, 1, 96).astype(np.float32)

    def model():
        return TransformInvariantNMF(n_atoms=4, atom_shape=(96,),
                                     reconstruction_mode='full', seed=0)

    h = model()
    h.fit(V, n_iterations=25, solver='hals', record_energies=True)
    e = np.asarray(h.energies_, np.float64)
    assert np.isfinite(e).all() and np.all(np.diff(e) <= 1e-6 * e[0])
    m = model()
    m.fit(V, n_iterations=25)  # plain MU from the same seeded start
    assert e[-1] < float(m._energy_function())  # exact steps beat MU here
    t = model()
    # this exact-rank problem still improves by more than 1e-7 per block at
    # 500 float32 iterations; 1e-6 stops near 330
    t.fit(V, n_iterations=500, solver='hals', tol=1e-6, tol_check_every=10)
    assert t.n_iterations_ < 500
    return f'tol stopped at {t.n_iterations_}'


@feature
def hals_conv_solver():
    from tnmf_tpu import TransformInvariantNMF
    V = _data(shape=(24, 24), seed=6)
    kw = dict(n_atoms=4, atom_shape=(5, 5), seed=0,
              reconstruction_mode='full', dtype='float32')
    m = TransformInvariantNMF(**kw)
    m.fit(V, solver='hals', n_iterations=20, record_energies=True)
    es = m.energies_
    assert np.all(np.isfinite(es))
    assert np.all(np.diff(es) <= 1e-4 * es[0])  # monotone to f32 noise
    mu = TransformInvariantNMF(**kw)
    mu.fit(V, n_iterations=20, record_energies=True)
    assert es[-1] < mu.energies_[-1]


@feature
def serving_small():
    from tnmf_tpu import TransformInvariantNMF, load_serving
    V = _data()
    m = TransformInvariantNMF(n_atoms=3, atom_shape=(5, 5), seed=0,
                              h_init='correlate')
    m.fit(V, n_iterations=3)
    srv = load_serving(m.export_serving(n_iterations=4, sparsity_H=0.1,
                                        include_decoder=True))
    V_new = _data(n=2, seed=9)
    H = np.asarray(srv(V_new))
    H_ref = np.asarray(m.transform(V_new, n_iterations=4, sparsity_H=0.1))
    err = _rel(H, H_ref.astype(np.float64))
    assert err < 1e-6, err
    assert np.isfinite(np.asarray(srv.inverse_transform(H))).all()


@feature
def checkpoints():
    """``.npz`` checkpoints round-trip W and H.  (``save_sharded`` needs
    the optional orbax-checkpoint package; the CPU tests cover it.)"""
    from tnmf_tpu import TransformInvariantNMF
    V = _data()
    m = TransformInvariantNMF(n_atoms=3, atom_shape=(5, 5), seed=0)
    m.fit(V, n_iterations=3)
    with tempfile.TemporaryDirectory(dir=os.environ.get('TMPDIR')) as d:
        m.save(os.path.join(d, 'm.npz'), include_H=True)
        r = TransformInvariantNMF.load(os.path.join(d, 'm.npz'))
        np.testing.assert_array_equal(r.W, m.W)
        np.testing.assert_array_equal(r.H, m.H)


@feature
def memory_estimate_exact():
    import jax
    from tnmf_tpu import TransformInvariantNMF, engine
    from tnmf_tpu.utils.memory import estimate_fit_memory
    V = _data()
    m = TransformInvariantNMF(n_atoms=4, atom_shape=(5, 5), seed=0,
                              dtype='float32')
    est = estimate_fit_memory(m, V.shape)
    m.fit(V, n_iterations=2)
    carrier = jax.eval_shape(
        lambda h: engine._enc_h(h, m._plan, m._strategy), m._H)
    assert est.tensors['H (loop carrier)'][2] == int(np.prod(carrier.shape)) * 4
    assert est.tensors['V prepared (loop-invariant)'][2] == m._Vp.nbytes
    return est.strategy


@feature
def phased_fused_rec_grad():
    """The explicit phased lowering's fused reconstruction->gradient path
    against its canonical extend/phase path."""
    import jax.numpy as jnp
    from tnmf_tpu.ops import phased
    from tnmf_tpu.ops.modes import ConvPlan
    worst = 0.0
    for mode, S, A in (('valid', (24, 24), (9, 9)),
                       ('valid', (20, 20), (9, 9)),
                       ('full', (24, 24), (9, 9))):
        plan = ConvPlan.create(mode, S, A, precision='highest')
        assert phased.fused_rec_supported(plan, jnp.float32), (mode, S)
        rng = np.random.default_rng(sum(S))
        V = jnp.asarray(rng.random((2, 1) + S), jnp.float32)
        W = jnp.asarray(rng.random((3, 1) + A), jnp.float32)
        H = jnp.asarray(rng.random((2, 3) + plan.transform_shape), jnp.float32)
        Hph = phased.encode_h(H, plan)
        Vs = phased.prepare_data(V, plan)
        R = phased.reconstruct(W, Hph, plan)
        pairs = (zip(phased.grad_H_pair_fused(Vs, W, Hph, plan),
                     phased.grad_H_pair(Vs, R, W, plan)),
                 zip(phased.grad_W_pair_fused(Vs, W, Hph, plan),
                     phased.grad_W_pair(Vs, R, Hph, plan)))
        for pair in pairs:
            for got, want in pair:
                worst = max(worst, _rel(got, np.asarray(want, np.float64)))
    assert worst < 1e-5, worst
    return f'worst relative error {worst:.2e}'


def phase_features():
    for name, fn in FEATURES.items():
        detail = fn()
        log(f'  {name}: pass' + (f' ({detail})' if detail else ''))


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def phase_data_parallel(n_devices=4, n=256, side=256, n_atoms=16, atom=9,
                        iters=10):
    """The flagship deployment, data-parallel over ``n_devices`` cards,
    against the same fit on one card.  precision='highest' makes every
    product exact in float32, so the two differ only in the order of the
    cross-card sum of the W statistics."""
    from tnmf_tpu import TransformInvariantNMF
    from tnmf_tpu.parallel.sharding import make_mesh
    V = flagship_data(n, side, seed=4)
    fits = {}
    for label, mesh in (('mesh', make_mesh(n_devices)), ('single', None)):
        m = TransformInvariantNMF(n_atoms=n_atoms, atom_shape=(atom, atom),
                                  mesh=mesh, precision='highest', seed=0)
        t0 = time.perf_counter()
        m.fit(V, n_iterations=iters, record_energies=True)
        _check_energies(m.energies_, label)
        fits[label] = (np.asarray(m.W, np.float64), np.asarray(m.H, np.float64),
                       np.asarray(m.energies_, np.float64))
        if mesh is not None:
            assert len(m._H.devices()) == n_devices, m._H.devices()
        log(f'  {label}: strategy={m._strategy} energy[-1]='
            f'{fits[label][2][-1]!r} wall (host clock, compile included) '
            f'{time.perf_counter() - t0:.1f} s')
    errs = [_rel(a, b) for a, b in zip(fits['mesh'], fits['single'])]
    log(f'  mesh vs single card: W {errs[0]:.2e} H {errs[1]:.2e} '
        f'energies {errs[2]:.2e} (bound 1e-4)')
    assert max(errs) < 1e-4, errs


def phase_layouts(n_devices=4):
    sys.path.insert(0, HERE)
    import __graft_entry__
    for label in __graft_entry__.check_layouts(n_devices, precision='highest'):
        log(f'  {label}: sharded step == single-card step')


# ---------------------------------------------------------------------------

def require_gpu(n_chips):
    """The device list, if JAX runs on at least ``n_chips`` GPUs; otherwise
    exit non-zero.  JAX quietly falls back to the CPU when its CUDA plugin
    does not load, so this is checked before anything else runs."""
    import jax
    devices = jax.devices()
    if devices[0].platform != 'gpu' or len(devices) < n_chips:
        sys.exit(f'chip_smoke: needs {n_chips} GPU(s); JAX found '
                 f'{len(devices)} {devices[0].platform!r} device(s)')
    return devices


def card_name():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--chips', type=int, default=1, choices=(1, 4),
                        help='4: run only the four-card data-parallel phases')
    args = parser.parse_args(argv)
    devices = require_gpu(args.chips)
    sys.path.insert(0, HERE)
    from tnmf_tpu.utils.compile_cache import enable_compile_cache
    cache = enable_compile_cache()
    log(f'device: {devices[0].device_kind} x{len(devices)}; '
        f'nvidia-smi: {card_name()}')
    log(f'compile cache: {cache}')
    if args.chips == 4:
        phases = [('data-parallel fit, 4 cards vs 1',
                   lambda: phase_data_parallel(4)),
                  ('sharded layouts on 4 cards', lambda: phase_layouts(4))]
    else:
        phases = [
            ('(a) flagship fit', phase_flagship),
            ('(b) operator parity', phase_parity),
            ('(c) fft strategy and HALS', phase_fft_and_hals),
            ('(d) serving', phase_serving),
            ('(e) feature checks', phase_features),
        ]
    for name, run in phases:
        log(f'phase {name}')
        t0 = time.perf_counter()
        run()
        log(f'phase {name}: pass ({time.perf_counter() - t0:.1f} s host clock)')
    print(json.dumps({'ok': True, 'device': {
        'platform': devices[0].platform, 'kind': devices[0].device_kind,
        'count': len(devices)}}), flush=True)


if __name__ == '__main__':
    main()
