"""Serialized serving artifacts (``tnmf_tpu.serving``; jax.export).

Pinned: the exported artifact reproduces ``model.transform`` exactly
(same compute: matched-filter init + H-only MU loop), the symbolic batch
dimension serves multiple request sizes from one artifact, the iteration
count stays a runtime knob, regularizers/groups/beta losses bake in
correctly, and the file roundtrip + guard rails hold.  No reference
counterpart: the reference can only pickle its Python objects
(SURVEY.md §5 checkpoint/resume — none as files).
"""

import numpy as np
import pytest

from tnmf_tpu import TransformInvariantNMF, export_serving, load_serving
from tnmf_tpu.serving import _MAGIC


def _data(n=3, shape=(12, 10), channels=1, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((n, channels) + shape).astype(np.float32)


def _fitted(mode='valid', **kw):
    m = TransformInvariantNMF(n_atoms=3, atom_shape=(4, 3), seed=0,
                              reconstruction_mode=mode, h_init='correlate',
                              **kw)
    m.fit(_data(), n_iterations=4)
    return m


def test_roundtrip_matches_transform(tmp_path):
    m = _fitted()
    p = str(tmp_path / 'model.tnmfsrv')
    blob = m.export_serving(path=p, n_iterations=6, sparsity_H=0.1)
    assert blob[:8] == _MAGIC
    assert (tmp_path / 'model.tnmfsrv').read_bytes() == blob

    V_new = _data(n=3, seed=7)
    served = load_serving(p)
    H_art = served.transform(V_new)
    H_ref = m.transform(V_new, n_iterations=6, sparsity_H=0.1)
    np.testing.assert_allclose(H_art, H_ref, rtol=1e-6, atol=1e-9)


def test_symbolic_batch_serves_any_size():
    m = _fitted()
    served = load_serving(m.export_serving(n_iterations=3))
    for n in (1, 2, 5):
        V_new = _data(n=n, seed=n)
        np.testing.assert_allclose(
            served(V_new), m.transform(V_new, n_iterations=3),
            rtol=1e-6, atol=1e-9)


def test_runtime_iteration_count():
    m = _fitted()
    served = load_serving(m.export_serving(n_iterations=2))
    V_new = _data(seed=5)
    for n in (1, 8):
        np.testing.assert_allclose(
            served.transform(V_new, n_iterations=n),
            m.transform(V_new, n_iterations=n), rtol=1e-6, atol=1e-9)


def test_fixed_batch_size_and_shape_guard():
    m = _fitted()
    served = load_serving(m.export_serving(batch_size=2, n_iterations=3))
    V2 = _data(n=2, seed=9)
    np.testing.assert_allclose(served(V2), m.transform(V2, n_iterations=3),
                               rtol=1e-6, atol=1e-9)
    with pytest.raises(ValueError, match='shape'):
        served(_data(n=4, seed=9))
    with pytest.raises(ValueError, match='shape'):
        served(_data(n=2, shape=(12, 11), seed=9))


def test_regularizers_and_modes_bake_in():
    m = _fitted(mode='circular', inhibition_range=2)
    kw = dict(sparsity_H=0.05, inhibition_strength=0.4,
              cross_atom_inhibition_strength=0.2)
    served = load_serving(m.export_serving(n_iterations=5, **kw))
    V_new = _data(seed=11)
    np.testing.assert_allclose(served(V_new),
                               m.transform(V_new, n_iterations=5, **kw),
                               rtol=1e-6, atol=1e-9)
    # the baked strengths actually matter (vs the unregularized encode)
    plain = m.transform(V_new, n_iterations=5)
    assert not np.allclose(np.asarray(served(V_new)), plain, rtol=1e-3)


def test_l2_bakes_in():
    """The ridge term rides the serving export exactly like transform's
    ``l2_H`` kwarg (and is recorded in the header)."""
    m = _fitted()
    kw = dict(sparsity_H=0.05, l2_H=2.0)
    art = m.export_serving(n_iterations=5, **kw)
    served = load_serving(art)
    assert served.header['l2_H'] == 2.0
    V_new = _data(seed=13)
    np.testing.assert_allclose(served(V_new),
                               m.transform(V_new, n_iterations=5, **kw),
                               rtol=1e-6, atol=1e-9)
    plain = m.transform(V_new, n_iterations=5, sparsity_H=0.05)
    assert np.linalg.norm(np.asarray(served(V_new))) < np.linalg.norm(plain)


def test_transform_group_layout():
    m = TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3), seed=0,
                              h_init='correlate', transform_type='shift+flip')
    m.fit(_data(), n_iterations=3)
    served = load_serving(m.export_serving(n_iterations=2))
    V_new = _data(n=2, seed=13)
    H = served(V_new)
    assert H.shape[:3] == (2, 2, 4)  # (n, atoms, transforms)
    np.testing.assert_allclose(H, m.transform(V_new, n_iterations=2),
                               rtol=1e-6, atol=1e-9)


def test_beta_divergence_bakes_in():
    m = TransformInvariantNMF(n_atoms=2, atom_shape=(4,), seed=0,
                              h_init='correlate', beta_loss=1.0)
    V = np.abs(_data(shape=(20,))) + 0.1
    m.fit(V, n_iterations=3)
    served = load_serving(m.export_serving(n_iterations=4))
    V_new = np.abs(_data(n=2, shape=(20,), seed=3)) + 0.1
    np.testing.assert_allclose(served(V_new),
                               m.transform(V_new, n_iterations=4),
                               rtol=1e-6, atol=1e-9)


def test_phased_strategy_exports(monkeypatch):
    """The GPU auto-choice (phase-decomposed lowering) must survive export
    with a symbolic batch: its space-to-depth reshapes touch only the
    static spatial axes."""
    from tnmf_tpu import engine
    monkeypatch.setattr(engine, '_phased_device', lambda: True)
    m = TransformInvariantNMF(n_atoms=3, atom_shape=(5, 5), seed=0,
                              h_init='correlate')
    m.fit(_data(shape=(16, 16)), n_iterations=3)
    assert m._strategy == 'phased'
    served = load_serving(m.export_serving(n_iterations=3, sparsity_H=0.1))
    for n in (2, 4):
        V_new = _data(n=n, shape=(16, 16), seed=n)
        np.testing.assert_allclose(
            served(V_new), m.transform(V_new, n_iterations=3, sparsity_H=0.1),
            rtol=1e-6, atol=1e-9)


def test_header_metadata():
    m = _fitted()
    served = load_serving(m.export_serving(n_iterations=7, sparsity_H=0.2))
    h = served.header
    assert h['n_atoms'] == served.n_atoms == 3
    assert h['n_iterations'] == 7
    assert h['sparsity_H'] == 0.2
    assert h['mode'] == 'valid'
    assert h['atom_shape'] == [4, 3]
    assert h['input_shape'] == ['b', 1, 12, 10]
    assert 'cpu' in served.platforms


def test_decoder_section_full_codec(tmp_path):
    """include_decoder=True ships encode AND decode in one file."""
    m = _fitted(mode='circular')
    p = str(tmp_path / 'codec.tnmfsrv')
    m.export_serving(path=p, n_iterations=4, include_decoder=True)
    served = load_serving(p)
    V_new = _data(n=2, seed=17)
    H = served(V_new)
    np.testing.assert_allclose(served.inverse_transform(H),
                               m.inverse_transform(H),
                               rtol=1e-6, atol=1e-9)
    # encoder-only artifacts say so
    plain = load_serving(m.export_serving(n_iterations=2))
    with pytest.raises(RuntimeError, match='decoder'):
        plain.inverse_transform(H)


def test_decoder_with_group_public_layout():
    m = TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3), seed=0,
                              h_init='correlate', transform_type='shift+flip')
    m.fit(_data(), n_iterations=3)
    served = load_serving(m.export_serving(n_iterations=2,
                                           include_decoder=True))
    H = served(_data(n=2, seed=19))          # (n, atoms, transforms, *shift)
    np.testing.assert_allclose(served.inverse_transform(H),
                               m.inverse_transform(H),
                               rtol=1e-6, atol=1e-9)


def test_multi_platform_artifact():
    """One artifact lowered for several platforms: export on the training
    host, serve wherever (cross-lowering needs no GPU present)."""
    m = _fitted()
    served = load_serving(m.export_serving(n_iterations=3,
                                           platforms=('cpu', 'cuda')))
    assert served.platforms == ('cpu', 'cuda')
    V_new = _data(n=2, seed=21)
    np.testing.assert_allclose(served(V_new),
                               m.transform(V_new, n_iterations=3),
                               rtol=1e-6, atol=1e-9)


def test_multiscale_correlate_init_and_export():
    """MultiScaleTNMF h_init='correlate' (per-scale matched filter): the
    serving path becomes deterministic, and the exported artifact matches
    model.transform exactly — per-scale activation tuple, decoder, and
    symbolic batch."""
    from tnmf_tpu import MultiScaleTNMF
    m = MultiScaleTNMF(n_atoms=(2, 2), atom_shapes=((3,), (7,)), seed=0,
                       h_init='correlate')
    V = np.abs(_data(n=3, shape=(24,), seed=0))
    m.fit(V, n_iterations=4, sparsity_H=(0.1, 0.0))
    e0 = m._energy_function()
    m.fit(V, n_iterations=12, sparsity_H=(0.1, 0.0))
    assert m._energy_function() < e0  # more iterations keep descending

    served = load_serving(m.export_serving(n_iterations=3,
                                           sparsity_H=(0.1, 0.0),
                                           include_decoder=True))
    assert served.header['multiscale'] == 2
    for n in (2, 5):
        V_new = _data(n=n, shape=(24,), seed=n)
        H_art = served(V_new)
        H_ref = m.transform(V_new, n_iterations=3, sparsity_H=(0.1, 0.0))
        assert isinstance(H_art, tuple) and len(H_art) == 2
        for a, r in zip(H_art, H_ref):
            np.testing.assert_allclose(a, r, rtol=1e-6, atol=1e-9)
        # decoder = the summed reconstruction of the model's own state
        np.testing.assert_allclose(served.inverse_transform(H_art),
                                   m.inverse_transform(),
                                   rtol=1e-6, atol=1e-9)


def test_multiscale_correlate_determinism():
    from tnmf_tpu import MultiScaleTNMF
    V = _data(n=2, shape=(16, 12), seed=3)
    outs = []
    for _ in range(2):
        m = MultiScaleTNMF(n_atoms=(2,), atom_shapes=((3, 3),), seed=5,
                           h_init='correlate')
        m.fit(V, n_iterations=3)
        outs.append(m.H[0])
    np.testing.assert_array_equal(outs[0], outs[1])
    with pytest.raises(ValueError, match='h_init'):
        MultiScaleTNMF(n_atoms=(2,), atom_shapes=((3, 3),), h_init='bogus')


def test_export_from_w_only_checkpoint(tmp_path):
    """A saved dictionary (no H, hence no restored plan) exports once the
    sample geometry is named — the deployment path from a trained
    artifact store."""
    m = _fitted()
    ckpt = str(tmp_path / 'w_only.npz')
    m.save(ckpt)  # W only
    from tnmf_tpu import TransformInvariantNMF as T
    loaded = T.load(ckpt, h_init='correlate')
    with pytest.raises(RuntimeError, match='sample_shape'):
        loaded.export_serving()
    served = load_serving(loaded.export_serving(sample_shape=(12, 10),
                                                n_iterations=3))
    V_new = _data(n=2, seed=23)
    np.testing.assert_allclose(served(V_new),
                               m.transform(V_new, n_iterations=3),
                               rtol=1e-6, atol=1e-9)


def test_cli_export(tmp_path):
    import os
    import subprocess
    import sys
    m = _fitted()
    ckpt = str(tmp_path / 'model.npz')
    m.save(ckpt, include_H=True)
    out = str(tmp_path / 'enc.tnmfsrv')
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, '-m', 'tnmf_tpu.cli', 'export', ckpt, out,
         '--iterations', '3', '--decoder'],
        capture_output=True, text=True, cwd=repo, env=env, timeout=600)
    assert res.returncode == 0, res.stderr
    served = load_serving(out)
    assert served.header['n_iterations'] == 3
    H = served(_data(n=2, seed=29))
    assert np.isfinite(served.inverse_transform(H)).all()


def test_input_dtype_and_bf16_default():
    m = _fitted()
    served = load_serving(m.export_serving(n_iterations=2,
                                           input_dtype='float64'))
    assert served.header['input_dtype'] == 'float64'
    V = _data(n=2, seed=31).astype(np.float64)
    np.testing.assert_allclose(served(V), m.transform(V, n_iterations=2),
                               rtol=1e-6, atol=1e-9)
    # bf16 + h_init='correlate' + conv strategy: regression for the dtype
    # mismatch inside correlate_init_H's scale reconstruction (the f32
    # gradient met the bf16 kernel; surfaced by this export path)
    for backend in ('jax_conv', 'jax_fft'):
        mb = TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3), seed=0,
                                   h_init='correlate', dtype='bfloat16',
                                   backend=backend)
        mb.fit(_data(), n_iterations=2)
        sb = load_serving(mb.export_serving(n_iterations=2))
        assert sb.header['input_dtype'] == 'float32'  # bf16 host arrays awkward
        assert np.isfinite(sb(_data(n=1, seed=33))).all()


def test_group_with_sample_shape_export():
    m = TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3), seed=0,
                              h_init='correlate', transform_type='shift+flip')
    m.fit(_data(), n_iterations=2)
    served = load_serving(m.export_serving(sample_shape=(12, 10),
                                           n_iterations=2))
    V = _data(n=2, seed=35)
    np.testing.assert_allclose(served(V), m.transform(V, n_iterations=2),
                               rtol=1e-6, atol=1e-9)


def test_multiscale_export_edges():
    from tnmf_tpu import MultiScaleTNMF
    with pytest.raises(RuntimeError, match='fitted'):
        export_serving(MultiScaleTNMF(n_atoms=(2,), atom_shapes=((3,),)))
    V = np.abs(_data(n=2, shape=(20,), seed=0)) + 0.1
    m = MultiScaleTNMF(n_atoms=(2, 2), atom_shapes=((3,), (5,)), seed=0,
                       h_init='correlate', beta_loss=1.0)
    m.fit(V, n_iterations=3)
    with pytest.raises(ValueError, match='inhibition'):
        m.export_serving(inhibition_strength=0.5)
    # scalar sparsity + fixed batch + explicit geometry + beta != 2
    served = load_serving(m.export_serving(
        n_iterations=3, sparsity_H=0.1, batch_size=2, sample_shape=(20,)))
    V_new = np.abs(_data(n=2, shape=(20,), seed=7)) + 0.1
    H_art = served(V_new)
    H_ref = m.transform(V_new, n_iterations=3, sparsity_H=0.1)
    for a, r in zip(H_art, H_ref):
        np.testing.assert_allclose(a, r, rtol=1e-6, atol=1e-9)


def test_guards():
    with pytest.raises(RuntimeError, match='fitted'):
        export_serving(TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3)))
    with pytest.raises(ValueError, match='magic'):
        load_serving(b'not an artifact at all')
    from tnmf_tpu.parallel.sharding import make_mesh
    m = TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3), seed=0,
                              h_init='correlate', mesh=make_mesh(8))
    m.fit(_data(n=8), n_iterations=2)
    with pytest.raises(ValueError, match='single-device'):
        m.export_serving()


def test_warmup_populates_compile_cache():
    m = _fitted()
    served = load_serving(m.export_serving(n_iterations=2))
    assert served.warmup(batch_sizes=(1, 3)) is served
    V = _data(n=3, seed=41)
    np.testing.assert_allclose(served(V), m.transform(V, n_iterations=2),
                               rtol=1e-6, atol=1e-9)


def test_hals_solver_artifact():
    """solver='hals' bakes exact H coordinate sweeps (plain-NMF geometry,
    frozen-dictionary Gram folded into the artifact): matches
    model.transform(solver='hals', hals_inner=1) from the same
    matched-filter init, reaches a lower residual than the MU artifact at
    equal iteration counts, and rejects MU-only configurations."""
    rng = np.random.default_rng(0)
    V = (rng.random((6, 3)) @ rng.random((3, 24))
         ).reshape(6, 1, 24).astype(np.float32)
    m = TransformInvariantNMF(n_atoms=3, atom_shape=(24,), seed=0,
                              reconstruction_mode='full',
                              h_init='correlate')
    m.fit(V, n_iterations=30, solver='hals')
    V_new = (rng.random((4, 3)) @ rng.random((3, 24))
             ).reshape(4, 1, 24).astype(np.float32)

    srv = load_serving(m.export_serving(n_iterations=8, sparsity_H=0.05,
                                        solver='hals'))
    H_art = srv.transform(V_new)
    H_ref = m.transform(V_new, n_iterations=8, solver='hals', hals_inner=1,
                        sparsity_H=0.05)
    np.testing.assert_allclose(H_art, H_ref, rtol=1e-6, atol=1e-9)

    # exact sweeps beat MU refinement at the same artifact iteration count
    srv_mu = load_serving(m.export_serving(n_iterations=8))
    srv_hals = load_serving(m.export_serving(n_iterations=8, solver='hals'))
    W2 = np.asarray(m.W).reshape(3, -1)

    def residual(H):
        R = np.asarray(H).reshape(4, -1) @ W2
        return float(np.sum((V_new.reshape(4, -1) - R) ** 2))

    assert residual(srv_hals.transform(V_new)) < residual(srv_mu.transform(V_new))

    # MU-only configurations are rejected
    with pytest.raises(ValueError, match='MU-only'):
        m.export_serving(solver='hals', inhibition_strength=0.1)
    with pytest.raises(ValueError, match="solver must be"):
        m.export_serving(solver='nope')
    shift = TransformInvariantNMF(n_atoms=2, atom_shape=(4, 3), seed=0)
    shift.fit(_data(), n_iterations=2)
    with pytest.raises(ValueError, match='degenerate'):
        shift.export_serving(solver='hals')


def test_conv_hals_solver_artifact():
    """solver='hals' on the shift-invariant 'full' geometry (round 5)
    bakes exact phase-blocked H sweeps against the frozen dictionary:
    matches model.transform(solver='hals') from the same matched-filter
    init and beats the MU artifact's residual at equal iteration counts."""
    rng = np.random.default_rng(1)
    V = rng.random((4, 1, 20)).astype(np.float32)
    m = TransformInvariantNMF(n_atoms=3, atom_shape=(4,), seed=0,
                              reconstruction_mode='full',
                              h_init='correlate')
    m.fit(V, n_iterations=25, solver='hals')
    V_new = rng.random((3, 1, 20)).astype(np.float32)

    srv = load_serving(m.export_serving(n_iterations=6, sparsity_H=0.02,
                                        solver='hals'))
    H_art = np.asarray(srv.transform(V_new))
    H_ref = m.transform(V_new, n_iterations=6, solver='hals',
                        sparsity_H=0.02)
    np.testing.assert_allclose(H_art, H_ref, rtol=1e-5, atol=1e-7)

    from tnmf_tpu.ops import oracle

    def residual(H):
        R = oracle.reconstruct(np.asarray(m.W, np.float64),
                               np.asarray(H, np.float64), 'full')
        return float(np.sum((V_new - R) ** 2))

    srv_mu = load_serving(m.export_serving(n_iterations=6))
    assert residual(srv.transform(V_new)) < residual(srv_mu.transform(V_new))


def test_artifact_roundtrip_without_flatbuffers_package():
    """Where the installed JAX lacks its optional FlatBuffers runtime the
    artifact still exports and loads (tnmf_tpu._vendor), and encodes like
    the model."""
    import os
    import subprocess
    import sys
    code = '''
import sys
sys.modules['flatbuffers'] = None          # as if it were not installed
import numpy as np
from tnmf_tpu import TransformInvariantNMF, load_serving
V = np.random.default_rng(0).random((3, 1, 12, 10)).astype(np.float32)
m = TransformInvariantNMF(2, (3, 3), h_init='correlate', seed=0)
m.fit(V, n_iterations=2)
srv = load_serving(m.export_serving(n_iterations=3, include_decoder=True))
assert 'tnmf_tpu._vendor' in sys.modules['flatbuffers'].__name__
np.testing.assert_allclose(srv(V), m.transform(V, n_iterations=3),
                           rtol=1e-6)
print('ok')
'''
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, '-c', code], cwd=repo,
                         env=dict(os.environ, JAX_PLATFORMS='cpu'),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith('ok')
