"""Device-memory planning (``tnmf_tpu.utils.memory``).

Pinned: the persistent-tensor predictions match the *live* device arrays
of a real fit byte-for-byte across strategies, modes and dtypes (they are
computed with jax.eval_shape on the engine's own operators, so this is a
real invariant, not a heuristic), meshes divide the sample-scaled
tensors, and ``suggest_batch_size`` inverts the estimate against a
budget.
"""

import numpy as np
import pytest

from tnmf_tpu import TransformInvariantNMF
from tnmf_tpu.utils.memory import estimate_fit_memory, suggest_batch_size


def _V(n=4, c=2, shape=(12, 10), seed=0):
    return np.random.default_rng(seed).random((n, c) + shape).astype(np.float32)


def _live_bytes(m):
    return {'V (device copy)': m._Vd.nbytes,
            'V prepared (loop-invariant)': m._Vp.nbytes,
            'H (loop carrier)': m._H.nbytes,
            'W (dictionary)': m._W.nbytes}


@pytest.mark.parametrize('backend,mode', [
    ('jax_conv', 'valid'), ('jax_conv', 'full'),
    ('jax_fft', 'circular'), ('jax_fft', 'reflect'),
])
def test_estimate_matches_live_fit(backend, mode):
    V = _V()
    m = TransformInvariantNMF(n_atoms=3, atom_shape=(4, 3), seed=0,
                              backend=backend, reconstruction_mode=mode,
                              dtype='float32')
    est = estimate_fit_memory(m, V.shape)
    m.fit(V, n_iterations=2)
    for name, live in _live_bytes(m).items():
        shape, dtype, b = est.tensors[name]
        assert b == live, (name, b, live)
    assert est.peak_bytes >= est.persistent_bytes > 0
    assert 'MiB' in str(est)


def test_estimate_matches_phased(monkeypatch):
    from tnmf_tpu import engine
    monkeypatch.setattr(engine, '_phased_device', lambda: True)
    V = _V(c=1, shape=(16, 16))
    m = TransformInvariantNMF(n_atoms=3, atom_shape=(5, 5), seed=0,
                              dtype='float32')
    est = estimate_fit_memory(m, V.shape)
    assert est.strategy == 'phased'
    m.fit(V, n_iterations=2)
    for name, live in _live_bytes(m).items():
        assert est.tensors[name][2] == live, name


def test_estimate_matches_dot_and_group():
    V = _V(c=1, shape=(8,))
    dot = TransformInvariantNMF(n_atoms=3, atom_shape=(8,), seed=0,
                                reconstruction_mode='full', dtype='float32')
    est = estimate_fit_memory(dot, V.shape)
    assert est.strategy == 'dot'
    dot.fit(V, n_iterations=2)
    for name, live in _live_bytes(dot).items():
        assert est.tensors[name][2] == live, name

    grp = TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3), seed=0,
                                transform_type='shift+flip', dtype='float32')
    V2 = _V()
    est2 = estimate_fit_memory(grp, V2.shape)
    grp.fit(V2, n_iterations=2)
    for name, live in _live_bytes(grp).items():
        assert est2.tensors[name][2] == live, name


def test_bfloat16_halves_the_carrier():
    m32 = TransformInvariantNMF(n_atoms=3, atom_shape=(4, 3), dtype='float32')
    m16 = TransformInvariantNMF(n_atoms=3, atom_shape=(4, 3), dtype='bfloat16')
    shape = (8, 1, 32, 32)
    h32 = estimate_fit_memory(m32, shape).tensors['H (loop carrier)'][2]
    h16 = estimate_fit_memory(m16, shape).tensors['H (loop carrier)'][2]
    assert h16 * 2 == h32


def test_mesh_divides_sample_scaled_tensors():
    from tnmf_tpu.parallel.sharding import make_mesh
    single = TransformInvariantNMF(n_atoms=3, atom_shape=(4, 3), dtype='float32')
    sharded = TransformInvariantNMF(n_atoms=3, atom_shape=(4, 3),
                                    dtype='float32', mesh=make_mesh(8))
    shape = (16, 1, 24, 24)
    e1, e8 = estimate_fit_memory(single, shape), estimate_fit_memory(sharded, shape)
    assert e8.tensors['H (loop carrier)'][2] * 8 == e1.tensors['H (loop carrier)'][2]
    assert e8.tensors['W (dictionary)'][2] == e1.tensors['W (dictionary)'][2]  # replicated


def test_suggest_batch_size_inverts_the_estimate():
    m = TransformInvariantNMF(n_atoms=4, atom_shape=(5, 5), dtype='float32')
    budget = 64 * 2 ** 20
    n = suggest_batch_size(m, (32, 32), n_channels=1,
                           budget_bytes=budget, safety=1.0)
    assert n >= 1
    assert estimate_fit_memory(m, (n, 1, 32, 32)).peak_bytes <= budget
    assert estimate_fit_memory(m, (n + 1, 1, 32, 32)).peak_bytes > budget
    assert suggest_batch_size(m, (4096, 4096), n_channels=1,
                              budget_bytes=budget, safety=1.0) == 0


def test_guards():
    m = TransformInvariantNMF(n_atoms=3, atom_shape=(4, 3))
    with pytest.raises(ValueError, match='V_shape'):
        estimate_fit_memory(m, (4, 8))


def test_budget_from_runtime_memory_stats(monkeypatch):
    import jax

    m = TransformInvariantNMF(n_atoms=3, atom_shape=(4, 3), dtype='float32')

    class FakeDev:
        def memory_stats(self):
            return {'bytes_limit': 64 * 2 ** 20}

    monkeypatch.setattr(jax, 'local_devices', lambda: [FakeDev()])
    n = suggest_batch_size(m, (32, 32), n_channels=1, safety=1.0)
    assert estimate_fit_memory(m, (n, 1, 32, 32)).peak_bytes <= 64 * 2 ** 20

    class NoStatsDev:
        def memory_stats(self):
            return None

    monkeypatch.setattr(jax, 'local_devices', lambda: [NoStatsDev()])
    with pytest.raises(ValueError, match='memory limit'):
        suggest_batch_size(m, (32, 32))


def test_multiscale_estimate_matches_live_fit():
    from tnmf_tpu import MultiScaleTNMF
    m = MultiScaleTNMF(n_atoms=(2, 3), atom_shapes=((3, 3), (5, 5)),
                       seed=0, dtype='float32')
    V = _V(n=3, c=1, shape=(14, 12))
    est = estimate_fit_memory(m, V.shape)
    m.fit(V, n_iterations=2)
    assert est.tensors['V (device copy)'][2] == m._Vd.nbytes
    import jax
    from tnmf_tpu import engine
    for k in range(2):
        assert est.tensors[f'V prepared, scale {k}'][2] == m._Vps[k].nbytes
        # the carrier row reports the strategy-encoded (possibly
        # phase-blocked) H the kernels actually loop over
        carrier = jax.eval_shape(
            lambda h: engine._enc_h(h, m._plans[k], m._strategies[k]),
            m._Hs[k])
        assert est.tensors[f'H, scale {k} (loop carrier)'][0] == carrier.shape
        assert est.tensors[f'W, scale {k}'][2] == m._Ws[k].nbytes
    assert est.peak_bytes > est.persistent_bytes
    n = suggest_batch_size(m, (14, 12), n_channels=1,
                           budget_bytes=8 * 2 ** 20, safety=1.0)
    assert estimate_fit_memory(m, (n, 1, 14, 12)).peak_bytes <= 8 * 2 ** 20


def test_hals_estimates():
    """solver='hals' accounting: the degenerate engine's flat views and
    the shift-invariant engine's padded residual + phase-major carrier
    match the real loop-state shapes."""
    from tnmf_tpu import engine_hals_conv as ehc
    from tnmf_tpu.ops.modes import ConvPlan
    from tnmf_tpu.utils.memory import estimate_fit_memory
    import jax.numpy as jnp

    flat = TransformInvariantNMF(n_atoms=3, atom_shape=(24,),
                                 reconstruction_mode='full')
    e = estimate_fit_memory(flat, (6, 1, 24), solver='hals')
    assert e.strategy == 'hals'
    assert e.tensors['H (n, m)'][0] == (6, 3)
    assert e.tensors['W (m, F)'][0] == (3, 24)

    conv = TransformInvariantNMF(n_atoms=3, atom_shape=(4,),
                                 reconstruction_mode='full')
    e = estimate_fit_memory(conv, (6, 1, 20), solver='hals')
    assert e.strategy == 'hals-conv'
    plan = ConvPlan.create('full', (20,), (4,))
    E_pad, H_pm = ehc._encode(jnp.zeros((6, 1, 20)), jnp.zeros((3, 1, 4)),
                              jnp.zeros((6, 3) + plan.transform_shape), plan)
    assert e.tensors['E residual (padded carrier)'][0] == E_pad.shape
    assert e.tensors['H (phase-major carrier)'][0] == H_pm.shape

    with pytest.raises(ValueError, match='mu.*hals|hals'):
        estimate_fit_memory(flat, (6, 1, 24), solver='nope')
    shift = TransformInvariantNMF(n_atoms=2, atom_shape=(3,))
    with pytest.raises(ValueError, match="reconstruction_mode='full'"):
        estimate_fit_memory(shift, (6, 1, 20), solver='hals')
