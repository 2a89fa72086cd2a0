"""What the package decides from the device: the lowering policy, the
persistent compile cache, and float32 oracle parity of every strategy."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from tnmf_tpu import engine
from tnmf_tpu.ops import oracle
from tnmf_tpu.ops.modes import ConvPlan

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   'tnmf_tpu')


def _sources():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith('.py'):
                path = os.path.join(d, f)
                with open(path, encoding='utf-8') as fh:
                    yield os.path.relpath(path, PKG), fh.read()


@pytest.mark.parametrize('pattern', [
    r'pallas\.tpu|pallas import tpu',                # Mosaic-TPU kernels
    r"""platform\s*==\s*['"]tpu['"]|['"]tpu['"]\s*==""",  # TPU branches
])
def test_package_has_no_tpu_only_code(pattern):
    hits = [name for name, src in _sources() if re.search(pattern, src)]
    assert not hits, hits


# ---------------------------------------------------------------------------
# compile cache
# ---------------------------------------------------------------------------

def _cache_dir_in_child(env_value):
    """The cache directory a fresh process ends up with after
    enable_compile_cache(), and what the helper returned."""
    env = {k: v for k, v in os.environ.items()
           if k != 'JAX_COMPILATION_CACHE_DIR'}
    if env_value is not None:
        env['JAX_COMPILATION_CACHE_DIR'] = env_value
    code = ('import jax\n'
            'from tnmf_tpu.utils.compile_cache import enable_compile_cache\n'
            'r = enable_compile_cache()\n'
            'print(r)\nprint(jax.config.jax_compilation_cache_dir)\n')
    out = subprocess.run([sys.executable, '-c', code], env=env,
                         cwd=os.path.dirname(PKG), capture_output=True,
                         text=True, check=True)
    return out.stdout.split()


@pytest.mark.parametrize('env_value', [None, 'set'])
def test_compile_cache_placement(env_value, tmp_path):
    if env_value is None:
        returned, active = _cache_dir_in_child(None)
        want = os.path.join(os.path.dirname(PKG), '.jax_cache')
    else:
        want = str(tmp_path / 'cache')
        returned, active = _cache_dir_in_child(want)
    assert returned == want and active == want


def test_compile_cache_dir_is_gitignored():
    with open(os.path.join(os.path.dirname(PKG), '.gitignore')) as f:
        assert '.jax_cache/' in f.read().split()


# ---------------------------------------------------------------------------
# float32 oracle parity per strategy x mode at precision='highest'
# ---------------------------------------------------------------------------

MODES = ('valid', 'full', 'circular', 'reflect')


def _f32_ops(strategy, plan, V, W, H):
    ops = engine.get_ops(strategy)
    f = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    Vd, Wd, Hd = f(V), f(W), f(H)
    Vp = ops.prepare_data(Vd, plan)
    He = engine._enc_h(Hd, plan, strategy)
    R = ops.reconstruct(Wd, He, plan)
    gh = [engine._dec_h(g, plan, strategy, W.shape[0])
          for g in ops.grad_H_pair(Vp, R, Wd, plan)]
    gw = list(ops.grad_W_pair(Vp, R, He, plan))
    return [R] + gh + gw


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('strategy', ['conv', 'fft', 'phased'])
def test_f32_highest_matches_oracle(strategy, mode):
    rng = np.random.default_rng(7)
    S, A = (18, 16), (5, 3)
    plan = ConvPlan.create(mode, S, A, precision='highest')
    V = rng.random((2, 1) + S).astype(np.float32)
    W = rng.random((3, 1) + A).astype(np.float32)
    H = rng.random((2, 3) + plan.transform_shape).astype(np.float32)
    got = _f32_ops(strategy, plan, V, W, H)
    V64, W64, H64 = (x.astype(np.float64) for x in (V, W, H))
    want = ([oracle.reconstruct(W64, H64, mode)]
            + list(oracle.reconstruction_gradient_H(V64, W64, H64, mode))
            + list(oracle.reconstruction_gradient_W(V64, W64, H64, mode)))
    for g, w in zip(got, want):
        g = np.asarray(g, np.float64)
        assert g.dtype == np.float64 and g.shape == w.shape
        assert np.max(np.abs(g - w)) / np.max(np.abs(w)) < 1e-5


def test_f32_highest_dot_matches_oracle():
    rng = np.random.default_rng(8)
    S = (6, 5)
    plan = ConvPlan.create('full', S, S, precision='highest')
    V = rng.random((4, 2) + S).astype(np.float32)
    W = rng.random((3, 2) + S).astype(np.float32)
    H = rng.random((4, 3, 1, 1)).astype(np.float32)
    got = _f32_ops('dot', plan, V, W, H)
    V64, W64, H64 = (x.astype(np.float64) for x in (V, W, H))
    want = ([oracle.reconstruct(W64, H64, 'full')]
            + list(oracle.reconstruction_gradient_H(V64, W64, H64, 'full'))
            + list(oracle.reconstruction_gradient_W(V64, W64, H64, 'full')))
    for g, w in zip(got, want):
        g = np.asarray(g, np.float64).reshape(w.shape)
        assert np.max(np.abs(g - w)) / np.max(np.abs(w)) < 1e-5


# ---------------------------------------------------------------------------
# lowering policy
# ---------------------------------------------------------------------------

# (mode, sample, atom, n_atoms, n_channels) -> auto strategy on a GPU / CPU;
# each phased row was timed on the card (engine._phased_device)
POLICY_GRID = [
    (('valid', (256, 256), (9, 9), 16, 1), 'phased', 'conv'),     # flagship
    (('valid', (64, 64), (15, 15), 16, 1), 'phased', 'fft'),      # phased beats fft
    (('valid', (64, 64), (15, 15), 128, 1), 'phased', 'fft'),     # 128 maps
    (('valid', (256, 256), (15, 15), 16, 1), 'phased', 'conv'),
    (('valid', (128, 128), (33, 33), 16, 1), 'fft', 'fft'),       # large atoms
    (('valid', (64, 64), (9, 9), 16, 16), 'conv', 'conv'),        # channel-rich
    (('valid', (64, 64), (15, 15), 16, 16), 'fft', 'fft'),
    (('valid', (256, 256), (9, 9), 16, 3), 'phased', 'conv'),     # RGB
    (('valid', (16000,), (9,), 16, 1), 'phased', 'conv'),         # 1-D
    (('full', (300,), (9,), 4, 2), 'phased', 'conv'),
    (('valid', (100,), (9,), 4, 1), 'conv', 'conv'),              # 1-D, short
    (('valid', (64, 64, 64), (5, 5, 5), 8, 1), 'phased', 'conv'),  # 3-D
    (('full', (8, 8), (8, 8), 4, 1), 'dot', 'dot'),               # plain NMF
    (('valid', (6, 5, 4, 3), (2, 2, 2, 2), 2, 1), 'fft', 'fft'),  # rank 4
]


def _auto(geometry, **gates):
    mode, sample, atom, n_atoms, n_channels = geometry
    plan = ConvPlan.create(mode, sample, atom)
    return engine.resolve_strategy('auto', plan, n_atoms, n_channels, **gates)


@pytest.mark.parametrize('geometry,on_gpu,on_cpu', POLICY_GRID,
                         ids=lambda x: str(x) if isinstance(x, str) else None)
@pytest.mark.parametrize('platform', ['gpu', 'cpu'])
def test_lowering_policy(monkeypatch, platform, geometry, on_gpu, on_cpu):
    class Dev:
        device_kind = 'fake'
    Dev.platform = platform
    monkeypatch.setattr(engine.jax, 'devices', lambda *a: [Dev()])
    want = on_gpu if platform == 'gpu' else on_cpu
    assert _auto(geometry) == want
    # with phased gated off (spatial meshes) 'auto' keeps the threshold's
    # choice, and explicit requests keep theirs
    assert _auto(geometry, allow_phased=False) == (
        on_cpu if want == 'phased' else want)
    mode, sample, atom, n_atoms, n_channels = geometry
    plan = ConvPlan.create(mode, sample, atom)
    assert engine.resolve_strategy('fft', plan, n_atoms, n_channels) == 'fft'


def test_conv_fft_threshold_follows_the_sweep():
    """conv up to ~128 atom elements at 64^2/128^2 samples, up to 256 at
    256^2 (the H100 sweep in engine.choose_strategy's docstring)."""
    def pick(side, a):
        return engine.choose_strategy(
            ConvPlan.create('valid', (side, side), (a, a)))
    assert [pick(64, a) for a in (9, 11, 13)] == ['conv', 'conv', 'fft']
    assert [pick(128, a) for a in (9, 15, 21)] == ['conv', 'fft', 'fft']
    assert [pick(256, a) for a in (15, 17, 21)] == ['conv', 'fft', 'fft']
