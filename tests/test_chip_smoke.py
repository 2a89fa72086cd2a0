"""``chip_smoke.py``, the card check, at tiny sizes on the CPU.

Each phase function runs here at a few samples of a few pixels; the script
itself must refuse to run without a GPU and print no result."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _run_script(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    return subprocess.run([sys.executable, 'chip_smoke.py'] + args, cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize('args', [[], ['--chips', '4']])
def test_script_refuses_cpu(args):
    out = _run_script(args, ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert 'needs' in out.stderr


def test_script_alone_fails(tmp_path):
    """In a directory holding only the script there is no package to
    drive: it must fail and print no result."""
    shutil.copy(os.path.join(ROOT, 'chip_smoke.py'), tmp_path)
    out = _run_script([], str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_main_exits_without_gpu(monkeypatch):
    monkeypatch.setattr(chip_smoke, 'phase_flagship',
                        lambda: pytest.fail('ran a phase without a GPU'))
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)


def test_main_last_line_on_fake_gpu(monkeypatch, capsys):
    """With the device check satisfied and every phase stubbed, the last
    line is the JSON object the card check reads."""
    class Dev:
        platform, device_kind = 'gpu', 'NVIDIA H100 80GB HBM3'
    monkeypatch.setattr(chip_smoke, 'require_gpu', lambda n: [Dev()] * n)
    monkeypatch.setattr(chip_smoke, 'card_name', lambda: 'H100, 700.00 W')
    for name in ('phase_flagship', 'phase_parity', 'phase_fft_and_hals',
                 'phase_serving', 'phase_features'):
        monkeypatch.setattr(chip_smoke, name, lambda: None)
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', '/nonexistent/cache')
    chip_smoke.main([])
    lines = capsys.readouterr().out.strip().splitlines()
    assert 'H100, 700.00 W' in lines[0]
    assert json.loads(lines[-1]) == {'ok': True, 'device': {
        'platform': 'gpu', 'kind': 'NVIDIA H100 80GB HBM3', 'count': 1}}


def test_check_energies_rejects_rise():
    chip_smoke._check_energies([3.0, 2.0, 2.0, 1.0], 'flat ok')
    with pytest.raises(AssertionError):
        chip_smoke._check_energies([3.0, 2.0, 2.1], 'rise')
    with pytest.raises(AssertionError):
        chip_smoke._check_energies([3.0, np.nan], 'nan')


def test_card_strategies_cover_chooser_and_upgrade():
    from tnmf_tpu.ops.modes import ConvPlan
    plan = ConvPlan.create('valid', (32, 32), (9, 9))
    assert chip_smoke.card_strategies(plan, 16, 1)[:2] == ['conv', 'fft']
    dot = ConvPlan.create('full', (8, 8), (8, 8))
    assert 'dot' in chip_smoke.card_strategies(dot, 4, 1)


def test_phase_flagship_tiny(capsys):
    chip_smoke.phase_flagship(n=2, side=24, n_atoms=4, atom=5, iters=12)
    out = capsys.readouterr().out
    assert out.count('strategy=') == 4  # 2 dtypes x 2 sparsities


def test_phase_parity_tiny():
    errors = chip_smoke.phase_parity(n=2, side=20, n_atoms=3, atom=5)
    strategies = {k[1] for k in errors}
    assert {'conv', 'fft', 'dot'} <= strategies
    for (geo, strategy, prec), err in errors.items():
        assert err < chip_smoke.PARITY_BOUNDS[prec], (geo, strategy, prec)


def test_dot_oracle_matches_oracle():
    """The matmul stand-in for the oracle on the plain-NMF geometry agrees
    with the per-shift oracle itself."""
    from tnmf_tpu.ops import oracle
    rng = np.random.default_rng(0)
    V = rng.random((3, 2, 4, 5))
    W = rng.random((4, 2, 4, 5))
    H = rng.random((3, 4, 1, 1))
    got = chip_smoke._dot_oracle_ops(V, W, H)
    want = chip_smoke._oracle_ops(V, W, H, 'full')
    for op in want:
        for g, w in zip(got[op], want[op]):
            np.testing.assert_allclose(g, w, rtol=1e-12)
    np.testing.assert_allclose(got['reconstruct'][0],
                               oracle.reconstruct(W, H, 'full'), rtol=1e-12)


def test_phase_fft_and_hals_tiny():
    chip_smoke.phase_fft_and_hals(n=2, side=48, atom=25, iters=5,
                                  hals_n=64, hals_f=32, hals_m=4,
                                  hals_iters=4)


def test_phase_serving_tiny():
    chip_smoke.phase_serving(n=3, side=20, n_atoms=3, atom=5, n_new=2,
                             iters=3)


@pytest.mark.parametrize('name', sorted(chip_smoke.FEATURES))
def test_feature_check(name):
    chip_smoke.FEATURES[name]()


def test_phase_data_parallel_tiny():
    chip_smoke.phase_data_parallel(4, n=8, side=20, n_atoms=3, atom=5,
                                   iters=3)


def test_check_layouts_highest_precision():
    import __graft_entry__
    labels = __graft_entry__.check_layouts(4, precision='highest')
    assert {'data-parallel/conv', 'spatial', 'data x atoms',
            'data x atoms/fft', 'HALS',
            'conv-HALS', 'multiscale/phased', 'sweep models axis'} <= set(labels)
