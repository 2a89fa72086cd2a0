"""Demo smoke tests (reference pattern: tnmf/tests/test_demos.py): every demo
runs headless through the streamlit shim in a subprocess."""

import os
import subprocess
import sys

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ENV = dict(
    os.environ,
    MPLBACKEND='Agg',
    JAX_PLATFORMS='cpu',
    TNMF_TPU_SMOKE='1',
)

DEMOS = ['1-D Synthetic Signals', '2-D Synthetic Signals', 'Test Image',
         'Image Inpainting (masked fit)', 'Hyperparameter Sweep (vmapped)']


@pytest.mark.parametrize('name', DEMOS)
def test_demo_headless(name):
    selector = os.path.join(REPO_ROOT, 'demos', 'demo_selector.py')
    res = subprocess.run([sys.executable, selector, name], env=_ENV,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, f'stdout:\n{res.stdout}\nstderr:\n{res.stderr}'


def test_cli_example_listing():
    from tnmf_tpu.cli import list_examples
    names = list_examples()
    assert 'shift_invariant_decomposition' in names
    assert 'convergence_control' in names
    assert 'minibatch_algorithms' in names
    assert 'data_parallel_fit' in names


def test_cli_help():
    res = subprocess.run([sys.executable, '-m', 'tnmf_tpu.cli', '--help'],
                         env=_ENV, capture_output=True, text=True, cwd=REPO_ROOT)
    assert res.returncode == 0
    assert 'demo' in res.stdout and 'example' in res.stdout and 'bench' in res.stdout
