"""Example-script smoke tests (reference pattern: tnmf/tests/test_examples.py):
every bundled example must run to completion in a subprocess."""

import os
import subprocess
import sys
from glob import glob

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob(os.path.join(REPO_ROOT, 'examples', '*.py')))

_ENV = dict(
    os.environ,
    MPLBACKEND='Agg',
    JAX_PLATFORMS='cpu',
    XLA_FLAGS=os.environ.get('XLA_FLAGS', '') + ' --xla_force_host_platform_device_count=8',
    TNMF_TPU_SMOKE='1',
)


@pytest.mark.parametrize('path', EXAMPLES, ids=[os.path.basename(p) for p in EXAMPLES])
def test_example_runs(path):
    # examples accept an env brake so smoke tests stay fast
    code = (
        'import os, runpy, sys\n'
        f'sys.argv = [{path!r}]\n'
        f'runpy.run_path({path!r}, run_name="__main__")\n'
    )
    res = subprocess.run([sys.executable, '-c', code], env=_ENV,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, f'stdout:\n{res.stdout}\nstderr:\n{res.stderr}'
