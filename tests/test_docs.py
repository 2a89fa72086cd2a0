"""The documentation tree must actually build (an unbuildable doc tree is
scaffolding).  CI additionally runs real ``sphinx-build -W``
(.github/workflows/docs.yml); this test exercises the hermetic offline
builder, which enforces the same strictness: every automodule target
imports, every listed member exists and is documented, every toctree entry
resolves."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOC = os.path.join(ROOT, 'doc')


def test_doc_build_strict(tmp_path):
    out = subprocess.run(
        [sys.executable, os.path.join(DOC, 'build.py'), str(tmp_path)],
        capture_output=True, text=True,
        env={**os.environ, 'JAX_PLATFORMS': 'cpu'})
    assert out.returncode == 0, out.stderr
    pages = {p for p in os.listdir(tmp_path) if p.endswith('.html')}
    assert {'index.html', 'api.html', 'GeneralIntroduction.html',
            'Architecture.html', 'Scaling.html', 'MigrationGuide.html'} <= pages
    api = open(tmp_path / 'api.html').read()
    # spot-check that the core API actually rendered
    for symbol in ('TransformInvariantNMF', 'MiniBatchAlgorithm', 'fit_batch',
                   'ConvPlan', 'shard_model_state'):
        assert symbol in api, f'{symbol} missing from rendered API docs'
