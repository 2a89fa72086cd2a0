"""Command-line interface.

Counterpart of the reference's ``tnmf`` console script
(``/root/reference/scripts/tnmf.py``): launches the demo dashboard and runs
the bundled examples — via ``subprocess`` rather than ``os.system``, with a
``--headless`` mode that works without streamlit, plus a ``bench``
subcommand for the performance harness.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from glob import glob

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_DIR = os.path.join(REPO_ROOT, 'demos')
EXAMPLE_DIR = os.path.join(REPO_ROOT, 'examples')

DEMO_NAMES = ['1-D Synthetic Signals', '2-D Synthetic Signals', 'Test Image',
              'Image Inpainting (masked fit)', 'Hyperparameter Sweep (vmapped)']


def list_examples():
    return sorted(
        os.path.splitext(os.path.basename(p))[0]
        for p in glob(os.path.join(EXAMPLE_DIR, '*.py'))
        if not os.path.basename(p).startswith('_'))


def cmd_demo(args) -> int:
    selector = os.path.join(DEMO_DIR, 'demo_selector.py')
    if not os.path.isfile(selector):
        print('demos are shipped with the source tree, not the wheel; '
              'clone the repository to run them.', file=sys.stderr)
        return 1
    if args.headless:
        return subprocess.call([sys.executable, selector, args.name])
    try:
        import streamlit  # noqa: F401
    except ImportError:
        print('streamlit is not installed; run with --headless for a '
              'non-interactive pass using the widget defaults.', file=sys.stderr)
        return 1
    return subprocess.call(
        [sys.executable, '-m', 'streamlit', 'run', selector, '--', args.name])


def cmd_example(args) -> int:
    examples = list_examples()
    if args.name not in examples:
        print(f'unknown example {args.name!r}; available: {", ".join(examples)}',
              file=sys.stderr)
        return 1
    return subprocess.call([sys.executable, os.path.join(EXAMPLE_DIR, args.name + '.py')])


def cmd_export(args) -> int:
    from .models.tnmf import TransformInvariantNMF
    model = TransformInvariantNMF.load(args.checkpoint)
    kwargs = {}
    if args.sample_shape:
        kwargs['sample_shape'] = tuple(args.sample_shape)
    try:
        model.export_serving(
            path=args.output, n_iterations=args.iterations,
            sparsity_H=args.sparsity, include_decoder=args.decoder,
            **kwargs)
    except (RuntimeError, ValueError) as e:
        print(str(e), file=sys.stderr)
        return 1
    print(f'wrote {args.output}')
    return 0


def cmd_bench(args) -> int:
    cmd = [sys.executable, os.path.join(REPO_ROOT, 'bench.py')]
    if args.all:
        cmd.append('--all')
    return subprocess.call(cmd)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog='tnmf-tpu',
        description='Transform-invariant NMF in JAX: demos, examples, benchmarks.')
    sub = parser.add_subparsers(dest='command', required=True)

    p_demo = sub.add_parser('demo', help='launch the interactive demo dashboard')
    p_demo.add_argument('name', nargs='?', default='2-D Synthetic Signals',
                        choices=DEMO_NAMES)
    p_demo.add_argument('--headless', action='store_true',
                        help='run once with widget defaults, no streamlit server')
    p_demo.set_defaults(func=cmd_demo)

    p_ex = sub.add_parser('example', help='run a bundled example script')
    p_ex.add_argument('name', help=f'one of: {", ".join(list_examples())}')
    p_ex.set_defaults(func=cmd_example)

    p_exp = sub.add_parser(
        'export', help='serialize a checkpoint into a serving artifact '
        '(StableHLO; see tnmf_tpu.serving)')
    p_exp.add_argument('checkpoint', help='.npz checkpoint from model.save()')
    p_exp.add_argument('output', help='artifact path to write')
    p_exp.add_argument('--iterations', type=int, default=100,
                       help='default MU refinement count baked in the header')
    p_exp.add_argument('--sparsity', type=float, default=0.,
                       help='sparsity_H strength baked into the program')
    p_exp.add_argument('--decoder', action='store_true',
                       help='also ship inverse_transform (full codec)')
    p_exp.add_argument('--sample-shape', type=int, nargs='+', default=None,
                       help='sample geometry for W-only checkpoints')
    p_exp.set_defaults(func=cmd_export)

    p_bench = sub.add_parser('bench', help='run the benchmark harness')
    p_bench.add_argument('--all', action='store_true',
                         help='measure every BASELINE.md anchor row')
    p_bench.set_defaults(func=cmd_bench)

    args = parser.parse_args(argv)
    # the parent never touches a device itself (only ``export`` computes,
    # in-process); the exported variable gives the spawned example, demo
    # and bench processes the same cache
    from .utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    return args.func(args)


if __name__ == '__main__':
    sys.exit(main())
