"""Vmapped-sweep throughput: S models in one graph vs S sequential fits.

Small conv-NMF problems leave the device mostly idle (a lone
reference-scale fit launches kernels far too small to fill it), so
batching S independent models as
a vmap axis should cost far less than S times one fit — that headroom is
the whole point of :func:`tnmf_tpu.models.sweep.sweep_fit`.  This script
measures both sides on the same shapes:

* ``sequential`` — one model fitted alone (engine fit_loop), scaled by S;
  the reference library's only option (a Python loop of ``fit`` calls).
* ``sweep``      — one ``sweep_fit`` call with S models.

Timing uses the two-length subtraction (iters (a, b): (t_b - t_a)/(b - a))
so compile, init and the final energy evaluation drop out of the rate.

    python benchmarks/sweep_scale.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from tnmf_tpu import sweep_fit  # noqa: E402


def _time_sweep(V, n_models, iters, **kw):
    """Seconds per (model x iteration) via the two-length subtraction."""
    def go(n):
        res = sweep_fit(V, 10, (7, 7), n_models=n_models, seed=0,
                        n_iterations=n, sparsity=0.1, **kw)
        return float(np.asarray(res.energies.astype(np.float32)).sum())

    go(2)  # compile + settle
    n1, n2 = iters
    t0 = time.perf_counter()
    go(n1)
    t1 = time.perf_counter()
    go(n2)
    t2 = time.perf_counter()
    per = ((t2 - t1) - (t1 - t0)) / (n2 - n1)
    if per <= 0:  # scheduler noise swamped the subtraction
        per = (t2 - t1) / n2
    return per / n_models


def main():
    rng = np.random.default_rng(0)
    # the reference fixture scale (bench.py continuity): 2 RGB images
    V = rng.random((2, 3, 76, 102)).astype(np.float32)
    iters = (50, 300)

    base = _time_sweep(V, 1, iters)
    print(f'sequential (S=1 fit, the reference pattern): '
          f'{base * 1e3:8.3f} ms/model-iter  {1 / base:8.1f} model-iters/s',
          flush=True)
    for S in (8, 32):
        per = _time_sweep(V, S, iters)
        print(f'sweep S={S:3d}: {per * 1e3:8.3f} ms/model-iter  '
              f'{1 / per:8.1f} model-iters/s  '
              f'({base / per:4.1f}x the sequential rate)', flush=True)

    n_dev = jax.device_count()
    if n_dev > 1:
        from tnmf_tpu.parallel import make_mesh_models
        per = _time_sweep(V, 8 * n_dev, iters, mesh=make_mesh_models())
        print(f'sweep S={8 * n_dev} over mesh({n_dev}): '
              f'{per * 1e3:8.3f} ms/model-iter  {1 / per:8.1f} model-iters/s',
              flush=True)


if __name__ == '__main__':
    from tnmf_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    main()
