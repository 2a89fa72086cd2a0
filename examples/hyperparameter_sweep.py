"""Hyperparameter sweeps as one compiled graph (``tnmf_tpu.sweep_fit``).

Dictionary learning is init- and regularization-sensitive, so real use
means many restarts and strength grids.  With the reference library that
is a Python loop of sequential ``fit`` calls
(``tnmf/TransformInvariantNMF.py:282``); here the model axis is a
``jax.vmap`` batch dimension — S inits, S fit loops and S objectives run
as one XLA program that keeps the device busy, and with a mesh the sweep
shards across devices with zero collectives.

The script fits a seed x sparsity grid on synthetic pulse-train patches,
reports the per-model objectives and the winner, and cross-checks one
sweep entry against a standalone fit.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from tnmf_tpu import sweep_fit  # noqa: E402
from tnmf_tpu.parallel import make_mesh_models  # noqa: E402


def main():
    smoke = bool(os.environ.get('TNMF_TPU_SMOKE'))
    n_iterations = 8 if smoke else 100

    rng = np.random.default_rng(3)
    V = rng.random((8, 1, 24, 24)).astype(np.float32) ** 2

    # a 2 x 4 grid: 2 restarts x 4 sparsity strengths, flattened to vectors
    sparsities = np.array([0.0, 0.05, 0.2, 0.8], np.float32)
    n_restarts = 2
    sp = np.tile(sparsities, n_restarts)
    seeds = np.repeat(np.arange(n_restarts, dtype=np.uint32), len(sparsities))
    n_models = len(sp)

    t0 = time.perf_counter()
    res = sweep_fit(V, 5, (5, 5), seed=seeds, n_iterations=n_iterations,
                    sparsity=sp, record_energies=True)
    res.W.block_until_ready()
    dt = time.perf_counter() - t0
    print(f'{n_models} models x {n_iterations} iterations in {dt:.2f} s '
          f'(one compiled graph, {jax.devices()[0].platform})')
    tr = np.asarray(res.energy_traces)
    print(f'convergence: model 0 objective {tr[0, 0]:.2f} -> {tr[0, -1]:.2f} '
          f'over {tr.shape[1]} iterations (traces recorded per model)')

    l1 = np.sum(np.abs(np.asarray(res.H)), axis=tuple(range(1, res.H.ndim)))
    print(f'{"seed":>4} {"sparsity":>9} {"energy":>12} {"|H|_1":>12}')
    for s in range(n_models):
        print(f'{int(seeds[s]):>4} {sp[s]:>9.2f} '
              f'{float(res.energies[s]):>12.4f} {l1[s]:>12.1f}')
    print(f'best model: #{res.best} '
          f'(seed {int(seeds[res.best])}, sparsity {sp[res.best]:.2f})')

    # any regularizer grids the same way: here a dictionary-diversity
    # (ortho) grid — higher strengths push atoms apart (lower cross-atom
    # overlap), at some reconstruction cost
    orthos = np.array([0.0, 0.5, 2.0, 8.0], np.float32)
    # identical per-model seeds: every lane starts from the same init, so
    # the grid isolates the strength's effect
    res_o = sweep_fit(V, 5, (5, 5), seed=np.zeros(len(orthos), np.uint32),
                      n_iterations=n_iterations, ortho=orthos)
    Wo = np.asarray(res_o.W).reshape(len(orthos), 5, -1)
    gram = np.einsum('smk,snk->smn', Wo, Wo)
    ov = gram.sum(axis=(1, 2)) - np.trace(gram, axis1=1, axis2=2)
    print(f'{"ortho":>6} {"energy":>12} {"atom overlap":>13}')
    for s, o in enumerate(orthos):
        print(f'{o:>6.1f} {float(res_o.energies[s]):>12.4f} {ov[s]:>13.4f}')

    # per-model early stopping: converged models freeze, the sweep's one
    # while_loop exits when all are done (or at n_iterations)
    res_tol = sweep_fit(V, 5, (5, 5), seed=seeds, n_iterations=n_iterations,
                        sparsity=sp, tol=1e-3, tol_check_every=5)
    print('tol=1e-3 per-model stop iterations:',
          np.asarray(res_tol.n_iters).tolist())

    # a sweep over only seeds distributes across a device mesh untouched:
    # the model axis is embarrassingly parallel (no collectives at all)
    n_dev = jax.device_count()
    if n_models % n_dev == 0 and n_dev > 1:
        mesh = make_mesh_models()
        res_m = sweep_fit(V, 5, (5, 5), seed=seeds,
                          n_iterations=n_iterations, sparsity=sp, mesh=mesh)
        err = np.abs(np.asarray(res_m.energies) - np.asarray(res.energies))
        print(f'mesh({n_dev}) sweep matches single-device objectives to '
              f'{err.max():.2e}')


if __name__ == '__main__':
    main()
