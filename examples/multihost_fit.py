"""Multi-host data-parallel fit, runnable on one machine.

Demonstrates the full multi-host flow of ``tnmf_tpu.parallel.distributed``
(reference has no distributed mode whatsoever — SURVEY.md §2.3): this
launcher spawns two worker processes with four virtual CPU devices each;
every worker connects to the JAX distributed runtime, builds the same
8-device global mesh, contributes its *local* half of the sample batch,
and fits — the W-statistic all-reduce spans both processes, exactly as it
would span GPU hosts of a cluster.

On a real cluster, delete the launcher block and run the worker on every
host, giving `distributed.initialize()` the coordinator address, process
count and rank (a cluster manager JAX recognises, e.g. SLURM, supplies
them itself).
"""

import os
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def worker(coordinator, rank):
    import numpy as np
    import jax
    jax.config.update('jax_platforms', 'cpu')

    sys.path.insert(0, ROOT)
    from tnmf_tpu import TransformInvariantNMF
    from tnmf_tpu.parallel import distributed

    distributed.initialize(coordinator_address=coordinator,
                           num_processes=2, process_id=rank)
    mesh = distributed.global_mesh()
    print(f'[rank {rank}] {jax.process_count()} processes, '
          f'{len(jax.devices())} global devices, mesh {mesh.shape}', flush=True)

    # every rank generates the same global batch and keeps its own slice
    # (in production each host would load its own shard from storage)
    rng = np.random.default_rng(0)
    V_global = rng.random((16, 2, 24, 24)).astype(np.float32)
    V_local = V_global[rank * 8:(rank + 1) * 8]

    nmf = TransformInvariantNMF(n_atoms=4, atom_shape=(5, 5), mesh=mesh,
                                init='device', seed=0)
    distributed.fit_distributed(nmf, V_local, n_iterations=30, sparsity_H=0.1)

    energy = nmf._energy_function()  # global energy; identical on all ranks
    print(f'[rank {rank}] final energy {energy:.4f}, '
          f'atom norms {np.asarray(nmf._W).sum(axis=(-2, -1)).round(4).tolist()}',
          flush=True)


def main():
    s = socket.socket()
    s.bind(('localhost', 0))
    coordinator = f'localhost:{s.getsockname()[1]}'
    s.close()

    env = {**os.environ,
           'JAX_PLATFORMS': 'cpu',
           'XLA_FLAGS': '--xla_force_host_platform_device_count=4'}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), coordinator, str(rank)], env=env)
        for rank in range(2)]
    codes = [p.wait(timeout=240) for p in procs]
    assert codes == [0, 0], codes
    print('multi-host fit finished on both ranks.')


if __name__ == '__main__':
    if len(sys.argv) == 3:
        worker(sys.argv[1], int(sys.argv[2]))
    else:
        main()
