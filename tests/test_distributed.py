"""Multi-host (multi-process) data parallelism, dry-run on CPU.

Spawns two OS processes with four virtual CPU devices each, connected via
``jax.distributed`` (the same runtime that spans GPU hosts), and
fits the same problem that a single 8-device process fits.  The device-side
PRNG init makes both trajectories identical, so this pins multi-process
correctness end to end: global-array assembly from process-local shards,
SPMD compilation over the process-spanning mesh, and the cross-host W
all-reduce.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r'''
import os, sys
sys.path.insert(0, %(root)r)
import numpy as np
import jax
jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)

from tnmf_tpu import TransformInvariantNMF
from tnmf_tpu.parallel import distributed

rank = int(sys.argv[1])
distributed.initialize(coordinator_address=%(coord)r, num_processes=2, process_id=rank)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())

mesh = distributed.global_mesh()
rng = np.random.default_rng(7)
V_global = rng.random((8, 2, 12, 12))          # all ranks draw the same batch
V_local = V_global[rank * 4:(rank + 1) * 4]    # ... and keep only their slice

nmf = TransformInvariantNMF(n_atoms=3, atom_shape=(3, 3), mesh=mesh,
                            init='device', seed=0, dtype='float64')
distributed.fit_distributed(nmf, V_local, n_iterations=4, sparsity_H=0.1)
W = np.asarray(nmf._W)  # W is replicated, hence addressable everywhere
print('WSUM', rank, repr(float(W.sum())), flush=True)
np.save(%(out)r + f'/W_{rank}.npy', W)

# minibatch fitting on a process-spanning global array (the stochastic
# ASG_MU schedule; seed=0 makes every process draw the same batch order)
from tnmf_tpu import MiniBatchAlgorithm
V2_global = rng.random((16, 2, 12, 12))
V2_local = V2_global[rank * 8:(rank + 1) * 8]
nmf2 = TransformInvariantNMF(n_atoms=3, atom_shape=(3, 3), mesh=mesh,
                             init='device', seed=0, dtype='float64')
V2 = distributed.distribute_samples(mesh, V2_local)
nmf2.fit(V2, algorithm=MiniBatchAlgorithm.ASG_MU, batch_size=8, n_epochs=3,
         sparsity_H=0.1)
np.save(%(out)r + f'/Wmb_{rank}.npy', np.asarray(nmf2._W))

# transform-group adapter across processes: a flip-tied dictionary under
# the process-spanning data-parallel mesh (H carries atom*transform maps)
nmf3 = TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3), mesh=mesh,
                             init='device', seed=0, dtype='float64',
                             transform_type='shift+flip')
distributed.fit_distributed(nmf3, V_local, n_iterations=3, sparsity_H=0.1)
np.save(%(out)r + f'/Wg_{rank}.npy', np.asarray(nmf3._W))

# masked factorization on process-spanning global arrays: the mask is
# distributed exactly like V (each process wraps its local slice), so no
# host ever holds the full mask — the inpainting-at-scale workload
M_global = (rng.random((8, 2, 12, 12)) > 0.3).astype(np.float64)
nmf4 = TransformInvariantNMF(n_atoms=3, atom_shape=(3, 3), mesh=mesh,
                             init='device', seed=0, dtype='float64')
V4 = distributed.distribute_samples(mesh, V_local)
M4 = distributed.distribute_samples(mesh, M_global[rank * 4:(rank + 1) * 4])
nmf4.fit(V4, n_iterations=4, sparsity_H=0.1, mask=M4)
np.save(%(out)r + f'/Wm_{rank}.npy', np.asarray(nmf4._W))
'''


def _free_port():
    s = socket.socket()
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_fit_matches_single_process(tmp_path):
    coord = f'localhost:{_free_port()}'
    env = {**os.environ,
           'JAX_PLATFORMS': 'cpu',
           'XLA_FLAGS': '--xla_force_host_platform_device_count=4'}
    script = WORKER % {'root': ROOT, 'coord': coord, 'out': str(tmp_path)}
    procs = [subprocess.Popen([sys.executable, '-c', script, str(rank)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    outs = [p.communicate(timeout=280)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]

    W0 = np.load(tmp_path / 'W_0.npy')
    W1 = np.load(tmp_path / 'W_1.npy')
    np.testing.assert_array_equal(W0, W1)

    # single-process 8-device run with the same device-init seed: the PRNG
    # draw depends only on the key and shapes, so trajectories must match
    from tnmf_tpu import TransformInvariantNMF
    from tnmf_tpu.parallel import make_mesh
    rng = np.random.default_rng(7)
    V = rng.random((8, 2, 12, 12))
    nmf = TransformInvariantNMF(n_atoms=3, atom_shape=(3, 3), mesh=make_mesh(8),
                                init='device', seed=0, dtype='float64')
    nmf.fit(V, n_iterations=4, sparsity_H=0.1)
    np.testing.assert_allclose(W0, np.asarray(nmf._W), rtol=1e-12, atol=1e-14)

    # minibatch (ASG_MU) on global arrays: both processes agree with each
    # other and with the single-process 8-device trajectory
    Wmb0 = np.load(tmp_path / 'Wmb_0.npy')
    Wmb1 = np.load(tmp_path / 'Wmb_1.npy')
    np.testing.assert_array_equal(Wmb0, Wmb1)
    from tnmf_tpu import MiniBatchAlgorithm
    V2 = rng.random((16, 2, 12, 12))
    nmf2 = TransformInvariantNMF(n_atoms=3, atom_shape=(3, 3), mesh=make_mesh(8),
                                 init='device', seed=0, dtype='float64')
    nmf2.fit(V2, algorithm=MiniBatchAlgorithm.ASG_MU, batch_size=8, n_epochs=3,
             sparsity_H=0.1)
    np.testing.assert_allclose(Wmb0, np.asarray(nmf2._W), rtol=1e-12, atol=1e-14)

    # flip-tied dictionary: processes agree with each other and with the
    # single-process 8-device trajectory
    Wg0 = np.load(tmp_path / 'Wg_0.npy')
    Wg1 = np.load(tmp_path / 'Wg_1.npy')
    np.testing.assert_array_equal(Wg0, Wg1)
    nmf3 = TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3), mesh=make_mesh(8),
                                 init='device', seed=0, dtype='float64',
                                 transform_type='shift+flip')
    nmf3.fit(V, n_iterations=3, sparsity_H=0.1)
    np.testing.assert_allclose(Wg0, np.asarray(nmf3._W), rtol=1e-12, atol=1e-14)

    # masked 2-process fit pinned to the single-process trajectory: the
    # distributed mask reproduces the single-host masked objective exactly
    Wm0 = np.load(tmp_path / 'Wm_0.npy')
    Wm1 = np.load(tmp_path / 'Wm_1.npy')
    np.testing.assert_array_equal(Wm0, Wm1)
    M = (rng.random((8, 2, 12, 12)) > 0.3).astype(np.float64)
    nmf4 = TransformInvariantNMF(n_atoms=3, atom_shape=(3, 3), mesh=make_mesh(8),
                                 init='device', seed=0, dtype='float64')
    nmf4.fit(V, n_iterations=4, sparsity_H=0.1, mask=M)
    np.testing.assert_allclose(Wm0, np.asarray(nmf4._W), rtol=1e-12, atol=1e-14)
