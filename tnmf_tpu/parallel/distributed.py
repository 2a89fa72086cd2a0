"""Multi-host (multi-process) data parallelism across processes.

The reference is strictly single-process (SURVEY.md §2.3).  Single-host
data parallelism lives in :mod:`tnmf_tpu.parallel.sharding`; this module
extends it across *processes* (e.g. several GPU hosts of a cluster, or
several CPU processes in tests):

1. every process calls :func:`initialize` (a thin wrapper over
   ``jax.distributed.initialize``),
2. builds the same :func:`global_mesh` over **all** devices in the job,
3. wraps its *local* slice of the sample batch with
   :func:`distribute_samples`, which assembles a global ``jax.Array``
   whose sample axis is sharded over the whole mesh without any host ever
   materializing the full batch,
4. fits as usual with ``TransformInvariantNMF(mesh=global_mesh,
   init='device')`` — the engine's jitted steps are SPMD, so the W-gradient
   sample reduction becomes one ``psum`` spanning the links within each
   host and the network across hosts, exactly like the single-host path.

Requirements under a process-spanning mesh: ``init='device'`` (W/H are
created directly in their sharded layout; no host holds global H), no
input shuffling, and — for the stochastic minibatch algorithms
(ASG_MU/GSG_MU/ASAG_MU/GSAG_MU), which draw the batch *order* host-side —
a ``seed=...`` so every process draws the same order (enforced with a
clear error; divergent orders would deadlock the SPMD programs).  The
``V``/``H`` gather properties raise on non-addressable arrays — at this
scale pull per-shard results via ``jax.experimental.multihost_utils``
instead.

Verified by ``tests/test_distributed.py``, which spawns two CPU processes
with four virtual devices each and pins the 2x4-process fit to the
single-process 8-device trajectory.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np

from .sharding import DATA_AXIS, data_sharding, make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Connect this process to the JAX distributed runtime.

    Under a cluster manager JAX recognises (e.g. SLURM) all arguments are
    discovered automatically (pass nothing).  Otherwise pass the
    coordinator ``host:port``, the total process count and this process's
    rank, like ``jax.distributed.initialize``.
    """
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh():
    """1-D data-parallel mesh over every device of every process.

    ``jax.devices()`` returns the global device list once the distributed
    runtime is initialized; device order groups by process, so sample
    shards are process-contiguous and the W all-reduce stays within a host
    before crossing the network."""
    return make_mesh(devices=jax.devices())


def distribute_samples(mesh, V_local: np.ndarray) -> jax.Array:
    """Assemble the global sample batch from per-process local slices.

    Every process passes its own ``(n_local, channels, *sample_shape)``
    block (equal ``n_local`` everywhere); the result is one global
    ``jax.Array`` of ``n_local * num_processes`` samples, sharded along the
    sample axis over ``mesh``, with each shard built from process-local
    host memory only (no cross-host gather, no full-batch host copy).
    """
    from jax.experimental import multihost_utils
    sharding = data_sharding(mesh, np.ndim(V_local))
    return multihost_utils.host_local_array_to_global_array(
        np.asarray(V_local), mesh, sharding.spec)


def fit_distributed(model, V_local: np.ndarray, **fit_kwargs):
    """Convenience driver: distribute ``V_local`` over the model's mesh and
    fit.  The model must have been constructed with ``mesh=global_mesh()``
    and ``init='device'``."""
    if model._mesh is None:
        raise ValueError('fit_distributed needs a model constructed with mesh=global_mesh()')
    V = distribute_samples(model._mesh, V_local)
    model.fit(V, **fit_kwargs)
    return model
