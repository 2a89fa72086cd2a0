"""Sharded execution over a device mesh (data / spatial / atom parallelism).

The reference is strictly single-process (SURVEY.md §2.3); this module is the
new capability that replaces it at scale.  Three shardable axes, composable
on 2-D meshes:

* **samples** (data parallelism) — V/H sharded along the sample axis, W
  replicated; GSPMD turns the sample contraction inside ``grad_W_pair``
  (``sum_n H[n,m,t] X[n,c,..]``) into an all-reduce, and the H update is
  embarrassingly parallel (no cross-sample term).
* **spatial** (context parallelism) — V/H sharded along their first spatial
  axis for samples too large for one device; the partitioner inserts conv
  halo exchanges.
* **atoms** (model/tensor parallelism) — W sharded along its atom axis and
  H along its atom axis for dictionaries too large for one device; both
  gradients are atom-local, the reconstruction's sum over atoms becomes the
  all-reduce.

Nothing else changes — the jitted update steps in :mod:`tnmf_tpu.engine` are
sharding-polymorphic.  This is valid mathematically because every cross-shard
term is a plain sum (over samples for W statistics, reference
``_NumPyFFTBackend.py:86-87``; over atoms for the reconstruction,
``TransformInvariantNMF.py:58-73``): psum of per-shard partials equals the
full quantity, so sharded trajectories are bitwise-equivalent to
single-device execution up to reduction order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = 'data'
SPATIAL_AXIS = 'space'
ATOM_AXIS = 'atoms'
MODEL_AXIS = 'models'


def make_mesh_models(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over the *model* axis of a hyperparameter sweep
    (:func:`tnmf_tpu.models.sweep.sweep_fit`): each device fits its own
    slice of the independent models — embarrassingly parallel, zero
    collectives."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (MODEL_AXIS,))


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D data-parallel mesh over the first ``n_devices`` devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (DATA_AXIS,))


def make_mesh_atoms(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D model-parallel mesh over the dictionary (atom) axis."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (ATOM_AXIS,))


def make_mesh_2d_atoms(n_data: int, n_atoms: int, devices=None) -> Mesh:
    """2-D mesh combining data and atom (model) parallelism: samples shard
    over ``'data'``, the dictionary over ``'atoms'``. The atom axis is laid
    innermost so the per-iteration reconstruct all-reduce over atom shards
    rides the fastest interconnect links."""
    if devices is None:
        devices = jax.devices()
    need = n_data * n_atoms
    if len(devices) < need:
        raise ValueError(f'mesh {n_data}x{n_atoms} needs {need} devices, have {len(devices)}')
    return Mesh(np.array(devices[:need]).reshape(n_data, n_atoms),
                (DATA_AXIS, ATOM_AXIS))


def make_mesh_2d(n_data: int, n_space: int, devices=None) -> Mesh:
    """2-D mesh combining data and spatial parallelism: samples shard over
    the ``'data'`` axis, the first spatial dimension of V/H over
    ``'space'``. Lay the spatial axis innermost so its halo exchanges ride
    the fastest interconnect links."""
    if devices is None:
        devices = jax.devices()
    need = n_data * n_space
    if len(devices) < need:
        raise ValueError(f'mesh {n_data}x{n_space} needs {need} devices, have {len(devices)}')
    return Mesh(np.array(devices[:need]).reshape(n_data, n_space),
                (DATA_AXIS, SPATIAL_AXIS))


def data_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Shard axis 0 (samples), replicate the rest."""
    return NamedSharding(mesh, P(DATA_AXIS, *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    """Fully replicated placement (used for the dictionary W)."""
    return NamedSharding(mesh, P())


def spatial_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Shard the first spatial axis (axis 2 of the (B, F, *spatial) layout).

    On a 1-D mesh its single axis is used (whatever its name); on a 2-D
    mesh from :func:`make_mesh_2d` the ``'space'`` axis is used — never the
    data axis, which would silently misplace the tensor."""
    if SPATIAL_AXIS in mesh.axis_names:
        name = SPATIAL_AXIS
    elif len(mesh.axis_names) == 1:
        name = mesh.axis_names[0]
    else:
        raise ValueError(
            f'spatial_sharding: mesh axes {mesh.axis_names} contain no '
            f'{SPATIAL_AXIS!r} axis and are not 1-D; build the mesh with '
            f'make_mesh / make_mesh_2d')
    spec = [None] * ndim
    spec[2] = name
    return NamedSharding(mesh, P(*spec))


def h_sharding(mesh: Mesh, ndim: int, axis: str = 'samples') -> NamedSharding:
    """The sharding H takes under :func:`shard_model_state` for ``axis`` —
    usable as a jit ``with_sharding_constraint`` so H can be *created*
    directly in its distributed layout (``init='device'``)."""
    if axis == 'samples':
        return data_sharding(mesh, ndim)
    if axis == 'spatial':
        return spatial_sharding(mesh, ndim)
    if axis == 'both':
        return NamedSharding(mesh, P(DATA_AXIS, None, SPATIAL_AXIS, *([None] * (ndim - 3))))
    if axis == 'atoms':
        return NamedSharding(mesh, P(None, ATOM_AXIS, *([None] * (ndim - 2))))
    if axis == 'samples+atoms':
        return NamedSharding(mesh, P(DATA_AXIS, ATOM_AXIS, *([None] * (ndim - 2))))
    raise ValueError(
        f"shard axis must be 'samples', 'spatial', 'both', 'atoms' or "
        f"'samples+atoms', got {axis!r}")


def w_sharding(mesh: Mesh, ndim: int, axis: str = 'samples') -> NamedSharding:
    """The sharding W takes under :func:`shard_model_state` for ``axis``:
    sharded along its atom axis (axis 0) under atom/model parallelism,
    replicated everywhere else."""
    if axis in ('atoms', 'samples+atoms'):
        return NamedSharding(mesh, P(ATOM_AXIS, *([None] * (ndim - 1))))
    return replicated(mesh)


def shard_model_state(mesh: Mesh, V, W, H, axis: str = 'samples') -> Tuple:
    """Place the model state on the mesh.

    ``axis='samples'`` — data parallelism: V/H sharded along the sample
    axis, W replicated; the W-statistic sample reduction becomes an
    all-reduce (the standard large-batch layout).

    ``axis='spatial'`` — spatial parallelism for very large individual
    samples (the conv-NMF analogue of sequence/context parallelism, which
    the reference has no counterpart for): V and H are sharded along their
    first *spatial* axis. The XLA SPMD partitioner inserts the halo
    exchanges that the direct convolutions need at shard boundaries; W
    stays replicated. Works with the 'conv' strategy (the FFT strategy
    would transform along the sharded axis, forcing all-to-alls).

    ``axis='atoms'`` — model (tensor) parallelism over the dictionary, for
    atom counts whose W/H exceed one device: W shards along its atom axis
    (axis 0), H along its atom axis (axis 1), V is replicated. Both
    gradients are embarrassingly parallel over atoms (grad_W[m] and
    grad_H[..., m, ...] read only shard-local W/H); the only collective is
    the reconstruction's sum over atoms, which GSPMD turns into an
    all-reduce. The cross-atom inhibition sum over atoms reduces the same
    way.

    ``axis='samples+atoms'`` — 2-D data x model parallelism on a mesh from
    :func:`make_mesh_2d_atoms`: V sample-sharded, W atom-sharded, H sharded
    along both.
    """
    n_dev = mesh.devices.size
    if axis == 'samples':
        n = V.shape[0]
        if n % n_dev != 0:
            raise ValueError(
                f'n_samples ({n}) must be divisible by the mesh size ({n_dev}); '
                f'pad the batch or use a smaller mesh')
        V = jax.device_put(V, data_sharding(mesh, V.ndim))
        H = jax.device_put(H, data_sharding(mesh, H.ndim))
    elif axis == 'spatial':
        if V.ndim < 3:
            raise ValueError('spatial sharding needs at least one spatial axis')
        if H.shape[2] % n_dev:
            raise ValueError(
                f'spatial sharding requires the first spatial axis of H '
                f'({H.shape[2]}, i.e. sample+atom-1 in "valid" mode) to be '
                f'divisible by the mesh size ({n_dev}); choose a compatible '
                f'mesh size or atom/sample shape')
        # H dominates memory and must shard; V shards too when its extent
        # divides, otherwise it stays replicated and the partitioner
        # re-slices V-sized intermediates as needed.
        if V.shape[2] % n_dev == 0:
            V = jax.device_put(V, spatial_sharding(mesh, V.ndim))
        else:
            V = jax.device_put(V, replicated(mesh))
        H = jax.device_put(H, spatial_sharding(mesh, H.ndim))
    elif axis == 'both':
        if SPATIAL_AXIS not in mesh.axis_names or DATA_AXIS not in mesh.axis_names:
            raise ValueError("axis='both' needs a 2-D mesh from make_mesh_2d")
        n_data = mesh.shape[DATA_AXIS]
        n_space = mesh.shape[SPATIAL_AXIS]
        if V.shape[0] % n_data:
            raise ValueError(
                f'n_samples ({V.shape[0]}) must be divisible by the data '
                f'mesh axis ({n_data})')
        if H.shape[2] % n_space:
            raise ValueError(
                f'first spatial axis of H ({H.shape[2]}) must be divisible '
                f'by the spatial mesh axis ({n_space})')
        rest = [None] * (V.ndim - 3)
        v_spatial = SPATIAL_AXIS if V.shape[2] % n_space == 0 else None
        V = jax.device_put(V, NamedSharding(mesh, P(DATA_AXIS, None, v_spatial, *rest)))
        H = jax.device_put(H, NamedSharding(mesh, P(DATA_AXIS, None, SPATIAL_AXIS, *rest)))
    elif axis in ('atoms', 'samples+atoms'):
        if axis == 'samples+atoms':
            if ATOM_AXIS not in mesh.axis_names or DATA_AXIS not in mesh.axis_names:
                raise ValueError("axis='samples+atoms' needs a 2-D mesh from make_mesh_2d_atoms")
            n_data = mesh.shape[DATA_AXIS]
            n_atom_shards = mesh.shape[ATOM_AXIS]
            if V.shape[0] % n_data:
                raise ValueError(
                    f'n_samples ({V.shape[0]}) must be divisible by the data '
                    f'mesh axis ({n_data})')
        else:
            n_atom_shards = n_dev
        if W.shape[0] % n_atom_shards:
            raise ValueError(
                f'n_atoms ({W.shape[0]}) must be divisible by the atom mesh '
                f'axis ({n_atom_shards}); pad the dictionary or resize the mesh')
        if axis == 'atoms':
            V = jax.device_put(V, replicated(mesh))
        else:
            V = jax.device_put(V, data_sharding(mesh, V.ndim))
        H = jax.device_put(H, h_sharding(mesh, H.ndim, axis))
        W = jax.device_put(W, w_sharding(mesh, W.ndim, axis))
        return V, W, H
    else:
        raise ValueError(
            f"shard axis must be 'samples', 'spatial', 'both', 'atoms' or "
            f"'samples+atoms', got {axis!r}")
    W = jax.device_put(W, replicated(mesh))
    return V, W, H
