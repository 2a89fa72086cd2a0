"""Atom (model/tensor) parallel conv-NMF — sharding the dictionary itself.

For dictionaries too large for one device (thousands of atoms; both W and
the ``n_atoms``-proportional activation tensor H grow with the atom count),
``shard_axis='atoms'`` splits W along its atom axis and H along its atom
axis across the mesh.  Both MU gradients are atom-local, so the only
collective is the reconstruction's sum over atoms — one all-reduce per
gradient pass, inserted automatically by the SPMD partitioner.

Run on GPUs, or on virtual CPU devices via
``XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu``.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from tnmf_tpu import TransformInvariantNMF  # noqa: E402
from tnmf_tpu.parallel import make_mesh_atoms  # noqa: E402


def main(n_iterations: int = None):
    if n_iterations is None:
        n_iterations = 5 if os.environ.get('TNMF_TPU_SMOKE') else 20
    n_dev = jax.device_count()
    print(f'devices: {n_dev} x {jax.devices()[0].platform}')
    mesh = make_mesh_atoms()

    rng = np.random.default_rng(0)
    n_atoms = 4 * n_dev  # 4 atoms per device shard
    V = rng.random((6, 1, 32, 32)).astype(np.float32)

    np.random.seed(42)
    nmf = TransformInvariantNMF(n_atoms=n_atoms, atom_shape=(5, 5), mesh=mesh,
                                shard_axis='atoms', verbose=2)
    nmf.fit(V, n_iterations=n_iterations, sparsity_H=0.1, inhibition_strength=0.1)
    print('sharded W layout:', nmf._W.sharding)
    print(f'final energy (atom-sharded, mesh={n_dev}): {nmf._energy_function():.4f}')

    np.random.seed(42)
    ref = TransformInvariantNMF(n_atoms=n_atoms, atom_shape=(5, 5))
    ref.fit(V, n_iterations=n_iterations, sparsity_H=0.1, inhibition_strength=0.1)
    print(f'final energy (single device):           {ref._energy_function():.4f}')
    print('max |W_mesh - W_single| =', np.abs(nmf.W - ref.W).max())
    return nmf


if __name__ == '__main__':
    main()
