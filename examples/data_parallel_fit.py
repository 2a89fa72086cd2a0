"""Data-parallel conv-NMF over a device mesh — the scale capability the
reference lacks.

Shards a stack of image samples over all available devices (GPUs, or
virtual CPU devices via ``XLA_FLAGS=--xla_force_host_platform_device_count=8``),
keeps the dictionary replicated and lets XLA all-reduce the W statistics
over the interconnect.  Prints per-device sharding info and verifies the
result matches single-device execution.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from tnmf_tpu import TransformInvariantNMF  # noqa: E402
from tnmf_tpu.parallel import make_mesh  # noqa: E402


def main(n_iterations: int = None):
    if n_iterations is None:
        n_iterations = 5 if os.environ.get('TNMF_TPU_SMOKE') else 20
    n_dev = jax.device_count()
    print(f'devices: {n_dev} x {jax.devices()[0].platform}')
    mesh = make_mesh()

    rng = np.random.default_rng(0)
    n_samples = 4 * n_dev
    V = rng.random((n_samples, 1, 32, 32)).astype(np.float32)

    np.random.seed(42)
    nmf = TransformInvariantNMF(n_atoms=8, atom_shape=(5, 5), mesh=mesh, verbose=2)
    nmf.fit(V, n_iterations=n_iterations, sparsity_H=0.1)
    print('sharded H layout:', nmf._H.sharding)
    print(f'final energy (mesh={n_dev}): {nmf._energy_function():.4f}')

    np.random.seed(42)
    ref = TransformInvariantNMF(n_atoms=8, atom_shape=(5, 5))
    ref.fit(V, n_iterations=n_iterations, sparsity_H=0.1)
    print(f'final energy (single device): {ref._energy_function():.4f}')
    print('max |W_mesh - W_single| =', np.abs(nmf.W - ref.W).max())
    return nmf


if __name__ == '__main__':
    main()
