"""tnmf_tpu — Transform-Invariant Non-Negative Matrix Factorization in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of the ``tnmf`` package
(shift-invariant NMF via multiplicative updates), run on a GPU:

* one jit-compiled engine with FFT and direct-convolution strategies in
  place of five interchangeable CPU backends,
* fused on-device fit loops,
* optional data parallelism over a ``jax.sharding.Mesh``.

Public API::

    from tnmf_tpu import TransformInvariantNMF, MiniBatchAlgorithm
    from tnmf_tpu import TransformGroup   # custom invariance transform sets
"""

from .models.multiscale import MultiScaleTNMF
from .models.sweep import SweepResult, sweep_fit
from .models.tnmf import (MiniBatchAlgorithm, MiniBatchTransformInvariantNMF,
                          TransformInvariantNMF)
from .ops.transforms import TransformGroup
from .serving import ServingModel, export_serving, load_serving

__all__ = ['TransformInvariantNMF', 'MiniBatchTransformInvariantNMF',
           'MiniBatchAlgorithm', 'TransformGroup',
           'MultiScaleTNMF', 'SweepResult', 'sweep_fit',
           'export_serving', 'load_serving', 'ServingModel']

__version__ = '0.3.0.dev0'
