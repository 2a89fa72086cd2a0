"""Fully on-device minibatch fit loops.

The compatibility path in :mod:`tnmf_tpu.models.tnmf` drives minibatch
epochs from Python (one dispatch per batch step, mirroring the reference's
loop structure).  On an accelerator per-batch host round trips and
kernel launches dominate small batches, so this module compiles a whole
multi-epoch minibatch fit into a single ``lax.scan`` program:

* samples are regrouped as ``(n_batches, batch, ...)`` once per fit,
* the per-epoch batch orders (host-RNG permutations, for exact parity with
  the Python path) are passed in as one ``(n_epochs, n_batches)`` index
  array,
* the scan carries ``(W, H_batched, inner_stat)`` and performs the same
  H-then-W updates as the reference algorithms 4-8
  (``TransformInvariantNMF.py:457-504``).

Eligibility: no per-epoch Python callback.  Ragged final batches are
zero-padded by the caller — zero V rows and zero H rows contribute exactly
zero to every statistic (plain sums over samples) and H = 0 is absorbing
under the multiplicative update, so the trajectory is identical to the
Python path's short final batch (same update order, same RNG consumption),
verified in tests/test_minibatch_scan.py.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from . import engine
from .ops.modes import ConvPlan

_STATICS = ('plan', 'strategy', 'algorithm', 'use_inhibition', 'use_cross',
            'record_energies', 'beta')


@partial(jax.jit, static_argnames=_STATICS, donate_argnums=(1, 2))
def minibatch_fit_loop(
    Vp_b, W, H_b, perms, sparsity, inhibition, cross_inhibition, sag_lambda, kernels, *,
    plan: ConvPlan, strategy: str, algorithm: int,
    use_inhibition: bool = False, use_cross: bool = False,
    record_energies: bool = False, V_flat=None, beta: float = 2.0,
    mask_b=None, mask_flat=None, l2_H=None, ortho_W=None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Run ``n_epochs`` minibatch epochs on device.

    Args:
      Vp_b: prepared data regrouped to (n_batches, batch, ...).
      W: dictionary.
      H_b: activations regrouped to (n_batches, batch, n_atoms, ...).
      perms: (n_epochs, n_batches) int32 batch visit order per epoch.
      algorithm: MiniBatchAlgorithm value (4-8).
      record_energies: with ``V_flat`` (the *data-space* samples, flattened
        over batches, zero rows for ragged padding), also record the
        post-epoch reconstruction energy on device — one extra
        reconstruction per epoch, like the reference's per-epoch logging
        (``TransformInvariantNMF.py:440``).
    Returns:
      (W, H_b, energies) after all epochs; ``energies`` is (n_epochs,) in
      the accumulation dtype (zeros when not recording).
    """
    ops = engine.get_ops(strategy)
    norm_axes = tuple(range(-plan.ndim, 0))
    n_atoms = W.shape[0]
    nb, bs = H_b.shape[:2]

    def enc_b(H_b):
        H = engine._enc_h(H_b.reshape((nb * bs,) + H_b.shape[2:]), plan, strategy)
        return H.reshape((nb, bs) + H.shape[1:])

    def dec_b(H_b):
        H = engine._dec_h(H_b.reshape((nb * bs,) + H_b.shape[2:]), plan,
                          strategy, n_atoms)
        return H.reshape((nb, bs) + H.shape[1:])

    H_b = enc_b(H_b)

    def mu_H(Vb, W, Hb, Mb):
        return engine._mu_H(ops, Vb, W, Hb, sparsity, inhibition, cross_inhibition,
                            kernels, plan=plan, use_inhibition=use_inhibition,
                            use_cross=use_cross, beta=beta,
                            mask=Mb, l2=l2_H)

    def grad_W(Vb, W, Hb, Mb):
        R = ops.reconstruct(W, Hb, plan)
        if beta != 2.0:
            return engine._beta_grad_W(ops, Vb, R, Hb, plan, beta, Mb,
                                       n_channels=W.shape[1])
        if Mb is not None:
            R = R * Mb.astype(R.dtype)  # Vb carries prepare(mask*V) already
        return ops.grad_W_pair(Vb, R, Hb, plan)

    def apply_W(W, neg, pos):
        if ortho_W is not None:
            # from the CURRENT W at update time — never part of the
            # accumulated statistics (which may average past dictionaries)
            pos = pos + engine._ortho_positive_term(W, ortho_W).astype(pos.dtype)
        Wn = W * neg / (pos + engine.EPS)
        return engine._normalize_W(Wn, plan.ndim).astype(W.dtype)  # stable carry dtype

    def sag_update(stat, neg, pos):
        # sag_lambda == 1 means plain summation (reference
        # _accumulate_gradient_W, TransformInvariantNMF.py:444-455)
        a_neg, a_pos = stat
        is_sum = sag_lambda == 1.0
        keep = jnp.where(is_sum, 1.0, 1.0 - sag_lambda)
        add = jnp.where(is_sum, 1.0, sag_lambda)
        return keep * a_neg + add * neg, keep * a_pos + add * pos

    acc_dtype = jnp.promote_types(W.dtype, jnp.float32)  # stats stay f32 under bf16
    zero_stat = (jnp.zeros(W.shape, acc_dtype), jnp.zeros(W.shape, acc_dtype))

    def batch_step(carry, idx):
        W, H_b, acc = carry
        Vb = Vp_b[idx]
        Mb = None if mask_b is None else mask_b[idx]
        Hb = mu_H(Vb, W, H_b[idx], Mb)
        H_b = H_b.at[idx].set(Hb)
        if algorithm == 4:      # Cyclic_MU: accumulate; W update at epoch end
            neg, pos = grad_W(Vb, W, Hb, Mb)
            acc = (acc[0] + neg, acc[1] + pos)
        elif algorithm == 5:    # ASG_MU: W update per batch
            neg, pos = grad_W(Vb, W, Hb, Mb)
            W = apply_W(W, neg, pos)
        elif algorithm == 6:    # GSG_MU: H only; W handled at epoch end
            pass
        elif algorithm == 7:    # ASAG_MU: averaged stats + W update per batch
            neg, pos = grad_W(Vb, W, Hb, Mb)
            acc = sag_update(acc, neg, pos)
            W = apply_W(W, *acc)
        elif algorithm == 8:    # GSAG_MU: H only; stats from last batch at epoch end
            pass
        else:
            raise ValueError(f'unknown minibatch algorithm {algorithm}')
        return (W, H_b, acc), None

    def epoch_step(carry, perm):
        W, H_b, inner = carry
        acc0 = zero_stat if algorithm == 4 else inner
        (W, H_b, acc), _ = jax.lax.scan(batch_step, (W, H_b, acc0), perm)
        if algorithm in (6, 8):
            last = perm[-1]
            Ml = None if mask_b is None else mask_b[last]
            neg, pos = grad_W(Vp_b[last], W, H_b[last], Ml)
            if algorithm == 8:
                acc = sag_update(acc, neg, pos)
                neg, pos = acc
            W = apply_W(W, neg, pos)
        elif algorithm == 4:
            W = apply_W(W, *acc)
        if record_energies:
            # zero-padded ragged rows have V = 0 and H = 0, so R = 0 there
            # and they contribute nothing to the energy
            H_flat = H_b.reshape((-1,) + H_b.shape[2:])
            R = ops.reconstruct(W, H_flat, plan)
            from .ops import beta as beta_ops
            return (W, H_b, acc), beta_ops.divergence(
                V_flat, R, beta, mask_flat).astype(acc_dtype)
        return (W, H_b, acc), jnp.zeros((), acc_dtype)

    (W, H_b, _), energies = jax.lax.scan(epoch_step, (W, H_b, zero_stat), perms)
    return W, dec_b(H_b), energies
