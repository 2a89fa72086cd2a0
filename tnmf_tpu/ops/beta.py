"""Beta-divergence factors and losses for the multiplicative-update rules.

Generalizes the reconstruction objective from the reference's squared
Euclidean energy (beta = 2; ``/root/reference/tnmf/backends/_Backend.py:127-130``)
to the full beta-divergence family of Fevotte & Idier 2011 — including
generalized Kullback-Leibler (beta = 1) and Itakura-Saito (beta = 0) — a
capability the reference cites as its minibatch algorithms' theoretical
setting (Serizel/Essid/Richard 2016 derive them "with beta-divergence",
``TransformInvariantNMF.py:136-139``) but never implements.

The MU update for any beta keeps the reference's ``(neg, pos)`` contract
(``_Backend.py:100-118``): with ``A = V * R**(beta-2)`` and
``B = R**(beta-1)``,

    neg = corr(A, W)   pos = corr(B, W)     (H gradient)
    neg = corr(A, H)   pos = corr(B, H)     (W gradient)

which for beta = 2 reduces to the implemented ``(corr(V, .), corr(R, .))``
pair.  Every strategy's correlation operators therefore serve all betas
unchanged.  How the engine feeds them (:func:`tnmf_tpu.engine._beta_grad_H`
/ ``_beta_grad_W``):

* conv / phased / dot (prepared domain = entrywise replication/zero-fill
  of the canonical domain): the factors are computed directly on prepared
  tensors — the loop-invariant ``prepare_data(V)`` is reused and no
  V-shaped tensor is re-prepared per iteration;
* beta = 1 (KL): ``B = 1``, so the denominator correlations collapse to
  correlations of the (constant) boundary-extension pattern — batch extent
  1 for the H gradient, batch-presummed H for the W gradient;
* fft (spectral prepared domain) and masked fits: the generic fallback
  computes the factors canonically and prepares ``A`` per iteration
  (:func:`tnmf_tpu.engine._beta_grad_pair`).

The factors are one fused elementwise pass over V-shaped streams (small
next to the H-sized streams of the iteration) — XLA fuses the power/divide
into the downstream convolution's input.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

#: floor applied to R wherever a non-positive power would blow up;
#: matches sklearn.decomposition._nmf.EPSILON's role.
EPS_R = 1.0e-9

_NAMED = {'frobenius': 2.0, 'kullback-leibler': 1.0, 'itakura-saito': 0.0}


def resolve_beta_loss(beta_loss) -> float:
    """Map a sklearn-style ``beta_loss`` (float or name) to a float."""
    if isinstance(beta_loss, str):
        try:
            return _NAMED[beta_loss]
        except KeyError as e:
            raise ValueError(
                f'unknown beta_loss {beta_loss!r}; choose a float or one of '
                f'{sorted(_NAMED)}') from e
    return float(beta_loss)


def factors(V, R, beta: float):
    """``(A, B) = (V * R**(beta-2), R**(beta-1))`` in the accumulation dtype,
    cast back to R's storage dtype.  ``beta`` is a static Python float."""
    acc = jnp.promote_types(R.dtype, jnp.float32)
    Rs = jnp.maximum(R.astype(acc), EPS_R)
    Vc = V.astype(acc)
    if beta == 1.0:
        A = Vc / Rs
        B = jnp.ones_like(Rs)
    elif beta == 0.0:
        A = Vc / (Rs * Rs)
        B = 1.0 / Rs
    else:
        A = Vc * Rs ** (beta - 2.0)
        B = Rs ** (beta - 1.0)
    return A.astype(R.dtype), B.astype(R.dtype)


def divergence(V, R, beta: float, mask=None):
    """Elementwise-summed beta-divergence D_beta(V || R) (scalar, accumulation
    dtype).  beta = 2 gives the reference energy ``0.5 * sum((V - R)**2)``;
    beta = 1 the generalized KL divergence; beta = 0 Itakura-Saito.

    With ``mask`` (broadcastable to V; binary for missing-data fits or
    nonnegative floats for per-entry weights) the elementwise terms are
    weighted before the sum — the objective of the masked/weighted MU
    updates."""
    acc = jnp.promote_types(jnp.result_type(V), jnp.float32)
    Vc, Rc = jnp.asarray(V).astype(acc), jnp.asarray(R).astype(acc)
    if beta == 2.0:
        d = Vc - Rc
        e = 0.5 * d * d
    else:
        Rs = jnp.maximum(Rc, EPS_R)
        if beta == 1.0:
            # x*log(x/y) - x + y with the x -> 0 limit handled exactly
            from jax.scipy.special import xlogy
            e = xlogy(Vc, Vc) - xlogy(Vc, Rs) - Vc + Rs
        elif beta == 0.0:
            q = jnp.maximum(Vc, EPS_R) / Rs
            e = q - jnp.log(q) - 1.0
        else:
            c = 1.0 / (beta * (beta - 1.0))
            e = c * (Vc ** beta + (beta - 1.0) * Rs ** beta
                     - beta * Vc * Rs ** (beta - 1.0))
    if mask is not None:
        e = e * jnp.asarray(mask).astype(acc)
    return jnp.sum(e)


# ---------------------------------------------------------------------------
# NumPy reference implementations (for the oracle / tests)
# ---------------------------------------------------------------------------

def np_factors(V: np.ndarray, R: np.ndarray, beta: float):
    """NumPy mirror of :func:`factors` (float64)."""
    Rs = np.maximum(np.asarray(R, np.float64), EPS_R)
    Vc = np.asarray(V, np.float64)
    return Vc * Rs ** (beta - 2.0), Rs ** (beta - 1.0)


def np_divergence(V: np.ndarray, R: np.ndarray, beta: float, mask=None) -> float:
    """NumPy mirror of :func:`divergence` (float64)."""
    Vc = np.asarray(V, np.float64)
    Rc = np.asarray(R, np.float64)
    if beta == 2.0:
        e = 0.5 * (Vc - Rc) ** 2
    else:
        Rs = np.maximum(Rc, EPS_R)
        if beta == 1.0:
            with np.errstate(divide='ignore', invalid='ignore'):
                t = np.where(Vc > 0, Vc * (np.log(np.maximum(Vc, EPS_R)) - np.log(Rs)), 0.0)
            e = t - Vc + Rs
        elif beta == 0.0:
            q = np.maximum(Vc, EPS_R) / Rs
            e = q - np.log(q) - 1.0
        else:
            c = 1.0 / (beta * (beta - 1.0))
            e = c * (Vc ** beta + (beta - 1.0) * Rs ** beta
                     - beta * Vc * Rs ** (beta - 1.0))
    if mask is not None:
        e = e * np.asarray(mask, np.float64)
    return float(np.sum(e))
