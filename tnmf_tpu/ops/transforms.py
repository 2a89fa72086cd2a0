"""Transform groups beyond shifts: flip- and rotation-invariant dictionaries.

The reference implements *shift* invariance only and explicitly defers other
transform types to future work (``/root/reference/tnmf/TransformInvariantNMF.py:65-69``:
"Currently, only a single transform type [...] shift invariance [...] is
supported").  This module supplies that extension for the JAX build: a
dictionary atom can additionally be matched under mirror flips and/or 90-degree
rotations, with one activation map per (atom, transform) pair.

Model
-----
For a finite set of orthogonal grid transforms ``T_g`` (permutations of the
atom index grid — flips and quarter-turn rotations), the reconstruction
becomes::

    R[n] = sum_{m, g}  H[n, m, g] * conv( T_g(W[m]) )

i.e. every canonical atom ``W[m]`` participates through all of its
transformed copies, each with its own shift-activation map.  The dictionary
stays *tied*: only the canonical ``W`` is learned.

MU derivation (why the tie-back below is exact): ``R`` is linear in ``W``
through the expansion ``W_exp[m, g] = T_g(W[m])``, so by the chain rule

    dE/dW[m] = sum_g  T_g^T ( dE/dW_exp[m, g] )  =  sum_g  T_g^{-1}( ... )

because every ``T_g`` is a permutation matrix (orthogonal, entrywise
nonnegative).  Nonnegativity of the entries also means the reference's
``(neg, pos)`` gradient split (``_Backend.py:100-118``) survives the
pull-back term by term, so the Lee-Seung update on the canonical ``W``
remains a valid multiplicative descent step.

Execution design
----------------
The transform group composes as a *wrapper* around an existing strategy
module ('fft' or 'conv'): the engine's static ``strategy`` argument becomes
the hashable tuple ``(base_strategy, TransformGroup)`` and
:func:`tnmf_tpu.engine.get_ops` returns a :class:`GroupOps` adapter that

* expands the canonical ``W (M, C, *A)`` to ``W_exp (M*G, C, *A)`` before
  every reconstruction / H-gradient (a handful of tiny ``rot90``/``flip``
  copies — XLA CSEs the repeated expansion within one jitted iteration), and
* ties the W-gradient statistics back, ``(M*G, ...) -> (M, ...)``, by
  inverse-transform-and-sum.

All hot kernels (the conv/fft strategy ops, the phased lowering's cousins,
inhibition, the MU ratio) are untouched; ``H`` simply carries ``M*G`` atom
channels, laid out m-major so the user-facing view is a clean
``(n_samples, n_atoms, n_transforms, *shift)`` reshape.
"""

from __future__ import annotations

import dataclasses
from itertools import chain, combinations
from typing import Tuple

import jax.numpy as jnp

# One group element: (k, flip_axes) — rotate by k quarter turns in the plane
# of the LAST TWO shift axes, then flip along each listed shift axis
# (axis indices are 0-based within the shift dimensions).
Element = Tuple[int, Tuple[int, ...]]

TRANSFORM_TYPES = ('shift', 'shift+flip', 'shift+rot90', 'shift+rot90+flip')


@dataclasses.dataclass(frozen=True)
class TransformGroup:
    """A finite set of orthogonal atom-grid transforms (hashable, so the
    ``(strategy, group)`` tuple can be a static jit argument)."""
    name: str
    ndim: int
    elements: Tuple[Element, ...]

    @property
    def size(self) -> int:
        return len(self.elements)


def _rot_axes(first_axis: int, ndim: int) -> Tuple[int, int]:
    """The rotation plane: the last two shift axes of an array whose shift
    dimensions start at ``first_axis``."""
    return (first_axis + ndim - 2, first_axis + ndim - 1)


def apply(x, elem: Element, first_axis: int, ndim: int):
    """Apply one group element to the shift axes of ``x`` (rotate, then flip)."""
    k, flips = elem
    if k % 4:
        x = jnp.rot90(x, k, axes=_rot_axes(first_axis, ndim))
    if flips:
        x = jnp.flip(x, axis=tuple(first_axis + a for a in flips))
    return x


def apply_inverse(x, elem: Element, first_axis: int, ndim: int):
    """Apply the inverse element (un-flip, then rotate back); because the
    transforms are permutations this is also the adjoint ``T^T``."""
    k, flips = elem
    if flips:
        x = jnp.flip(x, axis=tuple(first_axis + a for a in flips))
    if k % 4:
        x = jnp.rot90(x, -k, axes=_rot_axes(first_axis, ndim))
    return x


def make_group(transform_type, atom_shape: Tuple[int, ...]):
    """Build the :class:`TransformGroup` for a transform-type string.

    Returns None for the trivial ``'shift'`` type (pure shift invariance —
    the reference's model).  A ready-made :class:`TransformGroup` passes
    through unchanged (escape hatch for custom transform sets; any finite
    set of grid permutations yields a valid tied-MU scheme, group closure
    is not required by the math above).
    """
    if isinstance(transform_type, TransformGroup):
        return transform_type
    ndim = len(atom_shape)
    if transform_type == 'shift':
        return None
    if transform_type not in TRANSFORM_TYPES:
        raise ValueError(
            f'unknown transform type {transform_type!r}; '
            f'choose one of {TRANSFORM_TYPES} or pass a TransformGroup')
    if 'rot90' in transform_type:
        if ndim < 2:
            raise ValueError(
                f'{transform_type!r} needs >= 2 shift dimensions '
                f'(atoms of shape {atom_shape} cannot be quarter-turned)')
        if atom_shape[-1] != atom_shape[-2]:
            raise ValueError(
                f'{transform_type!r} requires square atoms in the rotation '
                f'plane (the last two atom axes), got {atom_shape}')
    if transform_type == 'shift+flip':
        # the full mirror group: one element per subset of flipped axes
        # (2^ndim elements; identity first)
        subsets = chain.from_iterable(
            combinations(range(ndim), r) for r in range(ndim + 1))
        elements = tuple((0, s) for s in subsets)
    elif transform_type == 'shift+rot90':
        elements = tuple((k, ()) for k in range(4))   # the C4 rotations
    else:  # 'shift+rot90+flip' — the dihedral group D4 (8 elements); only
        # the last axis is flipped: flipping both axes equals a 180-degree
        # rotation, which the k-range already covers
        elements = tuple((k, f) for f in ((), (ndim - 1,)) for k in range(4))
    return TransformGroup(name=transform_type, ndim=ndim, elements=elements)


def expand_w(W, group: TransformGroup):
    """Canonical dictionary -> tied copies: ``(M, C, *A) -> (M*G, C, *A)``
    with ``W_exp[m*G + g] = T_g(W[m])`` (m-major, matching the H layout)."""
    nd = group.ndim
    copies = [apply(W, e, 2, nd) for e in group.elements]
    We = jnp.stack(copies, axis=1)  # (M, G, C, *A)
    return We.reshape((W.shape[0] * group.size,) + W.shape[1:])


def tie_back(G_exp, group: TransformGroup):
    """Pull an expanded-dictionary gradient back onto the canonical atoms:
    ``(M*G, C, *A) -> (M, C, *A)`` via ``sum_g T_g^{-1}(grad[m, g])``."""
    nd = group.ndim
    g = group.size
    Gm = G_exp.reshape((G_exp.shape[0] // g, g) + G_exp.shape[1:])
    return sum(apply_inverse(Gm[:, i], e, 2, nd)
               for i, e in enumerate(group.elements))


class GroupOps:
    """Strategy adapter implementing the engine's operator contract
    (``prepare_data`` / ``reconstruct`` / ``grad_H_pair`` / ``grad_W_pair``)
    on top of a base strategy module, with the dictionary expansion and
    gradient tie-back folded around the base calls."""

    def __init__(self, base, group: TransformGroup):
        self.base = base
        self.group = group
        # the engine detects the phased lowering by the presence of
        # encode_h (engine._mu_H); forward it so the adapter composes with
        # the phase-blocked H carry too
        if hasattr(base, 'encode_h'):
            self.encode_h = base.encode_h
            self.decode_h = base.decode_h
        # forward the beta-divergence fast-path contract: the expansion /
        # tie-back wraps the base correlations exactly like the pairs
        self.FACTORS_IN_PREPARED = bool(
            getattr(base, 'FACTORS_IN_PREPARED', False))

    def inhibition_positive_term_phased(self, Hph, kernels, plan, n_atoms,
                                        *args, **kwargs):
        """Phased-layout inhibition; ``n_atoms`` arrives as the canonical
        count (W.shape[0]) but H carries one map per (atom, transform)."""
        return self.base.inhibition_positive_term_phased(
            Hph, kernels, plan, n_atoms * self.group.size, *args, **kwargs)

    def prepare_data(self, V, plan):
        return self.base.prepare_data(V, plan)

    def reconstruct(self, W, H, plan):
        return self.base.reconstruct(expand_w(W, self.group), H, plan)

    def grad_H_pair(self, Vp, R, W, plan):
        return self.base.grad_H_pair(Vp, R, expand_w(W, self.group), plan)

    def grad_W_pair(self, Vp, R, H, plan):
        neg, pos = self.base.grad_W_pair(Vp, R, H, plan)
        return tie_back(neg, self.group), tie_back(pos, self.group)

    # beta-divergence fast-path primitives (engine._beta_grad_H/_beta_grad_W)

    def corr_H(self, Xp, W, plan):
        return self.base.corr_H(Xp, expand_w(W, self.group), plan)

    def corr_W(self, Xp, H, plan):
        return tie_back(self.base.corr_W(Xp, H, plan), self.group)

    def grad_H_pair_prepared(self, Ap, Bp, W, plan):
        return self.base.grad_H_pair_prepared(
            Ap, Bp, expand_w(W, self.group), plan)

    def grad_W_pair_prepared(self, Ap, Bp, H, plan):
        neg, pos = self.base.grad_W_pair_prepared(Ap, Bp, H, plan)
        return tie_back(neg, self.group), tie_back(pos, self.group)
