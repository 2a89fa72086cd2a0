"""Shift-invariant decomposition of a 2-D block image with lateral inhibition.

JAX counterpart of the reference example of the same name: learns a
patch dictionary of a synthetic block image in 'circular' reconstruction
mode with same-atom inhibition, then plots the learned atoms against the
ground-truth patches and the reconstruction.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import matplotlib  # noqa: E402

if os.environ.get('DISPLAY', '') == '' and os.environ.get('MPLBACKEND', '') == '':
    matplotlib.use('Agg')
import matplotlib.pyplot as plt  # noqa: E402

from tnmf_tpu import TransformInvariantNMF  # noqa: E402
from tnmf_tpu.utils.signals import generate_block_image  # noqa: E402


def main(n_iterations: int = None):
    if n_iterations is None:
        n_iterations = 10 if os.environ.get('TNMF_TPU_SMOKE') else 100
    np.random.seed(42)

    # synthesize a 5x5-patch image from three grayscale symbols
    image, W_true = generate_block_image(symbols=['+', 'x', 's'], symbol_size=10, n_symbols=5)
    V = image[np.newaxis]

    nmf = TransformInvariantNMF(
        n_atoms=len(W_true),
        atom_shape=W_true.shape[-2:],
        reconstruction_mode='circular',
        verbose=2,
    )
    nmf.fit(V, n_iterations=n_iterations, inhibition_strength=0.01)
    print(f'final energy: {nmf._energy_function():.4f}')

    # quantitative ground-truth recovery: shift-invariant optimal matching
    # of the learned atoms onto the generating dictionary (the reference's
    # examples can only eyeball the atom plots)
    from tnmf_tpu.utils.atoms import match_dictionaries
    rec = match_dictionaries(nmf.W, W_true)
    print(f'dictionary recovery score: {rec["score"]:.3f} '
          f'(assignment {rec["assignment"].tolist()})')

    n = nmf.n_atoms
    fig, axes = plt.subplots(2, n, figsize=(2 * n, 4))
    for i in range(n):
        axes[0, i].imshow(W_true[i, 0], cmap='gray')
        axes[0, i].set_title(f'true atom {i}')
        axes[1, i].imshow(nmf.W[i, 0], cmap='gray')
        axes[1, i].set_title(f'learned atom {i}')
        for ax in axes[:, i]:
            ax.axis('off')
    fig.tight_layout()

    fig, axes = plt.subplots(1, 2, figsize=(8, 4))
    axes[0].imshow(np.moveaxis(V[0], 0, -1) if V.shape[1] == 3 else V[0, 0], cmap='gray')
    axes[0].set_title('input')
    axes[1].imshow(np.moveaxis(nmf.R[0], 0, -1) if V.shape[1] == 3 else nmf.R[0, 0], cmap='gray')
    axes[1].set_title('reconstruction')
    for ax in axes:
        ax.axis('off')
    fig.tight_layout()
    plt.show()
    return nmf


if __name__ == '__main__':
    main()
