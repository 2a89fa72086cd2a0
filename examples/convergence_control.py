"""Early stopping: the progress-callback protocol vs on-device ``tol``.

JAX counterpart of the reference's convergence_control example: the
``(model, iteration) -> bool`` callback inspects the reconstruction energy
every iteration and aborts the fit once it drops below a threshold.

A second fit shows the on-device alternative: ``fit(tol=...)`` runs the
convergence check inside one on-device ``lax.while_loop`` — a single
dispatch for the whole adaptive fit, where the callback protocol pays a
host round trip per iteration.
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
from tnmf_tpu.utils.signals import generate_pulse_train  # noqa: E402

# stop once the energy has dropped to this fraction of its starting value
RELATIVE_THRESHOLD = 0.05 if os.environ.get('TNMF_TPU_SMOKE') else 0.001


def main():
    np.random.seed(42)
    signal, W_true = generate_pulse_train(pulse_length=20, n_pulses=5)
    V = signal[np.newaxis]

    energies = []

    def progress_callback(nmf: TransformInvariantNMF, iteration: int) -> bool:
        e = nmf._energy_function()
        energies.append(e)
        print(f'iteration {iteration:4d}  energy {e:.6f}')
        return e > energies[0] * RELATIVE_THRESHOLD

    nmf = TransformInvariantNMF(n_atoms=len(W_true), atom_shape=(20,))
    nmf.fit(V, n_iterations=1000, progress_callback=progress_callback)

    print(f'stopped after {len(energies)} iterations at energy {energies[-1]:.6f}')

    # the same idea without any host round trips: sklearn-style tol, checked
    # on device every tol_check_every iterations inside one while_loop
    np.random.seed(42)
    nmf_tol = TransformInvariantNMF(n_atoms=len(W_true), atom_shape=(20,))
    nmf_tol.fit(V, n_iterations=1000, tol=1e-4, tol_check_every=10)
    print(f'tol=1e-4 fit stopped after {nmf_tol.n_iterations_} iterations '
          f'at energy {nmf_tol._energy_function():.6f}')

    # accelerate the same adaptive fit: extrapolated MU (multiplicative
    # momentum with on-device safeguard restarts) typically reaches the
    # tolerance in substantially fewer iterations, often at a lower energy
    np.random.seed(42)
    nmf_xtr = TransformInvariantNMF(n_atoms=len(W_true), atom_shape=(20,))
    nmf_xtr.fit(V, n_iterations=1000, tol=1e-4, tol_check_every=10,
                extrapolate=True)
    print(f'extrapolated tol fit stopped after {nmf_xtr.n_iterations_} '
          f'iterations at energy {nmf_xtr._energy_function():.6f}')

    plt.figure(figsize=(6, 4))
    plt.semilogy(energies)
    plt.axhline(energies[0] * RELATIVE_THRESHOLD, color='r', ls='--', label='threshold')
    plt.xlabel('iteration')
    plt.ylabel('energy')
    plt.legend()
    plt.tight_layout()
    plt.show()
    return energies


if __name__ == '__main__':
    main()
