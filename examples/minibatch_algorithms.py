"""Convergence / wall-clock comparison of the five minibatch MU algorithms.

JAX counterpart of the reference's minibatch_algorithms example.  The
reference used an ECG recording (scipy.misc.electrocardiogram, no longer
downloadable offline); here the sample set is a stack of synthetic
multi-channel pulse trains with the same structure: many short 1-D samples
sharing a common dictionary.
"""

import os
import sys
from time import process_time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import matplotlib  # noqa: E402

if os.environ.get('DISPLAY', '') == '' and os.environ.get('MPLBACKEND', '') == '':
    matplotlib.use('Agg')
import matplotlib.pyplot as plt  # noqa: E402

from tnmf_tpu import MiniBatchAlgorithm, TransformInvariantNMF  # noqa: E402
from tnmf_tpu.utils.signals import generate_pulse_train  # noqa: E402

ENERGY_THRESHOLD = 50.0
MAX_EPOCHS = 5 if os.environ.get('TNMF_TPU_SMOKE') else 40


def make_samples(n_samples: int = 30) -> np.ndarray:
    np.random.seed(42)
    return np.stack([
        generate_pulse_train(pulse_length=20, n_pulses=3)[0] for _ in range(n_samples)])


def run(V: np.ndarray, algorithm):
    energies, times = [], []

    def cb(nmf, epoch) -> bool:
        energies.append(nmf._energy_function())
        times.append(process_time())
        return energies[-1] > ENERGY_THRESHOLD

    np.random.seed(7)
    nmf = TransformInvariantNMF(n_atoms=5, atom_shape=(20,))
    t0 = process_time()
    if algorithm is None:
        nmf.fit(V, n_iterations=MAX_EPOCHS, progress_callback=cb)
    else:
        nmf.fit(V, algorithm=algorithm, batch_size=5, n_epochs=MAX_EPOCHS,
                sag_lambda=0.8, progress_callback=cb)
    return energies, [t - t0 for t in times]


def main():
    V = make_samples()
    runs = {'full batch': run(V, None)}
    for algorithm in MiniBatchAlgorithm:
        runs[algorithm.name] = run(V, algorithm)

    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    for name, (energies, times) in runs.items():
        print(f'{name:12s} epochs={len(energies):3d} final_energy={energies[-1]:10.3f} '
              f'cpu_time={times[-1]:6.2f}s')
        axes[0].semilogy(energies, label=name)
        axes[1].semilogy(times, energies, label=name)
    axes[0].set_xlabel('epoch')
    axes[1].set_xlabel('process time [s]')
    for ax in axes:
        ax.set_ylabel('energy')
        ax.legend(fontsize=8)
    fig.tight_layout()
    plt.show()
    return runs


if __name__ == '__main__':
    main()
