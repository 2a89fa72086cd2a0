"""Classic (plain) NMF: racing the MU and HALS solvers.

With ``reconstruction_mode='full'`` and ``atom_shape == sample_shape`` the
shift axis degenerates and the model IS standard NMF (``V ~ H @ W``) — the
engine lowers every update to matmuls (the ``dot`` strategy, see
:mod:`tnmf_tpu.ops.dot`).  In that geometry two solvers are available:

* ``solver='mu'`` (default): Lee–Seung multiplicative updates — the
  reference's algorithm (``TransformInvariantNMF.py:136-179``), optionally
  accelerated with ``extrapolate=True``;
* ``solver='hals'``: exact block coordinate descent (fast HALS — the
  algorithm behind sklearn's ``NMF(solver='cd')``, pinned trajectory-exact
  against it in ``tests/test_hals.py``), which typically needs far fewer
  iterations and cannot strand zeroed atoms.

This script fits the same seeded low-rank data with MU, extrapolated MU,
and HALS, compares the energy trajectories, and then uses the fitted HALS
dictionary to encode held-out data (``transform(solver='hals')``).
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

N_ITERATIONS = 20 if os.environ.get('TNMF_TPU_SMOKE') else 150
N_SAMPLES, N_FEATURES, N_COMPONENTS = 128, 192, 8


#: the ground-truth generative dictionary, shared by train and held-out
#: draws so the learned atoms can actually explain the held-out samples
_W_TRUE = np.random.default_rng(7).random((N_COMPONENTS, N_FEATURES))


def make_data(seed=0):
    """Nonnegative rank-``N_COMPONENTS`` data (n_samples, 1, n_features)
    drawn from the shared ground-truth dictionary."""
    rng = np.random.default_rng(seed)
    X = rng.random((N_SAMPLES, N_COMPONENTS)) @ _W_TRUE
    return X.reshape(N_SAMPLES, 1, N_FEATURES).astype(np.float32)


def make_model():
    return TransformInvariantNMF(n_atoms=N_COMPONENTS,
                                 atom_shape=(N_FEATURES,),
                                 reconstruction_mode='full')


def main():
    V = make_data()

    runs = {}
    for label, kwargs in [('MU', {}), ('HALS', dict(solver='hals'))]:
        np.random.seed(42)  # identical starting factors for every solver
        nmf = make_model()
        nmf.fit(V, n_iterations=N_ITERATIONS, record_energies=True, **kwargs)
        runs[label] = np.asarray(nmf.energies_, np.float64)
        print(f'{label:16s} energy after {N_ITERATIONS} iterations: '
              f'{runs[label][-1]:.6f}')

    # race all three to the same tolerance (adaptive on-device while_loops
    # — extrapolated MU records no trace, so it joins the tol race only)
    for label, kwargs in [('MU', {}),
                          ('extrapolated MU', dict(extrapolate=True)),
                          ('HALS', dict(solver='hals'))]:
        np.random.seed(42)
        nmf = make_model()
        nmf.fit(V, n_iterations=20 * N_ITERATIONS, tol=1e-6,
                tol_check_every=5, **kwargs)
        print(f'{label:16s} tol=1e-6 reached after {nmf.n_iterations_:5d} '
              f'iterations (energy {nmf._energy_function():.6f})')

    # encode held-out data against the frozen HALS dictionary (exact
    # H-only coordinate sweeps — the serving path)
    V_new = make_data(seed=1)
    H_new = nmf.transform(V_new, n_iterations=50, solver='hals')
    R = H_new.reshape(len(V_new), -1) @ nmf.W.reshape(N_COMPONENTS, -1)
    rel = np.linalg.norm(V_new.reshape(len(V_new), -1) - R) \
        / np.linalg.norm(V_new)
    print(f'held-out encoding relative error: {rel:.4f}')

    plt.figure(figsize=(6, 4))
    for label, e in runs.items():
        plt.semilogy(e, label=label)
    plt.xlabel('iteration')
    plt.ylabel('energy')
    plt.title('Plain NMF: solver comparison from the same start')
    plt.legend()
    plt.tight_layout()
    plt.show()
    return runs


if __name__ == '__main__':
    main()
