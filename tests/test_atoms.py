"""Dead-atom detection and revival (tnmf_tpu.utils.atoms).

MU's absorbing zero state: an atom with an all-zero activation map can
never recover (the update multiplies by H itself). The revival utility
re-draws exactly the dead atoms and their maps so a keep_W/keep_H refit
continues with the full dictionary live.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tnmf_tpu import TransformInvariantNMF
from tnmf_tpu.utils.atoms import find_dead_atoms, revive_dead_atoms


def _V(shape=(3, 1, 12, 12), seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _kill_atom(nmf, m):
    H = np.asarray(nmf._H).copy()
    H[:, m] = 0.0
    nmf._H = jnp.asarray(H, dtype=nmf._H.dtype)


def test_find_and_revive_dead_atom():
    V = _V()
    nmf = TransformInvariantNMF(n_atoms=3, atom_shape=(3, 3), seed=5)
    nmf.fit(V, n_iterations=3)
    assert find_dead_atoms(nmf).size == 0

    _kill_atom(nmf, 1)
    np.testing.assert_array_equal(find_dead_atoms(nmf), [1])
    W_before = nmf.W

    dead = revive_dead_atoms(nmf)
    np.testing.assert_array_equal(dead, [1])
    W_after = nmf.W
    # only the dead atom was re-drawn; the others are untouched
    np.testing.assert_array_equal(W_after[0], W_before[0])
    np.testing.assert_array_equal(W_after[2], W_before[2])
    assert not np.allclose(W_after[1], W_before[1])
    np.testing.assert_allclose(W_after[1].sum(), 1.0, rtol=1e-6)
    assert find_dead_atoms(nmf).size == 0  # H maps are live again

    # zero is absorbing without revival: a keep_W/keep_H refit keeps the
    # revived atom alive, whereas the killed atom would have stayed at 0
    nmf.fit(V, n_iterations=3, keep_W=True, keep_H=True)
    assert find_dead_atoms(nmf).size == 0


def test_absorbing_state_without_revival():
    V = _V()
    nmf = TransformInvariantNMF(n_atoms=3, atom_shape=(3, 3), seed=5)
    nmf.fit(V, n_iterations=2)
    _kill_atom(nmf, 2)
    nmf.fit(V, n_iterations=3, keep_W=True, keep_H=True)
    np.testing.assert_array_equal(find_dead_atoms(nmf), [2])  # still dead


def test_fit_revive_every_self_heals():
    """fit(revive_every=k) escapes the absorbing state mid-fit — the same
    start as test_absorbing_state_without_revival ends with every atom
    live."""
    V = _V()
    nmf = TransformInvariantNMF(n_atoms=3, atom_shape=(3, 3), seed=5)
    nmf.fit(V, n_iterations=2)
    _kill_atom(nmf, 2)
    nmf.fit(V, n_iterations=6, keep_W=True, keep_H=True, revive_every=2)
    assert find_dead_atoms(nmf).size == 0
    assert np.isfinite(nmf.W).all() and (nmf.W >= 0).all()


def test_fit_revive_every_noop_when_all_alive():
    """With no dead atoms the revival hook must not perturb the trajectory:
    revive_every=k equals the plain fit exactly."""
    V = _V()
    a = TransformInvariantNMF(n_atoms=3, atom_shape=(3, 3), seed=5)
    a.fit(V, n_iterations=6, revive_every=2)
    b = TransformInvariantNMF(n_atoms=3, atom_shape=(3, 3), seed=5)
    b.fit(V, n_iterations=6)
    np.testing.assert_allclose(a.W, b.W, rtol=0, atol=0)
    np.testing.assert_allclose(a.H, b.H, rtol=0, atol=0)


def test_fit_revive_every_guard_rails():
    V = _V()
    nmf = TransformInvariantNMF(n_atoms=3, atom_shape=(3, 3), seed=5)
    with pytest.raises(ValueError, match='revive_every'):
        nmf.fit(V, revive_every=2, progress_callback=lambda m, i: True)
    with pytest.raises(ValueError, match='revive_every'):
        nmf.fit(V, revive_every=2, tol=1e-4)
    with pytest.raises(ValueError, match='update_H'):
        nmf.fit(V, revive_every=2, update_W=False)


def test_revival_is_reproducible_with_seed():
    V = _V()
    outs = []
    for _ in range(2):
        nmf = TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3), seed=9)
        nmf.fit(V, n_iterations=2)
        _kill_atom(nmf, 0)
        revive_dead_atoms(nmf)
        outs.append(nmf.W)
    np.testing.assert_array_equal(outs[0], outs[1])


def test_revival_under_mesh_matches_single_device():
    """Mesh-sharded revival: revive_every
    under a data-parallel mesh reproduces the single-device trajectory and
    preserves the factor shardings across the host round-trip, so the
    following fused chunks reuse the compiled sharded program."""
    import jax
    from tnmf_tpu.parallel import DATA_AXIS, make_mesh
    if jax.device_count() < 8:
        pytest.skip('needs 8 (virtual) devices')
    V = _V(shape=(8, 1, 12, 12)).astype(np.float64)

    def kill(nmf, m):
        H = np.asarray(nmf._H).copy()
        H[:, m] = 0.0
        Hd = jnp.asarray(H, dtype=nmf._H.dtype)
        nmf._H = jax.device_put(Hd, nmf._H.sharding)

    results = []
    for mesh in (None, make_mesh(8)):
        nmf = TransformInvariantNMF(n_atoms=3, atom_shape=(3, 3), seed=5,
                                    mesh=mesh)
        nmf.fit(V, n_iterations=2)
        kill(nmf, 2)
        assert find_dead_atoms(nmf).size == 1
        nmf.fit(V, n_iterations=6, keep_W=True, keep_H=True, revive_every=2)
        assert find_dead_atoms(nmf).size == 0
        results.append((nmf.W, nmf.H, nmf))
    (Ws, Hs, _), (Wm, Hm, meshed) = results
    np.testing.assert_allclose(Wm, Ws, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(Hm, Hs, rtol=1e-8, atol=1e-10)
    # the revival kept H distributed on the data axis
    assert meshed._H.sharding.spec[0] == DATA_AXIS
    assert len(meshed._H.devices()) == 8


def test_transform_group_atom_mass_and_revival():
    V = _V()
    nmf = TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3), seed=3,
                                transform_type='shift+flip')
    nmf.fit(V, n_iterations=2)
    g = nmf.n_transforms
    assert g == 4
    # kill every tied map of canonical atom 0
    H = np.asarray(nmf._H).copy()
    H[:, 0:g] = 0.0
    nmf._H = jnp.asarray(H, dtype=nmf._H.dtype)
    np.testing.assert_array_equal(find_dead_atoms(nmf), [0])
    revive_dead_atoms(nmf)
    assert find_dead_atoms(nmf).size == 0


def test_errors_and_noop():
    nmf = TransformInvariantNMF(n_atoms=2, atom_shape=(3, 3))
    with pytest.raises(RuntimeError, match='fitted'):
        find_dead_atoms(nmf)
    V = _V()
    nmf.fit(V, n_iterations=2)
    W = nmf.W
    assert revive_dead_atoms(nmf).size == 0
    np.testing.assert_array_equal(nmf.W, W)  # no-op when nothing is dead


# ---------------------------------------------------------------------------
# dictionary comparison / recovery scoring
# ---------------------------------------------------------------------------

def test_atom_similarity_invariances():
    from tnmf_tpu.utils.atoms import atom_similarity
    rng = np.random.default_rng(0)
    a = np.zeros((1, 7, 7))
    a[0, 1:4, 1:4] = rng.random((3, 3))

    assert atom_similarity(a, a) == pytest.approx(1.0)
    assert atom_similarity(a, 3.5 * a) == pytest.approx(1.0)      # scale
    assert atom_similarity(a, np.roll(a, (2, 3), (1, 2))) == pytest.approx(1.0)  # shift
    b = np.asarray(np.flip(a, axis=2))
    s_shift = atom_similarity(a, b)                               # flip: < 1
    assert s_shift < 0.999
    assert atom_similarity(a, b, 'shift+flip') == pytest.approx(1.0)
    r = np.rot90(a, 1, axes=(1, 2))
    assert atom_similarity(a, r, 'shift+rot90') == pytest.approx(1.0)
    # different atom shapes are allowed
    wide = np.zeros((1, 5, 11)); wide[0, 1:4, 4:7] = a[0, 1:4, 1:4]
    assert atom_similarity(a, wide) == pytest.approx(1.0)
    assert atom_similarity(a, np.zeros((1, 5, 5))) == 0.0


def test_match_dictionaries_recovers_permuted_shifted_copies():
    from tnmf_tpu.utils.atoms import match_dictionaries
    rng = np.random.default_rng(1)
    W_true = np.zeros((4, 2, 7, 7))
    W_true[:, :, 2:5, 2:5] = rng.random((4, 2, 3, 3))  # interior support:
    perm = np.asarray([2, 0, 3, 1])                    # rolling = shifting
    W_learned = np.stack([
        1.7 * np.roll(W_true[j], (1, -2), (1, 2)) for j in perm])
    res = match_dictionaries(W_learned, W_true)
    np.testing.assert_array_equal(res['assignment'], perm)
    np.testing.assert_allclose(res['scores'], 1.0, atol=1e-12)
    # unrelated noise dictionaries score clearly lower than copies
    noise = match_dictionaries(rng.random((4, 2, 7, 7)), W_true)
    assert noise['score'] < res['score']
    # rectangular: more learned atoms than true ones
    res2 = match_dictionaries(W_true, W_learned[:3])
    assert (res2['assignment'] == -1).sum() == 1  # one true atom unmatched
