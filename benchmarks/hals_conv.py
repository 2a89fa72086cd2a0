"""Shift-invariant exact CD (engine_hals_conv) vs MU vs extrapolated MU.

The round-5 question: does exact phase-blocked coordinate descent beat
(extrapolated) multiplicative updates on the shift-invariant 'full'
geometry in *wall-clock to tolerance* on the accelerator?  Three solvers race from
the SAME seeded start with the same on-device tol protocol
((e_prev - e)/e_init < tol per check block); reported per solver:
ms/iteration, iterations to stop, seconds to stop, and the final
objective.

    python benchmarks/hals_conv.py [n_samples]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tnmf_tpu import engine, engine_hals_conv as ehc  # noqa: E402
from tnmf_tpu.ops.modes import ConvPlan  # noqa: E402


def race(n=16, sample=(128, 128), atom=(8, 8), m=16, c=1, tol=1e-5,
         n_max=2000, check=10, dtype='float32'):
    dt = jnp.dtype(dtype)
    plan = ConvPlan.create('full', sample, atom)
    kv, km, kh = jax.random.split(jax.random.PRNGKey(0), 3)
    # planted structure so "converged" is meaningful (pure noise converges
    # almost immediately at high energy); mask and values use DISTINCT
    # keys — an earlier draft reused one key, which makes both uniforms
    # identical so every surviving activation equals its own >0.95 mask
    # draw (5%-dense but values only in (0.95, 1], not uniform)
    Wt = jax.random.uniform(kv, (m, c) + atom, dt)
    Ht = jnp.where(jax.random.uniform(km, (n, m) + plan.transform_shape) > 0.95,
                   jax.random.uniform(kh, (n, m) + plan.transform_shape, dt), 0)
    from tnmf_tpu.ops import conv
    V = conv.reconstruct(Wt, Ht, plan) + 0.01 * jax.random.uniform(
        jax.random.PRNGKey(2), (n, c) + plan.sample_shape, dt)
    W0, H0 = engine.init_matrices(
        jax.random.PRNGKey(3), w_shape=(m, c) + atom,
        h_shape=(n, m) + plan.transform_shape, n_shift_axes=plan.ndim,
        dtype=dt)

    strategy = engine.resolve_strategy('conv', plan, m, c)
    Vp = engine.prepare_data(V, plan=plan, strategy=strategy)
    z = jnp.asarray(0.0, dt)
    tol_a = jnp.asarray(tol, jnp.float32)
    nm = jnp.asarray(n_max, jnp.int32)
    results = {}

    def timed(label, fn, per_iter_probe):
        fn(jnp.asarray(2, jnp.int32), jnp.asarray(0.0, jnp.float32))  # compile
        t0 = time.perf_counter()
        n_done, e = fn(nm, tol_a)
        dt_s = time.perf_counter() - t0
        it_ms = per_iter_probe()
        results[label] = (it_ms, int(n_done), dt_s, float(e))
        print(f'{label:18s} {it_ms:8.2f} ms/iter  stopped at {int(n_done):5d}'
              f'  {dt_s:7.2f} s  final E = {float(e):.5f}', flush=True)

    # --- plain MU ---------------------------------------------------------
    statics = dict(plan=plan, strategy=strategy, update_H=True, update_W=True,
                   use_inhibition=False, use_cross=False)

    def mu(nmx, tl):
        W, H, n_done, e, _ = engine.fit_loop_tol(
            Vp, V, W0 + 0, H0 + 0, nmx, tl, z, z, z, (),
            check_every=check, **statics)
        return int(np.asarray(n_done)), float(np.asarray(e))

    def mu_probe(k=200):
        # np.asarray forces completion
        np.asarray(engine.fit_loop(Vp, W0 + 0, H0 + 0, 2, z, z, z, (),
                                   **statics)[0].sum())
        t0 = time.perf_counter()
        np.asarray(engine.fit_loop(Vp, W0 + 0, H0 + 0, k, z, z, z, (),
                                   **statics)[0].sum())
        return (time.perf_counter() - t0) / k * 1e3

    # --- extrapolated MU --------------------------------------------------
    def xtr(nmx, tl):
        W, H, n_done, e, _ = engine.fit_loop_extrapolated(
            Vp, V, W0 + 0, H0 + 0, nmx, tl, jnp.asarray(0.5, jnp.float32),
            z, z, z, (), check_every=check, **statics)
        return int(np.asarray(n_done)), float(np.asarray(e))

    # --- shift-invariant exact CD ----------------------------------------
    hstat = dict(inner=1, update_H=True, update_W=True, plan=plan)

    def hals(nmx, tl):
        W, H, n_done, e, _ = ehc.fit_loop_tol(
            V, W0 + 0, H0 + 0, nmx, tl, z, z, check_every=check, **hstat)
        return int(np.asarray(n_done)), float(np.asarray(e))

    def hals_probe(k=50):
        np.asarray(ehc.fit_loop(V, W0 + 0, H0 + 0, 2, z, z,
                                **hstat)[0].sum())  # compile
        t0 = time.perf_counter()
        np.asarray(ehc.fit_loop(V, W0 + 0, H0 + 0, k, z, z, **hstat)[0].sum())
        return (time.perf_counter() - t0) / k * 1e3

    def xtr_probe(k=200):
        # per-iteration cost of the extrapolated loop itself (tol=0 runs
        # exactly k iterations); an earlier draft reported mu_probe here,
        # i.e. plain MU's timing, for the extrapolated row
        def go(kk):
            W, H, n_done, e, _ = engine.fit_loop_extrapolated(
                Vp, V, W0 + 0, H0 + 0, jnp.asarray(kk, jnp.int32),
                jnp.asarray(0.0, jnp.float32),
                jnp.asarray(0.5, jnp.float32), z, z, z, (),
                check_every=check, **statics)
            np.asarray(W.sum())
        go(2)
        t0 = time.perf_counter()
        go(k)
        return (time.perf_counter() - t0) / k * 1e3

    print(f'race: n={n} {sample}x{atom} m={m} c={c} strategy={strategy} '
          f'tol={tol} [{dtype}]', flush=True)
    timed('mu', mu, mu_probe)
    timed('mu+extrapolate', xtr, xtr_probe)
    timed('hals-conv (exact)', hals, hals_probe)
    return results


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    race(n=n)
    race(n=n, sample=(512,), atom=(8,), m=8)


if __name__ == '__main__':
    from tnmf_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    main()
