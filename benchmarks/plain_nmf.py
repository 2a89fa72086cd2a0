"""Classic (plain) NMF throughput: the 'dot' matmul lowering vs the conv
lowering of the same degenerate geometry, and vs sklearn's
``NMF(solver='mu')`` on CPU (identical objective and update family).

The degenerate geometry — reconstruction mode 'full' with atom_shape ==
sample_shape — makes the transform axis a single offset, so the model IS
standard Lee-Seung NMF (``V[n,c,*S] ~ sum_m H[n,m] * W[m,c,*S]``); see
``tnmf_tpu/ops/dot.py``.  BASELINE.md's plain-NMF rows come from this
script.

    python benchmarks/plain_nmf.py            # benchmark-scale + production-scale
    python benchmarks/plain_nmf.py --small    # benchmark-scale config only
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tnmf_tpu import TransformInvariantNMF, engine  # noqa: E402


def fit_seconds(model, V, n_iterations, **kw):
    """End-to-end wall clock of one fit call (upload + fused loop +
    download), min over repetitions after a compile warm-up.  At
    sklearn-benchmark scale the per-iteration device cost is tiny next to
    launch and transfer overhead, so per-iteration rates mislead — the end-to-end
    fit is the honest comparison."""
    model.fit(V, n_iterations=n_iterations, **kw)  # compile + warm

    def timed():
        t0 = time.perf_counter()
        model.fit(V, n_iterations=n_iterations, **kw)
        return time.perf_counter() - t0

    return min(timed() for _ in range(3))


def bench_config(n, features, components, n_iterations, dtype='float32'):
    rng = np.random.default_rng(0)
    V = rng.random((n, 1, features)).astype(dtype)
    secs = {}
    for label, force_conv in [('dot', False), ('conv', True)]:
        m = TransformInvariantNMF(n_atoms=components, atom_shape=(features,),
                                  seed=1, reconstruction_mode='full')
        if force_conv:
            orig = engine.resolve_strategy
            engine.resolve_strategy = lambda s, *a, **k: 'conv'
            try:
                secs[label] = fit_seconds(m, V, n_iterations)
            finally:
                engine.resolve_strategy = orig
        else:
            secs[label] = fit_seconds(m, V, n_iterations)
        assert m._strategy == label
    return secs


def bench_device_loop(n, features, components, iters=(10, 110),
                      dtype='float32'):
    """Production-scale row: everything (data, init, loop) on device so the
    timing measures compute, not the ~270 MB per-fit upload (same
    methodology as benchmarks/large_scale.py)."""
    import jax
    import jax.numpy as jnp
    from tnmf_tpu.ops.modes import ConvPlan

    plan = ConvPlan.create('full', (features,), (features,))
    rates = {}
    dt = jnp.dtype(dtype)
    kv, ki = jax.random.split(jax.random.PRNGKey(0))
    V = jax.jit(lambda k: jax.random.uniform(k, (n, 1, features), dt))(kv)
    W0, H0 = engine.init_matrices(
        ki, w_shape=(components, 1, features),
        h_shape=(n, components) + plan.transform_shape,
        n_shift_axes=plan.ndim, dtype=dt)
    z = jnp.zeros((), dt)
    for strategy in ('dot', 'conv'):
        Vp = engine.prepare_data(V, plan=plan, strategy=strategy)
        statics = dict(plan=plan, strategy=strategy, update_H=True,
                       update_W=True, use_inhibition=False, use_cross=False)

        def go(k):
            Wn, _ = engine.fit_loop(Vp, W0 + 0, H0 + 0, k, z, z, z, (),
                                    None, **statics)
            return float(np.asarray(Wn.astype(jnp.float32)).sum())

        def timed(k):
            t0 = time.perf_counter()
            go(k)
            return time.perf_counter() - t0

        go(2)  # compile + settle
        n1, n2 = iters
        # min over repetitions cancels dispatch/scheduler noise, which can
        # swamp a single subtraction
        lo = min(timed(n1) for _ in range(3))
        hi = min(timed(n2) for _ in range(3))
        per_iter = (hi - lo) / (n2 - n1)
        if per_iter <= 0:
            per_iter = hi / n2
        rates[strategy] = 1.0 / per_iter
    return rates


def bench_sklearn(n, features, components, iters, solver='mu'):
    try:
        from sklearn.decomposition import NMF
    except ImportError:  # pragma: no cover
        return None
    rng = np.random.default_rng(0)
    X = rng.random((n, features))

    def timed():
        t0 = time.perf_counter()
        NMF(n_components=components, init='random', solver=solver,
            max_iter=iters, tol=0, random_state=0).fit(X)
        return time.perf_counter() - t0

    return min(timed() for _ in range(3))


def bench_hals(n, features, components, n_iterations):
    """End-to-end HALS fit at sklearn-benchmark scale (the comparison row
    for sklearn's NMF(solver='cd'), which is the same algorithm —
    tests/test_hals.py pins the trajectories equal)."""
    rng = np.random.default_rng(0)
    V = rng.random((n, 1, features)).astype('float32')
    m = TransformInvariantNMF(n_atoms=components, atom_shape=(features,),
                              seed=1, reconstruction_mode='full')
    return fit_seconds(m, V, n_iterations, solver='hals')


def bench_hals_device_loop(n, features, components, iters=(10, 110),
                           dtype='float32', inner=None):
    """Production-scale HALS outer-iterations/s, device-resident (same
    methodology as :func:`bench_device_loop`)."""
    import jax
    import jax.numpy as jnp
    from tnmf_tpu import engine_hals
    from tnmf_tpu.ops.modes import ConvPlan

    plan = ConvPlan.create('full', (features,), (features,))
    dt = jnp.dtype(dtype)
    kv, ki = jax.random.split(jax.random.PRNGKey(0))
    V = jax.jit(lambda k: jax.random.uniform(k, (n, 1, features), dt))(kv)
    W0, H0 = engine.init_matrices(
        ki, w_shape=(components, 1, features),
        h_shape=(n, components) + plan.transform_shape,
        n_shift_axes=plan.ndim, dtype=dt)
    inner = engine_hals.auto_inner(components, features, inner, n_samples=n)
    acc = jnp.promote_types(dt, jnp.float32)
    z = jnp.zeros((), acc)
    statics = dict(inner=inner, update_H=True, update_W=True, plan=plan)

    def go(k):
        Wn, _ = engine_hals.fit_loop(V, W0 + 0, H0 + 0, k, z, z, z, z,
                                     **statics)
        return float(np.asarray(Wn.astype(jnp.float32)).sum())

    def timed(k):
        t0 = time.perf_counter()
        go(k)
        return time.perf_counter() - t0

    go(2)
    n1, n2 = iters
    lo = min(timed(n1) for _ in range(3))
    hi = min(timed(n2) for _ in range(3))
    per_iter = (hi - lo) / (n2 - n1)
    if per_iter <= 0:  # pragma: no cover - timer noise floor
        per_iter = hi / n2
    return 1.0 / per_iter, inner


def hals_breakdown(n=16384, features=4096, components=256, dtype='float32'):
    """Where the HALS outer iteration goes: Grams vs sweeps vs inner reuse.

    The measurement behind the time-based ``auto_inner``: iteration cost
    at inner = 1, 2, 8 — the marginal cost per extra (H+W) sweep pair
    isolates the latency-bound Gauss-Seidel chains from the
    matmul/bandwidth-bound Grams.
    """
    rows = {}
    for inner in (1, 2, 8):
        rate, _ = bench_hals_device_loop(n, features, components,
                                         dtype=dtype, inner=inner)
        rows[inner] = 1000.0 / rate
    per_pair = (rows[8] - rows[1]) / 7
    grams = max(rows[1] - per_pair, 0.0)  # inner=1 = Grams + ONE sweep pair
    print(f'== HALS breakdown ({n} x {features}, {components} components, '
          f'{dtype}) ==')
    for inner, ms in rows.items():
        print(f'  inner={inner}: {ms:7.2f} ms/outer-iteration')
    print(f'  marginal (H+W) sweep pair: {per_pair:5.2f} ms '
          f'({per_pair / 2 / components * 1000:.1f} us per chain '
          f'step at m={components})')
    print(f'  implied Grams + overhead:  {grams:5.2f} ms '
          f'(sweeps dominate => time-based auto_inner picks 1 here)')


def main():
    if '--hals-breakdown' in sys.argv:
        hals_breakdown()
        return
    small_only = '--small' in sys.argv
    iters = 200

    print(f'== sklearn scale: 64 x 128, 8 components, {iters}-iteration '
          f'fit (end-to-end wall clock) ==')
    secs = bench_config(64, 128, 8, n_iterations=iters)
    sk = bench_sklearn(64, 128, 8, iters)
    for k, v in secs.items():
        print(f'  {k:5s}: {v * 1000:8.1f} ms')
    if sk:
        print(f'  sklearn NMF(solver=mu), CPU: {sk * 1000:8.1f} ms '
              f'(dot = {sk / secs["dot"]:.1f}x)')
    hals = bench_hals(64, 128, 8, n_iterations=iters)
    skcd = bench_sklearn(64, 128, 8, iters, solver='cd')
    print(f'  hals : {hals * 1000:8.1f} ms')
    if skcd:
        print(f'  sklearn NMF(solver=cd), CPU: {skcd * 1000:8.1f} ms '
              f'(hals = {skcd / hals:.1f}x)')

    if small_only:
        return

    print('== production scale (device-resident): 16384 x 4096, '
          '256 components ==')
    for dtype in ('float32', 'bfloat16'):
        rates = bench_device_loop(16384, 4096, 256, dtype=dtype)
        for k, v in rates.items():
            print(f'  {dtype:9s} {k:5s}: {v:8.2f} MU iters/s '
                  f'({1000 / v:.2f} ms/iter)')
        hv, inner = bench_hals_device_loop(16384, 4096, 256, dtype=dtype)
        print(f'  {dtype:9s} hals : {hv:8.2f} HALS iters/s '
              f'({1000 / hv:.2f} ms/iter, inner={inner})')


if __name__ == '__main__':
    from tnmf_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    main()
