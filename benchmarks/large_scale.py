"""Large-batch conv-NMF throughput on one device (the single-device slice
of BASELINE.md's scale config; the multi-device path is checked by
``chip_smoke.py --chips 4`` and examples/data_parallel_fit.py).

Everything (data, init, loop) lives on device so the timing measures
compute, not host<->device transfers.

    python benchmarks/large_scale.py [n_samples]
"""

import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tnmf_tpu import engine  # noqa: E402
from tnmf_tpu.ops.modes import ConvPlan  # noqa: E402


def run(n_samples=64, sample=(256, 256), atom=(9, 9), n_atoms=16, n_channels=1,
        dtype='float32', strategy='conv', iters=(20, 120),
        inhibition=0.0, label='', resolve=True, mode='valid',
        update_W=True, transform_type=None, masked=False, beta=2.0):
    plan = ConvPlan.create(mode, sample, atom)
    group = None
    if transform_type:  # tied transform-invariant dictionary (ops/transforms)
        from tnmf_tpu.ops import transforms as tr
        group = tr.make_group(transform_type, atom)
    n_maps = n_atoms * (group.size if group else 1)
    if resolve:  # the model's strategy resolution (phased upgrade on a GPU)
        strategy = engine.resolve_strategy(strategy, plan, n_maps, n_channels)
    if group is not None:
        strategy = (strategy, group)
    dt = jnp.dtype(dtype)
    key = jax.random.PRNGKey(0)
    kv, ki = jax.random.split(key)
    V = jax.jit(lambda k: jax.random.uniform(k, (n_samples, n_channels) + sample, dt))(kv)
    W0, H0 = engine.init_matrices(
        ki, w_shape=(n_atoms, n_channels) + atom,
        h_shape=(n_samples, n_maps) + plan.transform_shape,
        n_shift_axes=plan.ndim, dtype=dt)

    mask = None
    if masked:  # per-entry missing-data mask (~30% zeros), on device
        km = jax.random.PRNGKey(7)
        mask = (jax.random.uniform(km, V.shape) > 0.3).astype(dt)
        V = V * mask
    if beta == 2.0 or (mask is None and engine.beta_prepares_data(strategy)):
        Vp = engine.prepare_data(V, plan=plan, strategy=strategy)
    else:
        Vp = V  # fft / masked beta losses consume the canonical tensor
    z = jnp.zeros((), dt)
    kernels = ()
    if inhibition:
        from tnmf_tpu.ops.inhibition import inhibition_kernels, resolve_inhibition_range
        kernels = tuple(jnp.asarray(k, dt)
                        for k in inhibition_kernels(resolve_inhibition_range(None, atom)))
    statics = dict(plan=plan, strategy=strategy, update_H=True,
                   update_W=update_W,
                   use_inhibition=bool(inhibition), use_cross=False,
                   beta=float(beta))

    def go(n):
        # fit_loop donates W/H: clone on device (cheap) instead of re-uploading
        Wn, _ = engine.fit_loop(Vp, W0 + 0, H0 + 0, n, z, jnp.asarray(inhibition, dt),
                                z, kernels, mask, **statics)
        return float(np.asarray(Wn.astype(jnp.float32)).sum())

    go(2)  # compile + settle
    n1, n2 = iters
    t0 = time.perf_counter()
    go(n1)
    t1 = time.perf_counter()
    go(n2)
    t2 = time.perf_counter()
    per_iter = ((t2 - t1) - (t1 - t0)) / (n2 - n1)
    if per_iter <= 0:  # scheduler noise swamped the subtraction
        per_iter = (t2 - t1) / n2
    px = n_samples * n_channels * math.prod(sample)
    if isinstance(strategy, tuple):
        strategy = f'{strategy[0]}*{strategy[1].size}'
    print(f'{dtype:9s} {strategy:5s} N={n_samples:4d} {sample}x{atom}{label}: '
          f'{per_iter * 1e3:8.2f} ms/iter  {1 / per_iter:8.2f} it/s  '
          f'{px / per_iter / 1e9:6.2f} Gpx/s', flush=True)
    return per_iter


def run_multiscale(n_samples=64, sample=(256, 256), atoms=((9, 9), (5, 5)),
                   n_atoms=(12, 4), n_channels=1, dtype='float32',
                   iters=(20, 120), resolve=True, label=''):
    """Multi-scale fused fit loop at the channel-poor scale config.  With
    ``resolve`` the per-scale strategies upgrade exactly like the
    single-scale model (phased on a GPU); without, both scales run the
    plain conv lowering."""
    from tnmf_tpu.models import multiscale as ms
    plans = tuple(ConvPlan.create('valid', sample, a) for a in atoms)
    if resolve:
        strategies = tuple(
            engine.resolve_strategy('auto', p, m, n_channels, allow_dot=False)
            for p, m in zip(plans, n_atoms))
    else:
        strategies = ('conv',) * len(plans)
    dt = jnp.dtype(dtype)
    keys = jax.random.split(jax.random.PRNGKey(0), 1 + len(atoms))
    V = jax.jit(lambda k: jax.random.uniform(
        k, (n_samples, n_channels) + sample, dt))(keys[0])
    Ws, Hs = [], []
    for i, (m, a, p) in enumerate(zip(n_atoms, atoms, plans)):
        W0, H0 = engine.init_matrices(
            keys[1 + i], w_shape=(m, n_channels) + a,
            h_shape=(n_samples, m) + p.transform_shape,
            n_shift_axes=p.ndim, dtype=dt)
        Ws.append(W0)
        Hs.append(H0)
    Ws, Hs = tuple(Ws), tuple(Hs)
    Vps = tuple(engine.prepare_data(V, plan=p, strategy=s)
                for p, s in zip(plans, strategies))
    sp = tuple(jnp.zeros((), dt) for _ in plans)
    statics = dict(plans=plans, strategies=strategies, update_H=True,
                   update_W=True, beta=2.0)

    def go(n):
        Wn, _ = ms.ms_fit_loop(V, Vps, tuple(w + 0 for w in Ws),
                               tuple(h + 0 for h in Hs), n, sp, None,
                               **statics)
        return float(np.asarray(Wn[0].astype(jnp.float32)).sum())

    go(2)  # compile + settle
    n1, n2 = iters
    t0 = time.perf_counter()
    go(n1)
    t1 = time.perf_counter()
    go(n2)
    t2 = time.perf_counter()
    per_iter = ((t2 - t1) - (t1 - t0)) / (n2 - n1)
    if per_iter <= 0:
        per_iter = (t2 - t1) / n2
    px = n_samples * n_channels * math.prod(sample)
    strat = '+'.join(strategies)
    print(f'{dtype:9s} multiscale[{strat}] N={n_samples:4d} '
          f'{sample}x{"x".join(str(a) for a in atoms)}{label}: '
          f'{per_iter * 1e3:8.2f} ms/iter  {1 / per_iter:8.2f} it/s  '
          f'{px / per_iter / 1e9:6.2f} Gpx/s', flush=True)
    return per_iter


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    for dtype in ('float32', 'bfloat16'):
        run(n_samples=n, dtype=dtype, strategy='conv')           # phased on a GPU
    run(n_samples=n, strategy='conv', resolve=False, label=' (plain conv)')
    # lateral inhibition at scale: the banded-matmul chain
    run(n_samples=n, inhibition=0.1, label=' +inhibition')
    # the reference fixture scale, for continuity with bench.py
    run(n_samples=2, sample=(76, 102), atom=(7, 7), n_atoms=10, n_channels=3,
        iters=(200, 1200))
    # transform-group adapter at equal map count: 4 canonical atoms tied
    # across the 4 mirror flips carry the same 16 activation maps as the
    # plain 16-atom row above — invariance should cost ~nothing per
    # iteration (the expand/tie ops touch only the tiny W)
    run(n_samples=n, n_atoms=4, transform_type='shift+flip',
        label=' flip-tied 4x4 maps')
    # masked objective: one extra fused V-shaped elementwise multiply per
    # gradient pair — should cost a few percent at most
    run(n_samples=n, masked=True, label=' masked (30% missing)')
    # beta-divergence objectives at scale: KL (beta=1) runs prepared-domain
    # factors + batch-1 denominators (engine._beta_grad_H/_beta_grad_W), IS
    # (beta=0) prepared-domain factors + stacked pairs — both should land
    # within ~1.5x of the Euclidean iteration
    for dtype in ('float32', 'bfloat16'):
        run(n_samples=n, dtype=dtype, beta=1.0, label=' KL (beta=1)')
    run(n_samples=n, beta=0.0, label=' IS (beta=0)')
    # serving path: transform() = H inference with the dictionary frozen
    # (update_W=False) — the per-iteration cost of encoding new data
    # against a trained model
    run(n_samples=n, update_W=False, label=' serving (W frozen)')
    # 3-D volumetric factorization (the reference supports n-D only via
    # its NumPy backends; PyTorch caps at rank 3 — PyTorch.py:30-33).
    # On a GPU the conv row resolves to the phased lowering, so this
    # measures phased vs fft at rank 3 (benchmarks/lowering.py geometries
    # times plain conv beside both)
    for strat in ('conv', 'fft'):
        run(n_samples=8, sample=(64, 64, 64), atom=(5, 5, 5), n_atoms=8,
            n_channels=1, strategy=strat, iters=(10, 60),
            label=f' 3-D volume [{strat}]')
    # multi-scale banks at the channel-poor scale config: per-scale
    # strategy resolution (phased on a GPU) vs plain conv
    run_multiscale(n_samples=n, label=' (resolved)')
    run_multiscale(n_samples=n, resolve=False, label=' (plain conv)')
    # long-1-D fft strategy: per-sample cost should scale ~linearly from
    # the 4k row to the 16k row
    for L in (4000, 16000):
        run(n_samples=16, sample=(L,), atom=(64,), n_atoms=8, n_channels=1,
            strategy='fft', iters=(20, 120), label=f' 1D-fft L={L}')


if __name__ == '__main__':
    from tnmf_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    main()
