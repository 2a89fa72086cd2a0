"""Lowering decisions timed on the GPU, through ``engine.fit_loop``.

Times the choices the lowering policy makes at the flagship deployment
(64 x 1 x 256 x 256 images, 16 atoms 9 x 9, mode 'valid') in float32 and
bfloat16: phased vs conv vs fft, and the conv output blocking on vs off;
then an fft-geometry row (33 x 33 atoms), the per-operator split of one
conv and one phased iteration with the XLA time of the H and W updates, the HALS
cost-model constants (``engine_hals.HALS_COSTS``), the conv/fft/phased
sweep behind ``engine.choose_strategy``, and conv/phased/fft at the 1-D,
3-D, multi-channel and many-map geometries the phased gate also accepts.
Refuses to run without a GPU.
Prints one JSON line per measurement and writes them all to
``chiprun_out/lowering.json``.

    JAX_PLATFORMS=cuda python benchmarks/lowering.py [section ...]
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tnmf_tpu import engine  # noqa: E402
from tnmf_tpu.ops import conv as conv_ops  # noqa: E402
from tnmf_tpu.ops.modes import ConvPlan  # noqa: E402

ROWS = []


def _emit(**row):
    ROWS.append(row)
    print(json.dumps(row), flush=True)


def _timed(fn, reps=5):
    """Median seconds of ``fn()`` (which blocks) over ``reps`` calls."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _per_iter(go):
    """Seconds per iteration of ``go(n)``: compile, pick n so a run takes
    ~0.3 s, then the median slope between n and 2n iterations."""
    go(2)
    t = _timed(lambda: go(8), reps=1)
    n = int(min(400, max(10, math.ceil(0.3 / max(t / 8, 1e-6)))))
    t1 = _timed(lambda: go(n), reps=3)
    t2 = _timed(lambda: go(2 * n), reps=3)
    return max(t2 - t1, 1e-9) / n


def fit_case(strategy, sample=(256, 256), atom=(9, 9), n_samples=64,
             n_atoms=16, n_channels=1, dtype='float32', inhibition=0.0,
             mode='valid'):
    plan = ConvPlan.create(mode, sample, atom)
    dt = jnp.dtype(dtype)
    kv, ki = jax.random.split(jax.random.PRNGKey(0))
    V = jax.jit(lambda k: jax.random.uniform(
        k, (n_samples, n_channels) + sample, dt))(kv)
    W0, H0 = engine.init_matrices(
        ki, w_shape=(n_atoms, n_channels) + atom,
        h_shape=(n_samples, n_atoms) + plan.transform_shape,
        n_shift_axes=plan.ndim, dtype=dt)
    Vp = engine.prepare_data(V, plan=plan, strategy=strategy)
    z = jnp.zeros((), dt)
    kernels = ()
    if inhibition:
        from tnmf_tpu.ops.inhibition import (inhibition_kernels,
                                             resolve_inhibition_range)
        kernels = tuple(jnp.asarray(k, dt) for k in inhibition_kernels(
            resolve_inhibition_range(None, atom)))
    statics = dict(plan=plan, strategy=strategy, update_H=True, update_W=True,
                   use_inhibition=bool(inhibition), use_cross=False)

    def go(n):
        Wn, _ = engine.fit_loop(Vp, W0 + 0, H0 + 0, n, z,
                                jnp.asarray(inhibition, dt), z, kernels,
                                **statics)
        Wn.block_until_ready()

    return _per_iter(go)


def op_case(name, fn, *args):
    f = jax.jit(fn)
    f(*args)[0].block_until_ready()

    def go():
        out = None
        for _ in range(20):
            out = f(*args)
        out[0].block_until_ready()

    return _timed(go) / 20


def _row(section, label, thunk, **extra):
    try:
        s = thunk()
        _emit(section=section, label=label, ms=round(s * 1e3, 4), **extra)
    except Exception as e:  # noqa: BLE001 - report the row, keep measuring
        _emit(section=section, label=label, error=f'{type(e).__name__}: '
              f'{str(e)[:300]}', **extra)


class _patch:
    def __init__(self, mod, name, value):
        self.mod, self.name, self.value = mod, name, value

    def __enter__(self):
        self.old = getattr(self.mod, self.name)
        setattr(self.mod, self.name, self.value)

    def __exit__(self, *a):
        setattr(self.mod, self.name, self.old)


def _no_blocking(out_shape, n_out_channels, atom_shape, target=64):
    return (1,) * len(out_shape)


def flagship():
    for dtype in ('float32', 'bfloat16'):
        _row('flagship', f'{dtype} conv blocked',
             lambda: fit_case('conv', dtype=dtype), dtype=dtype)
        with _patch(conv_ops, '_block_factors', _no_blocking):
            jax.clear_caches()
            _row('flagship', f'{dtype} conv unblocked',
                 lambda: fit_case('conv', dtype=dtype), dtype=dtype)
        jax.clear_caches()
        _row('flagship', f'{dtype} phased',
             lambda: fit_case('phased', dtype=dtype), dtype=dtype)
        _row('flagship', f'{dtype} fft',
             lambda: fit_case('fft', dtype=dtype), dtype=dtype)


def fft_geometry():
    kw = dict(atom=(33, 33))
    _row('fft-geometry', 'float32 256x256 33x33 conv',
         lambda: fit_case('conv', **kw))
    _row('fft-geometry', 'float32 256x256 33x33 fft',
         lambda: fit_case('fft', **kw))


def per_op(n=64, side=256):
    """One flagship conv iteration split by operator, plus the XLA time of
    the H and W updates a hand-written kernel would have to beat."""
    from tnmf_tpu.ops import phased
    from tnmf_tpu.ops.inhibition import (inhibition_kernels,
                                         resolve_inhibition_range)
    for dtype in ('float32', 'bfloat16'):
        dt = jnp.dtype(dtype)
        plan = ConvPlan.create('valid', (side, side), (9, 9))
        rng = jax.random.split(jax.random.PRNGKey(1), 3)
        V = jax.random.uniform(rng[0], (n, 1, side, side), dt)
        W = jax.random.uniform(rng[1], (16, 1, 9, 9), dt)
        H = jax.random.uniform(rng[2], (n, 16) + plan.transform_shape, dt)
        Vp = conv_ops.prepare_data(V, plan)
        R = conv_ops.reconstruct(W, H, plan)
        _row('per-op', f'{dtype} conv reconstruct', lambda: op_case(
            'rec', lambda W, H: (conv_ops.reconstruct(W, H, plan),), W, H))
        _row('per-op', f'{dtype} conv grad_H_pair', lambda: op_case(
            'gh', lambda Vp, R, W: conv_ops.grad_H_pair(Vp, R, W, plan),
            Vp, R, W))
        _row('per-op', f'{dtype} conv grad_W_pair', lambda: op_case(
            'gw', lambda Vp, R, H: conv_ops.grad_W_pair(Vp, R, H, plan),
            Vp, R, H))
        _row('per-op', f'{dtype} conv corr_W single', lambda: op_case(
            'cw', lambda Vp, H: (conv_ops.corr_W(Vp, H, plan),), Vp, H))
        with _patch(conv_ops, '_block_factors', _no_blocking):
            jax.clear_caches()
            _row('per-op', f'{dtype} conv reconstruct unblocked',
                 lambda: op_case('rec', lambda W, H: (
                     conv_ops.reconstruct(W, H, plan),), W, H))
            _row('per-op', f'{dtype} conv grad_H_pair unblocked',
                 lambda: op_case('gh', lambda Vp, R, W: conv_ops.grad_H_pair(
                     Vp, R, W, plan), Vp, R, W))
        jax.clear_caches()
        # the H and W updates as XLA compiles them
        ks = tuple(jnp.asarray(k, dt) for k in inhibition_kernels(
            resolve_inhibition_range(None, (9, 9))))
        s = jnp.asarray(0.1, dt)
        z = jnp.zeros((), dt)
        _row('xla-updates', f'{dtype} inhibited _mu_H (conv)',
             lambda: op_case('mh', lambda Vp, W, H: (engine._mu_H(
                 conv_ops, Vp, W, H, s, s, z, ks, plan=plan,
                 use_inhibition=True, use_cross=False),), Vp, W, H))
        _row('xla-updates', f'{dtype} _mu_W grad pair (conv)',
             lambda: op_case('mw', lambda Vp, W, H: (engine._mu_W(
                 conv_ops, Vp, W, H, plan=plan),), Vp, W, H))
        Vs = phased.prepare_data(V, plan)
        Hph = phased.encode_h(H, plan)
        _row('xla-updates', f'{dtype} _mu_H (phased)',
             lambda: op_case('mhp', lambda Vs, W, H: (engine._mu_H(
                 phased, Vs, W, H, s, z, z, (), plan=plan,
                 use_inhibition=False, use_cross=False),), Vs, W, Hph))
        _row('xla-updates', f'{dtype} inhibited fit iteration (conv)',
             lambda: fit_case('conv', dtype=dtype, inhibition=0.1,
                                  n_samples=n, sample=(side, side)))


def phased_ops(n=64, side=256):
    """One flagship phased iteration split by operator and update."""
    from tnmf_tpu.ops import phased
    for dtype in ('float32', 'bfloat16'):
        dt = jnp.dtype(dtype)
        plan = ConvPlan.create('valid', (side, side), (9, 9))
        rng = jax.random.split(jax.random.PRNGKey(1), 3)
        V = jax.random.uniform(rng[0], (n, 1, side, side), dt)
        W = jax.random.uniform(rng[1], (16, 1, 9, 9), dt)
        H = jax.random.uniform(rng[2], (n, 16) + plan.transform_shape, dt)
        Vs = phased.prepare_data(V, plan)
        Hph = phased.encode_h(H, plan)
        R = phased.reconstruct(W, Hph, plan)
        s = jnp.asarray(0.1, dt)
        z = jnp.zeros((), dt)
        rows = {
            'reconstruct': (lambda W, H: (phased.reconstruct(W, H, plan),),
                            W, Hph),
            'grad_H_pair': (lambda Vs, R, W: phased.grad_H_pair(
                Vs, R, W, plan), Vs, R, W),
            'grad_W_pair': (lambda Vs, R, H: phased.grad_W_pair(
                Vs, R, H, plan), Vs, R, Hph),
            '_mu_H': (lambda Vs, W, H: (engine._mu_H(
                phased, Vs, W, H, s, z, z, (), plan=plan,
                use_inhibition=False, use_cross=False),), Vs, W, Hph),
            '_mu_W': (lambda Vs, W, H: (engine._mu_W(
                phased, Vs, W, H, plan=plan),), Vs, W, Hph),
        }
        if phased.fused_rec_supported(plan, dt):
            rows['grad_H_pair_fused'] = (lambda Vs, W, H: phased.grad_H_pair_fused(
                Vs, W, H, plan), Vs, W, Hph)
            rows['grad_W_pair_fused'] = (lambda Vs, W, H: phased.grad_W_pair_fused(
                Vs, W, H, plan), Vs, W, Hph)
        for name, (fn, *args) in rows.items():
            _row('phased-ops', f'{dtype} phased {name}',
                 lambda: op_case(name, fn, *args))


def sweep():
    """conv vs fft (and phased where it applies) across sample and atom
    sizes: the data behind ``choose_strategy``'s threshold."""
    from tnmf_tpu.ops import phased
    for side in (64, 128, 256):
        for a in (7, 9, 15, 21, 25, 33):
            if a > side // 2:
                continue
            plan = ConvPlan.create('valid', (side, side), (a, a))
            for strategy in ('conv', 'fft', 'phased'):
                if strategy == 'phased' and not phased.applicable(plan, 1, 16):
                    continue
                _row('sweep', f'{side}x{side} atom {a}x{a} {strategy}',
                     lambda: fit_case(strategy, sample=(side, side),
                                      atom=(a, a), n_samples=16),
                     side=side, atom=a, strategy=strategy)
            jax.clear_caches()


#: geometries outside the 2-D single-channel sweep where the phased gate
#: applies: (label, fit_case kwargs)
OFF_SWEEP = [
    ('1-D 16x1x4096 atom 9, 16 atoms',
     dict(sample=(4096,), atom=(9,), n_samples=16)),
    ('1-D 16x1x16000 atom 9, 16 atoms',
     dict(sample=(16000,), atom=(9,), n_samples=16)),
    ('3-D 8x1x64^3 atom 5^3, 8 atoms',
     dict(sample=(64, 64, 64), atom=(5, 5, 5), n_samples=8, n_atoms=8)),
    ('3-D 8x1x64^3 atom 3^3, 8 atoms',
     dict(sample=(64, 64, 64), atom=(3, 3, 3), n_samples=8, n_atoms=8)),
    ('2-D 64x3x256^2 atom 9^2, 16 atoms',
     dict(n_channels=3)),
    ('2-D 16x8x128^2 atom 9^2, 16 atoms',
     dict(sample=(128, 128), n_samples=16, n_channels=8)),
    ('2-D 64x3x76x102 atom 7^2, 10 atoms',
     dict(sample=(76, 102), atom=(7, 7), n_channels=3, n_atoms=10)),
    ('2-D 64x1x256^2 atom 9^2, 128 maps',
     dict(n_atoms=128)),
    ('2-D 16x1x64^2 atom 15^2, 128 maps',
     dict(sample=(64, 64), atom=(15, 15), n_samples=16, n_atoms=128)),
]


def geometries():
    """conv vs phased vs fft (float32) where the phased gate applies but the
    2-D single-channel sweep did not reach: 1-D, 3-D, several channels, and
    the activation-map counts of transform groups; then the flagship fft
    iteration again (its transforms run on the leading-axes reshape of
    ``ops/fft._leading_flat``)."""
    from tnmf_tpu.ops import phased
    for label, kw in OFF_SWEEP:
        plan = ConvPlan.create('valid', kw.get('sample', (256, 256)),
                               kw.get('atom', (9, 9)))
        assert phased.applicable(plan, kw.get('n_channels', 1),
                                 kw.get('n_atoms', 16)), label
        for strategy in ('conv', 'phased', 'fft'):
            _row('geometries', f'{label} {strategy}',
                 lambda: fit_case(strategy, **kw), strategy=strategy)
        jax.clear_caches()
    fft_reshape()


def fft_reshape():
    """The flagship fft iteration with and without the leading-axes reshape
    of ``ops/fft._leading_flat``."""
    from tnmf_tpu.ops import fft as fft_ops
    for dtype in ('float32', 'bfloat16'):
        _row('fft-reshape', f'flagship {dtype} fft',
             lambda: fit_case('fft', dtype=dtype), dtype=dtype)
        with _patch(fft_ops, '_leading_flat', lambda f, x: f(x)):
            jax.clear_caches()
            _row('fft-reshape', f'flagship {dtype} fft without the reshape',
                 lambda: fit_case('fft', dtype=dtype), dtype=dtype)
        jax.clear_caches()


def hals(n=16384, F=4096, m=256, big=8192):
    """Constants of ``engine_hals.auto_inner``'s cost model."""
    from tnmf_tpu import engine_hals
    plan = ConvPlan.create('full', (F,), (F,))
    k = jax.random.split(jax.random.PRNGKey(2), 3)
    V = jax.random.uniform(k[0], (n, 1, F), jnp.float32)
    W0 = jax.random.uniform(k[1], (m, 1, F), jnp.float32)
    H0 = jax.random.uniform(k[2], (n, m, 1), jnp.float32)
    z = jnp.zeros((), jnp.float32)
    out = {}
    for inner in (1, 4):
        def go(it, inner=inner):
            Wn, _ = engine_hals.fit_loop(V, W0 + 0, H0 + 0, it, z, z, z, z,
                                         inner=inner, update_H=True,
                                         update_W=True, plan=plan)
            Wn.block_until_ready()
        _row('hals', f'{n}x{F}/{m} inner={inner}',
             lambda: out.setdefault(inner, _per_iter(go)))
    if 1 in out and 4 in out:
        step = (out[4] - out[1]) / (3 * 2 * m)
        _emit(section='hals', label='chain step seconds (derived)',
              seconds=step)
    a = jax.random.uniform(k[0], (big, big), jnp.float32)
    b = jax.random.uniform(k[1], (big, big), jnp.float32)
    for prec in (None, 'highest'):
        f = jax.jit(lambda a, b, prec=prec: jnp.matmul(a, b, precision=prec))
        f(a, b).block_until_ready()
        s = _timed(lambda: f(a, b).block_until_ready())
        _emit(section='hals', label=f'f32 matmul {big}^3 precision={prec}',
              ms=round(s * 1e3, 4), flops_per_s=2 * big ** 3 / s)
    x = jax.random.uniform(k[2], (big // 32, 1024, 1024), jnp.float32)
    f = jax.jit(lambda x: x * 2.0)
    f(x).block_until_ready()
    s = _timed(lambda: f(x).block_until_ready())
    _emit(section='hals', label=f'copy {x.nbytes >> 20} MiB read+write', ms=round(s * 1e3, 4),
          bytes_per_s=2 * x.nbytes / s)


def main():
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        sys.exit(f'no GPU: JAX found {dev.platform!r}')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True).stdout
    _emit(section='device', kind=dev.device_kind, count=len(jax.devices()),
          nvidia_smi=smi.strip(), jax=jax.__version__)
    which = sys.argv[1:] or ['flagship', 'fft_geometry', 'per_op',
                             'phased_ops', 'hals', 'sweep', 'geometries']
    for name in which:
        t0 = time.perf_counter()
        globals()[name]()
        _emit(section='wall', label=name, s=round(time.perf_counter() - t0, 1))
    os.makedirs('chiprun_out', exist_ok=True)
    with open(os.path.join('chiprun_out', 'lowering.json'), 'w') as f:
        json.dump(ROWS, f, indent=1)


if __name__ == '__main__':
    from tnmf_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    main()
