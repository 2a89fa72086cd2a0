"""Benchmarks: the new framework on the accelerator vs the reference tnmf (NumPy_FFT
backend, its default) on CPU, on the BASELINE.md anchor configs.

Default run prints exactly ONE JSON line (the headline metric, driver
contract):
  {"metric": ..., "value": N, "unit": "iter/s", "vs_baseline": N}

``--all`` additionally measures the other BASELINE.md rows (one JSON line
per metric):

* ``mu_iterations_per_sec_2d_conv_nmf`` — the reference's 2-D regression
  fixture (tnmf/tests/test_backends.py shapes).
* ``mu_iterations_per_sec_1d_pulse_train`` — the 1-D fixture with lateral
  inhibition (tnmf/tests/test_1d.py shapes).
* ``time_to_tolerance_sparsity_inhibition_sec`` — wall-clock seconds to
  complete 25 MU iterations (identical seeded trajectory on both sides, so
  both reach the *same* energy; steady state, compile excluded) on the
  sparsity+inhibition patch config (the reference's CachingFFT-style
  config, tnmf/tests/test_sparsity_inhibition.py shapes).
* ``minibatch_asg_mu_epochs_per_sec`` — ASG_MU epochs/sec over 144 32x32
  patches (tnmf/tests/test_minibatch.py shapes).

The reference publishes no performance numbers (BASELINE.md), so baselines
were measured once on this machine (idle CPU, most favorable of
{float32, float64} x repetitions) and PINNED into ``BASELINE.json``
(``pinned_reference``): ``vs_baseline`` is stable round over round instead
of moving +-30% with CPU load.  ``--remeasure-reference`` re-measures the
reference live and reports against the fresh numbers instead.

Timing methodology: our fits run as fused on-device loops; per-metric
timing subtracts a smaller run from a larger one to cancel the fixed
dispatch/compile-cache overhead.  Negative/zero deltas (scheduler noise) fall back to the
unsubtracted conservative estimate instead of printing absurd numbers.
"""

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

REFERENCE_PATH = '/root/reference'
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)


# ---------------------------------------------------------------------------
# wall-clock budget: the driver JSON line is guaranteed
# ---------------------------------------------------------------------------
#
# A run that outlives its caller's time limit records nothing (rc=124): an
# unbounded best_of refinement on a slow or contended device would print no
# JSON line at all.  The guard is defense in depth:
#
#   1. a HARD deadline (BENCH_DEADLINE_S, default 240 s) enforced by a
#      daemon watchdog thread that prints the best measurement taken so far
#      (or a null-value line if none completed) and os._exit(0)s — this
#      works even while the main thread is blocked inside a device dispatch,
#      because JAX releases the GIL while waiting on the device;
#   2. a conservative single-shot measurement taken FIRST and registered as
#      the fallback before any refinement starts, so the watchdog always
#      has a real number after the first ~compile+seconds;
#   3. soft budget checks inside subtractive_rate/best_of that cap the
#      adaptive iteration count and skip refinement attempts by *time
#      remaining*, so the normal path finishes well before the watchdog.

_START = time.monotonic()
_DEADLINE_S = float(os.environ.get('BENCH_DEADLINE_S', '240'))
_HEADLINE_DONE = threading.Event()
# best-so-far headline metric dict, single-slot so the watchdog thread
# always reads a complete snapshot (a clear()-then-update() dict would
# race: the watchdog could observe it empty mid-refresh and emit the
# null line despite a real measurement)
_FALLBACK = [None]


def budget_left():
    """Seconds until the hard deadline."""
    return _START + _DEADLINE_S - time.monotonic()


def register_fallback(metric, value, unit, ref, detail=None):
    """Record the best-so-far headline so the watchdog can emit it."""
    cur = _FALLBACK[0]
    if cur is not None and cur.get('value') is not None and \
            value is not None and value <= cur['value']:
        return
    out = {'metric': metric, 'value': round(value, 3) if value else value,
           'unit': unit,
           'vs_baseline': round(value / ref, 3) if (value and ref) else None}
    if detail:
        out['detail'] = detail
    _FALLBACK[0] = out  # atomic slot swap


def _watchdog(headline_metric):
    while True:
        left = budget_left()
        if _HEADLINE_DONE.is_set():
            return
        if left <= 0:
            break
        time.sleep(min(left, 1.0))
    if _HEADLINE_DONE.is_set():
        return
    fb = _FALLBACK[0]
    out = dict(fb) if fb is not None else {
        'metric': headline_metric, 'value': None, 'unit': 'iter/s',
        'vs_baseline': None,
        'detail': f'deadline {_DEADLINE_S:.0f}s hit before the first '
                  'measurement completed'}
    out.setdefault('detail', f'deadline {_DEADLINE_S:.0f}s hit during refinement; '
                             'emitting the conservative single-shot fallback')
    print(json.dumps(out), flush=True)
    sys.stdout.flush()
    os._exit(0)


def start_watchdog(headline_metric='mu_iterations_per_sec_2d_conv_nmf'):
    t = threading.Thread(target=_watchdog, args=(headline_metric,), daemon=True)
    t.start()
    return t


# ---------------------------------------------------------------------------
# fixtures (shapes mirror the reference's regression tests)
# ---------------------------------------------------------------------------

def make_V_2d(dtype):
    from tnmf_tpu.utils.data_loading import synthetic_face
    img = synthetic_face(gray=False)[::10, ::10]
    return np.repeat(img.transpose((2, 0, 1))[np.newaxis], 2, axis=0).astype(dtype)


def make_V_1d(dtype):
    from tnmf_tpu.utils.signals import generate_pulse_train
    np.random.seed(42)
    signal, _ = generate_pulse_train(pulse_length=20, n_pulses=5)
    return signal[np.newaxis].astype(dtype)


def make_patches(dtype, n=144, size=32):
    from tnmf_tpu.utils.data_loading import synthetic_face
    img = synthetic_face(gray=True)
    rows, cols = img.shape[0] // size, img.shape[1] // size
    blocks = (img[:rows * size, :cols * size]
              .reshape(rows, size, cols, size)
              .transpose(0, 2, 1, 3)
              .reshape(-1, 1, size, size))
    reps = -(-n // len(blocks))
    if reps > 1:
        blocks = np.concatenate([blocks] * reps)
    return np.ascontiguousarray(blocks[:n]).astype(dtype)


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

def pinned(name):
    """The pinned reference-side number from BASELINE.json (or None)."""
    try:
        with open(os.path.join(HERE, 'BASELINE.json')) as f:
            return json.load(f)['pinned_reference'][name]
    except Exception:
        return None


def subtractive_rate(run, n_small, target_seconds=2.0, floor=30,
                     fallback=None):
    """Iterations/sec of ``run(n)`` with the fixed overhead cancelled by
    subtracting a small run from a large one.  Guards against nonpositive
    deltas from scheduler noise.  The adaptive large-run size is capped by
    the remaining wall-clock budget (leaving slack for the big run itself
    plus emission), so one congested dispatch cannot eat the deadline.  If
    ``fallback`` is given, the crude single-shot rate from the small run is
    reported to it immediately — before the large run starts."""
    run(2)  # compile
    t0 = time.perf_counter()
    run(n_small)
    base = time.perf_counter() - t0
    if fallback is not None:
        # conservative: includes the full dispatch overhead, so it can only
        # undersell the subtracted number
        fallback(n_small / max(base, 1e-9))
    seconds = max(min(target_seconds, budget_left() / 3.0 - base), 0.2)
    n = max(floor, int(n_small * seconds / max(base, 1e-4)))
    t0 = time.perf_counter()
    run(n_small + n)
    total = time.perf_counter() - t0
    dt = total - base
    if dt <= 0:  # noise swamped the subtraction; fall back to conservative
        dt = total
    return n / dt


def best_of(measure, k=3, cooldown=5.0):
    """Best of ``k`` measurement attempts (standard max-throughput
    practice): a single-shot reading can record a transient stall of a
    shared host or device.  Early exit when two attempts agree
    within 10% — the steady-state case costs only one retry.  Retries are
    skipped outright once the remaining wall-clock budget would not cover
    another attempt of the same duration."""
    t0 = time.perf_counter()
    best = measure()
    attempt_cost = time.perf_counter() - t0
    for _ in range(k - 1):
        if budget_left() < cooldown + 1.5 * attempt_cost + 5.0:
            return best  # not enough budget for a safe retry
        time.sleep(cooldown)
        t0 = time.perf_counter()
        nxt = measure()
        attempt_cost = max(attempt_cost, time.perf_counter() - t0)
        if max(best, nxt) <= 1.1 * min(best, nxt):
            return max(best, nxt)
        best = max(best, nxt)
    return best


def callback_rate(fit, n_iterations):
    """Reference-side iterations/sec via per-iteration callback stamps."""
    stamps = []

    def cb(nmf, it):
        stamps.append(time.perf_counter())
        return True

    fit(cb, n_iterations)
    return 1.0 / float(np.median(np.diff(stamps)))


# ---------------------------------------------------------------------------
# metric: 2-D headline (driver contract)
# ---------------------------------------------------------------------------

def bench_ours_2d(fallback=None):
    import jax.numpy as jnp
    from tnmf_tpu import engine
    from tnmf_tpu.ops.modes import ConvPlan

    V = make_V_2d(np.float32)
    n_atoms, atom_shape, sparsity = 10, (7, 7), 0.1
    plan = ConvPlan.create('valid', V.shape[2:], atom_shape)
    strategy = engine.resolve_strategy(
        'auto', plan, n_atoms, V.shape[1])  # the model's real path

    rng = np.random.default_rng(42)
    W = rng.random((n_atoms, V.shape[1]) + atom_shape).astype(np.float32)
    W /= W.sum(axis=(-2, -1), keepdims=True)
    H = rng.random((V.shape[0], n_atoms) + plan.transform_shape).astype(np.float32)

    Vp = engine.prepare_data(jnp.asarray(V), plan=plan, strategy=strategy)
    zero = jnp.float32(0.0)
    statics = dict(plan=plan, strategy=strategy, update_H=True, update_W=True,
                   use_inhibition=False, use_cross=False)

    def run(n):
        Wn, _ = engine.fit_loop(Vp, jnp.asarray(W), jnp.asarray(H), n,
                                jnp.float32(sparsity), zero, zero, (), **statics)
        return float(np.asarray(Wn).sum())  # host transfer forces completion

    return subtractive_rate(run, n_small=100, fallback=fallback)


def bench_reference_2d():
    sys.path.insert(0, REFERENCE_PATH)
    from tnmf.TransformInvariantNMF import TransformInvariantNMF

    best = 0.0
    for dtype in (np.float32, np.float64):
        V = make_V_2d(dtype)
        for _ in range(3):
            def fit(cb, n):
                np.random.seed(42)
                nmf = TransformInvariantNMF(n_atoms=10, atom_shape=(7, 7),
                                            backend='numpy_fft')
                nmf.fit(V, sparsity_H=0.1, n_iterations=n, progress_callback=cb)
            best = max(best, callback_rate(fit, 12))
    return best


def metric_2d(remeasure=False):
    name = 'mu_iterations_per_sec_2d_conv_nmf'
    ref = None if remeasure else pinned(name)

    def fb(rate):
        register_fallback(name, rate, 'iter/s', ref)

    def measure():
        rate = bench_ours_2d(fallback=fb)
        fb(rate)  # keep the watchdog's number in sync with refinement
        return rate

    ours = best_of(measure)
    if ref is None:
        try:
            ref = bench_reference_2d()
        except Exception as e:
            print(f'reference baseline unavailable: {e!r}', file=sys.stderr)
    return {'metric': 'mu_iterations_per_sec_2d_conv_nmf',
            'value': round(ours, 3), 'unit': 'iter/s',
            'vs_baseline': round(ours / ref, 3) if ref else None}


# ---------------------------------------------------------------------------
# metric: 1-D pulse train with inhibition
# ---------------------------------------------------------------------------

def metric_1d(remeasure=False):
    import jax.numpy as jnp
    from tnmf_tpu import engine
    from tnmf_tpu.ops.inhibition import inhibition_kernels, resolve_inhibition_range
    from tnmf_tpu.ops.modes import ConvPlan

    V = make_V_1d(np.float32)
    n_atoms, atom_shape = 3, (20,)
    plan = ConvPlan.create('valid', V.shape[2:], atom_shape)
    strategy = engine.resolve_strategy('auto', plan, n_atoms, V.shape[1])
    kernels = tuple(jnp.asarray(k, jnp.float32)
                    for k in inhibition_kernels(resolve_inhibition_range(None, atom_shape)))

    rng = np.random.default_rng(42)
    W = rng.random((n_atoms, V.shape[1]) + atom_shape).astype(np.float32)
    W /= W.sum(axis=-1, keepdims=True)
    H = rng.random((V.shape[0], n_atoms) + plan.transform_shape).astype(np.float32)

    Vp = engine.prepare_data(jnp.asarray(V), plan=plan, strategy=strategy)
    zero = jnp.float32(0.0)
    statics = dict(plan=plan, strategy=strategy, update_H=True, update_W=True,
                   use_inhibition=True, use_cross=False)

    def run(n):
        Wn, _ = engine.fit_loop(Vp, jnp.asarray(W), jnp.asarray(H), n,
                                zero, jnp.float32(0.1), zero, kernels, **statics)
        return float(np.asarray(Wn).sum())

    ours = best_of(lambda: subtractive_rate(run, n_small=200))

    ref = None if remeasure else pinned('mu_iterations_per_sec_1d_pulse_train')
    if ref is None:
        try:
            sys.path.insert(0, REFERENCE_PATH)
            from tnmf.TransformInvariantNMF import TransformInvariantNMF
            best = 0.0
            for dtype in (np.float32, np.float64):
                Vr = make_V_1d(dtype)
                for _ in range(3):
                    def fit(cb, n):
                        np.random.seed(42)
                        nmf = TransformInvariantNMF(n_atoms=3, atom_shape=(20,),
                                                    backend='numpy_fft')
                        nmf.fit(Vr, inhibition_strength=0.1, n_iterations=n,
                                progress_callback=cb)
                    best = max(best, callback_rate(fit, 25))
            ref = best
        except Exception as e:
            print(f'reference 1-D baseline unavailable: {e!r}', file=sys.stderr)

    return {'metric': 'mu_iterations_per_sec_1d_pulse_train',
            'value': round(ours, 3), 'unit': 'iter/s',
            'vs_baseline': round(ours / ref, 3) if ref else None}


# ---------------------------------------------------------------------------
# metric: time-to-tolerance on the sparsity+inhibition patch config
# ---------------------------------------------------------------------------

def metric_time_to_tolerance(n_iterations=25, remeasure=False):
    from tnmf_tpu import TransformInvariantNMF as OursNMF

    V = make_patches(np.float32, n=64)
    kw = dict(n_iterations=n_iterations, sparsity_H=0.1, inhibition_strength=0.1)

    def run_ours():
        np.random.seed(42)
        nmf = OursNMF(n_atoms=10, atom_shape=(7, 7))
        nmf.fit(V, **kw)
        return float(nmf.W.sum())

    run_ours()  # warm the compile cache: steady-state production metric

    def timed_rate():
        t0 = time.perf_counter()
        run_ours()
        return 1.0 / (time.perf_counter() - t0)

    ours_sec = 1.0 / best_of(timed_rate)

    ref_sec = None if remeasure else pinned('time_to_tolerance_sparsity_inhibition_sec')
    if ref_sec is None:
        try:
            sys.path.insert(0, REFERENCE_PATH)
            from tnmf.TransformInvariantNMF import TransformInvariantNMF as RefNMF
            best = float('inf')
            for dtype in (np.float32, np.float64):
                Vr = V.astype(dtype)
                for _ in range(2):
                    np.random.seed(42)
                    nmf = RefNMF(n_atoms=10, atom_shape=(7, 7), backend='numpy_fft')
                    t0 = time.perf_counter()
                    nmf.fit(Vr, **kw)
                    best = min(best, time.perf_counter() - t0)
            ref_sec = best
        except Exception as e:
            print(f'reference tolerance baseline unavailable: {e!r}', file=sys.stderr)

    return {'metric': 'time_to_tolerance_sparsity_inhibition_sec',
            'value': round(ours_sec, 4), 'unit': 's (25 MU iters, same trajectory)',
            'vs_baseline': round(ref_sec / ours_sec, 3) if ref_sec else None}


# ---------------------------------------------------------------------------
# metric: minibatch ASG_MU epochs/sec
# ---------------------------------------------------------------------------

def metric_minibatch(n_epochs=5, batch_size=12, remeasure=False):
    from tnmf_tpu import MiniBatchAlgorithm, TransformInvariantNMF as OursNMF

    V = make_patches(np.float32, n=144)

    def run_ours():
        # init='device': the production init path (on-device PRNG).  The
        # host-numpy init exists only for reference-RNG trajectory parity
        # and costs ~0.3 s of host draws + per-tensor transfers per fit at
        # this scale — pure fixed overhead that swamps the ~0 per-epoch
        # compute of this tiny config (25 epochs measure *faster* than 5
        # wall-to-wall under it).
        nmf = OursNMF(n_atoms=10, atom_shape=(7, 7), init='device', seed=42)
        nmf.fit_minibatches(V, algorithm=MiniBatchAlgorithm.ASG_MU,
                            batch_size=batch_size, n_epochs=n_epochs, sparsity_H=0.1)
        return float(nmf.W.sum())

    run_ours()  # warm compile cache (the whole multi-epoch fit is one scan)
    ts = []
    for _ in range(3):  # host-load noise: report the best of 3
        t0 = time.perf_counter()
        run_ours()
        ts.append(time.perf_counter() - t0)
    ours = n_epochs / min(ts)

    ref = None if remeasure else pinned('minibatch_asg_mu_epochs_per_sec')
    if ref is None:
        try:
            sys.path.insert(0, REFERENCE_PATH)
            from tnmf.TransformInvariantNMF import (MiniBatchAlgorithm as RefAlg,
                                                    TransformInvariantNMF as RefNMF)
            best = 0.0
            for dtype in (np.float32, np.float64):
                for _ in range(2):
                    stamps = []

                    def cb(nmf, epoch):
                        stamps.append(time.perf_counter())
                        return True

                    np.random.seed(42)
                    nmf = RefNMF(n_atoms=10, atom_shape=(7, 7), backend='numpy_fft')
                    nmf.fit_minibatches(V.astype(dtype), algorithm=RefAlg.ASG_MU,
                                        batch_size=batch_size, n_epochs=n_epochs,
                                        sparsity_H=0.1, progress_callback=cb)
                    best = max(best, 1.0 / float(np.median(np.diff(stamps))))
            ref = best
        except Exception as e:
            print(f'reference minibatch baseline unavailable: {e!r}', file=sys.stderr)

    return {'metric': 'minibatch_asg_mu_epochs_per_sec',
            'value': round(ours, 3), 'unit': 'epoch/s',
            'vs_baseline': round(ours / ref, 3) if ref else None}


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--all', action='store_true',
                        help='measure every BASELINE.md row (one JSON line each)')
    parser.add_argument('--remeasure-reference', action='store_true',
                        help='re-measure the reference baselines live instead '
                             'of using the pinned BASELINE.json numbers')
    args = parser.parse_args()
    rm = args.remeasure_reference

    selftest = os.environ.get('BENCH_SELFTEST')
    if selftest == 'hang':
        # deadline-robustness selftest (tests/test_bench_deadline.py): a
        # fake measurement registers a fallback, then the "measurement"
        # blocks forever — the watchdog must still emit one JSON line and
        # exit 0 before the deadline.  No accelerator / jax needed.
        start_watchdog()
        register_fallback('mu_iterations_per_sec_2d_conv_nmf', 123.456,
                          'iter/s', None, detail='selftest fallback')
        time.sleep(3600)
        return
    if selftest == 'hang-before-measurement':
        start_watchdog()
        time.sleep(3600)
        return

    start_watchdog()
    from tnmf_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    def emit(m):
        print(json.dumps(m), flush=True)

    emit(metric_2d(remeasure=rm))
    _HEADLINE_DONE.set()  # driver contract satisfied; watchdog stands down
    if args.all and 'BENCH_DEADLINE_S' not in os.environ:
        # the headline kept its full hard deadline; the three extra
        # metrics get additional SOFT budget (subtractive_rate/best_of
        # cap their work by budget_left()) — --all is a manual run, not
        # the driver contract, so no watchdog re-arm
        global _DEADLINE_S
        _DEADLINE_S += 3 * 240
    if args.all:
        emit(metric_1d(remeasure=rm))
        emit(metric_time_to_tolerance(remeasure=rm))
        emit(metric_minibatch(remeasure=rm))


if __name__ == '__main__':
    main()
