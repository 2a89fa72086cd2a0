"""Per-op time breakdown of one MU iteration at the large-batch scale.

Answers "where do the milliseconds go" for a given strategy on real
hardware.  Every step is a *real MU sub-update* whose full output feeds the
next iteration's carry: scalar-sum or sliced consumers are NOT used because
XLA algebraically rewrites ``sum(conv(...))`` and windows convolutions
under sliced consumers, silently under-measuring the op (observed up to
"51 TF/s" for a conv that runs at ~14 TF/s when its full output is
consumed).  For the same reason the sub-step times legitimately overlap
(each includes the reconstruction it depends on); the FULL row is the
ground truth the parts explain.

Note on the carry: W is held fixed in the mu_H row and H in the mu_W row,
so anything that depends only on the fixed operand (e.g. the one-hot
expanded kernels of the phased lowering) is hoisted out of the scan — the
FULL row is the only one that charges every per-iteration cost.

Usage: python benchmarks/op_breakdown.py [n_samples] [side] [dtype] [strategy]
       (strategy defaults to the engine's resolved choice, i.e. 'phased'
       on a GPU for channel-poor configs)
"""

import os
import sys
import time
from functools import partial

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from tnmf_tpu import engine  # noqa: E402
from tnmf_tpu.ops.modes import ConvPlan  # noqa: E402

K_LO, K_HI = 16, 64


def bench(step_fn, carry0, *consts, k_lo=None, k_hi=None):
    """Per-iteration time from the K_LO/K_HI *slope*: the loop is scanned at
    two lengths and the difference cancels every constant per-dispatch cost
    (arg sync, result fetch); a separately measured tiny-jit dispatch time
    is not the dispatch cost of a loop with big carried operands.

    ``consts`` are loop-invariant big tensors, passed as jit *arguments*
    (closure constants of this size would be embedded in the compiled
    program)."""
    def timed(K):
        @partial(jax.jit, static_argnames='K')
        def loop(c, *k, K):
            return lax.scan(lambda c, _: (step_fn(c, *k), None), c, None, length=K)[0]

        out = loop(carry0, *consts, K=K)
        jax.tree.map(lambda x: np.asarray(x.reshape(-1)[:1]), out)
        ts = []
        for _ in range(4):
            t0 = time.perf_counter()
            out = loop(carry0, *consts, K=K)
            jax.tree.map(lambda x: np.asarray(x.reshape(-1)[:1]), out)
            ts.append(time.perf_counter() - t0)
        return min(ts)

    lo, hi = k_lo or K_LO, k_hi or K_HI
    return (timed(hi) - timed(lo)) / (hi - lo)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    side = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    dtype = jnp.dtype(sys.argv[3]) if len(sys.argv) > 3 else jnp.float32
    S, A, M, C = (side, side), (9, 9), 16, 1
    plan = ConvPlan.create('valid', S, A)
    strategy = (sys.argv[4] if len(sys.argv) > 4
                else engine.resolve_strategy('conv', plan, M, C))
    ops = engine.get_ops(strategy)
    T = plan.transform_shape
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    V = jax.random.uniform(k1, (n, C) + S, dtype)
    W0 = jax.random.uniform(k2, (M, C) + A, dtype)
    H0 = jax.random.uniform(k3, (n, M) + T, dtype)
    Vp = engine.prepare_data(V, plan=plan, strategy=strategy)
    H0e = jax.jit(lambda h: engine._enc_h(h, plan, strategy))(H0)
    np.asarray(Vp.reshape(-1)[:1])
    print(f'device={jax.devices()[0]}, N={n} S={S} A={A} M={M} C={C} {dtype} '
          f'strategy={strategy}; per-iter times from the {K_LO}/{K_HI} slope')

    tA = np.prod(T) * np.prod(A)
    fl_rec = 2 * n * C * M * tA
    fl_g = 2 * fl_rec  # stacked V/R pair

    def row(name, t, fl=None):
        tf = f'  {fl/t/1e12:6.2f} TF/s useful' if fl else ''
        print(f'  {name:34s} {t*1e3:8.2f} ms{tf}')

    z = jnp.zeros((), dtype)
    kw = dict(plan=plan, use_inhibition=False, use_cross=False)

    # mu_H sub-update (W fixed in the carry)
    def step_mu_h(H, Vp):
        return engine._mu_H(ops, Vp, W0, H, z, z, z, (), **kw)

    # mu_W sub-update (H fixed in the carry)
    def step_mu_w(W, Vp, H):
        return engine._mu_W(ops, Vp, W, H, plan=plan)

    t_h = bench(step_mu_h, H0e, Vp)
    row('mu_H (rec + grad_H pair + ratio)', t_h, fl_rec + fl_g)
    t_w = bench(step_mu_w, W0, Vp, H0e)
    row('mu_W (rec + grad_W pair + ratio)', t_w, fl_rec + fl_g)

    # mu_H sub-ablations: where inside mu_H the time goes.
    # (a) the MU ratio against MATERIALIZED H-sized gradient tensors — its
    #     memory floor is 4 H streams (read neg/pos/H, write H);
    # (b) the gradient pair + ratio with the reconstruction hoisted out of
    #     the loop (R in the carry consts) — its floor is only 2 H streams
    #     (read H, write H) + the small Vp/R reads *if* both gradient convs
    #     fuse into the ratio; XLA may materialize one of the two conv
    #     outputs (an elementwise consumer can fuse only one producer
    #     chain), which (b) against its floor shows.
    neg_c = jax.jit(lambda h: h * 1.01)(H0e)
    pos_c = jax.jit(lambda h: h * 0.99)(H0e)
    t = bench(lambda H, a, b: (H * a / (b + 1e-9)).astype(H.dtype),
              H0e, neg_c, pos_c)
    row('  ratio alone (materialized grads)', t)
    Rfix = jax.jit(lambda h: ops.reconstruct(W0, h, plan))(H0e)
    np.asarray(Rfix.reshape(-1)[:1])

    def step_grad_ratio(H, Vp, Rfix):
        neg, pos = ops.grad_H_pair(Vp, Rfix, W0, plan)
        return (H * neg / (pos + 1e-9)).astype(H.dtype)

    t = bench(step_grad_ratio, H0e, Vp, Rfix)
    row('  grad_H pair + ratio (R fixed)', t, fl_g)

    def full(carry, Vp):
        W, H = carry
        H = engine._mu_H(ops, Vp, W, H, z, z, z, (), **kw)
        W = engine._mu_W(ops, Vp, W, H, plan=plan)
        return W, H

    t = bench(full, (W0, H0e), Vp)
    row('FULL MU iteration', t, 2 * fl_rec + 2 * fl_g)

    # ---- HBM roofline ----
    # In-situ achievable-bandwidth probe: an elementwise scale of the
    # H-sized carry (1 read + 1 write), the same access pattern as the MU
    # ratio.  The probe is much faster than an MU iteration, so it gets a
    # longer slope to stay above timer jitter.
    # 1 + 2^-7 is exact in bf16 (7 mantissa bits) AND f32; a sub-lsb
    # constant rounds to 1.0 in bf16 and XLA elides the whole loop
    t_bw = bench(lambda c: c * jnp.asarray(1.0078125, dtype), H0e,
                 k_lo=64, k_hi=512)
    bw = 2 * H0e.nbytes / t_bw
    # Analytic byte floor of one exact MU iteration — the streams no
    # schedule can avoid: H is read by rec(H), the grad_H pair consumer,
    # rec(H_new) and grad_W (4 reads) and written once by the ratio; the
    # prepared data is read by both gradient pairs; both reconstructions
    # write (and their extended forms are re-read as) an R-sized stream.
    r_bytes = n * C * int(np.prod(S)) * jnp.dtype(dtype).itemsize
    floor_bytes = 5 * H0e.nbytes + 2 * Vp.nbytes + 2 * r_bytes
    floor = floor_bytes / bw
    print(f'  achieved memory bandwidth (probe)  {bw / 1e9:8.0f} GB/s')
    print(f'  analytic byte floor / iteration    {floor * 1e3:8.2f} ms '
          f' ({floor_bytes / 1e6:.0f} MB)  ->  iteration at '
          f'{100 * floor / t:.0f}% of the memory roofline')


if __name__ == '__main__':
    from tnmf_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    main()
