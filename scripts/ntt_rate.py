"""NTT and fused-op throughput on one GPU, in one process, warm.

    python scripts/ntt_rate.py [--reps N] [--rounds R] [--presets a,b]

For each preset (bench_n14 and ckks_deep_hi, batch B=8):

1. standalone: forward and inverse NTT planes/s of a batch of B
   two-part ciphertexts at the top level (the kernel layer's metric);
2. fused op: ``multiply_relin_rescale`` ops/s at batch B (the op the
   NTT should move).

Each number is the median of ``--reps`` warm calls; ``--rounds`` repeats
the set so that the spread between rounds shows.  Prints one JSON line
per measurement; the device and card are named on earlier lines.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

PRESETS = (("bench_n14", 8), ("ckks_deep_hi", 8))


def _bench(fn, *args, reps):
    """Median seconds of fn(*args) over ``reps`` warm calls."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _rand_planes(rng, shape, primes):
    import jax.numpy as jnp
    q = np.array(primes, dtype=np.uint64).reshape(-1, 1)
    return jnp.asarray((rng.integers(0, 1 << 62, shape, dtype=np.uint64)
                        % q).astype(np.uint32))


def measure(name, B, args, emit):
    import jax
    import jax.numpy as jnp
    from hetpu.core.ntt import ntt_fwd, ntt_inv
    from hetpu.session import Session
    rng = np.random.default_rng(0)
    sess = Session.create(name, seed=b"\x21" * 32, galois_steps=[1])
    ctx = sess.ctx
    lvl = ctx.num_data - 1
    t = ctx.tables(lvl)
    x = _rand_planes(rng, (B, 2, lvl + 1, ctx.params.poly_degree), t.primes)
    planes = B * 2 * (lvl + 1)
    fwd = jax.jit(lambda a: ntt_fwd(a, t))
    inv = jax.jit(lambda a: ntt_inv(a, t, strip_mont=True))
    a = sess.encrypt(rng.uniform(-1, 1, sess.slots))
    b = sess.encrypt(rng.uniform(-1, 1, sess.slots))
    a = a.with_(data=jnp.stack([a.data] * B))
    b = b.with_(data=jnp.stack([b.data] * B))
    op = lambda u, v: sess.ev.multiply_relin_rescale(u, v, sess.rk).data
    for r in range(args.rounds):
        for direction, fn in (("fwd", fwd), ("inv", inv)):
            dt = _bench(fn, x, reps=args.reps)
            emit(metric="ntt_planes_per_s", preset=name, direction=direction,
                 B=B, planes=planes, round=r, value=planes / dt, seconds=dt)
        dt = _bench(op, a, b, reps=args.reps)
        emit(metric="mult_relin_rescale_ops_per_s", preset=name, B=B,
             round=r, value=B / dt, seconds=dt)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--presets", default=",".join(p for p, _ in PRESETS))
    args = ap.parse_args(argv)

    from hetpu.utils.device import card_name_and_power_limit, require_gpu
    dev = require_gpu()
    card = card_name_and_power_limit()
    print("device:", dev, "| card:", card, flush=True)

    def emit(**kw):
        print(json.dumps({**kw, "device": dev["kind"], "card": card}),
              flush=True)

    for name, B in PRESETS:
        if name in args.presets.split(","):
            measure(name, B, args, emit)


if __name__ == "__main__":
    main()
