"""Headline benchmark: CKKS ct·ct multiply + relinearize + rescale
throughput at N=2^14 on one GPU (the BASELINE.md north-star metric;
reference machinery: ``math_operations.cpp:338-354`` ct-ct mult + relin
timers).

Iterations form a true sequential dependency chain inside one jitted
``lax.scan``: each step's input folds in every element of the previous
output, so nothing is memoizable or dead-code-eliminable, and host
dispatch stays out of the timed region.  The clock stops after
``block_until_ready``.

Earlier lines name the device (platform, device kind, count, the card's
name and power limit); the run stops without a GPU.  The last line is
ONE JSON object:
  {"metric": ..., "value": N, "unit": "ops/s", "vs_baseline": null}
vs_baseline stays null until an H100 baseline exists (the reference
publishes no numbers — BASELINE.md).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


def main():
    from hetpu.utils.device import card_name_and_power_limit, require_gpu
    dev = require_gpu()
    print(f"device: platform={dev['platform']} kind={dev['kind']} "
          f"count={dev['count']}")
    print(f"card: {card_name_and_power_limit()}")
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}", flush=True)

    import jax
    import jax.numpy as jnp
    from hetpu.utils.keycache import cached_session

    # preset variants (same metric — N=2^14 mult+relin+rescale):
    #   bench_n14      α=5, 30/31-bit primes (default)
    #   bench_n14_a4   α=4 — fewer key-switch planes
    #   bench_n14_fast α=4 + all primes < 2^30
    preset = os.environ.get("HETPU_BENCH_PRESET", "bench_n14")
    sess = cached_session(preset, seed=b"\x21" * 32, galois_steps=[1])
    rng = np.random.default_rng(0)

    BATCH = int(os.environ.get("HETPU_BENCH_BATCH", "8"))
    K = int(os.environ.get("HETPU_BENCH_K", "64"))       # chained steps
    base = sess.encrypt(rng.uniform(-1, 1, sess.slots))
    b_ct = sess.encrypt(rng.uniform(-1, 1, sess.slots))
    a = base.with_(data=jnp.stack([base.data] * BATCH))
    b = b_ct.with_(data=jnp.stack([b_ct.data] * BATCH))

    def fold_into(x0, y):
        """XOR-fold EVERY element of y into an x0-shaped tag: each step's
        full output feeds the next step's input, so XLA cannot slice any
        elementwise stage down to a sampled tag."""
        n0 = x0.size
        yf = jnp.ravel(y)
        k = -(-yf.size // n0)
        yf = jnp.pad(yf, (0, k * n0 - yf.size))
        folded = jax.lax.reduce(yf.reshape(k, n0), jnp.uint32(0),
                                jnp.bitwise_xor, (0,))
        return (folded & jnp.uint32(1)).reshape(x0.shape)

    @jax.jit
    def run(da, db, tag0):
        def body(tag, _):
            ca = a.with_(data=jnp.bitwise_xor(da, tag))
            out = sess.ev.multiply_relin_rescale(ca, b.with_(data=db),
                                                 sess.rk)
            return fold_into(da, out.data), ()
        tag, _ = jax.lax.scan(body, tag0, None, length=K)
        return tag

    tag = jnp.zeros_like(a.data)
    jax.block_until_ready(run(a.data, b.data, tag))      # compile + warm

    reps = int(os.environ.get("HETPU_BENCH_REPS", "3"))
    t0 = time.perf_counter()
    for _ in range(reps):
        tag = run(a.data, b.data, tag)
    jax.block_until_ready(tag)
    dt = time.perf_counter() - t0

    ops_per_s = BATCH * K * reps / dt
    print(json.dumps({
        "metric": "ckks_mult_relin_rescale_n14_ops_per_s",
        "value": round(ops_per_s, 2),
        "unit": "ops/s",
        "vs_baseline": None,
    }))


if __name__ == "__main__":
    main()
