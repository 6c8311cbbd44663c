"""Card against host CPU, bit by bit, where float rounding can differ.

    python scripts/numerics_check.py

Ring arithmetic is exact integer arithmetic, but three places round
floats, and a GPU compiler may contract a multiply and an add into one
fused multiply-add, which rounds once instead of twice:

1. the Veltkamp split and Dekker two-product of core/twofloat.py (the
   precise α of BFV's fast base conversions rests on both being exact);
2. the plain-f32 α of the centred fast base conversion (rns.fbc_apply)
   in key-switch mod-down and the fused rescale;
3. whatever the compiled ops do beyond that.

The same jitted functions run on the GPU and on the CPU backend of the
same process, at ckks_deep_hi widths (N=2^15, the key basis of the
top level).  Prints one JSON line per comparison: mismatching elements,
and for the fused op the decrypt error of both results.
"""

from __future__ import annotations

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="ckks_deep_hi")
    args = ap.parse_args(argv)

    from hetpu.utils.device import card_name_and_power_limit, require_gpu
    dev = require_gpu()
    card = card_name_and_power_limit()
    print("device:", dev, "| card:", card, flush=True)

    import jax
    import jax.numpy as jnp
    from hetpu.core import backend, rns, twofloat
    from hetpu.core.evaluator import Evaluator
    from hetpu.session import Session

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]

    def emit(**kw):
        print(json.dumps({**kw, "device": dev["kind"], "card": card}),
              flush=True)

    def both(fn, *args):
        """fn on the GPU and on the CPU."""
        g = jax.jit(fn)(*(jax.device_put(a, gpu) for a in args))
        with jax.default_device(cpu):
            c = jax.jit(fn)(*(jax.device_put(a, cpu) for a in args))
        return jax.tree.map(np.asarray, g), jax.tree.map(np.asarray, c)

    rng = np.random.default_rng(0)

    # 1. two-float error-free transformations
    a = rng.uniform(-2.0 ** 15, 2.0 ** 15, 1 << 20).astype(np.float32)
    b = rng.uniform(0, 2.0 ** -14, 1 << 20).astype(np.float32)
    (gp, ge), (cp, ce) = both(twofloat.two_prod, a, b)
    exact = a.astype(np.float64) * b.astype(np.float64)
    emit(check="two_prod", n=int(a.size),
         mismatches=int(((gp != cp) | (ge != ce)).sum()),
         gpu_inexact=int((gp.astype(np.float64) + ge != exact).sum()),
         cpu_inexact=int((cp.astype(np.float64) + ce != exact).sum()))
    (gh, gl), (ch, cl) = both(twofloat._split, a)
    emit(check="veltkamp_split", n=int(a.size),
         mismatches=int(((gh != ch) | (gl != cl)).sum()))

    # 2. fast base conversion, plain and precise α, deep_hi mod-down
    sess = Session.create(args.preset, seed=b"\x21" * 32,
                          galois_steps=[])
    ctx = sess.ctx
    lvl = ctx.num_data - 1
    md = ctx.keyswitch_plan(lvl).moddown
    n = ctx.params.poly_degree
    qs = np.array(md.src_tables.primes, dtype=np.uint64).reshape(-1, 1)
    u = (rng.integers(0, 1 << 62, (8, len(qs), n), dtype=np.uint64)
         % qs).astype(np.uint32)
    for precise in (False, True):
        g, c = both(lambda x: rns.fbc_apply(x, md.fbc, correct=True,
                                            premul=False, precise=precise),
                    u)
        emit(check="fbc_apply", precise=precise, n=n,
             planes=int(np.prod(g.shape[:-1])),
             mismatches=int((g != c).sum()))

    # 3. the fused op end to end, GPU against CPU
    x = rng.uniform(-1, 1, sess.slots)
    y = rng.uniform(-1, 1, sess.slots)
    cx, cy = sess.encrypt(x), sess.encrypt(y)
    g = Evaluator(ctx).multiply_relin_rescale(cx, cy, sess.rk)
    with jax.default_device(cpu):
        to_cpu = lambda ct: ct.with_(data=jax.device_put(ct.data, cpu))
        rk_cpu = jax.device_put(sess.rk, cpu)
        c = Evaluator(ctx).multiply_relin_rescale(to_cpu(cx), to_cpu(cy),
                                                  rk_cpu)
    gd, cd = np.asarray(g.data), np.asarray(c.data)
    err = lambda ct: float(np.max(np.abs(
        sess.decrypt(ct.with_(data=jnp.asarray(np.asarray(ct.data))))
        .real - x * y)))
    emit(check="multiply_relin_rescale", preset=args.preset,
         gpu_path=backend.ntt_path("gpu"), n=n,
         mismatches=int((gd != cd).sum()), elements=int(gd.size),
         gpu_err=err(g), cpu_err=err(c))


if __name__ == "__main__":
    main()
