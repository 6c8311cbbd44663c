"""Smoke run of hetpu's main path on the GPU, at the presets users run.

    python chip_smoke.py          # one card
    python chip_smoke.py --four   # the multi-card path only, on four cards

One process drives every phase through the entry points a user calls
(Session, the Evaluator, BfvSession, the least-squares demo, the offload
client and server).  Each phase prints one line with its result, or its
error and traceback; any failed phase makes the script exit non-zero and
print no result line.  Without a GPU it stops before the first phase.

One card:
  device   platform, device kind, count, XLA_FLAGS, compile-cache
           directory, the card's name and power limit
  ntt      bench_n14: the golden vectors on the device path; forward,
           inverse, digit-lift and fast-base-conversion variants bit by
           bit against the host CPU
  op       bench_n14, B=8: multiply_relin_rescale, rotate,
           rotate_hoisted and mod_switch decrypt-compared; the batched
           fused op bit-exact against the same op on the host CPU
  bfv      bfv_batch: multiply_relin, exact
  lsq      least_squares_2d at full size (ckks_deep_hi), error < 2^-10
  served   the offload ``inv`` request at full size (ckks_deep), client
           and server in one process over a socketpair
  memory   compiled.memory_analysis() of the fused op, peak bytes in use

Four cards (--four): the dp-sharded fused op, tp relinearize and rotate,
the cp NTT, bucketed_matvec and the server's dp mesh, each bit-exact
against one card or decrypt-checked.

The last line is ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import json
import os
import pathlib
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent
SEED = b"\x21" * 32

# full-size configuration (what the card runs) ...
FULL = {
    "ntt": "bench_n14", "golden": ("golden_n14", "ntt_n14"),
    "op": "bench_n14", "batch": 8, "bfv": "bfv_batch", "small": False,
}
# ... and one a CPU test can afford (N=4096 keeps four-step tables)
SMALL = {
    "ntt": "test_n4096", "golden": None,
    "op": "test_n4096", "batch": 4, "bfv": "test_bfv_tiny", "small": True,
}


def _params(name):
    from hetpu.core.params import ckks_params, preset
    if name == "test_n4096":
        return ckks_params(1 << 12, levels=3, scale_bits=30, num_special=2,
                           first_prime_bits=31, special_prime_bits=31,
                           sec_level=0)
    return preset(name)


def _max_err(got, want):
    import numpy as np
    return float(np.max(np.abs(np.asarray(got).real - want)))


def _check(cond, what):
    if not cond:
        raise AssertionError(what)


# ----------------------------------------------------------------------
# one card
# ----------------------------------------------------------------------

def phase_device(cfg):
    import jax
    from hetpu.utils.device import card_name_and_power_limit
    devs = jax.devices()
    print(card_name_and_power_limit())         # as nvidia-smi gives it
    return (f"platform={devs[0].platform} kind={devs[0].device_kind} "
            f"count={len(devs)} XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}"
            f" cache={jax.config.jax_compilation_cache_dir}")


def _on_host(fn, *args):
    """fn on the host CPU backend: the card's results are compared with
    these bit by bit."""
    import jax
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        return jax.jit(fn)(*(jax.device_put(a, cpu) for a in args))


def phase_ntt(cfg):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from hetpu.core import backend, ntt4, rns
    from hetpu.core.context import Context
    from hetpu.core.ntt import ntt_fwd, ntt_inv
    ctx = Context(_params(cfg["ntt"]))
    t = ctx.tables_full
    out = [f"path={backend.ntt_path()}"]
    if cfg["golden"]:
        fname, key = cfg["golden"]
        z = np.load(ROOT / "tests" / "golden" / f"{fname}.npz")
        _check(tuple(int(p) for p in z[f"{key}_primes"]) == t.primes,
               "golden basis differs from the preset's")
        x = jnp.asarray(z[f"{key}_x"])
        _check((np.asarray(jax.jit(lambda a: ntt_fwd(a, t))(x))
                == z[f"{key}_fwd"]).all(), "forward NTT != golden")
        _check((np.asarray(jax.jit(lambda a: ntt_inv(a, t))(x))
                == z[f"{key}_inv"]).all(), "inverse NTT != golden")
        out.append("golden bit-exact")
    lvl = ctx.num_data - 1
    tl = ctx.tables(lvl)
    ks = ctx.keyswitch_plan(lvl)
    md = ks.moddown
    n = ctx.params.poly_degree
    rng = np.random.default_rng(1)
    q = np.array(tl.primes, dtype=np.uint32).reshape(-1, 1)
    x = jnp.asarray(rng.integers(0, 1 << 31, (8, lvl + 1, n), np.uint32) % q)
    qs = np.array(md.src_tables.primes, dtype=np.uint32).reshape(-1, 1)
    u = jnp.asarray(rng.integers(0, 1 << 31, (8, len(qs), n), np.uint32) % qs)

    def fwd(a):
        return ntt4.ntt_fwd(a, tl)

    def inv(a):
        return ntt4.ntt_inv(a, tl, strip_mont=True, extra=ks.dig_inv)

    def lifted(a):
        from hetpu.core.modular import mod_add, shoup_mul
        accs = []
        for di, (lo, hi) in enumerate(ks.digit_bounds):
            f = ks.foreign_idx[di]
            acc = None
            for i in range(lo, hi):
                term = shoup_mul(a[..., i: i + 1, :], ks.dhat[i][f][:, None],
                                 ks.dhat_shoup[i][f][:, None], ks.q[f])
                acc = term if acc is None else mod_add(acc, term, ks.q[f])
            accs.append(acc)
        return ntt4.ntt_fwd(jnp.concatenate(accs, axis=-2),
                            ks.foreign_cat_tables)

    def fbc(a):
        return ntt4.ntt_fwd(rns.fbc_apply(a, md.fbc, correct=True,
                                          premul=False),
                            md.dst_tables, to_mont=True)

    # (name, device result, reference on the host CPU)
    cases = (
        ("fwd vs host", lambda: jax.jit(fwd)(x), lambda: _on_host(fwd, x)),
        ("inv vs host", lambda: jax.jit(inv)(x), lambda: _on_host(inv, x)),
        ("fbc vs host", lambda: jax.jit(fbc)(u), lambda: _on_host(fbc, u)),
        ("lifted vs host", lambda: jax.jit(lifted)(x),
         lambda: _on_host(lifted, x)),
    )
    for name, got, want in cases:
        got, want = np.asarray(got()), np.asarray(want())
        bad = int((got != want).sum())
        _check(bad == 0, f"{name}: {bad} of {got.size} elements differ")
        out.append(f"{name} bit-exact ({got.shape[0] * got.shape[1]} planes)")
    return "; ".join(out)


_SESSIONS: dict = {}


def _session(cfg, name, steps):
    """Session.create, shared between phases that use the same keys."""
    from hetpu.session import Session
    key = (name, tuple(steps))
    if key not in _SESSIONS:
        _SESSIONS[key] = Session.create(_params(name), seed=SEED,
                                        galois_steps=steps)
    return _SESSIONS[key]


def phase_op(cfg):
    import numpy as np
    import jax.numpy as jnp
    from hetpu.core.evaluator import Evaluator
    sess = _session(cfg, cfg["op"], [1])
    ev = sess.ev
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, sess.slots)
    y = rng.uniform(-1, 1, sess.slots)
    cx, cy = sess.encrypt(x), sess.encrypt(y)
    errs = {
        "multiply_relin_rescale": (_max_err(sess.decrypt(
            ev.multiply_relin_rescale(cx, cy, sess.rk)), x * y), 2e-3),
        "rotate": (_max_err(sess.decrypt(ev.rotate(cx, 1, sess.gk)),
                            np.roll(x, -1)), 1e-2),
        "rotate_hoisted": (_max_err(sess.decrypt(
            ev.rotate_hoisted(cx, [1], sess.gk)[0]), np.roll(x, -1)), 1e-2),
        "mod_switch": (_max_err(sess.decrypt(ev.mod_switch(cx)), x), 2e-3),
    }
    for name, (err, bound) in errs.items():
        _check(err < bound, f"{name} decrypt error {err} >= {bound}")
    B = cfg["batch"]
    xs = rng.uniform(-1, 1, (B, sess.slots))
    ys = rng.uniform(-1, 1, (B, sess.slots))
    a = cx.with_(data=jnp.stack([sess.encrypt(v).data for v in xs]))
    b = cy.with_(data=jnp.stack([sess.encrypt(v).data for v in ys]))
    got = ev.multiply_relin_rescale(a, b, sess.rk)
    host = Evaluator(sess.ctx)
    want = _on_host(lambda da, db, rk: host.multiply_relin_rescale(
        a.with_(data=da), b.with_(data=db), rk).data, a.data, b.data, sess.rk)
    bad = int((np.asarray(got.data) != np.asarray(want)).sum())
    _check(bad == 0, f"batched fused op: {bad} elements differ from the "
                     f"same op on the host CPU")
    err_b = max(_max_err(sess.decrypt(got.with_(data=got.data[i])),
                         xs[i] * ys[i]) for i in range(B))
    _check(err_b < 2e-3, f"batched fused op decrypt error {err_b}")
    return "; ".join(f"{k} err={e:.3e}" for k, (e, _) in errs.items()) + \
        f"; batched B={B} bit-exact vs host CPU, err={err_b:.3e}"


def phase_bfv(cfg):
    import numpy as np
    from hetpu.bfv import BfvSession
    sess = BfvSession.create(cfg["bfv"], seed=b"\x41" * 32, galois_steps=[])
    rng = np.random.default_rng(10)
    t = sess.scheme.t
    hi = min(t, 1 << 40)
    a = rng.integers(0, hi, sess.slots)
    b = rng.integers(0, hi, sess.slots)
    got = np.asarray(sess.decrypt(sess.multiply_relin(
        sess.encrypt(a), sess.encrypt(b)))).astype(object)
    want = (a.astype(object) * b.astype(object)) % t
    bad = int((got != want).sum())
    _check(bad == 0, f"BFV multiply_relin: {bad} slots wrong")
    return f"multiply_relin exact over {sess.slots} slots, t={t}"


def phase_lsq(cfg):
    from hetpu.demos.matrix_operations import demo_least_squares_2d
    err = demo_least_squares_2d(small=cfg["small"])
    bound = 2 ** -10
    _check(err < bound, f"least-squares error {err} >= 2^-10")
    return f"least_squares_2d err={err:.3e} (< 2^-10)"


def phase_served(cfg):
    import numpy as np
    from hetpu.demos.offload_demos import demo_rookie
    got, want = demo_rookie("inv", small=cfg["small"])
    rel = float(np.max(np.abs(np.asarray(got).real - want) / np.abs(want)))
    _check(rel < 5e-3, f"offload inv relative error {rel}")
    return f"offload inv answered, {len(want)} slots, max rel err={rel:.3e}"


def phase_memory(cfg):
    import numpy as np
    import jax
    import jax.numpy as jnp
    sess = _session(cfg, cfg["op"], [1])
    B = cfg["batch"]
    ct = sess.encrypt(np.zeros(sess.slots))
    a = ct.with_(data=jnp.stack([ct.data] * B))
    ma = sess.ev.multiply_relin_rescale.lower(a, a, sess.rk).compile() \
        .memory_analysis()
    stats = jax.devices()[0].memory_stats() or {}
    return (f"fused op B={B}: {ma}; peak_bytes_in_use="
            f"{stats.get('peak_bytes_in_use', 'n/a')}")


ONE_CARD = (phase_device, phase_ntt, phase_op, phase_bfv, phase_lsq,
            phase_served, phase_memory)


# ----------------------------------------------------------------------
# four cards
# ----------------------------------------------------------------------

def _mesh(n, name):
    import numpy as np
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:n]), axis_names=(name,))


def four_dp(cfg):
    """dp-sharded fused op at bench_n14, B=8, against one card."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from hetpu import parallel
    sess = _session(cfg, cfg["op"], [1])
    rng = np.random.default_rng(3)
    B = cfg["batch"]
    a = sess.encrypt(np.zeros(sess.slots)).with_(data=jnp.stack(
        [sess.encrypt(v).data for v in rng.uniform(-1, 1, (B, sess.slots))]))
    one = jax.device_put(a.data, jax.devices()[0])
    want = np.asarray(sess.ev.multiply_relin_rescale(
        a.with_(data=one), a.with_(data=one), sess.rk).data)
    sh = parallel.shard_batch(a, _mesh(4, "dp"), "dp")
    got = sess.ev.multiply_relin_rescale(sh, sh, sess.rk)
    _check(len(got.data.sharding.device_set) == 4, "output not on 4 cards")
    _check((np.asarray(got.data) == want).all(), "dp fused op != one card")
    return f"dp=4 fused op B={B} bit-exact vs one card"


def four_tp(cfg):
    """tp relinearize and rotate at bench_n14 level 7 (8 data limbs)."""
    import numpy as np
    from hetpu.core import galois
    from hetpu.parallel import tp as tpmod
    sess = _session(cfg, cfg["op"], [1])
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, sess.slots)
    ct = sess.encrypt(x)
    while (ct.level + 1) % 4:
        ct = sess.ev.mod_switch(ct)
    mesh = _mesh(4, "tp")
    c3 = sess.ev.multiply(ct, ct)
    want = np.asarray(sess.ev.relinearize(c3, sess.rk).data)
    got = np.asarray(tpmod.tp_relinearize(sess, c3, mesh, axis="tp").data)
    _check((got == want).all(), "tp relinearize != one card")
    n = sess.ctx.params.poly_degree
    want = np.asarray(sess.ev.apply_galois(
        ct, galois.rotation_elt(n, 1), sess.gk).data)
    got = np.asarray(tpmod.tp_rotate(sess, ct, 1, mesh).data)
    _check((got == want).all(), "tp rotate != one card")
    return (f"tp=4 relinearize + rotate bit-exact vs one card "
            f"({cfg['op']}, level {ct.level}, {ct.level + 1} limbs)")


def four_cp(cfg):
    """cp NTT at N=2^14 over 4 cards against one card."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from hetpu.core.context import Context
    from hetpu.core.ntt import ntt_fwd, ntt_inv
    from hetpu.parallel import cp as cpmod
    ctx = Context(_params(cfg["op"]))
    t = ctx.tables(ctx.num_data - 1)
    rng = np.random.default_rng(5)
    q = np.array(t.primes, dtype=np.uint32).reshape(-1, 1)
    x = jnp.asarray(rng.integers(0, 1 << 31, (len(t.primes), t.n),
                                 np.uint32) % q)
    mesh = _mesh(4, "cp")
    want = np.asarray(jax.jit(lambda a: ntt_fwd(a, t))(x))
    got = np.asarray(cpmod.cp_ntt_fwd(x, t, mesh))
    _check((got == want).all(), "cp forward NTT != one card")
    back = np.asarray(cpmod.cp_ntt_inv(jnp.asarray(want), t, mesh))
    _check((back == np.asarray(jax.jit(lambda a: ntt_inv(a, t))(
        jnp.asarray(want)))).all(), "cp inverse NTT != one card")
    return f"cp=4 NTT N={t.n} fwd+inv bit-exact vs one card"


def four_matvec(cfg):
    """bucketed_matvec 64x64 at N=2^13 (ckks_small) over rot=4."""
    import numpy as np
    import jax.numpy as jnp
    from hetpu import parallel
    d = 8 if cfg["small"] else 64
    sess = _session(cfg, "test_tiny" if cfg["small"] else "ckks_small",
                    list(range(d)))
    rng = np.random.default_rng(6)
    A = rng.uniform(-1, 1, (d, d))
    v = rng.uniform(-1, 1, d)
    rows = [sess.encrypt(np.tile([A[i, (i + j) % d] for i in range(d)],
                                 2)).data for j in range(d)]
    diags = sess.encrypt(np.zeros(d)).with_(data=jnp.stack(rows))
    out = parallel.bucketed_matvec(sess, diags, sess.encrypt(np.tile(v, 2)),
                                   d, _mesh(4, "rot"), "rot")
    err = _max_err(sess.decrypt(out)[:d], A @ v)
    _check(err < 1e-2, f"bucketed_matvec error {err}")
    return f"bucketed_matvec {d}x{d} rot=4 err={err:.3e}"


def four_server(cfg):
    """The offload server's dp mesh: batch_matmul over 4 cards."""
    import threading
    import numpy as np
    import jax
    from hetpu.demos.offload_demos import serve_or_hang_up
    from hetpu.offload import server
    from hetpu.offload.client import Client
    from hetpu.runtime import native
    seen = []
    stack = server._stack

    def spy(sess, cts):
        out = stack(sess, cts)
        seen.append(len(out.data.sharding.device_set))
        return out

    server._stack = spy
    try:
        cl = Client("test_tiny" if cfg["small"] else "ckks_small",
                    galois_steps=[1], seed=b"\x51" * 32)
        rng = np.random.default_rng(8)
        a = rng.uniform(-1, 1, (2, 4, 8))        # 8 operands per side
        b = rng.uniform(-1, 1, (4, 2, 8))
        ta, tb = native.pipe_pair()
        th = threading.Thread(target=serve_or_hang_up, args=(tb,))
        th.start()
        try:
            got = cl.batch_matmul(ta, a, b)
        finally:
            th.join()
            ta.close()
            tb.close()
    finally:
        server._stack = stack
    _check(seen and min(seen) == len(jax.devices()),
           f"server operands spread over {seen} devices")
    err = _max_err(got[:, :, :8], np.einsum("ikb,kjb->ijb", a, b))
    _check(err < 1e-2, f"served batch_matmul error {err}")
    return f"server dp mesh over {seen[0]} cards, batch_matmul err={err:.3e}"


FOUR_CARDS = (phase_device, four_dp, four_tp, four_server, four_cp,
              four_matvec)


# ----------------------------------------------------------------------

def run(phases, cfg) -> bool:
    ok = True
    for fn in phases:
        t0 = time.perf_counter()
        try:
            detail = fn(cfg)
        except Exception:
            ok = False
            print(f"[{fn.__name__}] FAIL after "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            traceback.print_exc(file=sys.stdout)
            continue
        print(f"[{fn.__name__}] ok {time.perf_counter() - t0:.1f} s: "
              f"{detail}", flush=True)
    return ok


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    four = "--four" in argv
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX's default device is "
              f"{devs[0].platform!r})", file=sys.stderr)
        return 2
    if four and len(devs) < 4:
        print(f"chip_smoke --four: {len(devs)} GPU(s), needs 4",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import hetpu  # noqa: F401  (fails outside the repository)
    if not run(FOUR_CARDS if four else ONE_CARD, FULL):
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": 4 if four else len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
