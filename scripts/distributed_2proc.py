"""Two-PROCESS distributed evaluator exercise, on the host CPU only.

Spawns a coordinator + worker process (jax.distributed, CPU backend with
4 virtual devices each → one 8-device global dp mesh) and runs a sharded
mult+relin+rescale step across BOTH processes with decrypt verification
— the CPU-emulated form of SURVEY §4(c)'s multi-host recipe and the
analog of the reference's 2-process client/server trust split
(client.cpp / server.cpp).

This is a stand-in that never touches a GPU: two processes would each
take a card.  One process drives all the cards of a machine (see
``chip_smoke.py --four``).

Usage:
  python scripts/distributed_2proc.py          # parent: spawns both, checks
  (child invocation is internal: --role N with HETPU_COORD/... set)
"""
import os
import pathlib
import socket
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

LOCAL_DEVS = 4
NPROCS = 2
SEED = b"\x5a" * 32


def child(role: int) -> None:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count={LOCAL_DEVS}").strip()
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")      # CPU-only stand-in
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from hetpu.offload.pipeline import maybe_init_distributed
    maybe_init_distributed()               # HETPU_COORD/NUM_PROCS/PROC_ID
    assert jax.process_count() == NPROCS, jax.process_count()
    n_glob = len(jax.devices())
    assert n_glob == LOCAL_DEVS * NPROCS, n_glob

    # identical deterministic session in both processes (same seed →
    # bit-identical keys; the real pod would broadcast serialized keys)
    from hetpu.session import Session
    sess = Session.create("test_tiny", seed=SEED, galois_steps=[1])

    rng = np.random.default_rng(0)
    B = n_glob
    xs = [rng.uniform(-1, 1, sess.slots) for _ in range(B)]
    ys = [rng.uniform(-1, 1, sess.slots) for _ in range(B)]
    cts_a = [sess.encrypt(x) for x in xs]
    cts_b = [sess.encrypt(y) for y in ys]
    da = np.stack([np.asarray(c.data) for c in cts_a])
    db = np.stack([np.asarray(c.data) for c in cts_b])

    mesh = Mesh(np.array(jax.devices()).reshape(n_glob), axis_names=("dp",))
    sh = NamedSharding(mesh, P("dp"))
    # every process holds the full host batch; hand jax each shard
    ga = jax.make_array_from_callback(da.shape, sh, lambda idx: da[idx])
    gb = jax.make_array_from_callback(db.shape, sh, lambda idx: db[idx])
    proto = cts_a[0]

    @jax.jit
    def step(u, v):
        out = sess.ev.multiply_relin_rescale(
            proto.with_(data=u), proto.with_(data=v), sess.rk)
        return out.data, out.level, out.scale

    with mesh:
        out_d, lvl, scale = step(ga, gb)
    # replicate for verification (multihost: every proc gets every shard)
    from jax.experimental import multihost_utils
    host = multihost_utils.process_allgather(out_d, tiled=True)
    max_err = 0.0
    for i in range(B):
        got = sess.decrypt(proto.with_(data=host[i], level=int(lvl),
                                       scale=float(scale)))
        max_err = max(max_err, float(np.abs(got.real - xs[i] * ys[i]).max()))
    print(f"proc{role}: DISTRIBUTED_OK n_procs={jax.process_count()} "
          f"global_devices={n_glob} max_err={max_err:.2e}", flush=True)
    assert max_err < 5e-3, max_err


def parent() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    procs = []
    for role in range(NPROCS):
        env = dict(os.environ,
                   HETPU_COORD=coord,
                   HETPU_NUM_PROCS=str(NPROCS),
                   HETPU_PROC_ID=str(role))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--role", str(role)],
            env=env, cwd=str(REPO),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    ok = True
    t0 = time.time()
    for role, p in enumerate(procs):
        out, _ = p.communicate(timeout=900)
        tail = "\n".join(out.strip().splitlines()[-4:])
        print(f"--- proc {role} (exit {p.returncode}, "
              f"{time.time()-t0:.0f}s) ---\n{tail}")
        ok &= p.returncode == 0 and "DISTRIBUTED_OK" in out
    print("RESULT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    if "--role" in sys.argv:
        child(int(sys.argv[sys.argv.index("--role") + 1]))
    else:
        sys.exit(parent())
