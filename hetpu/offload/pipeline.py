"""Multi-host pipeline stand-in: host-0 client → mesh-parallel evaluator
(VERDICT r2 item 9; SURVEY.md §2d "Pipeline/offload parallelism").

The reference's offload is a single-threaded evaluator behind a TCP
socket (``client.cpp`` / ``server.cpp``).  Here the evaluator side is a
*pod-slice analog*: it builds a ``dp`` mesh over ALL of its local
devices, shards the batch axis of the received ciphertexts, and runs the
encrypted step as ONE jitted sharded program.  The client side keeps the
reference's trust split — secret key never crosses the wire, evaluator
session comes from ``Session.from_wire`` (no decrypt path) — and the
transport reuses the size-prefixed wire format of ``core/serial``.

On one machine this runs against the 8-virtual-device CPU mesh (the
SURVEY §4 "multi-node-without-a-cluster" harness, like
``client_server_rookie.cpp``).  On real multi-host hardware the SAME
evaluator code spans processes: call ``jax.distributed.initialize()``
first (env ``HETPU_COORD=host:port``, ``HETPU_PROC_ID``,
``HETPU_NUM_PROCS``) and ``jax.devices()`` becomes the global device
set; nothing else changes.
"""

from __future__ import annotations

import json

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import random as rnd, serial
from ..core.modular import mod_add
from ..runtime import native
from ..session import Session
from . import recv_reply, recv_request, send_reply, send_request


def maybe_init_distributed() -> None:
    """Span processes over DCN when the env asks for it (no-op
    otherwise).  With HETPU_COORD set, jax.devices() afterwards covers
    every process's chips and the pipeline below is multi-host."""
    import os
    coord = os.environ.get("HETPU_COORD")
    if coord:
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(os.environ["HETPU_NUM_PROCS"]),
            process_id=int(os.environ["HETPU_PROC_ID"]))


def evaluate_sharded(sess: Session, cts, n_devices: int | None = None):
    """The evaluator-side pod program: batch the operand cts, shard the
    batch axis over a dp mesh of local devices, run ONE jitted
    mult+relin+rescale + rotate + accumulate step, return per-item cts."""
    devs = np.array(jax.devices())
    nd = int(n_devices or devs.size)
    mesh = Mesh(devs[:nd], axis_names=("dp",))
    if len(cts) % 2 != 0:
        raise ValueError(
            f"evaluate_sharded pairs operands: need an even ciphertext "
            f"count, got {len(cts)}")
    half = len(cts) // 2
    if half % nd != 0:
        raise ValueError(
            f"batch of {half} pairs does not divide the {nd}-device dp "
            "mesh; pad the request or pass n_devices")
    xa = jnp.stack([c.data for c in cts[:half]])
    xb = jnp.stack([c.data for c in cts[half:]])
    proto = cts[0]
    sh = NamedSharding(mesh, P("dp"))
    xa, xb = jax.device_put(xa, sh), jax.device_put(xb, sh)

    def step(da, db):
        prod = sess.ev.multiply_relin_rescale(
            proto.with_(data=da), proto.with_(data=db), sess.rk)
        rot = sess.ev.rotate(prod, 1, sess.gk)
        return sess.ev.add(prod, rot)

    with mesh:
        out = jax.jit(step, in_shardings=(sh, sh))(xa, xb)
    host = np.asarray(out.data)
    return [out.with_(data=host[i]) for i in range(half)]


def _infer_weights(slots: int, n_diags: int, wseed: int):
    """Deterministic 'model weights' both ends can derive from the wire
    header: n_diags circulant diagonals + a degree-2 activation poly.
    (Inference setting: the EVALUATOR owns the weights; only the seed
    crosses the wire.)"""
    rng = np.random.default_rng(wseed)
    diags = rng.uniform(-1, 1, (n_diags, slots)) / n_diags
    act = (0.5, 0.25, -0.02)          # c0 + c1·u + c2·u² (sigmoid-ish)
    return diags, act


def infer_step(sess: Session, ct, diags, act):
    """ONE inference layer on an encrypted activation vector: diagonal-
    method matvec against plaintext weights (rotation hot loop with ONE
    hoisted decomposition) + degree-2 activation polynomial with exact
    solved-scale alignment — the BASELINE config-5 workload (replaces the
    r4 toy mult+rot+add step).  Consumes 3 levels (g=1)."""
    from ..math import mult_const_to
    ev = sess.ev
    n_diags = len(diags)
    rots = [ct] + ev.rotate_hoisted(ct, list(range(1, n_diags)), sess.gk)
    q = sess.ctx.mont(ct.level)["q"]
    acc = None
    for d, src in enumerate(rots):
        pt = sess.cached_encode(("infer_diag", d, n_diags), diags[d],
                                level=src.level)
        term = ev.multiply_plain(src, pt)
        acc = term.data if acc is None else mod_add(acc, term.data, q)
    u = ev.rescale(term.with_(data=acc))               # W·x
    c0, c1, c2 = act
    u2 = ev.square_relin_rescale(u, sess.rk)           # u²
    s = u.scale
    quad = mult_const_to(sess, u2, c2, s)
    lin = mult_const_to(sess, sess.reach_level(u, u2.level), c1, s)
    y = ev.add(quad, lin)
    return ev.add_plain(y, sess.const_like(y, c0))


def infer_reference(x: np.ndarray, diags: np.ndarray, act) -> np.ndarray:
    """Plaintext replica of infer_step for verification."""
    u = sum(diags[d] * np.roll(x, -d) for d in range(len(diags)))
    c0, c1, c2 = act
    return c0 + c1 * u + c2 * u * u


def evaluate_sharded_infer(sess: Session, cts, wseed: int, n_diags: int = 8,
                           n_devices: int | None = None):
    """Pod-side inference: shard the request batch over the dp mesh and
    run infer_step as ONE jitted sharded program (BASELINE config 5:
    'batched enc matvec + activation polynomial eval sharded across
    hosts')."""
    devs = np.array(jax.devices())
    nd = int(n_devices or devs.size)
    mesh = Mesh(devs[:nd], axis_names=("dp",))
    if len(cts) % nd != 0:
        raise ValueError(f"batch {len(cts)} does not divide dp mesh {nd}")
    diags, act = _infer_weights(sess.slots, n_diags, wseed)
    x = jnp.stack([c.data for c in cts])
    proto = cts[0]
    sh = NamedSharding(mesh, P("dp"))
    x = jax.device_put(x, sh)

    def step(dx):
        return infer_step(sess, proto.with_(data=dx), diags, act)

    with mesh:
        out = jax.jit(step, in_shardings=(sh,))(x)
    host = np.asarray(out.data)
    return [out.with_(data=host[i]) for i in range(len(cts))]


def serve_pipeline(transport=None, n_devices: int | None = None) -> int:
    """Evaluator process: answer ONE pipeline request.  Returns the batch
    size served."""
    t = transport
    if t is None:
        maybe_init_distributed()
        t, _ = native.serve()
    try:
        header, sess, cts = recv_request(t)
        if header["workload"] == "pipeline":
            results = evaluate_sharded(sess, cts, n_devices)
        elif header["workload"] == "pipeline_infer":
            results = evaluate_sharded_infer(
                sess, cts, wseed=int(header["wseed"]),
                n_diags=int(header.get("n_diags", 8)), n_devices=n_devices)
        else:
            raise ValueError(f"expected pipeline*, got {header['workload']!r}")
        send_reply(t, results)
        return len(results)
    finally:
        if transport is None:
            t.close()


def run_client(t, batch: int = 8, params="test_tiny", seed=None):
    """Client process: encrypt 2·batch operands (seeded symmetric — half
    wire size), offload, decrypt, verify against plaintext math.
    Returns (max_error, results)."""
    sess = Session.create(params, seed=seed, galois_steps=[1])
    rng = np.random.default_rng(0)
    vals = [rng.uniform(-1, 1, sess.slots) for _ in range(2 * batch)]
    pairs = []
    for v in vals:
        s = rnd.new_seed()
        pairs.append((sess.encryptor.encrypt_symmetric(sess.encode(v),
                                                       seed=s), s))
    send_request(t, "pipeline", sess.ctx.params, rk=sess.rk, gk=sess.gk,
                 cts=[c for c, _ in pairs], seeds=[s for _, s in pairs])
    res = recv_reply(t, sess.ctx)
    errs = []
    for i, ct in enumerate(res):
        got = sess.decrypt(ct).real
        w = vals[i] * vals[batch + i]
        errs.append(np.max(np.abs(got - (w + np.roll(w, -1)))))
    return float(np.max(errs)), res


def run_client_infer(t, batch: int = 8, params="test_deep", seed=None,
                     n_diags: int = 8, wseed: int = 7):
    """Client for the config-5 inference pipeline: encrypt a batch of
    activation vectors, offload matvec+activation to the pod evaluator,
    decrypt, verify against the plaintext replica.  Galois keys cover the
    evaluator's diagonal rotations 1..n_diags−1 (the key material the
    reference client ships for the server's rotation loop,
    ``client.cpp``/``server.cpp``)."""
    sess = Session.create(params, seed=seed,
                          galois_steps=list(range(1, n_diags)))
    rng = np.random.default_rng(1)
    vals = [rng.uniform(-1, 1, sess.slots) for _ in range(batch)]
    pairs = []
    for v in vals:
        s = rnd.new_seed()
        pairs.append((sess.encryptor.encrypt_symmetric(sess.encode(v),
                                                       seed=s), s))
    send_request(t, "pipeline_infer", sess.ctx.params, rk=sess.rk,
                 gk=sess.gk, cts=[c for c, _ in pairs],
                 seeds=[s for _, s in pairs],
                 meta={"wseed": wseed, "n_diags": n_diags})
    res = recv_reply(t, sess.ctx)
    diags, act = _infer_weights(sess.slots, n_diags, wseed)
    errs = []
    for i, ct in enumerate(res):
        got = sess.decrypt(ct).real
        errs.append(np.max(np.abs(got - infer_reference(vals[i], diags,
                                                        act))))
    return float(np.max(errs)), res
