"""Multi-chip parallelism over a jax.sharding.Mesh.

The reference has NO intra-job parallelism (single-threaded CPU + a TCP
offload, SURVEY.md §2d) — every concept here is created for this build
and anchored to the reference's behavioral patterns:

* **batch (dp)** — the slot/SIMD batching axis as a sharded array axis
  (`shard_batch`); thousands of independent ciphertexts spread over chips.
* **rotation/key parallelism** — the diagonal-matmul hot loop's rotations
  bucketed across a mesh axis, Galois keys sharded with their buckets,
  per-device partial sums combined by a modular all-reduce over NVLink
  (`bucketed_matvec`) — the BASELINE north-star pattern.
* **modular collectives** — `mod_all_reduce`: uint32 residues can't ride a
  plain `psum` (overflow); a ppermute butterfly with `mod_add` at each of
  log2(n) rounds keeps everything in [0, q).

Multi-host: the same programs run over a process-spanning mesh via
`jax.distributed` (DCN); the trust-boundary offload (client encrypts,
pod evaluates) reuses the wire format in core/serial.py.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import galois
from ..core.ciphertext import Ciphertext
from ..core.keys import KSwitchKey
from ..core.modular import mod_add
from ..session import Session


def make_mesh(shape=None, names=("dp",)) -> Mesh:
    devs = np.array(jax.devices())
    if shape is None:
        shape = (devs.size,)
    return Mesh(devs[: int(np.prod(shape))].reshape(shape), axis_names=names)


def shard_batch(ct: Ciphertext, mesh: Mesh, axis: str = "dp") -> Ciphertext:
    """Shard a batched ciphertext's leading axis over the mesh (dp)."""
    spec = P(axis, *([None] * (ct.data.ndim - 1)))
    return ct.with_(data=jax.device_put(ct.data, NamedSharding(mesh, spec)))


def replicate(tree, mesh: Mesh):
    return jax.device_put(tree, NamedSharding(mesh, P()))


def mod_all_reduce(x, q, axis: str):
    """Modular sum over a mesh axis: ppermute butterfly + mod_add per
    round (log2(n) rounds), values stay in [0, q)."""
    n = jax.lax.axis_size(axis)
    if n & (n - 1):
        raise ValueError("mod_all_reduce needs a power-of-two axis size")
    shift = 1
    while shift < n:
        perm = [(i, i ^ shift) for i in range(n)]
        y = jax.lax.ppermute(x, axis, perm)
        x = mod_add(x, y, q)
        shift *= 2
    return x


def bucketed_matvec(sess: Session, diags: Ciphertext, vec: Ciphertext,
                    d: int, mesh: Mesh, axis: str = "rot") -> Ciphertext:
    """Distributed encrypted matrix-vector product by the diagonal method:
    A·v = Σ_k diag_k(A) ⊙ rot(v, k).

    The k-loop (each step a Galois key-switch — the reference's hot loop,
    ``he_linalg.cpp:977-1003``) is bucketed across `axis`: every device
    key-switches only its rotation bucket with only its shard of the
    Galois keys, accumulates a 3-part partial sum, and the partials meet
    in a modular all-reduce over NVLink.  The key-switch digit decomposition
    of v is computed once per device (hoisting).

    Requires: d divisible by the axis size; session galois keys for steps
    0..d-1 (create_galois_keys(steps=range(d)) — step 0 uses the identity
    galois element, a valid self-keyswitch, keeping the SPMD program
    uniform).  diags: [d, parts, L, N] diag-layout (slot-tiled); vec: one
    ct, col layout tiled ×2.
    """
    from jax import shard_map

    n_dev = mesh.shape[axis]
    if d % n_dev:
        raise ValueError(f"d={d} not divisible by mesh axis {n_dev}")
    k_per = d // n_dev
    n = sess.ctx.params.poly_degree
    lvl = vec.level
    steps = np.arange(d).reshape(n_dev, k_per)
    perms = np.stack([
        [galois.permutation(n, galois.rotation_elt(n, int(s))) for s in row]
        for row in steps]).astype(np.int32)                # [n_dev, k_per, N]
    keys = jnp.stack([
        jnp.stack([sess.gk.key_for(galois.rotation_elt(n, int(s))).data
                   for s in row]) for row in steps])       # [n_dev,k_per,...]
    keys_sh = jnp.stack([
        jnp.stack([sess.gk.key_for(galois.rotation_elt(n, int(s))).shoup
                   for s in row]) for row in steps])
    ev = sess.ev
    mc = sess.ctx.mont(lvl)
    q, qn = mc["q"], mc["qinv_neg"]

    def shard_fn(diag_s, vec_d, perm_s, key_s, key_sh_s):
        # diag_s [k_per, parts, L, N]; vec_d full ct data; perm_s [1,k_per,N]
        c0, c1 = vec_d[0], vec_d[1]
        ext = ev._decompose(c1, lvl)                      # hoisted, per device
        acc = None
        for t in range(k_per):
            p = perm_s[0, t]
            c0r = c0[..., p]
            extr = ext[..., p]
            p0, p1 = ev._inner_product(
                extr, lvl,
                KSwitchKey(data=key_s[0, t], shoup=key_sh_s[0, t]))
            rot = jnp.stack([mod_add(c0r, p0, q), p1])
            dt = diag_s[t]
            prod = ev.multiply(
                Ciphertext(data=rot, level=lvl, scale=vec.scale),
                Ciphertext(data=dt, level=lvl, scale=vec.scale))
            acc = prod.data if acc is None else mod_add(acc, prod.data, q)
        return mod_all_reduce(acc, q, axis)

    fn = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(axis), P(), P(axis), P(axis), P(axis)),
        out_specs=P(), check_vma=False,
    )
    out3 = fn(diags.data, vec.data, jnp.asarray(perms), keys, keys_sh)
    c3 = Ciphertext(data=out3, level=lvl, scale=vec.scale * diags.scale)
    return ev.rescale(ev.relinearize(c3, sess.rk))
