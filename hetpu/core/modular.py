"""uint32 modular-arithmetic kernels (pure JAX, identical results on every backend).

This is the layer SEAL implements with native u64/x86 intrinsics
(``seal::util::multiply_uint_mod`` etc., used under every Evaluator call the
reference makes — SURVEY.md §2b).  Every op here is built from 32-bit
integer arithmetic (no u64 anywhere, so JAX needs no x64 mode):

  * ``mulhi_u32``   — high 32 bits of a 32x32 product via 16-bit schoolbook
  * ``mont_mul``    — Montgomery multiply (R=2^32), for ct x ct products
  * ``shoup_mul``   — Shoup multiply for *precomputed* constants
                      (twiddles, plaintexts, key-switch keys): 6 int muls
  * ``barrett_reduce_u32`` — reduce an arbitrary uint32 mod q

Conventions: residues live in [0, q) as uint32; primes q < 2^31; per-limb
constants broadcast over the trailing polynomial axis (shape [..., L, 1]
against data [..., L, N]).

All functions are shape-polymorphic and jit/vmap/shard_map friendly.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

U32 = jnp.uint32
_MASK16 = np.uint32(0xFFFF)


# ----------------------------------------------------------------------
# 64-bit emulation building blocks
# ----------------------------------------------------------------------

def mulhi_u32(a, b):
    """High 32 bits of the 64-bit product of two uint32 arrays."""
    a = a.astype(U32)
    b = b.astype(U32)
    a0 = a & _MASK16
    a1 = a >> 16
    b0 = b & _MASK16
    b1 = b >> 16
    t = a1 * b0 + ((a0 * b0) >> 16)          # < 2^32, no wrap
    w1 = (t & _MASK16) + a0 * b1             # < 2^32, no wrap
    return a1 * b1 + (t >> 16) + (w1 >> 16)


def mullo_u32(a, b):
    """Low 32 bits (uint32 multiply wraps by definition)."""
    return a.astype(U32) * b.astype(U32)


# ----------------------------------------------------------------------
# Montgomery (R = 2^32)
# ----------------------------------------------------------------------

def mont_mul(a, b, q, qinv_neg):
    """a * b * R^-1 mod q   (R = 2^32).

    qinv_neg = -q^-1 mod 2^32 (per-limb constant, broadcastable).
    Inputs in [0, q); output in [0, q).  10 int32 multiplies.
    """
    t_lo = mullo_u32(a, b)
    t_hi = mulhi_u32(a, b)
    m = mullo_u32(t_lo, qinv_neg)
    mq_hi = mulhi_u32(m, q)
    carry = (t_lo != 0).astype(U32)
    u = t_hi + mq_hi + carry                 # < 2q < 2^32
    return jnp.where(u >= q, u - q, u)


def shoup_mul(x, w, w_shoup, q):
    """x * w mod q where (w, w_shoup) are precomputed constants.

    w_shoup = floor(w * 2^32 / q).  6 int32 multiplies; exact product
    (no Montgomery scaling).  Requires x < q... x may be any value < 2^32 as
    long as x*w/q fits 32 bits; we use x, w < q < 2^31.
    """
    q_est = mulhi_u32(x, w_shoup)
    r = mullo_u32(x, w) - mullo_u32(q_est, q)   # in [0, 2q) mod 2^32
    return jnp.where(r >= q, r - q, r)


# ----------------------------------------------------------------------
# add / sub / neg
# ----------------------------------------------------------------------

def mod_add(a, b, q):
    s = a + b                                # a,b < q < 2^31 → no wrap
    return jnp.where(s >= q, s - q, s)


def mod_sub(a, b, q):
    return jnp.where(a >= b, a - b, a + (q - b))


def mod_neg(a, q):
    return jnp.where(a == 0, jnp.zeros_like(a), q - a)


# ----------------------------------------------------------------------
# Barrett reduction of a full uint32 value
# ----------------------------------------------------------------------

def barrett_reduce_u32(x, q, mu):
    """x mod q for arbitrary uint32 x; mu = floor(2^32 / q)."""
    est = mulhi_u32(x, mu)
    r = x - mullo_u32(est, q)                # in [0, 2q)
    return jnp.where(r >= q, r - q, r)


# ----------------------------------------------------------------------
# Host-side constant computation (exact Python ints → numpy)
# ----------------------------------------------------------------------

def mont_constants(primes) -> dict[str, np.ndarray]:
    """Per-prime constants, each shaped [L, 1] for broadcast over [L, N]."""
    R = 1 << 32
    q = np.array(primes, dtype=np.uint64)
    qinv = [pow(int(p), -1, R) for p in primes]
    qinv_neg = [(R - x) % R for x in qinv]
    r_mod = [R % int(p) for p in primes]
    r2 = [(R * R) % int(p) for p in primes]
    mu = [R // int(p) for p in primes]
    col = lambda xs, dt=np.uint32: np.array(xs, dtype=dt).reshape(-1, 1)
    out = {
        "q": col([int(p) for p in primes]),
        "qinv": col(qinv),
        "qinv_neg": col(qinv_neg),
        "r_mod_q": col(r_mod),
        "r2": col(r2),
        "mu": col(mu),
    }
    out["r_mod_q_shoup"] = col([(x << 32) // int(p) for x, p in zip(r_mod, primes)])
    return out


def shoup_precompute_dev(w, q, r_mod_q, r_mod_q_shoup, mu, qinv):
    """floor(w·2^32/q) computed EXACTLY on device with u32-only math
    (the on-device analog of :func:`shoup_precompute`, so key generation
    can emit Shoup companions without a host round-trip).

    Identity: w·2^32 = q·(w·mu) + w·rho with mu = ⌊2^32/q⌋, rho = 2^32 mod q,
    so ⌊w·2^32/q⌋ = w·mu + ⌊w·rho/q⌋.  The second quotient comes from exact
    division: X = w·rho − (w·rho mod q) is divisible by q and its quotient
    (< q < 2^31) is X_lo·q⁻¹ mod 2^32 — low 32 bits suffice.

    Constants (all per-limb, broadcastable): q, r_mod_q = 2^32 mod q (+ its
    host Shoup companion), mu = ⌊2^32/q⌋, qinv = q⁻¹ mod 2^32.
    Requires w < q.
    """
    m = shoup_mul(w, r_mod_q, r_mod_q_shoup, q)       # (w·rho) mod q
    x_lo = mullo_u32(w, r_mod_q)                      # (w·rho) mod 2^32
    quo = mullo_u32(x_lo - m, qinv)                   # ⌊w·rho/q⌋, exact
    return mullo_u32(w, mu) + quo


def shoup_precompute(w: np.ndarray, primes: np.ndarray) -> np.ndarray:
    """floor(w * 2^32 / q) elementwise; w shape [..., L, N] (or [L, 1]),
    primes broadcastable.  Host-side exact: w < 2^31 so w<<32 fits uint64."""
    w64 = w.astype(np.uint64)
    q64 = np.broadcast_to(primes, w.shape).astype(np.uint64)
    return ((w64 << np.uint64(32)) // q64).astype(np.uint32)


def to_mont(a, consts):
    """Standard → Montgomery form (x·R mod q) via Shoup with constant R."""
    return shoup_mul(a, consts["r_mod_q"], consts["r_mod_q_shoup"], consts["q"])


def from_mont(a, consts):
    """Montgomery → standard form (x·R^-1 mod q)."""
    one = jnp.ones_like(a)
    return mont_mul(a, one, consts["q"], consts["qinv_neg"])
