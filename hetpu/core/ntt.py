"""Negacyclic NTT/INTT over RNS limb-planar arrays [..., L, N] (pure JAX).

This is the replacement for SEAL's ``util::ntt_negacyclic_harvey``
(invoked inside every Evaluator op the reference uses — SURVEY.md §2b,
"negacyclic NTT/INTT butterflies").  Design (SURVEY.md §7 Phase 1):

  * limbs vectorized along axis -2, butterflies along the last axis;
  * forward = Cooley-Tukey decimation, natural → bit-reversed order;
    inverse = Gentleman-Sande, bit-reversed → natural order — no explicit
    bit-reversal permutation ever happens (same trick as SEAL/Harvey);
  * ψ (2N-th root) powers folded into the twiddle tables ⇒ negacyclic wrap
    is free;
  * per-stage twiddle multiply is a Shoup multiply (6 int32 muls) with
    tables precomputed host-side;
  * the stage loop is unrolled at trace time (log2 N stages, static shapes,
    each stage a single fused elementwise op for XLA).

Ciphertexts stay in this bit-reversed evaluation order between ops (like
SEAL's CKKS pipeline); Galois/rotation tables account for the ordering
(see galois.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from . import nt
from .modular import mod_add, mod_sub, shoup_mul, shoup_precompute


@dataclass(frozen=True)
class NttTables:
    """Per-RNS-basis twiddle tables. All arrays numpy uint32, device-put lazily.

    Shapes: w_* are [L, N]; n_inv_* are [L, 1]; q/mu-style constants [L, 1].

    Montgomery-domain support (the scheme keeps ciphertext/key polys in
    Montgomery form — x·R mod q, R=2^32): Shoup-multiplying a Montgomery
    value by a *standard* constant keeps the domain, so the twiddle tables
    work on either domain.  ``n_inv_rinv`` = N⁻¹·R⁻¹ mod q lets the inverse
    transform strip Montgomery form for free; ``r`` = R mod q re-enters it.
    """

    n: int
    primes: tuple[int, ...]
    q: np.ndarray               # [L, 1]
    fwd_w: np.ndarray           # ψ^{br(i)}        [L, N]
    fwd_w_shoup: np.ndarray
    inv_w: np.ndarray           # ψ^{-br(i)}       [L, N]
    inv_w_shoup: np.ndarray
    n_inv: np.ndarray           # N^{-1} mod q     [L, 1]
    n_inv_shoup: np.ndarray
    n_inv_rinv: np.ndarray      # N^{-1}·R^{-1} mod q  [L, 1]
    n_inv_rinv_shoup: np.ndarray
    r: np.ndarray               # R mod q          [L, 1]
    r_shoup: np.ndarray

    def slice(self, idx) -> "NttTables":
        """Sub-basis view: select primes by index list/array (host-side)."""
        idx = np.asarray(idx)
        take = lambda a: np.ascontiguousarray(a[idx])
        return NttTables(
            n=self.n,
            primes=tuple(self.primes[int(i)] for i in idx),
            q=take(self.q),
            fwd_w=take(self.fwd_w),
            fwd_w_shoup=take(self.fwd_w_shoup),
            inv_w=take(self.inv_w),
            inv_w_shoup=take(self.inv_w_shoup),
            n_inv=take(self.n_inv),
            n_inv_shoup=take(self.n_inv_shoup),
            n_inv_rinv=take(self.n_inv_rinv),
            n_inv_rinv_shoup=take(self.n_inv_rinv_shoup),
            r=take(self.r),
            r_shoup=take(self.r_shoup),
        )


def build_tables(n: int, primes) -> NttTables:
    logn = n.bit_length() - 1
    L = len(primes)
    R = 1 << 32
    fwd = np.zeros((L, n), dtype=np.uint32)
    inv = np.zeros((L, n), dtype=np.uint32)
    n_inv = np.zeros((L, 1), dtype=np.uint32)
    n_inv_rinv = np.zeros((L, 1), dtype=np.uint32)
    r_col = np.zeros((L, 1), dtype=np.uint32)
    br = np.array([nt.bit_reverse(i, logn) for i in range(n)])
    for li, q in enumerate(primes):
        psi = nt.root_of_unity(2 * n, q)
        psi_inv = nt.modinv(psi, q)
        # powers ψ^i then scatter to bit-reversed index layout
        pw = np.empty(n, dtype=object)
        ipw = np.empty(n, dtype=object)
        x = ix = 1
        for i in range(n):
            pw[i] = x
            ipw[i] = ix
            x = x * psi % q
            ix = ix * psi_inv % q
        fwd[li] = pw[br].astype(np.uint64).astype(np.uint32)
        inv[li] = ipw[br].astype(np.uint64).astype(np.uint32)
        n_inv[li, 0] = nt.modinv(n, q)
        n_inv_rinv[li, 0] = nt.modinv(n, q) * nt.modinv(R % q, q) % q
        r_col[li, 0] = R % q
    qcol = np.array([int(p) for p in primes], dtype=np.uint32).reshape(-1, 1)
    return NttTables(
        n=n,
        primes=tuple(int(p) for p in primes),
        q=qcol,
        fwd_w=fwd,
        fwd_w_shoup=shoup_precompute(fwd, qcol),
        inv_w=inv,
        inv_w_shoup=shoup_precompute(inv, qcol),
        n_inv=n_inv,
        n_inv_shoup=shoup_precompute(n_inv, qcol),
        n_inv_rinv=n_inv_rinv,
        n_inv_rinv_shoup=shoup_precompute(n_inv_rinv, qcol),
        r=r_col,
        r_shoup=shoup_precompute(r_col, qcol),
    )


# ----------------------------------------------------------------------
# Forward / inverse transforms
# ----------------------------------------------------------------------

def build_best_tables(n: int, primes):
    """Flat tables for small N; four-step for N ≥ 4096.
    Both produce identical transforms — ntt_fwd/ntt_inv dispatch on the
    table type."""
    if n >= 4096:
        from . import ntt4
        return ntt4.build_tables(n, primes)
    return build_tables(n, primes)


def ntt_fwd(a: jnp.ndarray, t) -> jnp.ndarray:
    """Negacyclic forward NTT. a: uint32 [..., L, N] (natural coeff order)
    → [..., L, N] evaluations in bit-reversed order."""
    if hasattr(t, "sub1"):
        from . import ntt4
        return ntt4.ntt_fwd(a, t)
    n = t.n
    L = len(t.primes)
    lead = a.shape[:-2]
    q3 = t.q.reshape(L, 1, 1)
    x = a
    m = 1
    half = n // 2
    while m < n:
        # blocks: [m, 2, half]; twiddles for this stage: table[m : 2m]
        x = x.reshape(*lead, L, m, 2, half)
        w = t.fwd_w[:, m : 2 * m].reshape(L, m, 1)
        ws = t.fwd_w_shoup[:, m : 2 * m].reshape(L, m, 1)
        u = x[..., 0, :]
        v = shoup_mul(x[..., 1, :], w, ws, q3)
        x = jnp.stack([mod_add(u, v, q3), mod_sub(u, v, q3)], axis=-2)
        m *= 2
        half //= 2
    return x.reshape(*lead, L, n)


def ntt_fwd_mont(a: jnp.ndarray, t) -> jnp.ndarray:
    """Forward NTT of standard-form coeffs → Montgomery-form evaluations
    (one extra Shoup pass to multiply by R mod q)."""
    if hasattr(t, "sub1"):
        from . import ntt4
        return ntt4.ntt_fwd(a, t, to_mont=True)
    return shoup_mul(ntt_fwd(a, t), t.r, t.r_shoup, t.q)


def ntt_inv(a: jnp.ndarray, t, *, strip_mont: bool = False,
            extra=None) -> jnp.ndarray:
    """Negacyclic inverse NTT. Bit-reversed evaluations → natural coeffs,
    including the final N^{-1} scaling.  With ``strip_mont`` the input is
    Montgomery-form and the output standard-form (N⁻¹R⁻¹ folded into the
    final constant — the conversion is free).  ``extra`` (with
    strip_mont) folds an additional per-limb constant multiply into the
    epilogue (one Shoup pass)."""
    if hasattr(t, "sub1"):
        from . import ntt4
        return ntt4.ntt_inv(a, t, strip_mont=strip_mont, extra=extra)
    if extra is not None:
        assert strip_mont
        out = ntt_inv(a, t, strip_mont=True)
        ex = np.asarray(extra, dtype=np.uint32).reshape(-1, 1)
        return shoup_mul(out, ex, shoup_precompute(ex, t.q), t.q)
    n = t.n
    L = len(t.primes)
    lead = a.shape[:-2]
    q3 = t.q.reshape(L, 1, 1)
    x = a
    m = n // 2
    half = 1
    while m >= 1:
        x = x.reshape(*lead, L, m, 2, half)
        w = t.inv_w[:, m : 2 * m].reshape(L, m, 1)
        ws = t.inv_w_shoup[:, m : 2 * m].reshape(L, m, 1)
        u = x[..., 0, :]
        v = x[..., 1, :]
        s = mod_add(u, v, q3)
        d = shoup_mul(mod_sub(u, v, q3), w, ws, q3)
        x = jnp.stack([s, d], axis=-2)
        m //= 2
        half *= 2
    x = x.reshape(*lead, L, n)
    if strip_mont:
        return shoup_mul(x, t.n_inv_rinv, t.n_inv_rinv_shoup, t.q)
    return shoup_mul(x, t.n_inv, t.n_inv_shoup, t.q)
