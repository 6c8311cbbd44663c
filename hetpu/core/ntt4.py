"""Four-step negacyclic NTT.

The flat stage loop (ntt.py) pairs elements at strides N/2…1 over one
long axis.  The four-step decomposition N = n1·n2 turns the whole
transform into:

    x[n1, n2] → sub-NTT along n1 (row ops, lanes fully vectorized)
              → elementwise twiddle matrix
              → transpose
              → sub-NTT along n2 (row ops again)
              → transpose

Both sub-transforms use the SAME negacyclic Cooley-Tukey butterflies as
the flat kernel, with sub-tables built from φ₁ = ψ^{n2}, φ₂ = ψ^{n1}; the
inter-step twiddle T[p, j2] = ψ^{j2·(1 + 2·br(p) − n1)} also folds the
big-ψ twist and the step-3 untwist (derivation in git history / tests).

**Bit-exact drop-in**: produces the identical output ordering as
ntt.ntt_fwd / ntt_inv (pinned by tests/test_ntt4.py), so galois tables,
the encoder, and every evaluator op are unchanged.  Dispatch: Context
builds FourStepTables for N ≥ 4096, and ntt.ntt_fwd/ntt_inv route here
when given one.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax.numpy as jnp

from . import nt
from .modular import mod_add, mod_sub, shoup_mul, shoup_precompute
from . import ntt as flat


@dataclass(frozen=True)
class FourStepTables:
    n: int
    n1: int
    n2: int
    primes: tuple[int, ...]
    sub1: flat.NttTables          # size n1, psi = ψ^{n2}
    sub2: flat.NttTables          # size n2, psi = ψ^{n1}
    t_fwd: np.ndarray             # [L, n1, n2]
    t_fwd_shoup: np.ndarray
    t_inv: np.ndarray
    t_inv_shoup: np.ndarray
    # constants mirrored from the flat tables (call sites use these)
    q: np.ndarray                 # [L, 1]
    r: np.ndarray
    r_shoup: np.ndarray

    def slice(self, idx) -> "FourStepTables":
        idx = np.asarray(idx)
        take = lambda a: np.ascontiguousarray(a[idx])
        return FourStepTables(
            n=self.n, n1=self.n1, n2=self.n2,
            primes=tuple(self.primes[int(i)] for i in idx),
            sub1=self.sub1.slice(idx), sub2=self.sub2.slice(idx),
            t_fwd=take(self.t_fwd), t_fwd_shoup=take(self.t_fwd_shoup),
            t_inv=take(self.t_inv), t_inv_shoup=take(self.t_inv_shoup),
            q=take(self.q), r=take(self.r), r_shoup=take(self.r_shoup),
        )


def _build_sub(n_sub: int, primes, psis) -> flat.NttTables:
    """build_tables but with an explicit ψ per prime (ψ^k powers of the
    big root, so four-step output matches the flat kernel exactly)."""
    logn = n_sub.bit_length() - 1
    R = 1 << 32
    L = len(primes)
    fwd = np.zeros((L, n_sub), dtype=np.uint32)
    inv = np.zeros((L, n_sub), dtype=np.uint32)
    n_inv = np.zeros((L, 1), dtype=np.uint32)
    n_inv_rinv = np.zeros((L, 1), dtype=np.uint32)
    r_col = np.zeros((L, 1), dtype=np.uint32)
    br = np.array([nt.bit_reverse(i, logn) for i in range(n_sub)])
    for li, (q, psi) in enumerate(zip(primes, psis)):
        psi_inv = nt.modinv(psi, q)
        pw = np.empty(n_sub, dtype=object)
        ipw = np.empty(n_sub, dtype=object)
        x = ix = 1
        for i in range(n_sub):
            pw[i] = x
            ipw[i] = ix
            x = x * psi % q
            ix = ix * psi_inv % q
        fwd[li] = pw[br].astype(np.uint64).astype(np.uint32)
        inv[li] = ipw[br].astype(np.uint64).astype(np.uint32)
        n_inv[li, 0] = nt.modinv(n_sub, q)
        n_inv_rinv[li, 0] = nt.modinv(n_sub, q) * nt.modinv(R % q, q) % q
        r_col[li, 0] = R % q
    qcol = np.array([int(p) for p in primes], dtype=np.uint32).reshape(-1, 1)
    return flat.NttTables(
        n=n_sub, primes=tuple(int(p) for p in primes), q=qcol,
        fwd_w=fwd, fwd_w_shoup=shoup_precompute(fwd, qcol),
        inv_w=inv, inv_w_shoup=shoup_precompute(inv, qcol),
        n_inv=n_inv, n_inv_shoup=shoup_precompute(n_inv, qcol),
        n_inv_rinv=n_inv_rinv,
        n_inv_rinv_shoup=shoup_precompute(n_inv_rinv, qcol),
        r=r_col, r_shoup=shoup_precompute(r_col, qcol),
    )


def build_tables(n: int, primes) -> FourStepTables:
    n2 = 128 if n <= (1 << 14) else 256
    n1 = n // n2
    L = len(primes)
    log1 = n1.bit_length() - 1
    br1 = np.array([nt.bit_reverse(i, log1) for i in range(n1)])
    psis = [nt.root_of_unity(2 * n, q) for q in primes]
    t_fwd = np.zeros((L, n1, n2), dtype=np.uint32)
    t_inv = np.zeros((L, n1, n2), dtype=np.uint32)
    for li, (q, psi) in enumerate(zip(primes, psis)):
        psi_i = nt.modinv(psi, q)
        j2 = np.arange(n2)
        for p in range(n1):
            e = int(1 + 2 * br1[p] - n1)
            w = pow(psi, e % (2 * n), q)
            wi = pow(psi_i, e % (2 * n), q)
            # powers w^{j2}
            row = np.empty(n2, dtype=object)
            rowi = np.empty(n2, dtype=object)
            x = xi = 1
            for j in range(n2):
                row[j] = x
                rowi[j] = xi
                x = x * w % q
                xi = xi * wi % q
            t_fwd[li, p] = row.astype(np.uint64).astype(np.uint32)
            t_inv[li, p] = rowi.astype(np.uint64).astype(np.uint32)
    qcol = np.array([int(p) for p in primes], dtype=np.uint32).reshape(-1, 1)
    sub1 = _build_sub(n1, primes, [pow(p, n2, q) for p, q in zip(psis, primes)])
    sub2 = _build_sub(n2, primes, [pow(p, n1, q) for p, q in zip(psis, primes)])
    R = 1 << 32
    r_col = np.array([[R % q] for q in primes], dtype=np.uint32)
    return FourStepTables(
        n=n, n1=n1, n2=n2, primes=tuple(int(p) for p in primes),
        sub1=sub1, sub2=sub2,
        t_fwd=t_fwd,
        t_fwd_shoup=shoup_precompute(t_fwd, qcol[:, :, None]),
        t_inv=t_inv,
        t_inv_shoup=shoup_precompute(t_inv, qcol[:, :, None]),
        q=qcol, r=r_col, r_shoup=shoup_precompute(r_col, qcol),
    )


# ----------------------------------------------------------------------
# sub-NTT stage loops along axis -2 (vectorized over the trailing axis)
# ----------------------------------------------------------------------

def _fwd_axis2(x, t: flat.NttTables):
    """x: [..., L, n_sub, V] → CT-DIT along the n_sub axis."""
    n = t.n
    L = len(t.primes)
    lead = x.shape[:-3]
    V = x.shape[-1]
    q4 = t.q.reshape(L, 1, 1, 1)
    m, half = 1, n // 2
    while m < n:
        x = x.reshape(*lead, L, m, 2, half, V)
        w = t.fwd_w[:, m: 2 * m].reshape(L, m, 1, 1)
        ws = t.fwd_w_shoup[:, m: 2 * m].reshape(L, m, 1, 1)
        u = x[..., 0, :, :]
        v = shoup_mul(x[..., 1, :, :], w, ws, q4)
        x = jnp.stack([mod_add(u, v, q4), mod_sub(u, v, q4)], axis=-3)
        m *= 2
        half //= 2
    return x.reshape(*lead, L, n, V)


def _inv_axis2(x, t: flat.NttTables, *, strip_mont: bool):
    n = t.n
    L = len(t.primes)
    lead = x.shape[:-3]
    V = x.shape[-1]
    q4 = t.q.reshape(L, 1, 1, 1)
    m, half = n // 2, 1
    while m >= 1:
        x = x.reshape(*lead, L, m, 2, half, V)
        w = t.inv_w[:, m: 2 * m].reshape(L, m, 1, 1)
        ws = t.inv_w_shoup[:, m: 2 * m].reshape(L, m, 1, 1)
        u = x[..., 0, :, :]
        v = x[..., 1, :, :]
        s = mod_add(u, v, q4)
        d = shoup_mul(mod_sub(u, v, q4), w, ws, q4)
        x = jnp.stack([s, d], axis=-3)
        m //= 2
        half *= 2
    x = x.reshape(*lead, L, n, V)
    if strip_mont:
        return shoup_mul(x, t.n_inv_rinv.reshape(L, 1, 1),
                         t.n_inv_rinv_shoup.reshape(L, 1, 1),
                         t.q.reshape(L, 1, 1))
    return shoup_mul(x, t.n_inv.reshape(L, 1, 1),
                     t.n_inv_shoup.reshape(L, 1, 1), t.q.reshape(L, 1, 1))


def ntt_fwd(a, t: FourStepTables, *, to_mont: bool = False):
    """[..., L, N] → bit-exact equivalent of flat ntt_fwd (times R mod q
    with ``to_mont``: Montgomery-form evaluations)."""
    lead = a.shape[:-2]
    L = a.shape[-2]
    x = a.reshape(*lead, L, t.n1, t.n2)
    x = _fwd_axis2(x, t.sub1)                                 # along n1
    x = shoup_mul(x, t.t_fwd, t.t_fwd_shoup, t.q[:, :, None])
    x = jnp.swapaxes(x, -1, -2)                               # [n2, n1]
    x = _fwd_axis2(x, t.sub2)                                 # along n2
    x = jnp.swapaxes(x, -1, -2)                               # [n1, n2]
    x = x.reshape(*lead, L, t.n)
    return shoup_mul(x, t.r, t.r_shoup, t.q) if to_mont else x


def ntt_inv(a, t: FourStepTables, *, strip_mont: bool = False, extra=None):
    if extra is not None:
        out = ntt_inv(a, t, strip_mont=strip_mont)
        q = t.q
        ex = np.asarray(extra, dtype=np.uint32).reshape(-1, 1)
        return shoup_mul(out, ex, shoup_precompute(ex, q), q)
    lead = a.shape[:-2]
    L = a.shape[-2]
    x = a.reshape(*lead, L, t.n1, t.n2)
    x = jnp.swapaxes(x, -1, -2)
    x = _inv_axis2(x, t.sub2, strip_mont=False)
    x = jnp.swapaxes(x, -1, -2)
    x = shoup_mul(x, t.t_inv, t.t_inv_shoup, t.q[:, :, None])
    x = _inv_axis2(x, t.sub1, strip_mont=strip_mont)
    return x.reshape(*lead, L, t.n)
