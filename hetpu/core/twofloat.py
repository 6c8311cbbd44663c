"""Two-float (double-single) arithmetic: ~2^-45 precision out of f32 pairs.

The kernels stay in float32 (SURVEY.md §7 hard-part 5).  Where the
framework needs a near-f64 rounding decision — the FBC α-correction of
exact BFV arithmetic (rns.fbc_apply(precise=True)) — we use classic
error-free transformations on f32:

* Veltkamp splitting + Dekker TwoProd: the product of two f32 values as
  an exact hi+lo pair (no FMA required — XLA does not reassociate IEEE
  float ops, so the algebra below is preserved).
* Knuth TwoSum: exact hi+lo of a sum.

These give Σ y_i·w_i with per-term error ~2^-45 instead of f32's 2^-24 —
the adversarial near-half-integer cases in tests/test_rns.py pin it.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

_SPLIT = np.float32(4097.0)          # 2^12 + 1 (f32 Veltkamp constant)


def _split(a):
    t = a * _SPLIT
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """(p, e) with p + e == a·b exactly (a, b f32, no overflow)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def two_sum(a, b):
    """(s, e) with s + e == a + b exactly."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def ds_add(hi, lo, p, e):
    """Accumulate the exact pair (p, e) into the double-single (hi, lo)."""
    s, err = two_sum(hi, p)
    lo = lo + (err + e)
    return s, lo


def ds_round(hi, lo):
    """round(hi + lo) to the nearest integer (half away from the base),
    honoring lo even when hi sits within ~2^-45 of a half-integer.

    f = hi − round(hi) is exact (Sterbenz), as are f ± 0.5; adding lo to
    an exact quantity can round the magnitude but NEVER flips the sign,
    so the two boundary comparisons are exact-sign decisions — no 2^-25
    rounding cliff at |f| ≈ 0.5 like a naive round(f + lo) has."""
    r = jnp.round(hi)
    f = hi - r
    up = ((f - jnp.float32(0.5)) + lo) >= 0       # hi+lo ≥ r + 0.5
    dn = ((f + jnp.float32(0.5)) + lo) < 0        # hi+lo < r − 0.5
    return r + up.astype(hi.dtype) - dn.astype(hi.dtype)
