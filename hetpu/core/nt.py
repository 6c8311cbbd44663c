"""Number-theory primitives (host side, exact Python integers).

Provides the prime/root machinery the reference obtains from SEAL's
``CoeffModulus::Create`` / ``PlainModulus::Batching`` (see reference
``src/demos/math_operations.cpp:17-247``, ``matrix_operations.cpp:63-66``):
NTT-friendly prime generation (q ≡ 1 mod 2N), primitive roots of unity,
modular inverses.  Everything here runs at context-build time on the host;
nothing is traced by JAX.

Constraint: all runtime primes are < 2^31 so that residues fit a
uint32 lane and Montgomery products fit two 32-bit words (SURVEY.md §7
"hard parts" #1).  SEAL's 40/60-bit primes are replaced by deeper chains of
30/31-bit primes with an equivalent precision budget.
"""

from __future__ import annotations

import random
from functools import lru_cache


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (covers all 64-bit ints)."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def modinv(a: int, m: int) -> int:
    """Modular inverse via extended Euclid (m need not be prime)."""
    g, x = _egcd(a % m, m)
    if g != 1:
        raise ValueError(f"{a} not invertible mod {m}")
    return x % m


def _egcd(a: int, b: int) -> tuple[int, int]:
    old_r, r = a, b
    old_s, s = 1, 0
    while r:
        q = old_r // r
        old_r, r = r, old_r - q * r
        old_s, s = s, old_s - q * s
    return old_r, old_s


@lru_cache(maxsize=None)
def gen_primes(bit_size: int, count: int, ntt_size: int,
               strict: bool = True) -> tuple[int, ...]:
    """Generate ``count`` distinct primes of ``bit_size`` bits with
    q ≡ 1 (mod ntt_size)  (pass ntt_size = 2N for negacyclic NTT support).

    Searches downward from 2^bit_size like SEAL's ``CoeffModulus::Create``
    so the primes are as large as the bit size allows (stable CKKS scale).

    ``strict=False`` returns however many primes exist in the bit window
    (possibly fewer than ``count``) instead of raising — used when a caller
    only needs *spares* and can tolerate pool exhaustion (e.g. the BFV
    CRT plain-factor pool at small N, where few small primes ≡ 1 mod 2N
    exist at all).
    """
    if bit_size > 31:
        raise ValueError("hetpu uses <=31-bit primes (uint32 residues)")
    found: list[int] = []
    # largest candidate of form k*ntt_size + 1 below 2^bit_size
    q = (2**bit_size - 1) // ntt_size * ntt_size + 1
    while len(found) < count and q > 2 ** (bit_size - 1):
        if is_prime(q):
            found.append(q)
        q -= ntt_size
    if strict and len(found) < count:
        raise ValueError(
            f"not enough {bit_size}-bit primes = 1 mod {ntt_size}: got {len(found)}"
        )
    return tuple(found)


def primitive_root(modulus: int) -> int:
    """Smallest-ish generator of Z_q^* (q prime)."""
    phi = modulus - 1
    factors = _factorize(phi)
    for g in range(2, modulus):
        if all(pow(g, phi // f, modulus) != 1 for f in factors):
            return g
    raise ValueError("no primitive root found")


def root_of_unity(order: int, modulus: int) -> int:
    """A primitive ``order``-th root of unity mod prime ``modulus``.

    Deterministic: derived from the smallest primitive root, then the
    smallest such primitive order-th root is returned so context builds are
    reproducible across hosts.
    """
    if (modulus - 1) % order != 0:
        raise ValueError(f"{order} does not divide {modulus}-1")
    g = primitive_root(modulus)
    w = pow(g, (modulus - 1) // order, modulus)
    # take the smallest power that is still a primitive root of this order
    best = None
    x = w
    for k in range(1, order):
        if _gcd(k, order) == 1:
            if best is None or x < best:
                best = x
        x = x * w % modulus
    assert best is not None
    assert pow(best, order, modulus) == 1
    assert pow(best, order // 2, modulus) == modulus - 1
    return best


def _gcd(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a


def _factorize(n: int) -> set[int]:
    factors: set[int] = set()
    d = 2
    while d * d <= n:
        while n % d == 0:
            factors.add(d)
            n //= d
        d += 1 if d == 2 else 2
    if n > 1:
        factors.add(n)
    return factors


def bit_reverse(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


# --- security: max log2(Q*P) per ring degree at 128-bit classical security
# (homomorphicencryption.org standard table; SEAL enforces the same bounds
# via seal::sec_level_type::tc128).
MAX_LOGQ_128 = {1024: 27, 2048: 54, 4096: 109, 8192: 218, 16384: 438, 32768: 881}


def max_coeff_modulus_bits(poly_degree: int, sec_level: int = 128) -> int:
    if sec_level == 0:
        return 10**9
    if sec_level != 128:
        raise ValueError("only 128-bit table bundled")
    return MAX_LOGQ_128[poly_degree]
