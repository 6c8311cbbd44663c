"""Generate checked-in golden vectors (tests/golden/*.npz) from an
INDEPENDENT big-integer model of the kernel specs.

This is the stand-in for BASELINE.md's "bit-exact SEAL agreement": SEAL
itself is not available in this environment, so the external referee is
exact Python-int arithmetic — no uint32 lanes, no Shoup/Montgomery/Barrett
tricks, no JAX — implementing the same *mathematical specs* the kernels
claim (negacyclic NTT via CT/GS butterflies over object ints, CRT-lift
divide-and-round rescale).  The bigint NTT is itself cross-validated here
against the O(N·samples) polynomial-evaluation definition before any
vector is emitted, so the goldens don't just mirror kernel bugs.

Coverage (VERDICT r2 item 5): NTT/INTT on the full bench_n14 basis
(14 primes, N=2^14) and the tiny test basis; rescale (divide-and-round by
the dropped prime) at both sizes; plus kernel-regression pins for the
fused multiply+relin+rescale and the BFV CRT multiply captured from the
CPU path under fixed seeds (exact u32 equality across platforms and NTT
implementations is a scheme invariant — tests/test_ntt4.py).

Runs on the host CPU only.
Run:  python scripts/gen_golden.py        (writes tests/golden/*.npz)
"""

from __future__ import annotations

import os
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=2")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from hetpu.core import nt  # noqa: E402
from hetpu.core.params import preset  # noqa: E402

OUT_DIR = pathlib.Path(__file__).resolve().parent.parent / "tests" / "golden"


# ----------------------------------------------------------------------
# independent bigint transforms (object dtype — exact Python ints)
# ----------------------------------------------------------------------

def bigint_ntt_fwd(a, q: int, psi: int) -> np.ndarray:
    """CT decimation, natural -> bit-reversed, twiddles psi^br(i): the
    spec of core/ntt.py::ntt_fwd re-implemented in exact ints."""
    n = len(a)
    logn = n.bit_length() - 1
    x = np.array([int(v) % q for v in a], dtype=object)
    pw = np.empty(n, dtype=object)
    t = 1
    for i in range(n):
        pw[i] = t
        t = t * psi % q
    br = np.array([nt.bit_reverse(i, logn) for i in range(n)])
    w_tab = pw[br]
    m, half = 1, n // 2
    while m < n:
        x = x.reshape(m, 2, half)
        w = w_tab[m: 2 * m].reshape(m, 1)
        u = x[:, 0, :]
        v = x[:, 1, :] * w % q
        x = np.stack([(u + v) % q, (u - v) % q], axis=1)
        m, half = m * 2, half // 2
    return x.reshape(n)


def bigint_ntt_inv(a, q: int, psi: int) -> np.ndarray:
    """GS butterflies, bit-reversed -> natural, inverse twiddles, x N^-1."""
    n = len(a)
    logn = n.bit_length() - 1
    x = np.array([int(v) % q for v in a], dtype=object)
    psi_inv = nt.modinv(psi, q)
    ipw = np.empty(n, dtype=object)
    t = 1
    for i in range(n):
        ipw[i] = t
        t = t * psi_inv % q
    br = np.array([nt.bit_reverse(i, logn) for i in range(n)])
    iw_tab = ipw[br]
    m, half = n // 2, 1
    while m >= 1:
        x = x.reshape(m, 2, half)
        w = iw_tab[m: 2 * m].reshape(m, 1)
        u, v = x[:, 0, :], x[:, 1, :]
        x = np.stack([(u + v) % q, (u - v) * w % q], axis=1)
        m, half = m // 2, half * 2
    n_inv = nt.modinv(n, q)
    return (x.reshape(n) * n_inv) % q


def _selfcheck_bigint_ntt(n: int = 16, samples: int = 4):
    """Cross-validate the bigint butterflies against the polynomial-
    evaluation DEFINITION: fwd output[j] == a(psi^(2*br(j)+1))."""
    q = nt.gen_primes(17, 1, 2 * n)[0]
    psi = nt.root_of_unity(2 * n, q)
    rng = np.random.default_rng(7)
    a = rng.integers(0, q, n)
    out = bigint_ntt_fwd(a, q, psi)
    logn = n.bit_length() - 1
    for j in range(n):
        e = 2 * nt.bit_reverse(j, logn) + 1
        x = pow(psi, e, q)
        val = 0
        for i in reversed(range(n)):
            val = (val * x + int(a[i])) % q
        assert val == out[j], f"bigint NTT fails definition at j={j}"
    back = bigint_ntt_inv(out, q, psi)
    assert np.array_equal(back, np.array([int(v) % q for v in a],
                                         dtype=object)), "INTT != inverse"


def bigint_rescale(data_std: np.ndarray, primes) -> np.ndarray:
    """Divide-and-round a coefficient-domain standard-form RNS array
    [m, N] over `primes` by its LAST prime (SEAL
    divide_and_round_q_last semantics as implemented by
    evaluator._div_round_last): out_i = (x_i - r) * q_last^-1 where
    r = centered-round residue of the last limb.

    Independent model: v = last limb value; v2 = (v + q_last//2) mod
    q_last; out_i = (x_i - (v2 - q_last//2)) / q_last mod q_i.
    """
    q_last = primes[-1]
    half = q_last // 2
    out = np.zeros((len(primes) - 1, data_std.shape[-1]), dtype=object)
    for i, qi in enumerate(primes[:-1]):
        inv = nt.modinv(q_last % qi, qi)
        for j in range(data_std.shape[-1]):
            v = int(data_std[-1, j])
            r = (v + half) % q_last - half          # centered round term
            out[i, j] = (int(data_std[i, j]) - r) * inv % qi
    return out


# ----------------------------------------------------------------------
# vector emission
# ----------------------------------------------------------------------

def _psi_for(q: int, n: int) -> int:
    return nt.root_of_unity(2 * n, q)


def make_ntt_vectors(name: str, n: int, primes, n_polys: int, rng):
    """Golden (input, fwd, inv) triples over every prime of a basis.
    fwd/inv are INDEPENDENT bigint transforms of the same input."""
    L = len(primes)
    x = np.stack([rng.integers(0, primes[li], n, dtype=np.uint32)
                  for li in range(L)])
    fwd = np.zeros((L, n), dtype=np.uint32)
    inv = np.zeros((L, n), dtype=np.uint32)
    for li, q in enumerate(primes):
        psi = _psi_for(q, n)
        fwd[li] = bigint_ntt_fwd(x[li], q, psi).astype(np.uint64)
        inv[li] = bigint_ntt_inv(x[li], q, psi).astype(np.uint64)
    return {f"{name}_x": x, f"{name}_fwd": fwd, f"{name}_inv": inv,
            f"{name}_primes": np.array(primes, dtype=np.uint64)}


def make_rescale_vectors(name: str, n: int, primes, rng):
    """Golden rescale: standard-form coefficient-domain input [m, N] ->
    bigint divide-and-round output [m-1, N]."""
    m = len(primes)
    x = np.stack([rng.integers(0, primes[i], n, dtype=np.uint32)
                  for i in range(m)])
    out = bigint_rescale(x, primes).astype(np.uint64).astype(np.uint32)
    return {f"{name}_x": x, f"{name}_out": out,
            f"{name}_primes": np.array(primes, dtype=np.uint64)}


def make_kernel_pins():
    """Kernel-regression pins: fused multiply+relin+rescale and BFV CRT
    multiply outputs under fixed seeds on the CPU path.  NOT an
    independent model — these pin today's (bigint-validated at tiny size
    by tests/test_scheme.py, tests/test_bfv*.py) behavior bit-exactly so
    any kernel change that flips a single u32 fails test_golden."""
    import jax.numpy as jnp
    from hetpu.session import Session
    from hetpu.bfv import BfvSession

    pins = {}
    sess = Session.create("test_dnum", seed=b"\x33" * 32, galois_steps=[1])
    rng = np.random.default_rng(5)
    a = sess.encrypt(rng.uniform(-1, 1, sess.slots))
    b = sess.encrypt(rng.uniform(-1, 1, sess.slots))
    out = sess.ev.multiply_relin_rescale(a, b, sess.rk)
    rot = sess.ev.rotate(out, 1, sess.gk)
    pins["fused_a"] = np.asarray(a.data)
    pins["fused_b"] = np.asarray(b.data)
    pins["fused_out"] = np.asarray(out.data)
    pins["fused_rot"] = np.asarray(rot.data)

    bs = BfvSession.create("test_bfv_crt", seed=b"\x34" * 32,
                           galois_steps=[1])
    t = bs.ctx.params.plain_modulus
    va = rng.integers(0, t, bs.slots).astype(object)
    vb = rng.integers(0, t, bs.slots).astype(object)
    ca, cb = bs.encrypt(va), bs.encrypt(vb)
    prod = bs.multiply_relin(ca, cb)
    pins["bfv_a"] = np.asarray(ca.data)
    pins["bfv_b"] = np.asarray(cb.data)
    pins["bfv_out"] = np.asarray(prod.data)
    # sanity: the pinned product decrypts to the exact bigint product
    got = bs.decrypt(prod)
    want = (va * vb) % t
    assert np.array_equal(got, want), "BFV pin does not decrypt correctly"
    return pins


def main():
    print("self-checking bigint NTT against the polynomial definition ...")
    _selfcheck_bigint_ntt(16)
    _selfcheck_bigint_ntt(32)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(2026)

    tiny = preset("test_tiny")
    tiny_basis = tuple(tiny.moduli) + tuple(tiny.special_moduli)
    print(f"tiny basis: N={tiny.poly_degree} primes={tiny_basis}")
    vecs = {}
    vecs.update(make_ntt_vectors("ntt_tiny", tiny.poly_degree, tiny_basis,
                                 1, rng))
    vecs.update(make_rescale_vectors("rs_tiny", tiny.poly_degree,
                                     tiny_basis[:3], rng))
    np.savez_compressed(OUT_DIR / "golden_tiny.npz", **vecs)
    print("wrote golden_tiny.npz")

    n14 = preset("bench_n14")
    basis = tuple(n14.moduli) + tuple(n14.special_moduli)
    print(f"bench_n14 basis: N={n14.poly_degree} L={len(basis)}")
    vecs = {}
    vecs.update(make_ntt_vectors("ntt_n14", n14.poly_degree, basis, 1, rng))
    vecs.update(make_rescale_vectors("rs_n14", n14.poly_degree,
                                     tuple(n14.moduli), rng))
    np.savez_compressed(OUT_DIR / "golden_n14.npz", **vecs)
    print("wrote golden_n14.npz")

    pins = make_kernel_pins()
    np.savez_compressed(OUT_DIR / "golden_pins.npz", **pins)
    print("wrote golden_pins.npz")


if __name__ == "__main__":
    main()
