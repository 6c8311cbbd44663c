"""Four-step NTT must be bit-exact vs the flat kernel (same ordering)."""

import numpy as np
import jax.numpy as jnp
import pytest

from hetpu.core import nt
from hetpu.core import ntt as flat
from hetpu.core import ntt4


@pytest.mark.parametrize("n", [4096, 16384, 32768])   # n2 = 128, 256
def test_four_step_matches_flat(n, rng):
    primes = nt.gen_primes(30, 2, 2 * n)
    tf = flat.build_tables(n, primes)
    t4 = ntt4.build_tables(n, primes)
    a = np.stack([rng.integers(0, q, n, dtype=np.uint64).astype(np.uint32)
                  for q in primes])
    want = np.asarray(flat.ntt_fwd(jnp.asarray(a), tf))
    got = np.asarray(ntt4.ntt_fwd(jnp.asarray(a), t4))
    np.testing.assert_array_equal(got, want)
    # inverse: roundtrip + match flat inverse on arbitrary eval-domain data
    back = np.asarray(ntt4.ntt_inv(jnp.asarray(got), t4))
    np.testing.assert_array_equal(back, a)
    want_inv = np.asarray(flat.ntt_inv(jnp.asarray(a), tf))
    got_inv = np.asarray(ntt4.ntt_inv(jnp.asarray(a), t4))
    np.testing.assert_array_equal(got_inv, want_inv)


def test_four_step_strip_mont(rng):
    n = 4096
    primes = nt.gen_primes(30, 2, 2 * n)
    tf = flat.build_tables(n, primes)
    t4 = ntt4.build_tables(n, primes)
    a = np.stack([rng.integers(0, q, n, dtype=np.uint64).astype(np.uint32)
                  for q in primes])
    want = np.asarray(flat.ntt_inv(jnp.asarray(a), tf, strip_mont=True))
    got = np.asarray(ntt4.ntt_inv(jnp.asarray(a), t4, strip_mont=True))
    np.testing.assert_array_equal(got, want)
    # batched leading dims
    ab = jnp.asarray(np.stack([a, a]))
    got_b = np.asarray(ntt4.ntt_fwd(ab, t4))
    want_b = np.asarray(flat.ntt_fwd(ab, tf))
    np.testing.assert_array_equal(got_b, want_b)


def _tables(n, k=3):
    primes = nt.gen_primes(30, k, 2 * n)
    return flat.build_tables(n, primes), ntt4.build_tables(n, primes)


def _rand(rng, shape, primes):
    q = np.array(primes, dtype=np.uint32).reshape(-1, 1)
    return jnp.asarray(rng.integers(0, 2**31, shape, dtype=np.uint32) % q)


def test_four_step_to_mont(rng):
    tf, t4 = _tables(4096)
    x = _rand(rng, (2, len(t4.primes), t4.n), t4.primes)
    np.testing.assert_array_equal(
        np.asarray(ntt4.ntt_fwd(x, t4, to_mont=True)),
        np.asarray(flat.ntt_fwd_mont(x, tf)))


def test_four_step_inv_extra_factor(rng):
    """The digit-local ĥat⁻¹ the key-switch decompose folds into its INTT."""
    tf, t4 = _tables(4096)
    x = _rand(rng, (2, len(t4.primes), t4.n), t4.primes)
    extra = np.array([3, 5, 7], dtype=np.uint32)
    np.testing.assert_array_equal(
        np.asarray(ntt4.ntt_inv(x, t4, strip_mont=True, extra=extra)),
        np.asarray(flat.ntt_inv(x, tf, strip_mont=True, extra=extra)))


def test_four_step_mont_roundtrip(rng):
    """fwd into Montgomery form, then inverse with strip: the identity."""
    _, t4 = _tables(4096)
    x = _rand(rng, (3, len(t4.primes), t4.n), t4.primes)
    back = ntt4.ntt_inv(ntt4.ntt_fwd(x, t4, to_mont=True), t4,
                        strip_mont=True)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(x))


def test_four_step_worst_case_residues():
    """Every residue at q-1 and at the q/2 edges: the modular-add and
    Shoup bounds at their limits."""
    tf, t4 = _tables(4096)
    L = len(t4.primes)
    q = np.array(t4.primes, dtype=np.uint32).reshape(-1, 1)
    for val in (q - 1, q // 2, q // 2 + 1):
        x = jnp.asarray(np.broadcast_to(val, (L, t4.n)).copy())
        np.testing.assert_array_equal(np.asarray(ntt4.ntt_fwd(x, t4)),
                                      np.asarray(flat.ntt_fwd(x, tf)))
        np.testing.assert_array_equal(np.asarray(ntt4.ntt_inv(x, t4)),
                                      np.asarray(flat.ntt_inv(x, tf)))


def test_four_step_slice_with_repeated_primes(rng):
    """A basis that repeats primes (the key switch's concatenated foreign
    bases) transforms each row with its own prime's tables."""
    tf, t4 = _tables(4096)
    idx = [0, 1, 0, 2, 1]
    tf, t4 = tf.slice(idx), t4.slice(idx)
    assert t4.primes == tuple(tf.primes)
    x = _rand(rng, (2, len(idx), t4.n), t4.primes)
    np.testing.assert_array_equal(np.asarray(ntt4.ntt_fwd(x, t4)),
                                  np.asarray(flat.ntt_fwd(x, tf)))
    np.testing.assert_array_equal(np.asarray(ntt4.ntt_inv(x, t4)),
                                  np.asarray(flat.ntt_inv(x, tf)))
