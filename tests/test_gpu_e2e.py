"""GPU tier: the timed path decrypt-compared on the card, at the timed
sizes, plus the golden-vector NTT check on the device.

Runs only on a GPU; elsewhere every test skips (decided inside the
fixtures, never at import, so every pytest-xdist worker collects the same
tests).  On the card:

    python -m pytest tests/test_gpu_e2e.py -m gpu -n 0

Covers bench_n14 (the headline fused op), BFV at the 60-bit CRT preset, and an in-slot FFT.
"""

import pathlib

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

GOLD = pathlib.Path(__file__).parent / "golden"


@pytest.fixture(scope="module")
def gpu():
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run: pytest tests/test_gpu_e2e.py -m gpu)")
    return jax.devices()[0]


@pytest.fixture(scope="module")
def sess(gpu):
    from hetpu.utils.keycache import cached_session
    return cached_session("bench_n14", seed=b"\x21" * 32, galois_steps=[1])


def test_fused_op_decrypts_on_gpu(sess):
    """multiply+relin+rescale through the GPU NTT path, decrypt-compared."""
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, sess.slots)
    y = rng.uniform(-1, 1, sess.slots)
    out = sess.ev.multiply_relin_rescale(sess.encrypt(x), sess.encrypt(y),
                                         sess.rk)
    err = np.max(np.abs(sess.decrypt(out).real - x * y))
    assert err < 2e-3, f"fused-op decrypt error {err}"


def test_rotate_decrypts_on_gpu(sess):
    rng = np.random.default_rng(8)
    x = rng.uniform(-1, 1, sess.slots)
    ct = sess.encrypt(x)
    got = sess.decrypt(sess.ev.rotate(ct, 1, sess.gk)).real
    err = np.max(np.abs(got - np.roll(x, -1)))
    assert err < 1e-2, f"rotate decrypt error {err}"


def test_ntt_golden_on_gpu(sess):
    """The GPU NTT path must match the independent-bigint golden vectors
    bit-exactly (same basis the bench runs on)."""
    import jax.numpy as jnp
    from hetpu.core.ntt import ntt_fwd, ntt_inv

    z = np.load(GOLD / "golden_n14.npz")
    t = sess.ctx.tables_full
    assert tuple(int(p) for p in z["ntt_n14_primes"]) == t.primes
    x = jnp.asarray(z["ntt_n14_x"])
    np.testing.assert_array_equal(np.asarray(ntt_fwd(x, t)),
                                  z["ntt_n14_fwd"])
    np.testing.assert_array_equal(np.asarray(ntt_inv(x, t)),
                                  z["ntt_n14_inv"])


def test_hoisted_rotation_decrypts_on_gpu(sess):
    """rotate_hoisted (ONE decomposition, many steps) on the device
    (reference hot loop, he_linalg.cpp:977-1003)."""
    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, sess.slots)
    ct = sess.encrypt(x)
    outs = sess.ev.rotate_hoisted(ct, [1], sess.gk)
    err = np.max(np.abs(sess.decrypt(outs[0]).real - np.roll(x, -1)))
    assert err < 1e-2, f"hoisted rotate decrypt error {err}"


def test_bfv_crt_multiply_on_gpu(gpu):
    """BFV HPS multiply + relin at the 60-bit CRT batching preset on the
    card: EXACT integer result (reference batch_matmul_bfv scale,
    matrix_operations.cpp:360-361)."""
    from hetpu.bfv import BfvSession
    sess = BfvSession.create("bfv_batch", seed=b"\x41" * 32,
                             galois_steps=[1])
    rng = np.random.default_rng(10)
    t = sess.scheme.t
    a = rng.integers(0, 1 << 40, sess.slots)
    b = rng.integers(0, 1 << 40, sess.slots)
    out = sess.decrypt(sess.multiply_relin(sess.encrypt(a),
                                           sess.encrypt(b)))
    want = (a.astype(object) * b.astype(object)) % t
    got = np.asarray(out).astype(object)
    assert (got == want).all(), "BFV multiply not exact on the GPU"


def test_bfft_small_on_gpu(gpu):
    """In-slot encrypted FFT (16-pt) decrypt-checked on the device —
    hoisted ±h rotation pairs + mask multiplies + rescale (reference
    he_fft.cpp:89-223)."""
    from hetpu import fft as hefft
    from hetpu.utils.keycache import cached_session
    n = 16
    steps = sorted({s for h in [n >> (i + 1)
                                for i in range(n.bit_length() - 1)]
                    for s in (h, -h)})
    fs = cached_session("ckks_fft", seed=b"\x42" * 32, galois_steps=steps)
    rng = np.random.default_rng(11)
    sig = rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)
    ct = fs.encrypt(np.tile(sig, fs.slots // n))
    out = hefft.bfft(fs, ct, n)
    got = fs.decrypt(out)[:n]
    want = hefft.bit_reverse_order(np.fft.fft(sig))
    err = np.abs(got - want).max()
    assert err < 1e-2, f"bfft decrypt error {err}"


def test_mod_switch_decrypts_on_gpu(sess):
    """mod_switch (drop a prime, no scaling) on-device."""
    rng = np.random.default_rng(12)
    x = rng.uniform(-1, 1, sess.slots)
    ct = sess.ev.mod_switch(sess.encrypt(x))
    err = np.max(np.abs(sess.decrypt(ct).real - x))
    assert err < 2e-3, f"mod_switch decrypt error {err}"
