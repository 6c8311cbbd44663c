"""End-to-end CKKS scheme tests — the reference's decrypt-and-print checks
(SURVEY.md §4) re-expressed as tolerance asserts against plaintext math."""

import numpy as np
import pytest

from hetpu.core.context import Context
from hetpu.core.encoding import CkksEncoder
from hetpu.core.encrypt import Decryptor, Encryptor
from hetpu.core.evaluator import Evaluator
from hetpu.core.keys import KeyGenerator
from hetpu.core.params import preset


SEED = b"\x01" * 32


@pytest.fixture(scope="module")
def env():
    ctx = Context(preset("test_tiny"))
    kg = KeyGenerator(ctx, seed=SEED)
    pk = kg.create_public_key()
    rk = kg.create_relin_keys()
    gk = kg.create_galois_keys()
    enc = CkksEncoder(ctx)
    return dict(ctx=ctx, kg=kg, pk=pk, rk=rk, gk=gk, enc=enc,
                encryptor=Encryptor(ctx, public_key=pk, secret_key=kg.secret),
                dec=Decryptor(ctx, kg.secret), ev=Evaluator(ctx))


def _rand_slots(rng, n_slots, lo=-1.0, hi=1.0, complex_=True):
    x = rng.uniform(lo, hi, n_slots)
    if complex_:
        x = x + 1j * rng.uniform(lo, hi, n_slots)
    return x


def test_encode_decode_roundtrip(env, rng):
    enc = env["enc"]
    z = _rand_slots(rng, enc.slot_count)
    pt = enc.encode(z)
    ctx = env["ctx"]
    # decode requires coefficient residues: invert the NTT
    from hetpu.core.ntt import ntt_inv
    coeffs = np.asarray(ntt_inv(pt.data, ctx.tables(pt.level)))
    back = enc.decode(coeffs, pt.level, pt.scale)
    np.testing.assert_allclose(back, z, atol=1e-5)


def test_encrypt_decrypt(env, rng):
    enc, dec = env["enc"], env["dec"]
    z = _rand_slots(rng, enc.slot_count)
    ct = env["encryptor"].encrypt(enc.encode(z))
    assert ct.num_parts == 2
    np.testing.assert_allclose(dec.decrypt(ct), z, atol=1e-4)


def test_encrypt_symmetric(env, rng):
    enc, dec = env["enc"], env["dec"]
    z = _rand_slots(rng, enc.slot_count)
    ct = env["encryptor"].encrypt_symmetric(enc.encode(z))
    np.testing.assert_allclose(dec.decrypt(ct), z, atol=1e-4)


def test_add_sub_negate(env, rng):
    enc, dec, ev = env["enc"], env["dec"], env["ev"]
    x = _rand_slots(rng, enc.slot_count)
    y = _rand_slots(rng, enc.slot_count)
    cx = env["encryptor"].encrypt(enc.encode(x))
    cy = env["encryptor"].encrypt(enc.encode(y))
    np.testing.assert_allclose(dec.decrypt(ev.add(cx, cy)), x + y, atol=1e-4)
    np.testing.assert_allclose(dec.decrypt(ev.sub(cx, cy)), x - y, atol=1e-4)
    np.testing.assert_allclose(dec.decrypt(ev.negate(cx)), -x, atol=1e-4)


def test_plain_ops(env, rng):
    enc, dec, ev = env["enc"], env["dec"], env["ev"]
    x = _rand_slots(rng, enc.slot_count)
    y = _rand_slots(rng, enc.slot_count)
    cx = env["encryptor"].encrypt(enc.encode(x))
    py = enc.encode(y)
    np.testing.assert_allclose(dec.decrypt(ev.add_plain(cx, py)), x + y, atol=1e-4)
    np.testing.assert_allclose(dec.decrypt(ev.sub_plain(cx, py)), x - y, atol=1e-4)
    prod = ev.multiply_plain(cx, py)
    np.testing.assert_allclose(dec.decrypt(prod), x * y, atol=1e-3)
    # and rescaled back to the working scale
    np.testing.assert_allclose(dec.decrypt(ev.rescale(prod)), x * y, atol=1e-3)


def test_multiply_relin_rescale(env, rng):
    enc, dec, ev = env["enc"], env["dec"], env["ev"]
    x = _rand_slots(rng, enc.slot_count)
    y = _rand_slots(rng, enc.slot_count)
    cx = env["encryptor"].encrypt(enc.encode(x))
    cy = env["encryptor"].encrypt(enc.encode(y))
    c3 = ev.multiply(cx, cy)
    assert c3.num_parts == 3
    # decrypt the 3-part ct directly (no relin) — checks the tensor product
    np.testing.assert_allclose(dec.decrypt(c3), x * y, atol=1e-3)
    c2 = ev.relinearize(c3, env["rk"])
    assert c2.num_parts == 2
    np.testing.assert_allclose(dec.decrypt(c2), x * y, atol=1e-3)
    cr = ev.rescale(c2)
    assert cr.level == cx.level - 1
    np.testing.assert_allclose(dec.decrypt(cr), x * y, atol=1e-3)


def test_square(env, rng):
    enc, dec, ev = env["enc"], env["dec"], env["ev"]
    x = _rand_slots(rng, enc.slot_count)
    cx = env["encryptor"].encrypt(enc.encode(x))
    got = dec.decrypt(ev.square_relin_rescale(cx, env["rk"]))
    np.testing.assert_allclose(got, x * x, atol=1e-3)


def test_depth_two(env, rng):
    """(x·y)·x across two rescales — exercises level-1 keyswitch plans."""
    enc, dec, ev = env["enc"], env["dec"], env["ev"]
    x = _rand_slots(rng, enc.slot_count, -0.9, 0.9)
    y = _rand_slots(rng, enc.slot_count, -0.9, 0.9)
    cx = env["encryptor"].encrypt(enc.encode(x))
    cy = env["encryptor"].encrypt(enc.encode(y))
    p = ev.multiply_relin_rescale(cx, cy, env["rk"])
    cx1 = ev.mod_switch(cx)
    # scales: p.scale = Δ²/q₂ ≈ Δ; align by exact-scale multiply
    p2 = ev.multiply(p, cx1.with_(scale=cx1.scale))
    p2 = ev.rescale(ev.relinearize(p2, env["rk"]))
    np.testing.assert_allclose(dec.decrypt(p2), x * y * x, atol=5e-3)


def test_rotate(env, rng):
    enc, dec, ev = env["enc"], env["dec"], env["ev"]
    z = _rand_slots(rng, enc.slot_count)
    cx = env["encryptor"].encrypt(enc.encode(z))
    # keyed power-of-two step
    got = dec.decrypt(ev.rotate(cx, 1, env["gk"]))
    np.testing.assert_allclose(got, np.roll(z, -1), atol=1e-4)
    got = dec.decrypt(ev.rotate(cx, -2, env["gk"]))
    np.testing.assert_allclose(got, np.roll(z, 2), atol=1e-4)
    # non-power-of-two → decomposition chain
    got = dec.decrypt(ev.rotate(cx, 5, env["gk"]))
    np.testing.assert_allclose(got, np.roll(z, -5), atol=1e-4)


def test_conjugate(env, rng):
    enc, dec, ev = env["enc"], env["dec"], env["ev"]
    z = _rand_slots(rng, enc.slot_count)
    cx = env["encryptor"].encrypt(enc.encode(z))
    got = dec.decrypt(ev.conjugate(cx, env["gk"]))
    np.testing.assert_allclose(got, np.conj(z), atol=1e-4)


def test_mod_switch(env, rng):
    enc, dec, ev = env["enc"], env["dec"], env["ev"]
    z = _rand_slots(rng, enc.slot_count)
    cx = env["encryptor"].encrypt(enc.encode(z))
    cm = ev.mod_switch(cx)
    assert cm.level == cx.level - 1 and cm.scale == cx.scale
    np.testing.assert_allclose(dec.decrypt(cm), z, atol=1e-4)


def test_batched_ciphertexts(env, rng):
    """Leading batch axes flow through every op (the batching story —
    SURVEY.md §2d 'Slot/SIMD batching' becomes an array axis here)."""
    import jax.numpy as jnp
    enc, dec, ev = env["enc"], env["dec"], env["ev"]
    zs = [_rand_slots(rng, enc.slot_count) for _ in range(3)]
    cts = [env["encryptor"].encrypt(enc.encode(z)) for z in zs]
    batched = cts[0].with_(data=jnp.stack([c.data for c in cts]))
    summed = ev.add(batched, batched)
    prod = ev.square_relin_rescale(batched, env["rk"])
    for i, z in enumerate(zs):
        np.testing.assert_allclose(
            dec.decrypt(summed.with_(data=summed.data[i])), 2 * z, atol=1e-3)
        np.testing.assert_allclose(
            dec.decrypt(prod.with_(data=prod.data[i])), z * z, atol=1e-3)


def test_kpart_multiply_relinearize(env, rng):
    """Deferred-relin chain: (x·y)·z as a 3-part × 2-part multiply → 4-part
    ct, relinearized with s²/s³ keys (SEAL size-k semantics; reference
    SMART_RELIN patterns ``he_linalg.cpp:975-1002``)."""
    enc, dec, ev = env["enc"], env["dec"], env["ev"]
    rk3 = env["kg"].create_relin_keys(count=2)
    x = _rand_slots(rng, enc.slot_count, -0.9, 0.9)
    y = _rand_slots(rng, enc.slot_count, -0.9, 0.9)
    z = _rand_slots(rng, enc.slot_count, -0.9, 0.9)
    cx = env["encryptor"].encrypt(enc.encode(x))
    cy = env["encryptor"].encrypt(enc.encode(y))
    cz = env["encryptor"].encrypt(enc.encode(z))
    c3 = ev.multiply(cx, cy)                 # 3 parts, no relin
    c4 = ev.multiply(c3, cz)                 # 4 parts (and 2×k order flip)
    c4b = ev.multiply(cz, c3)
    assert c4.num_parts == 4 == c4b.num_parts
    want = x * y * z
    np.testing.assert_allclose(dec.decrypt(c4), want, atol=5e-3)
    c2 = ev.relinearize(c4, rk3)
    assert c2.num_parts == 2
    np.testing.assert_allclose(dec.decrypt(c2), want, atol=5e-3)
    np.testing.assert_allclose(dec.decrypt(ev.relinearize(c4b, rk3)),
                               want, atol=5e-3)
    # missing-key error path
    with pytest.raises(KeyError):
        ev.relinearize(c4, env["rk"])


def test_relin_keys_roundtrip_multi(env):
    """Multi-key RelinKeys survive the wire format."""
    from hetpu.core import serial
    rk3 = env["kg"].create_relin_keys(count=2)
    blob = serial.dump_relin_keys(rk3)
    back = serial.load_relin_keys(blob, env["ctx"])
    assert len(back.more) == 1
    np.testing.assert_array_equal(np.asarray(back.key.data),
                                  np.asarray(rk3.key.data))
    np.testing.assert_array_equal(np.asarray(back.more[0].data),
                                  np.asarray(rk3.more[0].data))
