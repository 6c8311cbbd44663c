"""On-disk session/key cache.

Keygen for deep chains costs minutes (host-side sampling + per-digit RLWE
pairs); benchmarks and demos re-creating identical deterministic sessions
(same preset + seed) can reload the keys from disk instead.  Uses the
wire-format serializer (core/serial.py) — so this doubles as a test of the
checkpoint/restore path (SURVEY.md §5 checkpoint/resume).

SECURITY: the cache stores the RAW SECRET KEY on disk (0o700 dir /
0o600 files, but still plaintext).  It exists for benchmarks, demos and
tests with throwaway deterministic keys — do NOT point it at production
keys; a real deployment should checkpoint only public material (pk/rk/gk
via core/serial) and keep sk in a KMS."""

from __future__ import annotations

import hashlib
import os
import pathlib

import numpy as np
import jax.numpy as jnp

from .. import CACHE_ROOT
from ..core import serial
from ..core.context import Context
from ..core.encoding import CkksEncoder
from ..core.encrypt import Decryptor, Encryptor
from ..core.evaluator import Evaluator
from ..core.keys import KeyGenerator, SecretKey
from ..core.params import HeParams, preset as get_preset
from ..session import Session

CACHE_DIR = pathlib.Path(os.environ.get("HETPU_KEY_CACHE",
                                        CACHE_ROOT / "keys"))


def cached_session(params: HeParams | str, *, seed: bytes,
                   galois_steps=None) -> Session:
    """Session.create with a disk cache keyed on (params, seed, steps)."""
    if isinstance(params, str):
        params = get_preset(params)
    tag = hashlib.sha256(
        repr((params, seed, tuple(galois_steps or ()))).encode()).hexdigest()[:16]
    path = CACHE_DIR / f"sess_{tag}.npz"
    ctx = Context(params)
    if path.exists():
        try:
            z = np.load(path, allow_pickle=False)
            sk = SecretKey(data=jnp.asarray(z["sk"]), seed=seed)
            pk = serial.load_public_key(z["pk"].tobytes())
            rk = serial.load_relin_keys(z["rk"].tobytes(), ctx)
            gk = serial.load_galois_keys(z["gk"].tobytes(), ctx)
            return Session(
                ctx=ctx, encoder=CkksEncoder(ctx), ev=Evaluator(ctx),
                rk=rk, gk=gk,
                encryptor=Encryptor(ctx, public_key=pk, secret_key=sk),
                decryptor=Decryptor(ctx, sk),
            )
        except ValueError:
            path.unlink()      # stale wire version — regenerate below
    sess = Session.create(params, seed=seed, galois_steps=galois_steps)
    CACHE_DIR.mkdir(parents=True, exist_ok=True, mode=0o700)
    os.chmod(CACHE_DIR, 0o700)        # pre-existing dir: tighten it too
    kg_sk = sess.decryptor.sk
    # open with 0o600 BEFORE any bytes are written — np.savez(path) under
    # the default umask would leave a window where the plaintext sk is
    # world-readable (ADVICE r4)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "wb") as fh:
        np.savez(
            fh,
            sk=np.asarray(kg_sk.data),
            pk=np.frombuffer(serial.dump_public_key(
                sess.encryptor.pk), dtype=np.uint8),
            rk=np.frombuffer(serial.dump_relin_keys(sess.rk), dtype=np.uint8),
            gk=np.frombuffer(serial.dump_galois_keys(sess.gk), dtype=np.uint8),
        )
    return sess
