"""Session: the user-facing bundle of context + keys + engines.

The reference threads ``(Evaluator, RelinKeys, GaloisKeys, Encoder)``
through every call via the `%`-currying DSL (``he_operators.h:22-39``).
The equivalent here is one object holding them all, passed to the
linalg/math/fft layers.  It also centralizes scale/level alignment — the
reference's manual ``he::util`` chain juggling (``he_util.h``).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

import numpy as np

from .core.ciphertext import Ciphertext, Plaintext
from .core.context import Context
from .core.encoding import CkksEncoder
from .core.encrypt import Decryptor, Encryptor
from .core.evaluator import Evaluator
from .core.keys import GaloisKeys, KeyGenerator, PublicKey, RelinKeys, SecretKey
from .core.params import HeParams, preset


@dataclass
class Session:
    ctx: Context
    encoder: CkksEncoder
    ev: Evaluator
    rk: RelinKeys | None = None
    gk: GaloisKeys | None = None
    encryptor: Encryptor | None = None
    decryptor: Decryptor | None = None
    # plaintext-constant cache: (key, level, scale) → device-resident
    # Plaintext.  Kills the reference's O(n log n) per-call host re-encoding
    # quirk (``he_fft.cpp:40-61``, SURVEY.md §2c) — twiddles/masks/constants
    # are encoded once per (key, level, scale) and reused forever.
    _pt_cache: dict = dfield(default_factory=dict, repr=False)
    # active device mesh (set via use_mesh): linalg hot loops route
    # through the sharded kernels (parallel.bucketed_matvec / tp) when set
    mesh: object = None
    mesh_axis: str = "rot"

    def use_mesh(self, mesh, axis: str = "rot") -> "Session":
        """Activate a device mesh: subsequent ``BatchedMatrix`` matvecs
        bucket their rotation hot loop across ``mesh[axis]``
        (parallel.bucketed_matvec).  Pass ``None`` to deactivate.
        Returns self for chaining."""
        self.mesh = mesh
        self.mesh_axis = axis
        return self

    # -- construction ---------------------------------------------------
    @classmethod
    def create(cls, params: HeParams | str, *, seed: bytes | None = None,
               galois_steps=None, with_secret: bool = True) -> "Session":
        if isinstance(params, str):
            params = preset(params)
        ctx = Context(params)
        kg = KeyGenerator(ctx, seed=seed)
        pk = kg.create_public_key()
        rk = kg.create_relin_keys()
        gk = kg.create_galois_keys(galois_steps)
        return cls(
            ctx=ctx, encoder=CkksEncoder(ctx), ev=Evaluator(ctx), rk=rk, gk=gk,
            encryptor=Encryptor(ctx, public_key=pk, secret_key=kg.secret),
            decryptor=Decryptor(ctx, kg.secret) if with_secret else None,
        )

    @classmethod
    def from_wire(cls, params: HeParams, rk: RelinKeys | None = None,
                  gk: GaloisKeys | None = None) -> "Session":
        """Evaluator-side session built from received parameters and
        evaluation keys — NO secret material (the reference server builds
        its SEALContext from the wire, ``server.cpp:110-113``, and holds no
        Decryptor anywhere)."""
        ctx = Context(params)
        return cls(ctx=ctx, encoder=CkksEncoder(ctx), ev=Evaluator(ctx),
                   rk=rk, gk=gk)

    @property
    def slots(self) -> int:
        return self.encoder.slot_count

    # -- encode / encrypt / decrypt ------------------------------------
    def encode(self, values, level=None, scale=None) -> Plaintext:
        return self.encoder.encode(values, level, scale)

    def encrypt(self, values, level=None, scale=None) -> Ciphertext:
        return self.encryptor.encrypt(self.encode(values, level, scale))

    def decrypt(self, ct: Ciphertext) -> np.ndarray:
        return self.decryptor.decrypt(ct)

    def const_like(self, ct: Ciphertext, values) -> Plaintext:
        """Encode at ct's exact level+scale (for exact additive alignment).
        Scalar constants go through the plaintext cache."""
        if np.isscalar(values) or getattr(values, "ndim", 1) == 0:
            return self.cached_encode(("const", complex(values)), values,
                                      level=ct.level, scale=ct.scale)
        return self.encode(values, level=ct.level, scale=ct.scale)

    def cached_encode(self, key, values, level=None, scale=None) -> Plaintext:
        """Encode through the session plaintext cache.  ``key`` must
        uniquely identify ``values`` (hashable); level/scale are folded into
        the cache key after default resolution.  ``values`` may be a
        zero-arg callable, only invoked on a miss."""
        if level is None:
            level = self.ctx.num_data - 1
        if scale is None:
            scale = self.ctx.params.scale
        k = (key, level, float(scale))
        pt = self._pt_cache.get(k)
        if pt is None:
            v = values() if callable(values) else values
            pt = self.encode(v, level=level, scale=scale)
            self._pt_cache[k] = pt
        return pt

    # -- level / scale management (he::util parity) --------------------
    def chain_index(self, ct: Ciphertext) -> int:
        """Reference ``he::util::get_chain_index`` (he_util.h:13-21)."""
        return ct.level

    def drop_level(self, ct: Ciphertext) -> Ciphertext:
        """Burn one rescale level (one prime — or one PAIR in the
        rescale_group=2 high-precision mode), EXACTLY preserving scale:
        multiply by 1 encoded at scale ∏dropped, then rescale.  The
        scale-preserving version of the reference's drop_chain_levels
        (``he_util.h:27-55``, multiply-by-1 + rescale)."""
        g = self.ctx.params.rescale_group
        prod = 1.0
        for q in self.ctx.params.moduli[ct.level - g + 1: ct.level + 1]:
            prod *= q
        one = self.cached_encode(("const", 1.0 + 0j), 1.0,
                                 level=ct.level, scale=prod)
        return self.ev.rescale(self.ev.multiply_plain(ct, one))

    def reach_level(self, ct: Ciphertext, target: int) -> Ciphertext:
        """Reference ``he::util::reach_chain_level`` (he_util.h:57-77)."""
        while ct.level > target:
            ct = self.drop_level(ct)
        return ct

    def align(self, a: Ciphertext, b: Ciphertext):
        """Bring two cts to a common level for add/sub."""
        if a.level > b.level:
            a = self.reach_level(a, b.level)
        elif b.level > a.level:
            b = self.reach_level(b, a.level)
        return a, b

    # -- scheme protocol for the linalg layer (CKKS flavor) ------------
    # BfvSession implements the same three methods with exact-integer
    # semantics, so ``linalg.Matrix`` works over either scheme (the
    # reference's Matrix is used by both BFV and CKKS demos,
    # ``matrix_operations.cpp:211-349`` vs ``:495-629``).
    def mat_multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self.ev.multiply(a, b)

    def mat_reduce_finish(self, c3: Ciphertext) -> Ciphertext:
        """Finish an accumulated 3-part sum: relin + rescale (CKKS)."""
        return self.ev.rescale(self.ev.relinearize(c3, self.rk))

    def mat_mult_finish(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self.ev.multiply_relin_rescale(a, b, self.rk)
