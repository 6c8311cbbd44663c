"""Key generation: secret, public, relinearization and Galois keys.

Replaces SEAL's ``KeyGenerator`` (reference sites:
``matrix_operations.cpp:764-771``, ``client.cpp:87-92``).

Representation.  All key polynomials are NTT-domain.  Secret/public keys
are Montgomery form; **key-switching keys are stored in Shoup form**
(value + ⌊value·2^32/q⌋ companion): the key-switch inner product multiplies
a *standard-form* extended digit by the key with one 6-mul ``shoup_mul``,
landing directly in Montgomery form — the domain conversion is free and
the hot-loop MAC is ~2x cheaper than the former R²-form ``mont_mul``
(see evaluator._inner_product_raw).

Switching-key structure (hybrid, single special prime P, per-prime RNS
digits — level-independent like SEAL ``util/rlwe.cpp``):
    ksk_j = ( -(a_j·s + e_j) + δ_j·s' ,  a_j )   over basis {q_0..q_{L-1}, P}
with δ_j ≡ P (mod q_j), δ_j ≡ 0 on every other limb.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp

from . import galois, modular, random as rnd
from .context import Context
from .modular import mod_add, mod_neg, mont_mul, shoup_mul, shoup_precompute
from .ntt import ntt_fwd_mont


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SecretKey:
    data: jax.Array                      # [L_tot, N] Montgomery NTT
    seed: bytes = field(metadata=dict(static=True), default=b"")


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PublicKey:
    data: jax.Array                      # [2, L_data, N] Montgomery NTT (b, a)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class KSwitchKey:
    """Key-switch key in *Shoup form*: ``data`` holds the NTT-domain key
    values (standard form; multiplying a standard-form digit by them lands
    directly in Montgomery form — the same free domain conversion as the
    old R²-form, but the inner product becomes a 6-mul ``shoup_mul``
    instead of a 10-mul ``mont_mul``); ``shoup`` is the per-element
    precomputed companion ⌊data·2^32/q⌋."""

    data: jax.Array                      # [J, 2, L_tot, N] NTT
    shoup: jax.Array                     # [J, 2, L_tot, N] companions


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class RelinKeys:
    """Relinearization keys.  ``key`` switches s² → s (the common case);
    ``more`` optionally holds keys for s³, s⁴, … so k-part ciphertexts
    from deferred-relin chains can be reduced (SEAL's size-k relinearize;
    reference SMART_RELIN patterns ``he_linalg.cpp:975-1002``)."""

    key: KSwitchKey
    more: tuple = ()                     # tuple[KSwitchKey] for s^3, s^4, …

    def key_for_power(self, p: int) -> KSwitchKey:
        if p == 2:
            return self.key
        if 3 <= p < 3 + len(self.more):
            return self.more[p - 3]
        raise KeyError(
            f"no relin key for s^{p}; create_relin_keys(count={p - 1})")


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class GaloisKeys:
    elts: tuple = field(metadata=dict(static=True), default=())
    keys: tuple = ()                     # tuple[KSwitchKey] parallel to elts

    def key_for(self, elt: int) -> KSwitchKey:
        try:
            return self.keys[self.elts.index(elt)]
        except ValueError:
            raise KeyError(f"no galois key for element {elt}; "
                           f"have {self.elts}") from None

    def has(self, elt: int) -> bool:
        return elt in self.elts


class KeyGenerator:
    """Samples a fresh secret on construction (like seal::KeyGenerator).

    All device math is batched into ONE jitted call per key: host-side
    numpy sampling feeds [J, L, N] tensors to a compiled kernel — no
    per-digit eager dispatch."""

    def __init__(self, ctx: Context, seed: bytes | None = None):
        self.ctx = ctx
        self.seed = seed if seed is not None else rnd.new_seed()
        self._domain = 0
        n = ctx.params.poly_degree
        tabs = ctx.tables_full
        self._qinv_full = np.array(
            [((1 << 32) - pow(int(p), -1, 1 << 32)) % (1 << 32)
             for p in tabs.primes], dtype=np.uint32).reshape(-1, 1)
        s = rnd.ternary(self.seed, self._next_domain(), n)
        s_rns = rnd.signed_to_rns(s, tabs.q)
        self.secret = SecretKey(
            data=jax.jit(lambda x: ntt_fwd_mont(x, tabs))(jnp.asarray(s_rns)),
            seed=self.seed,
        )
        # generalized hybrid: digits of size α = #specials; P = ∏ specials.
        # δ_i = P mod q_i is naturally 0 on special limbs.
        alpha = ctx.num_special
        self.num_digits = J = -(-ctx.num_data // alpha)
        L_tot = len(ctx.all_primes)
        P = 1
        for p in ctx.params.special_moduli:
            P *= p
        delta = np.array([P % q for q in ctx.all_primes],
                         dtype=np.uint32).reshape(L_tot, 1)
        self._delta = delta
        self._delta_shoup = np.array(
            [(int(P % q) << 32) // q for q in ctx.all_primes],
            dtype=np.uint32).reshape(L_tot, 1)
        digit_mask = np.zeros((J, L_tot, 1), dtype=bool)
        for j in range(J):
            digit_mask[j, j * alpha: min((j + 1) * alpha, ctx.num_data)] = True
        self._digit_mask = digit_mask

        mc_full = modular.mont_constants(tabs.primes)
        r_sh = modular.shoup_precompute(mc_full["r_mod_q"], mc_full["q"])

        # NOTE: key material (secret, s') is passed as ARGUMENTS, never
        # closed over — a closed-over jax.Array becomes an HLO constant,
        # which changes the persistent-cache key every time the seed
        # changes and forces a full recompile per session.  Closure
        # constants below (tabs, δ, masks) are deterministic functions of
        # the params — cache-stable.
        def ksk_kernel(a, e_rns, s_prime, s_data):
            """a, e_rns: [J, L_tot, N]; s_prime/s_data: [L_tot, N]
            Montgomery NTT → ([J, 2, L_tot, N] key, Shoup companions)."""
            e_m = ntt_fwd_mont(e_rns, tabs)
            b = mod_neg(mod_add(mont_mul(a, s_data, tabs.q,
                                         self._qinv_full), e_m, tabs.q),
                        tabs.q)
            term = shoup_mul(s_prime, self._delta, self._delta_shoup, tabs.q)
            b = jnp.where(self._digit_mask,
                          mod_add(b, term, tabs.q), b)
            k = jnp.stack([b, a], axis=1)
            ks = modular.shoup_precompute_dev(
                k, tabs.q, mc_full["r_mod_q"], r_sh,
                mc_full["mu"], mc_full["qinv"])
            return k, ks

        self._ksk_jit = jax.jit(ksk_kernel)

        def pk_kernel(a, e_rns, s_data):
            dtabs = tabs.slice(np.arange(ctx.num_data))
            e_m = ntt_fwd_mont(e_rns, dtabs)
            b = mod_neg(mod_add(mont_mul(a, s_data, dtabs.q,
                                         self._qinv_full[: ctx.num_data]),
                                e_m, dtabs.q), dtabs.q)
            return jnp.stack([b, a])

        self._pk_jit = jax.jit(pk_kernel)
        self._s2_jit = jax.jit(lambda s: mont_mul(s, s, tabs.q, self._qinv_full))
        self._spow_jit = jax.jit(
            lambda sp, s: mont_mul(sp, s, tabs.q, self._qinv_full))

    def _next_domain(self) -> int:
        self._domain += 1
        return self._domain

    # ------------------------------------------------------------------
    def create_public_key(self) -> PublicKey:
        ctx = self.ctx
        n = ctx.params.poly_degree
        q = ctx.tables_full.q[: ctx.num_data]
        a = rnd.uniform_rns(self.seed, self._next_domain(), q, n)
        e = rnd.signed_to_rns(rnd.gaussian(self.seed, self._next_domain(), n), q)
        return PublicKey(data=self._pk_jit(
            jnp.asarray(a), jnp.asarray(e), self.secret.data[: ctx.num_data]))

    # ------------------------------------------------------------------
    def _sample_jln(self):
        """[J, L_tot, N] uniform + noise tensors from the seeded stream."""
        ctx = self.ctx
        n = ctx.params.poly_degree
        q = ctx.tables_full.q
        J = self.num_digits
        a = np.stack([rnd.uniform_rns(self.seed, self._next_domain(), q, n)
                      for _ in range(J)])
        e = np.stack([rnd.signed_to_rns(
            rnd.gaussian(self.seed, self._next_domain(), n), q)
            for _ in range(J)])
        return jnp.asarray(a), jnp.asarray(e)

    def _kswitch_key(self, s_prime: jax.Array) -> KSwitchKey:
        """Switching key for s' → s.  s_prime: [L_tot, N] Montgomery NTT."""
        a, e = self._sample_jln()
        k, ks = self._ksk_jit(a, e, s_prime, self.secret.data)
        return KSwitchKey(data=k, shoup=ks)

    def create_relin_keys(self, count: int = 1) -> RelinKeys:
        """Keys for s²→s (always) and, with ``count`` > 1, s³…s^{count+1}
        — enabling relinearization of up-to-(count+2)-part ciphertexts
        (SEAL KeyGenerator::create_relin_keys size semantics)."""
        s_pow = self._s2_jit(self.secret.data)   # s²
        keys = [self._kswitch_key(s_pow)]
        for _ in range(count - 1):
            s_pow = self._spow_jit(s_pow, self.secret.data)
            keys.append(self._kswitch_key(s_pow))
        return RelinKeys(key=keys[0], more=tuple(keys[1:]))

    def create_galois_keys(self, steps=None) -> GaloisKeys:
        """Keys for slot rotations.  Default: ± all powers of two (SEAL's
        default set — arbitrary steps decompose, evaluator.rotate) plus
        conjugation."""
        ctx = self.ctx
        n = ctx.params.poly_degree
        if steps is None:
            slots = n // 2
            steps = []
            p = 1
            while p < slots:
                steps += [p, -p]
                p *= 2
        elts = []
        for s in steps:
            e = galois.rotation_elt(n, s)
            if e not in elts:
                elts.append(e)
        ce = galois.conjugation_elt(n)
        if ce not in elts:
            elts.append(ce)
        keys = []
        for e in elts:
            s_prime = galois.apply(self.secret.data, n, e)
            keys.append(self._kswitch_key(s_prime))
        return GaloisKeys(elts=tuple(elts), keys=tuple(keys))
