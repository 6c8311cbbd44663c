"""HE context: device-ready precomputed tables for one parameter set.

Replaces SEAL's ``SEALContext`` + ``context_data`` modulus chain (reference
uses it everywhere; chain walking in ``include/he_util.h:13-21``).  The
context owns, per RNS prime: NTT twiddle tables, Montgomery/Barrett
constants, and per-level key-switch / rescale constants — all as numpy
arrays that JAX closes over (device-put + cached by jit automatically).

Level convention: ``level = ℓ`` means data primes ``q_0..q_ℓ`` are active
(ℓ+1 limbs).  A fresh ciphertext is at ``level = num_levels-1``; rescale /
mod-switch decrement it.  This equals the reference's ``chain_index``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from . import backend, nt
from .modular import mont_constants, shoup_precompute
from .ntt import NttTables, build_best_tables, build_tables
from .params import HeParams, Scheme


def _col(xs, dt=np.uint32) -> np.ndarray:
    return np.array(xs, dtype=dt).reshape(-1, 1)


@dataclass(frozen=True)
class RescalePlan:
    """Constants for dividing-and-rounding a ciphertext by its last active
    prime q_ℓ (CKKS rescale), or by the special prime P (key-switch
    mod-down).  All shapes broadcast against data [..., ℓ(+1), N]."""

    src_tables: NttTables        # the dropped prime (1 limb)
    dst_tables: NttTables        # remaining primes (ℓ limbs)
    half: np.ndarray             # [1,1]  q_src >> 1
    half_mod: np.ndarray         # [ℓ,1]  (q_src>>1) mod q_i
    mu: np.ndarray               # [ℓ,1]  floor(2^32/q_i) for Barrett
    src_inv: np.ndarray          # [ℓ,1]  q_src^{-1} mod q_i
    src_inv_shoup: np.ndarray


@dataclass(frozen=True)
class ModDownPlan:
    """Divide a key-basis accumulator by P = ∏ special primes, back to the
    active data basis: INTT the k special limbs, centered-FBC them to each
    q_i, subtract, multiply by P^{-1} (one α-misround = ±1 rounding noise)."""

    src_tables: NttTables        # the k special primes
    dst_tables: NttTables        # active data primes
    fbc: object                  # rns.FbcPlan  specials → data
    p_inv: np.ndarray            # [ℓ+1,1]  P^{-1} mod q_i
    p_inv_shoup: np.ndarray


@dataclass(frozen=True)
class ModDownRescalePlan:
    """FUSED key-switch mod-down + CKKS rescale: divide the key-basis
    accumulator (plus P·(c0,c1)) by P·q_ℓ in ONE divide-and-round, landing
    directly on level ℓ-1.  Saves the separate rescale's INTT/NTT tower
    (~20% of the NTT planes of a mult+relin+rescale) and one elementwise
    pass; rounding quality matches the two-step path (one centered-FBC
    α-misround = ±1 noise unit)."""

    src_tables: NttTables        # [q_ℓ] + specials  (α+1 limbs)
    dst_tables: NttTables        # data primes q_0..q_{ℓ-1}
    fbc: object                  # rns.FbcPlan  sources → dst
    p_mod: np.ndarray            # [ℓ+1,1]  P mod q_i (for c·P lift)
    p_mod_shoup: np.ndarray
    pq_inv: np.ndarray           # [ℓ,1]  (P·q_ℓ)^{-1} mod q_i
    pq_inv_shoup: np.ndarray


@dataclass(frozen=True)
class KeySwitchPlan:
    """Constants for generalized hybrid key-switching at level ℓ with
    digit size α = #special primes (dnum trade-off).

    Digits partition the active primes into groups of α; digit j of d is
    its lift from basis D_j = {q_{jα}..}, carried to the key basis
    {q_0..q_ℓ} ∪ specials via a per-digit fast base conversion.  The
    switching key's b-component carries (P mod q_i)·s' exactly on digit
    j's limbs (P ≡ 0 on special limbs automatically) — keys stay
    level-independent because Q_ℓ | Q (SEAL's trick generalized; α=1
    reduces to SEAL's per-prime decomposition).
    """

    level: int
    alpha: int
    num_digits: int              # ceil((ℓ+1)/α)
    digit_bounds: tuple          # ((start, stop), ...) within active primes
    basis_tables: NttTables      # key basis {q_0..q_ℓ, specials}   [R, N]
    q: np.ndarray                # [R,1]
    qinv_neg: np.ndarray         # [R,1] Montgomery -q^{-1} mod 2^32
    # per-source-prime digit-lift constants (digit-local ĥat inverses):
    dig_inv: np.ndarray          # [ℓ+1,1]  (D_j/q_i)^{-1} mod q_i
    dig_inv_shoup: np.ndarray
    # R^{-1} mod q_i: on a digit's OWN primes the lifted value is c2
    # itself (Σ ŷ_i·d̂_i ≡ c2·D̂_i^{-1}·D̂_i ≡ c2; foreign d̂ terms and the
    # FBC excess u·D all contain the prime), so those rows come straight
    # from the Montgomery-NTT input with one strip-R Shoup multiply —
    # no INTT→NTT roundtrip, bit-identical to the lift
    rinv: np.ndarray             # [ℓ+1,1]
    rinv_shoup: np.ndarray
    # per-digit FOREIGN-prime views (key basis minus the digit's own
    # primes), precomputed so jit traces reuse one table identity
    foreign_idx: tuple           # (np.ndarray, ...) per digit
    foreign_tables: tuple        # (NttTables/FourStepTables, ...) per digit
    # ALL digits' foreign bases concatenated (duplicate primes allowed):
    # one NTT call covers every lifted plane instead of one call per digit
    foreign_cat_tables: object
    dhat: np.ndarray             # [ℓ+1,R]  (D_j/q_i) mod r
    dhat_shoup: np.ndarray
    moddown: ModDownPlan


class Context:
    """All precomputed state for a parameter set. Host-side numpy; arrays
    are closed over by jitted evaluator functions (JAX device-puts and
    caches them)."""

    def __init__(self, params: HeParams):
        backend.ntt_path()          # an unsupported platform fails here
        self.params = params
        n = params.poly_degree
        self.all_primes: tuple[int, ...] = params.moduli + params.special_moduli
        self.num_data = len(params.moduli)
        self.num_special = len(params.special_moduli)
        # one full table set over data + special primes; levels slice it
        self.tables_full = build_best_tables(n, self.all_primes)
        self.mont_full = mont_constants(self.all_primes)

    # ------------------------------------------------------------------
    # Per-level views (cached)
    # ------------------------------------------------------------------

    @lru_cache(maxsize=None)
    def tables(self, level: int) -> NttTables:
        """NTT tables for active data primes q_0..q_level."""
        return self.tables_full.slice(np.arange(level + 1))

    @lru_cache(maxsize=None)
    def mont(self, level: int) -> dict:
        idx = np.arange(level + 1)
        return {k: np.ascontiguousarray(v[idx]) for k, v in self.mont_full.items()}

    @lru_cache(maxsize=None)
    def rescale_plan(self, level: int) -> RescalePlan:
        """Divide-and-round by q_level, landing on level-1."""
        if level < 1:
            raise ValueError("cannot rescale below level 0")
        src = self.params.moduli[level]
        dst = self.params.moduli[: level]
        return self._make_rescale(src_idx=level, dst_idx=np.arange(level),
                                  src_prime=src, dst_primes=dst)

    @lru_cache(maxsize=None)
    def group_rescale_plan(self, level: int) -> ModDownPlan:
        """Paired-prime rescale: divide-and-round by q_{ℓ-1}·q_ℓ (the
        rescale_group=2 high-precision mode).  Same centered-FBC
        divide machinery as the key-switch mod-down (evaluator._mod_down
        with k=2)."""
        from . import rns
        g = self.params.rescale_group
        if level - g + 1 < self.params.num_anchor:
            raise ValueError("cannot rescale into the anchor primes")
        src = list(self.params.moduli[level - g + 1: level + 1])
        dst = list(self.params.moduli[: level - g + 1])
        P = 1
        for p in src:
            P *= p
        return ModDownPlan(
            src_tables=self.tables_full.slice(
                np.arange(level - g + 1, level + 1)),
            dst_tables=self.tables_full.slice(np.arange(level - g + 1)),
            fbc=rns.make_fbc(src, dst),
            p_inv=_col([nt.modinv(P % q, q) for q in dst]),
            p_inv_shoup=shoup_precompute(
                _col([nt.modinv(P % q, q) for q in dst]), _col(dst)),
        )

    def _make_rescale(self, src_idx, dst_idx, src_prime, dst_primes) -> RescalePlan:
        half = src_prime >> 1
        return RescalePlan(
            src_tables=self.tables_full.slice(np.array([src_idx])),
            dst_tables=self.tables_full.slice(dst_idx),
            half=_col([half]),
            half_mod=_col([half % q for q in dst_primes]),
            mu=_col([(1 << 32) // q for q in dst_primes]),
            src_inv=_col([nt.modinv(src_prime % q, q) for q in dst_primes]),
            src_inv_shoup=shoup_precompute(
                _col([nt.modinv(src_prime % q, q) for q in dst_primes]),
                _col(dst_primes),
            ),
        )

    @lru_cache(maxsize=None)
    def keyswitch_plan(self, level: int) -> KeySwitchPlan:
        """Generalized hybrid key-switch constants at level ℓ."""
        from . import rns
        alpha = self.num_special
        k = self.num_special
        n_data = level + 1
        J = -(-n_data // alpha)
        active = list(self.params.moduli[: n_data])
        specials = list(self.params.special_moduli)
        basis_index = np.concatenate(
            [np.arange(n_data),
             np.arange(self.num_data, self.num_data + k)])
        basis_primes = active + specials
        R = len(basis_primes)
        bounds = tuple((j * alpha, min((j + 1) * alpha, n_data))
                       for j in range(J))
        # per-digit lift constants
        dig_inv = np.zeros((n_data, 1), dtype=np.uint32)
        rinv = _col([nt.modinv((1 << 32) % q, q) for q in active])
        dhat = np.zeros((n_data, R), dtype=np.uint32)
        for (lo, hi) in bounds:
            D = 1
            for i in range(lo, hi):
                D *= active[i]
            for i in range(lo, hi):
                qi = active[i]
                dig_inv[i, 0] = nt.modinv((D // qi) % qi, qi)
                for rj, r in enumerate(basis_primes):
                    dhat[i, rj] = (D // qi) % r
        dhat_shoup = np.zeros_like(dhat)
        for rj, r in enumerate(basis_primes):
            dhat_shoup[:, rj] = ((dhat[:, rj].astype(np.uint64) << np.uint64(32))
                                 // np.uint64(r)).astype(np.uint32)
        P = 1
        for p in specials:
            P *= p
        moddown = ModDownPlan(
            src_tables=self.tables_full.slice(
                np.arange(self.num_data, self.num_data + k)),
            dst_tables=self.tables_full.slice(np.arange(n_data)),
            fbc=rns.make_fbc(specials, active),
            p_inv=_col([nt.modinv(P % q, q) for q in active]),
            p_inv_shoup=shoup_precompute(
                _col([nt.modinv(P % q, q) for q in active]), _col(active)),
        )
        basis_tables = self.tables_full.slice(basis_index)
        foreign_idx = tuple(
            np.concatenate([np.arange(lo), np.arange(hi, R)])
            for (lo, hi) in bounds)
        return KeySwitchPlan(
            level=level,
            alpha=alpha,
            num_digits=J,
            digit_bounds=bounds,
            basis_tables=basis_tables,
            foreign_idx=foreign_idx,
            foreign_tables=tuple(basis_tables.slice(f) for f in foreign_idx),
            foreign_cat_tables=basis_tables.slice(
                np.concatenate(foreign_idx)) if len(foreign_idx) else None,
            q=_col(basis_primes),
            qinv_neg=_col([((1 << 32) - nt.modinv(r, 1 << 32)) % (1 << 32)
                           for r in basis_primes]),
            dig_inv=dig_inv,
            dig_inv_shoup=shoup_precompute(dig_inv, _col(active)),
            rinv=rinv,
            rinv_shoup=shoup_precompute(rinv, _col(active)),
            dhat=dhat,
            dhat_shoup=dhat_shoup,
            moddown=moddown,
        )

    @lru_cache(maxsize=None)
    def moddown_rescale_plan(self, level: int) -> ModDownRescalePlan:
        """Fused divide-and-round by P·q_level (·q_{level-1} when
        rescale_group=2): key-switch mod-down and rescale in one pass,
        landing on level-group."""
        from . import rns
        g = self.params.rescale_group
        floor = self.params.num_anchor if g > 1 else 1
        if level - g + 1 < floor:
            raise ValueError("cannot rescale below the chain floor")
        k = self.num_special
        dropped = list(self.params.moduli[level - g + 1: level + 1])
        specials = list(self.params.special_moduli)
        dst = list(self.params.moduli[: level - g + 1])
        src_idx = np.concatenate(
            [np.arange(level - g + 1, level + 1),
             np.arange(self.num_data, self.num_data + k)])
        P = 1
        for p in specials:
            P *= p
        PQ = P
        for q in dropped:
            PQ *= q
        active = list(self.params.moduli[: level + 1])
        return ModDownRescalePlan(
            src_tables=self.tables_full.slice(src_idx),
            dst_tables=self.tables_full.slice(np.arange(level - g + 1)),
            fbc=rns.make_fbc(dropped + specials, dst),
            p_mod=_col([P % q for q in active]),
            p_mod_shoup=shoup_precompute(
                _col([P % q for q in active]), _col(active)),
            pq_inv=_col([nt.modinv(PQ % q, q) for q in dst]),
            pq_inv_shoup=shoup_precompute(
                _col([nt.modinv(PQ % q, q) for q in dst]), _col(dst)),
        )

    # ------------------------------------------------------------------
    # Exact CRT helpers (host side, Python ints)
    # ------------------------------------------------------------------

    def q_at(self, level: int) -> int:
        x = 1
        for q in self.params.moduli[: level + 1]:
            x *= q
        return x

    def crt_lift(self, residues: np.ndarray, level: int) -> np.ndarray:
        """[ℓ+1, N] uint32 standard-form residues → object array of centered
        Python ints in (-Q/2, Q/2]."""
        primes = self.params.moduli[: level + 1]
        Q = self.q_at(level)
        acc = np.zeros(residues.shape[-1], dtype=object)
        for i, q in enumerate(primes):
            qhat = Q // q
            coef = qhat * nt.modinv(qhat % q, q) % Q
            acc = (acc + residues[i].astype(object) * coef) % Q
        return np.where(acc > Q // 2, acc - Q, acc)

    def _lift_k(self, residues: np.ndarray, primes, k: int):
        """Centered CRT lift over the first k limbs (object ints).
        Returns (out, Qk)."""
        Qk = 1
        for q in primes[:k]:
            Qk *= q
        acc = np.zeros(residues.shape[-1], dtype=object)
        for i in range(k):
            q = primes[i]
            qhat = Qk // q
            coef = qhat * nt.modinv(qhat % q, q) % Qk
            acc = (acc + residues[i].astype(object) * coef) % Qk
        return np.where(acc > Qk // 2, acc - Qk, acc), Qk

    def _lift_consistent(self, out: np.ndarray, residues: np.ndarray,
                         primes, k: int, spares: int) -> bool:
        """True iff the k-limb lift reproduces the next `spares` limbs'
        residues (per-spare false-accept ~2^-31; two spares ⇒ ≥2^60
        guard band — ADVICE r4)."""
        for spare in range(k, min(k + spares, len(primes))):
            qc = int(primes[spare])
            if not np.array_equal((out % qc).astype(np.int64),
                                  residues[spare].astype(np.int64)):
                return False
        return True

    def crt_lift_auto(self, residues: np.ndarray, level: int) -> np.ndarray:
        """Centered lift of values of UNKNOWN (typically small) magnitude:
        escalates the limb count geometrically, validating each attempt
        against two spare limbs, falling back to the exact full lift.
        Cost ≤ ~2× the optimal bounded lift; used by the BFV noise-budget
        probe where the noise is usually ≪ Q (reference
        ``matrix_operations.cpp:195-199`` prints budgets around every op)."""
        primes = self.params.moduli[: level + 1]
        k = 2
        while k + 2 <= len(primes):
            out, _ = self._lift_k(residues, primes, k)
            if self._lift_consistent(out, residues, primes, k, 2):
                return out
            k *= 2
        return self.crt_lift(residues, level)

    def crt_lift_small(self, residues: np.ndarray, level: int,
                       bound_bits: int) -> np.ndarray:
        """Centered lift of values KNOWN to be < 2^bound_bits in magnitude
        (e.g. a decrypted CKKS coefficient ≈ scale·|m| + noise ≪ Q): CRT
        over only the first k limbs with q_0…q_{k-1} product > 2^{bound+2},
        then a consistency check against limb k — on mismatch (value
        larger than promised) falls back to the full lift.  Deep hi-prec
        chains lift 26 limbs of 800-bit bigints otherwise (~47 s per
        decode at N=2^15; this path is ~20× cheaper)."""
        primes = self.params.moduli[: level + 1]
        k, prod = 0, 1
        while k < len(primes) and prod.bit_length() <= bound_bits + 2:
            prod *= primes[k]
            k += 1
        if k >= len(primes):
            return self.crt_lift(residues, level)
        Qk = prod
        acc = np.zeros(residues.shape[-1], dtype=object)
        for i in range(k):
            q = primes[i]
            qhat = Qk // q
            coef = qhat * nt.modinv(qhat % q, q) % Qk
            acc = (acc + residues[i].astype(object) * coef) % Qk
        out = np.where(acc > Qk // 2, acc - Qk, acc)
        # consistency: the lifted value must reproduce the residues of the
        # NEXT TWO spare limbs (when available) — one limb alone leaves a
        # ~2^-31 per-coefficient false-accept window (a value differing by
        # a multiple of Qk·q_k passes); two limbs push the window past
        # 2^-62, i.e. a ≥2^60 guard band (ADVICE r4).  On any mismatch the
        # bound was wrong: fall back to the exact full lift.
        for spare in range(k, min(k + 2, len(primes))):
            qc = int(primes[spare])
            if not np.array_equal((out % qc).astype(np.int64),
                                  residues[spare].astype(np.int64)):
                return self.crt_lift(residues, level)  # bound was wrong
        return out

    def to_rns(self, coeffs: np.ndarray, level: int) -> np.ndarray:
        """Int array (possibly negative; int64 or object) → [ℓ+1, N] u32."""
        primes = self.params.moduli[: level + 1]
        out = np.empty((len(primes), coeffs.shape[-1]), dtype=np.uint32)
        if coeffs.dtype != object:
            c = coeffs.astype(np.int64)        # vectorized per-limb modulo
            for i, q in enumerate(primes):
                out[i] = (c % np.int64(q)).astype(np.uint32)
            return out
        c = coeffs.astype(object)
        for i, q in enumerate(primes):
            out[i] = (c % q).astype(np.uint64).astype(np.uint32)
        return out
