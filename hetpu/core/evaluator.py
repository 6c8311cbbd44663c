"""The homomorphic evaluator: every op the reference's DSL wraps.

Op-for-op parity with ``he_operators.cpp:14-237`` (which wraps
``seal::Evaluator`` 1:1):  negate(:14) add/sub/mult ct-ct & ct-pt(:33-142),
relinearize(:147), rescale(:166), mod_switch(:185), rotate ±(:204-237) —
plus square and fused multiply+relin+rescale (the reference's hot
combination, ``he_linalg.cpp:556-584``).

All methods are *pure traceable functions* on Ciphertext pytrees: no
internal jit, so callers compose entire encrypted pipelines (matmul,
least-squares, FFT) and jit ONCE at the top — the XLA-idiomatic shape.
Level/scale are static → jit specializes per chain position, mirroring
SEAL's per-context_data dispatch, with a bounded trace-cache (≤ chain
depth).

Hot-loop cost model (per [L, N] limb-plane, int32 multiplies/element):
  add/sub 0 · ct-pt mult 6 (Shoup) · ct-ct mult 10 (Montgomery) ·
  keyswitch = (ℓ+1) INTT + (ℓ+1)(ℓ+2) NTT-equivalents + 10(ℓ+1)(ℓ+2) MACs.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from . import galois, rns
from .ciphertext import Ciphertext, Plaintext, check_add_compat, scales_close
from .context import Context, KeySwitchPlan, RescalePlan
from .keys import GaloisKeys, KSwitchKey, RelinKeys
from .modular import (
    barrett_reduce_u32,
    mod_add,
    mod_neg,
    mod_sub,
    mont_mul,
    shoup_mul,
)
from .ntt import ntt_fwd, ntt_fwd_mont, ntt_inv


class Evaluator:
    """See module docstring.  With ``enable_jit`` (default) every public
    op is wrapped in ``jax.jit`` — level/scale are static pytree aux data,
    so XLA compiles one kernel per (op, level, shape) and replays it; an
    outer user-level jit simply inlines these."""

    def __init__(self, ctx: Context, enable_jit: bool = True):
        self.ctx = ctx
        if enable_jit:
            for name in ("negate", "add", "sub", "add_plain", "sub_plain",
                         "multiply_plain", "multiply", "square",
                         "relinearize", "rescale", "mod_switch",
                         "multiply_relin_rescale", "square_relin_rescale",
                         "multiply_plain_rescale"):
                setattr(self, name, jax.jit(getattr(self, name)))
            self.apply_galois = jax.jit(self.apply_galois, static_argnums=1)
            self._decompose = jax.jit(self._decompose, static_argnums=1)
            self._inner_product = jax.jit(self._inner_product, static_argnums=1)

    # ------------------------------------------------------------------
    # linear ops
    # ------------------------------------------------------------------

    def negate(self, ct: Ciphertext) -> Ciphertext:
        q = self.ctx.mont(ct.level)["q"]
        return ct.with_(data=mod_neg(ct.data, q))

    def _pad_parts(self, a: Ciphertext, b: Ciphertext):
        if a.num_parts == b.num_parts:
            return a.data, b.data
        big, small = (a, b) if a.num_parts > b.num_parts else (b, a)
        pad = jnp.zeros(
            (*small.batch_shape, big.num_parts - small.num_parts,
             small.data.shape[-2], small.poly_degree), dtype=jnp.uint32)
        sd = jnp.concatenate([small.data, pad], axis=-3)
        return (big.data, sd) if a.num_parts > b.num_parts else (sd, big.data)

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        check_add_compat(a, b, "add")
        da, db = self._pad_parts(a, b)
        q = self.ctx.mont(a.level)["q"]
        return Ciphertext(data=mod_add(da, db, q), level=a.level, scale=a.scale)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        check_add_compat(a, b, "sub")
        da, db = self._pad_parts(a, b)
        q = self.ctx.mont(a.level)["q"]
        return Ciphertext(data=mod_sub(da, db, q), level=a.level, scale=a.scale)

    def add_plain(self, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
        check_add_compat(ct, pt, "add_plain")
        tabs = self.ctx.tables(ct.level)
        ptm = shoup_mul(pt.data, tabs.r, tabs.r_shoup, tabs.q)
        d = ct.data.at[..., 0, :, :].set(mod_add(ct.data[..., 0, :, :], ptm, tabs.q))
        return ct.with_(data=d)

    def sub_plain(self, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
        check_add_compat(ct, pt, "sub_plain")
        tabs = self.ctx.tables(ct.level)
        ptm = shoup_mul(pt.data, tabs.r, tabs.r_shoup, tabs.q)
        d = ct.data.at[..., 0, :, :].set(mod_sub(ct.data[..., 0, :, :], ptm, tabs.q))
        return ct.with_(data=d)

    # ------------------------------------------------------------------
    # multiplication
    # ------------------------------------------------------------------

    def multiply_plain(self, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
        if ct.level != pt.level:
            raise ValueError(f"multiply_plain: level {ct.level} vs {pt.level}")
        q = self.ctx.tables(ct.level).q
        d = shoup_mul(ct.data, pt.data[..., None, :, :],
                      pt.shoup[..., None, :, :], q)
        return Ciphertext(data=d, level=ct.level, scale=ct.scale * pt.scale)

    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """ct·ct tensor product: k-part × m-part → (k+m−1)-part (SEAL
        multiplies arbitrary-size cts — deferred-relin chains across two
        multiplies, reference SMART_RELIN ``he_linalg.cpp:975-1002``).
        The common 2×2 case uses Karatsuba (3 modular multiplies)."""
        if a.level != b.level:
            raise ValueError(f"multiply: level {a.level} vs {b.level}")
        mc = self.ctx.mont(a.level)
        q, qn = mc["q"], mc["qinv_neg"]
        if a.num_parts == 2 and b.num_parts == 2:
            c0, c1 = a.data[..., 0, :, :], a.data[..., 1, :, :]
            d0, d1 = b.data[..., 0, :, :], b.data[..., 1, :, :]
            t0 = mont_mul(c0, d0, q, qn)
            t2 = mont_mul(c1, d1, q, qn)
            t1 = mod_sub(
                mod_sub(mont_mul(mod_add(c0, c1, q), mod_add(d0, d1, q), q, qn),
                        t0, q),
                t2, q)
            return Ciphertext(data=jnp.stack([t0, t1, t2], axis=-3),
                              level=a.level, scale=a.scale * b.scale)
        # general part-wise convolution: out_k = Σ_{i+j=k} a_i·b_j
        ka, kb = a.num_parts, b.num_parts
        parts = []
        for k in range(ka + kb - 1):
            acc = None
            for i in range(max(0, k - kb + 1), min(ka, k + 1)):
                t = mont_mul(a.data[..., i, :, :], b.data[..., k - i, :, :],
                             q, qn)
                acc = t if acc is None else mod_add(acc, t, q)
            parts.append(acc)
        return Ciphertext(data=jnp.stack(parts, axis=-3),
                          level=a.level, scale=a.scale * b.scale)

    def square(self, a: Ciphertext) -> Ciphertext:
        if a.num_parts != 2:
            raise ValueError("square requires a 2-part input")
        mc = self.ctx.mont(a.level)
        q, qn = mc["q"], mc["qinv_neg"]
        c0, c1 = a.data[..., 0, :, :], a.data[..., 1, :, :]
        t0 = mont_mul(c0, c0, q, qn)
        t2 = mont_mul(c1, c1, q, qn)
        t01 = mont_mul(c0, c1, q, qn)
        t1 = mod_add(t01, t01, q)
        return Ciphertext(data=jnp.stack([t0, t1, t2], axis=-3),
                          level=a.level, scale=a.scale * a.scale)

    # ------------------------------------------------------------------
    # key switching: relinearize / rotate / conjugate
    # ------------------------------------------------------------------

    def _decompose(self, d: jax.Array, level: int) -> jax.Array:
        """Key-switch 'hoistable' prefix: digit-decompose poly `d`
        ([..., ℓ+1, N] Montgomery NTT) into the key basis.
        Returns standard-form NTT digits [..., J, R, N].

        Generalized hybrid (dnum): digits cover α = #special primes each,
        lifted by a per-digit fast base conversion (uncorrected — the u·D
        excess is the standard noise the special primes absorb).

        Split out so rotations can HOIST it: the decomposition commutes with
        Galois automorphisms, so one decompose serves many rotation steps
        (`rotate_hoisted`) — the optimization SURVEY.md §2d targets for the
        diagonal-matmul rotation hot loop."""
        plan: KeySwitchPlan = self.ctx.keyswitch_plan(level)
        tabs = self.ctx.tables(level)
        # 1+2. digits → coefficient domain with the digit-local ĥat-inverse
        #    folded into the INTT epilogue (standard form, free Mont-strip).
        #    The key-basis lift then covers only each digit's FOREIGN
        #    primes: on the digit's own primes the lifted value ≡ the
        #    original residue (the FBC excess u·D and all foreign d̂ terms
        #    vanish mod every source prime), so those rows come straight
        #    from the still-NTT-domain input with a single Shoup multiply —
        #    no INTT→NTT roundtrip (J·α fewer key-basis NTT planes).
        y = ntt_inv(d, tabs, strip_mont=True, extra=plan.dig_inv)
        accs = []
        for di, (lo, hi) in enumerate(plan.digit_bounds):
            foreign = plan.foreign_idx[di]
            qf = plan.q[foreign]
            acc = None
            for i in range(lo, hi):
                term = shoup_mul(y[..., i: i + 1, :],
                                 plan.dhat[i][foreign][:, None],
                                 plan.dhat_shoup[i][foreign][:, None],
                                 qf)
                acc = term if acc is None else mod_add(acc, term, qf)
            accs.append(acc)
        # ONE forward NTT over every digit's lifted planes
        # (concatenated foreign bases — duplicate primes fine)
        lifted_cat = ntt_fwd(jnp.concatenate(accs, axis=-2),
                             plan.foreign_cat_tables)
        exts = []
        off = 0
        for di, (lo, hi) in enumerate(plan.digit_bounds):
            nf = len(plan.foreign_idx[di])
            lifted = lifted_cat[..., off:off + nf, :]
            off += nf
            direct = shoup_mul(d[..., lo:hi, :],
                               plan.rinv[lo:hi], plan.rinv_shoup[lo:hi],
                               tabs.q[lo:hi])
            exts.append(jnp.concatenate(
                [lifted[..., :lo, :], direct, lifted[..., lo:, :]], axis=-2))
        return jnp.stack(exts, axis=-3)                # [..., J, R, N]

    def _inner_product_raw(self, ext: jax.Array, level: int,
                           ksk: KSwitchKey) -> jax.Array:
        """Σ_j digit_j ⊙ ksk_j over the key basis (NO mod-down).
        ext: [..., J, R, N] standard NTT → [..., 2, R, N] Montgomery NTT."""
        plan: KeySwitchPlan = self.ctx.keyswitch_plan(level)
        J = plan.num_digits
        nd = self.ctx.num_data
        if level + 1 == nd:
            # top level: the key-basis slice is the whole key — skip the
            # concatenate (a full-key copy XLA does not always elide)
            sel = lambda a: a[:J]
        else:
            sel = lambda a: jnp.concatenate(
                [a[:J, :, : level + 1], a[:J, :, nd:]], axis=2)
        k, ks = sel(ksk.data), sel(ksk.shoup)
        q = plan.q
        # unrolled digit loop (J is small and static): one fusible XLA
        # expression of Shoup MACs, which XLA fuses into the decompose
        # epilogue
        acc = None
        for j in range(J):
            prod = shoup_mul(ext[..., j, None, :, :], k[j], ks[j], q)
            acc = prod if acc is None else mod_add(acc, prod, q)
        return acc

    def _inner_product(self, ext: jax.Array, level: int, ksk: KSwitchKey):
        """Σ_j digit_j ⊙ ksk_j, then mod-down by P = ∏ specials.
        ext: [..., J, R, N] standard NTT → (p0, p1) Montgomery NTT."""
        acc = self._inner_product_raw(ext, level, ksk)
        plan: KeySwitchPlan = self.ctx.keyswitch_plan(level)
        out = _mod_down(acc, plan.moddown, self.ctx.num_special)
        return out[..., 0, :, :], out[..., 1, :, :]

    def _keyswitch(self, d: jax.Array, level: int, ksk: KSwitchKey):
        """Switch poly `d` ([..., ℓ+1, N] Montgomery NTT, multiplying some
        s') to the base secret.  Returns (p0, p1) Montgomery NTT.

        Hybrid, per-prime digits, single special prime (SURVEY.md §2b
        'relinearization & Galois key-switching').
        """
        return self._inner_product(self._decompose(d, level), level, ksk)

    def rotate_hoisted(self, ct: Ciphertext, steps_list,
                       gk: GaloisKeys) -> list:
        """Rotate one ciphertext by MANY steps, decomposing c1 only once.

        σ commutes with digit decomposition (digits are coefficient-wise
        residues; σ permutes coefficients), so σ(digits) = permute the
        decomposed NTT digits.  Each step then costs one gather + one key
        inner product — the (ℓ+1)·(ℓ+2) NTT tower is paid once, not per
        rotation.  This accelerates the reference's hot loops
        (``he_linalg.cpp:667-713`` sum_elems, ``:977-1003`` matmul).
        """
        if ct.num_parts != 2:
            raise ValueError("rotate_hoisted expects a 2-part ciphertext")
        n = self.ctx.params.poly_degree
        q = self.ctx.mont(ct.level)["q"]
        ext = self._decompose(ct.data[..., 1, :, :], ct.level)
        outs = []
        for steps in steps_list:
            if steps % (n // 2) == 0:
                outs.append(ct)
                continue
            elt = galois.rotation_elt(n, steps)
            c0 = galois.apply(ct.data[..., 0, :, :], n, elt)
            p0, p1 = self._inner_product(galois.apply(ext, n, elt),
                                         ct.level, gk.key_for(elt))
            d = jnp.stack([mod_add(c0, p0, q), p1], axis=-3)
            outs.append(Ciphertext(data=d, level=ct.level, scale=ct.scale))
        return outs

    def relinearize(self, ct: Ciphertext, rk: RelinKeys) -> Ciphertext:
        """Reduce a k-part ciphertext to 2 parts: each part p ≥ 2
        (multiplying s^p) is key-switched with the s^p → s key
        (SEAL size-k relinearize; needs ``create_relin_keys(count=k-2)``
        for k > 3)."""
        if ct.num_parts < 3:
            raise ValueError("relinearize expects a ≥3-part ciphertext")
        q = self.ctx.mont(ct.level)["q"]
        c0, c1 = ct.data[..., 0, :, :], ct.data[..., 1, :, :]
        for p in range(2, ct.num_parts):
            p0, p1 = self._keyswitch(ct.data[..., p, :, :], ct.level,
                                     rk.key_for_power(p))
            c0, c1 = mod_add(c0, p0, q), mod_add(c1, p1, q)
        return Ciphertext(data=jnp.stack([c0, c1], axis=-3),
                          level=ct.level, scale=ct.scale)

    def apply_galois(self, ct: Ciphertext, elt: int, gk: GaloisKeys) -> Ciphertext:
        if ct.num_parts != 2:
            raise ValueError("apply_galois expects a 2-part ciphertext")
        n = self.ctx.params.poly_degree
        c0 = galois.apply(ct.data[..., 0, :, :], n, elt)
        c1 = galois.apply(ct.data[..., 1, :, :], n, elt)
        p0, p1 = self._keyswitch(c1, ct.level, gk.key_for(elt))
        q = self.ctx.mont(ct.level)["q"]
        d = jnp.stack([mod_add(c0, p0, q), p1], axis=-3)
        return Ciphertext(data=d, level=ct.level, scale=ct.scale)

    def rotate(self, ct: Ciphertext, steps: int, gk: GaloisKeys) -> Ciphertext:
        """Rotate slots left by `steps` (negative → right), decomposing into
        available keyed steps when the exact key is missing (SEAL
        rotate_vector semantics; reference ``he_operators.cpp:204-237``)."""
        n = self.ctx.params.poly_degree
        slots = n // 2
        steps = steps % slots
        if steps == 0:
            return ct
        e = galois.rotation_elt(n, steps)
        if gk.has(e):
            return self.apply_galois(ct, e, gk)
        # greedy power-of-two decomposition (default keyset covers ±2^i)
        remaining = steps
        bit = 1 << (slots.bit_length() - 2) if slots > 1 else 1
        out = ct
        while remaining:
            while bit > remaining:
                bit >>= 1
            e = galois.rotation_elt(n, bit)
            if not gk.has(e):
                raise KeyError(f"no galois key chain to rotate by {steps}")
            out = self.apply_galois(out, e, gk)
            remaining -= bit
        return out

    def conjugate(self, ct: Ciphertext, gk: GaloisKeys) -> Ciphertext:
        return self.apply_galois(ct, galois.conjugation_elt(
            self.ctx.params.poly_degree), gk)

    # ------------------------------------------------------------------
    # modulus chain management
    # ------------------------------------------------------------------

    def rescale(self, ct: Ciphertext) -> Ciphertext:
        """Divide-and-round by the last active prime — or prime PAIR in
        rescale_group=2 high-precision mode; level-g, scale/∏dropped
        (SEAL rescale_to_next; reference `^` operator)."""
        g = self.ctx.params.rescale_group
        if g == 1:
            plan = self.ctx.rescale_plan(ct.level)
            d = _div_round_last(ct.data, plan)
            q_last = self.ctx.params.moduli[ct.level]
            return Ciphertext(data=d, level=ct.level - 1,
                              scale=ct.scale / q_last)
        md = self.ctx.group_rescale_plan(ct.level)
        d = _mod_down(ct.data, md, g)
        prod = 1.0
        for q in self.ctx.params.moduli[ct.level - g + 1: ct.level + 1]:
            prod *= q
        return Ciphertext(data=d, level=ct.level - g, scale=ct.scale / prod)

    def mod_switch(self, ct: Ciphertext) -> Ciphertext:
        """Drop the last prime without scaling (SEAL mod_switch_to_next;
        reference `|` operator)."""
        if ct.level < 1:
            raise ValueError("cannot mod_switch below level 0")
        return Ciphertext(data=ct.data[..., : ct.level, :],
                          level=ct.level - 1, scale=ct.scale)

    def mod_switch_to(self, ct: Ciphertext, level: int) -> Ciphertext:
        out = ct
        while out.level > level:
            out = self.mod_switch(out)
        return out

    # ------------------------------------------------------------------
    # fused conveniences (reference hot combos)
    # ------------------------------------------------------------------

    def _relin_rescale_fused(self, ct3: Ciphertext, rk: RelinKeys) -> Ciphertext:
        """Relinearize + rescale with ONE fused divide-and-round by
        P·(dropped primes) — the last prime, or last PAIR in
        rescale_group=2 high-precision mode:
            out_i = round((c_i·P + Σ digit_j(c_2)·ksk_j) / (P·∏dropped))
        (c_i·P vanishes on the special limbs since P ≡ 0 there, and the
        source limbs {dropped} ∪ specials are a contiguous tail slice).
        Saves the standalone rescale's whole INTT/FBC/NTT tower — ~20% of
        the NTT planes of a mult+relin+rescale."""
        level = ct3.level
        L = level + 1
        g = self.ctx.params.rescale_group
        plan = self.ctx.moddown_rescale_plan(level)
        acc = self._inner_product_raw(
            self._decompose(ct3.data[..., 2, :, :], level), level, rk.key)
        c01 = ct3.data[..., :2, :, :]
        w_data = mod_add(
            acc[..., :L, :],
            shoup_mul(c01, plan.p_mod, plan.p_mod_shoup,
                      self.ctx.tables(level).q),
            self.ctx.tables(level).q)
        src = jnp.concatenate([w_data[..., L - g: L, :], acc[..., L:, :]],
                              axis=-2)
        u = ntt_inv(src, plan.src_tables, strip_mont=True,
                    extra=plan.fbc.inv_punit)
        r_m = _fbc_fwd_mont(u, plan.fbc, plan.dst_tables)
        q_dst = plan.dst_tables.q
        out = shoup_mul(mod_sub(w_data[..., : L - g, :], r_m, q_dst),
                        plan.pq_inv, plan.pq_inv_shoup, q_dst)
        prod = 1.0
        for q in self.ctx.params.moduli[level - g + 1: level + 1]:
            prod *= q
        return Ciphertext(data=out, level=level - g,
                          scale=ct3.scale / prod)

    def multiply_relin_rescale(self, a, b, rk: RelinKeys) -> Ciphertext:
        return self._relin_rescale_fused(self.multiply(a, b), rk)

    def square_relin_rescale(self, a, rk: RelinKeys) -> Ciphertext:
        return self._relin_rescale_fused(self.square(a), rk)

    def multiply_plain_rescale(self, ct, pt: Plaintext) -> Ciphertext:
        return self.rescale(self.multiply_plain(ct, pt))


def _mod_down(acc: jax.Array, md, k: int) -> jax.Array:
    """Divide a key-basis accumulator [..., parts, n_data+k, N] (Montgomery
    NTT) by P = ∏ of the k special primes, landing on the data basis:
    centered FBC of the special limbs + subtract + ×P^{-1}.  One α-misround
    = ±1 of rounding noise (see rns.fbc_apply)."""
    sp = acc[..., -k:, :]
    rest = acc[..., :-k, :]
    u = ntt_inv(sp, md.src_tables, strip_mont=True, extra=md.fbc.inv_punit)
    r_m = _fbc_fwd_mont(u, md.fbc, md.dst_tables)
    return shoup_mul(mod_sub(rest, r_m, md.dst_tables.q),
                     md.p_inv, md.p_inv_shoup, md.dst_tables.q)


def _fbc_fwd_mont(u, fbc, dst_tables):
    """Centered FBC + Montgomery forward NTT."""
    r_q = rns.fbc_apply(u, fbc, correct=True, premul=False)
    return ntt_fwd_mont(r_q, dst_tables)


def _div_round_last(data: jax.Array, plan: RescalePlan) -> jax.Array:
    """Divide a Montgomery-NTT poly array [..., m, N] by its last prime,
    rounding (SEAL divide_and_round_q_last_ntt semantics): result over the
    remaining m-1 primes."""
    last = data[..., -1:, :]
    rest = data[..., :-1, :]
    q_src = plan.src_tables.q
    last_c = ntt_inv(last, plan.src_tables, strip_mont=True)
    l2 = mod_add(last_c, plan.half, q_src)
    v = barrett_reduce_u32(l2, plan.dst_tables.q, plan.mu)
    v = mod_sub(v, plan.half_mod, plan.dst_tables.q)
    vm = ntt_fwd_mont(v, plan.dst_tables)
    return shoup_mul(mod_sub(rest, vm, plan.dst_tables.q),
                     plan.src_inv, plan.src_inv_shoup, plan.dst_tables.q)
