"""Coefficient-axis (sequence-parallel) sharded NTT with explicit
stage-wise ``all_to_all`` exchanges (SURVEY.md §2d "intra-ct sequence
parallelism"; VERDICT r2 item 4b).

The four-step decomposition (core/ntt4.py) views the N coefficients as an
[n1, n2] matrix: sub-NTT along n1 → twiddle → transpose → sub-NTT along
n2.  Distributed over ``cp`` devices that transpose IS the collective —
the ring-attention-style block exchange the survey calls for:

  fwd:  coeffs sharded on the n2 (interleaved) axis
          → local sub-NTT along n1 (vectorized over the local n2 slice)
          → local twiddle (tables sharded with the data)
          → ONE ``all_to_all`` (the n1↔n2 transpose across shards)
          → local sub-NTT along n2
        → evaluations sharded on the n1 (contiguous-block) axis
  inv:  the exact mirror — evaluations in, ONE ``all_to_all``, coeffs out
        with the original sharding (inv(fwd(x)) restores layout).

Per-device butterfly work is the full transform's /cp; the only
communication is one all_to_all of N/cp·L u32 per limb-plane — on real
hardware it rides NVLink inside ``shard_map``.

Bit-exact: identical output to ``ntt.ntt_fwd``/``ntt_inv`` on the same
FourStepTables (asserted in tests/test_parallel.py).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..core import ntt4
from ..core.modular import shoup_mul


def _check(t: ntt4.FourStepTables, cp: int):
    if t.n1 % cp or t.n2 % cp:
        raise ValueError(f"cp={cp} must divide n1={t.n1} and n2={t.n2}")


def cp_ntt_fwd(x, t: ntt4.FourStepTables, mesh: Mesh, axis: str = "cp"):
    """x: [L, N] coefficients (natural order).  Shards the n2 axis of the
    [n1, n2] view; returns [L, N] bit-reversed evaluations whose
    contiguous N/cp blocks live one-per-device."""
    cp = mesh.shape[axis]
    _check(t, cp)
    L = x.shape[-2]

    def fn(xl, tw, tws):
        # xl: [L, n1, n2/cp] — local column slice
        y = ntt4._fwd_axis2(xl, t.sub1)                 # along n1, local
        y = shoup_mul(y, tw, tws, t.q[:, :, None])      # sharded twiddles
        y = jnp.swapaxes(y, -1, -2)                     # [L, n2/cp, n1]
        y = jax.lax.all_to_all(y, axis, split_axis=2, concat_axis=1,
                               tiled=True)              # [L, n2, n1/cp]
        y = ntt4._fwd_axis2(y, t.sub2)                  # along n2, local
        return jnp.swapaxes(y, -1, -2)                  # [L, n1/cp, n2]

    from jax import shard_map
    sharded = shard_map(
        fn, mesh=mesh,
        in_specs=(P(None, None, axis), P(None, None, axis),
                  P(None, None, axis)),
        out_specs=P(None, axis, None), check_vma=False)
    out = sharded(x.reshape(L, t.n1, t.n2),
                  jnp.asarray(t.t_fwd), jnp.asarray(t.t_fwd_shoup))
    return out.reshape(L, t.n)


def cp_ntt_inv(x, t: ntt4.FourStepTables, mesh: Mesh, axis: str = "cp",
               *, strip_mont: bool = False):
    """Mirror of ``cp_ntt_fwd``: [L, N] bit-reversed evaluations sharded
    in contiguous blocks → [L, N] coefficients sharded on the interleaved
    axis (the layout ``cp_ntt_fwd`` consumes)."""
    cp = mesh.shape[axis]
    _check(t, cp)
    L = x.shape[-2]

    def fn(xl, tw, tws):
        # xl: [L, n1/cp, n2] — local row block
        y = jnp.swapaxes(xl, -1, -2)                    # [L, n2, n1/cp]
        y = ntt4._inv_axis2(y, t.sub2, strip_mont=False)  # along n2, local
        y = jax.lax.all_to_all(y, axis, split_axis=1, concat_axis=2,
                               tiled=True)              # [L, n2/cp, n1]
        y = jnp.swapaxes(y, -1, -2)                     # [L, n1, n2/cp]
        y = shoup_mul(y, tw, tws, t.q[:, :, None])
        return ntt4._inv_axis2(y, t.sub1, strip_mont=strip_mont)

    from jax import shard_map
    sharded = shard_map(
        fn, mesh=mesh,
        in_specs=(P(None, axis, None), P(None, None, axis),
                  P(None, None, axis)),
        out_specs=P(None, None, axis), check_vma=False)
    out = sharded(x.reshape(L, t.n1, t.n2),
                  jnp.asarray(t.t_inv), jnp.asarray(t.t_inv_shoup))
    return out.reshape(L, t.n)
