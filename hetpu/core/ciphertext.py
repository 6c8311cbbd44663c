"""Ciphertext / Plaintext pytrees.

Representation (SURVEY.md §7): a ciphertext is a single
limb-planar uint32 array ``[parts, L, N]`` (batched: ``[..., parts, L, N]``)
in **NTT evaluation order, Montgomery form** — the resident format for every
evaluator op, the analog of SEAL's ``Ciphertext`` in NTT form.  ``level``
and ``scale`` are static aux data (hashable → jit retraces per level, which
is bounded by chain depth, exactly like SEAL specializing per context_data).

Plaintexts are NTT-domain, **standard form with Shoup tables** so ct·pt
multiply is a 6-int-mul Shoup multiply (cheaper than ct·ct, mirroring
SEAL's multiply_plain being cheaper than multiply).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import jax
import numpy as np


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Ciphertext:
    data: jax.Array                      # uint32 [..., parts, level+1, N]
    level: int = field(metadata=dict(static=True), default=0)
    scale: float = field(metadata=dict(static=True), default=1.0)

    @property
    def num_parts(self) -> int:
        return self.data.shape[-3]

    @property
    def poly_degree(self) -> int:
        return self.data.shape[-1]

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return self.data.shape[:-3]

    def with_(self, **kw) -> "Ciphertext":
        return replace(self, **kw)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Plaintext:
    data: jax.Array                      # uint32 [..., level+1, N] (standard, NTT)
    shoup: jax.Array                     # uint32 same shape: floor(data·2^32/q)
    level: int = field(metadata=dict(static=True), default=0)
    scale: float = field(metadata=dict(static=True), default=1.0)

    @property
    def poly_degree(self) -> int:
        return self.data.shape[-1]


def scales_close(a: float, b: float, rel: float = 1e-6) -> bool:
    return abs(a - b) <= rel * max(abs(a), abs(b))


def check_add_compat(a, b, op: str = "add") -> None:
    if a.level != b.level:
        raise ValueError(
            f"{op}: level mismatch {a.level} vs {b.level} "
            "(use hetpu.util.reach_level to align — reference he_util.h:57)"
        )
    if not scales_close(a.scale, b.scale):
        raise ValueError(f"{op}: scale mismatch {a.scale} vs {b.scale}")


def np_data(ct) -> np.ndarray:
    return np.asarray(ct.data)
