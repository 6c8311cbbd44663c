"""Which NTT implementation runs on which platform — decided here only.

Every supported platform runs ntt4's four-step Cooley-Tukey /
Gentleman-Sande stage loops in plain jnp, lowered by XLA.  On the H100,
inside multiply_relin_rescale at B=8, it was 32% faster than int8 digit
matrix products at ckks_deep_hi and 6% slower at bench_n14; one path was
kept over a second one chosen by ring size (PERF.md, Findings).  Flat
tables (N < 4096) take ntt.py's stage loop; that is a choice by size,
made in ntt.py.  Context asks for the path when it is built, so an
unsupported platform fails there instead of running untested code.
"""

from __future__ import annotations

import jax

BUTTERFLY = "butterfly"

# platform (jax.default_backend()) -> NTT path
_BY_PLATFORM = {
    "cpu": BUTTERFLY,
    "gpu": BUTTERFLY,
}


def ntt_path(platform: str | None = None) -> str:
    """The NTT implementation for ``platform`` (default: JAX's default
    backend).  An unknown platform is an error, never a silent default."""
    if platform is None:
        platform = jax.default_backend()
    try:
        return _BY_PLATFORM[platform]
    except KeyError:
        raise RuntimeError(
            f"hetpu has no NTT path for platform {platform!r}; "
            f"supported: {sorted(_BY_PLATFORM)}") from None
