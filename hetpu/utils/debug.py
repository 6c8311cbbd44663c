"""Debug-check configs — the analog of the race-detector / sanitizer
row in SURVEY.md §5 (the reference is single-threaded; here the hazards
are nondeterministic lowering and accidental buffer donation/aliasing,
which corrupt retained uint32 ciphertext buffers silently).

Two audits, both cheap enough for CI:

* ``determinism_check`` — run a jitted function twice on the same inputs
  and require BIT-IDENTICAL outputs.  HE kernels are exact integer math:
  any u32 divergence between runs means a nondeterministic reduction or
  an uninitialized read somewhere in the lowering.
* ``donation_audit`` — compile and inspect the HLO's declared
  input→output buffer aliasing.  An op that silently aliases an input
  would invalidate the caller's retained ciphertext (JAX surfaces this as
  a deleted-buffer error only when lucky).  All evaluator ops must
  declare NO aliasing unless the caller opted in via donate_argnums.
"""

from __future__ import annotations

import re

import numpy as np
import jax


def determinism_check(fn, *args, reps: int = 2) -> None:
    """Assert `fn(*args)` is bit-identical across ``reps`` executions."""
    ref = jax.tree_util.tree_map(np.asarray, fn(*args))
    for _ in range(reps - 1):
        again = jax.tree_util.tree_map(np.asarray, fn(*args))
        jax.tree_util.tree_map(np.testing.assert_array_equal, ref, again)


def donation_audit(fn, *args, expect_aliases: int = 0) -> int:
    """Compile ``fn`` and count declared input→output buffer aliases in
    the HLO module header.  Returns the count; raises if it differs from
    ``expect_aliases``."""
    compiled = jax.jit(fn).lower(*args).compile()
    txt = compiled.as_text()
    m = re.search(r"input_output_alias=\{([^}]*)\}", txt)
    n = 0
    if m and m.group(1).strip():
        n = m.group(1).count(":")
    if n != expect_aliases:
        raise AssertionError(
            f"compiled fn declares {n} input→output buffer aliases "
            f"(expected {expect_aliases}) — an evaluator op must not "
            f"silently donate caller ciphertext buffers")
    return n
