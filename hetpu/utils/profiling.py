"""Profiling — the reference's Timer (tic_toc.h) grown up.

* ``trace(dir)`` — jax.profiler context; view in TensorBoard/Perfetto
  (SURVEY.md §5: the build's replacement for the reference's
  print-a-stopwatch observability).
* ``op_latency`` — honest per-op wall-clock: chains each iteration's
  input to the previous output through a tag and closes with a host
  fetch, so dispatch pipelining and runtime memoization can't fake the
  number.
"""

from __future__ import annotations

import contextlib
import time

import jax
import jax.numpy as jnp

from .. import CACHE_ROOT


@contextlib.contextmanager
def trace(log_dir: str = str(CACHE_ROOT.parent / "traces")):
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def _tag(x) -> jnp.ndarray:
    return jnp.sum(x[..., :1, :8].astype(jnp.uint32)) & jnp.uint32(1)


def op_latency(fn, data, iters: int = 10) -> float:
    """Seconds per call of ``fn(data_like) -> array``, honestly measured:
    sequential dependency chain + final host fetch."""

    @jax.jit
    def step(d, tag):
        out = fn(jnp.bitwise_xor(d, tag))
        return _tag(out)

    tag = step(data, jnp.uint32(0))
    int(tag)                                  # compile + drain
    t0 = time.perf_counter()
    tag = jnp.uint32(0)
    for _ in range(iters):
        tag = step(data, tag)
    int(tag)
    return (time.perf_counter() - t0) / iters
