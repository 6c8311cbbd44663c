"""Wall-clock stopwatch — parity with reference ``include/tic_toc.h``
(Timer::tic/toc/tocr), extended with a jax-aware toc that waits for the
device work it times."""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self.tic()

    def tic(self) -> None:
        self._t0 = time.perf_counter()

    def tocr(self, block_on=None) -> float:
        """Elapsed seconds (reference tocr).  If ``block_on`` is a jax
        array (or pytree), wait for it before reading the clock: JAX
        returns before the device finishes."""
        if block_on is not None:
            import jax
            jax.block_until_ready(block_on)
        return time.perf_counter() - self._t0

    def toc(self, label: str = "", block_on=None) -> float:
        dt = self.tocr(block_on)
        print(f"{label}: {dt:.6f} s" if label else f"{dt:.6f} s")
        from . import metrics
        metrics.emit("timer", label=label, seconds=round(dt, 6))
        return dt
