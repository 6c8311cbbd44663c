"""hetpu — homomorphic encryption (CKKS + BFV) in JAX, for the GPU.

Built from scratch for JAX/XLA/Pallas; capability parity with the
reference C++/SEAL codebase (see SURVEY.md)."""

import os
import pathlib

import jax

# Caches live in one fixed directory inside the checkout (listed in
# .gitignore): JAX keys its persistent compilation cache by path, so a
# directory that moves never hits.  JAX_COMPILATION_CACHE_DIR, where set,
# takes the compile cache instead.
CACHE_ROOT = pathlib.Path(__file__).resolve().parent.parent / ".cache"

if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", str(CACHE_ROOT / "jax"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
