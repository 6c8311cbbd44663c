"""core/backend.py: the one place that picks the NTT path per platform;
and where the compile cache goes."""

import subprocess
import sys
import pathlib

import pytest

from hetpu.core import backend

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("platform,path", [
    ("cpu", backend.BUTTERFLY),
    ("gpu", backend.BUTTERFLY),
    ("rocm", None),
    ("metal", None),
])
def test_ntt_path_by_platform(platform, path):
    if path is None:
        with pytest.raises(RuntimeError, match="no NTT path"):
            backend.ntt_path(platform)
    else:
        assert backend.ntt_path(platform) == path


def test_default_platform_here_is_cpu():
    assert backend.ntt_path() == backend.BUTTERFLY


@pytest.mark.parametrize("platform", ["rocm", "metal"])
def test_context_refuses_unknown_platform(monkeypatch, platform):
    """Building a Context on a platform with no NTT path fails at once,
    before any table is built."""
    from hetpu.core.context import Context
    from hetpu.core.params import preset
    monkeypatch.setattr(backend.jax, "default_backend", lambda: platform)
    with pytest.raises(RuntimeError, match="no NTT path"):
        Context(preset("test_tiny"))


@pytest.mark.parametrize("env_dir", [None, "given"])
def test_compile_cache_placement(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins where set; otherwise the cache sits
    at one fixed path inside the checkout."""
    import os
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    want = str(ROOT / ".cache" / "jax")
    if env_dir:
        want = env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    out = subprocess.run(
        [sys.executable, "-c",
         "import hetpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == want
