"""chip_smoke.py off the card: it must refuse to run without a GPU, and
its phases must run end to end at test sizes on the CPU (the same code
the card runs at full size)."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_gpu():
    out = _run(ROOT / "chip_smoke.py", ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_exits_nonzero_outside_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("phase", [
    "phase_ntt", "phase_op", "phase_bfv", "phase_lsq", "phase_served",
    "phase_memory"])
def test_one_card_phase_on_cpu(phase):
    detail = getattr(chip_smoke, phase)(chip_smoke.SMALL)
    assert isinstance(detail, str) and detail


@pytest.mark.parametrize("phase", [
    "four_dp", "four_tp", "four_cp", "four_matvec", "four_server"])
def test_four_card_phase_on_virtual_devices(phase):
    """The --four path on the suite's 8 virtual CPU devices."""
    detail = getattr(chip_smoke, phase)(chip_smoke.SMALL)
    assert isinstance(detail, str) and detail


def test_run_reports_a_failed_phase(capsys):
    def phase_boom(cfg):
        raise ValueError("boom")

    def phase_fine(cfg):
        return "fine"

    assert chip_smoke.run((phase_boom, phase_fine), chip_smoke.SMALL) is False
    out = capsys.readouterr().out
    assert "[phase_boom] FAIL" in out and "boom" in out
    assert "[phase_fine] ok" in out
