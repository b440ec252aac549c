"""CPU rehearsals of chip_smoke.py: the same phase functions the card run
calls, at tiny sizes on the CPU backend, plus the script's refusal to run
(or to print a result) without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("dt_mode", ["optimistic", "exact"])
def test_rehearse_single_run(tmp_path, dt_mode):
    """Phase (b): the production config cut to 16^3, through the CLI."""
    out = chip_smoke.phase_single(
        str(tmp_path), size=16, final_time=2.0, dt_modes=(dt_mode,)
    )
    assert out[dt_mode]["steps"] > 0
    assert not os.path.exists(tmp_path / "single" / dt_mode)  # cleaned up


def test_rehearse_ensemble_and_reference(tmp_path):
    """Phases (c) and (d): online vs offline synthesis agree, the scale
    factor grows, and c64/c128 steps meet the stated limits against the
    c128 CPU reference."""
    out = chip_smoke.phase_ensemble(str(tmp_path), size=16, cosmo_size=16)
    assert out["online_offline"]["Qx_abs"] <= chip_smoke.QX_ATOL
    ref = chip_smoke.phase_reference(size=16, steps=5)
    assert ref["c128"]["rel"] == 0.0  # same backend, same program
    assert ref["c64"]["rel"] <= chip_smoke.C64_GAP_FACTOR * chip_smoke.CPU_C64_GAP_128


@pytest.mark.parametrize("phase", ["space", "auto"])
def test_rehearse_four_cards(tmp_path, monkeypatch, phase):
    """The four-card phase on the virtual CPU devices: --mesh space /
    --mesh auto dumps match the one-device run within MESH_RTOL."""
    assert len(jax.devices()) > 1
    out = chip_smoke.phase_four_cards(
        str(tmp_path), size=16, final_time=1.0, ens_size=16, only=phase
    )
    assert out[phase] <= chip_smoke.MESH_RTOL


def test_last_line_format():
    line = chip_smoke.result_line(
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4,
         "extra": 1}
    )
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4},
    }


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_refuses_to_run_without_gpu():
    r = _run(os.path.join(ROOT, "chip_smoke.py"), ROOT)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_fails_alone_in_a_directory(tmp_path):
    """Without the repository beside it the script cannot import the
    program: non-zero exit, no result line."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert r.returncode != 0
    assert "No module named 'msm_tpu'" in r.stderr
    assert '"ok"' not in r.stdout
