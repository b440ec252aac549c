"""Card-only tests: chip_smoke.py's phases at small sizes on the GPU.

Marked `gpu`; each skips without a card (the `gpu_device` fixture decides
at run time). Card run, one process per card:

    MSM_TEST_GPU=1 python -m pytest -m gpu tests/test_gpu.py

chip_smoke.py runs them in-process as its phase (e).
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


def test_single_run_both_dt_modes(gpu_device, tmp_path):
    out = chip_smoke.phase_single(str(tmp_path), size=64, final_time=2.0)
    assert out["optimistic"]["steps"] > 0 and out["exact"]["steps"] > 0


def test_ensemble_online_matches_offline(gpu_device, tmp_path):
    out = chip_smoke.phase_ensemble(str(tmp_path), size=32, cosmo_size=16)
    assert out["a"] > 0.1


def test_steps_match_cpu_reference(gpu_device):
    out = chip_smoke.phase_reference(size=32, steps=10, device=gpu_device)
    assert out["c128"]["rel"] <= chip_smoke.C128_LIMIT
