"""bench.py contracts: it refuses a device without published peaks
unless asked for a rehearsal; a parseable headline JSON line exists as
soon as the first measurement completes; sub-modes are wall-budget-gated;
and the last stdout line is always the richest complete record.

Anchor: the reference always reports its wall timings
(`simulator/src/main.rs:71-77`); this harness must never do worse.
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "bench.py")


def _cpu_env(extra_env=()):
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=1",
    )
    env.update(extra_env)
    return env


def _run_bench(extra_env, *argv, timeout=600):
    r = subprocess.run(
        [sys.executable, BENCH, "--size", "16", "--steps", "4", "--rehearsal",
         *argv],
        env=_cpu_env(extra_env),
        capture_output=True,
        text=True,
        timeout=timeout,
    )
    assert r.returncode == 0, (r.stdout, r.stderr)
    records = [
        json.loads(line)
        for line in r.stdout.splitlines()
        if line.strip().startswith("{")
    ]
    assert records, (r.stdout, r.stderr)
    return records, r.stderr


def test_zero_budget_emits_headline_then_skips_submodes():
    """With no budget left, the headline is still measured and emitted
    immediately; both sub-modes degrade to {"skipped": reason} records —
    partial results, never silence."""
    records, stderr = _run_bench({"MSM_BENCH_BUDGET_S": "0"})
    head = records[0]
    for key in ("metric", "value", "unit", "device"):
        assert key in head
    assert head["metric"] == "grid_updates_per_s_per_chip"
    # a rehearsal record names its platform and carries no roofline share
    assert head["device"]["platform"] == "cpu"
    assert not any(k.startswith("vs_") for k in head)
    assert head["dt_mode"] == "optimistic"
    assert head["value"] > 0
    # the first emitted line is the headline alone (no sub-modes yet):
    # this is the line a timeout would leave behind
    assert "exact_dt" not in head
    last = records[-1]
    for key in ("exact_dt", "lagged_dt", "streams", "large_grid"):
        assert "skipped" in last[key], key
    assert "wall budget" in last["exact_dt"]["skipped"]
    # every intermediate record is itself complete and parseable, and the
    # headline fields never change across re-emits
    for rec in records:
        assert rec["value"] == head["value"]
    # heartbeat/progress went to stderr, not stdout
    assert "[bench]" in stderr


def test_full_budget_merges_all_submodes():
    # --streams 8 keeps the ensemble extra small on CPU (128 default)
    records, _ = _run_bench({"MSM_BENCH_BUDGET_S": "100000"}, "--streams", "8")
    last = records[-1]
    assert last["exact_dt"]["value"] > 0
    assert last["lagged_dt"]["value"] > 0
    for sub in (last["exact_dt"], last["lagged_dt"]):
        for key in ("value", "steps_per_s"):
            assert key in sub
    # budget-gated extras rode along: the ensemble point and the 2x-size
    # large-grid point (512^3 on the production defaults)
    assert last["streams"]["metric"] == "streams_per_s"
    assert last["streams"]["value"] > 0
    assert last["large_grid"]["value"] > 0
    assert "32^3" in last["large_grid"]["unit"]
    # five emits: headline, +exact, +lagged, +streams, +large_grid
    assert len(records) == 5


def test_per_metric_default_resolution():
    """The scaling metric must NOT inherit the kdk grid defaults: 256^3
    per device scales the global rehearsal grid to >=512^3 on CPU."""
    from types import SimpleNamespace

    from msm_tpu.utils.benchmarks import resolve_metric_defaults

    kdk = SimpleNamespace(metric="kdk", size=None, steps=None)
    resolve_metric_defaults(kdk)
    assert (kdk.size, kdk.steps) == (256, 100)
    scaling = SimpleNamespace(metric="scaling", size=None, steps=None)
    resolve_metric_defaults(scaling)
    assert (scaling.size, scaling.steps) == (64, 5)
    explicit = SimpleNamespace(metric="scaling", size=32, steps=3)
    resolve_metric_defaults(explicit)
    assert (explicit.size, explicit.steps) == (32, 3)


def test_single_mode_flag_unchanged():
    records, _ = _run_bench({}, "--dt-mode", "lagged")
    assert len(records) == 1
    assert records[0]["dt_mode"] == "lagged"
    assert "exact_dt" not in records[0]


def test_refuses_cpu_without_rehearsal_flag():
    """No silent CPU fallback: without --rehearsal a CPU-only run exits
    non-zero before measuring, and prints no record."""
    r = subprocess.run(
        [sys.executable, BENCH, "--size", "16", "--steps", "4"],
        env=_cpu_env(),
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert r.returncode != 0
    assert "{" not in r.stdout
    assert "no GPU" in r.stderr


def test_trace_step_refuses_cpu():
    """scripts/trace_step.py has no rehearsal mode: on the CPU it exits
    non-zero before timing anything."""
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "trace_step.py"),
         "--size", "16", "--steps", "2"],
        env=_cpu_env(),
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert r.returncode != 0
    assert "trace_step: no GPU" in r.stderr
    assert "ms/step" not in r.stdout


@pytest.mark.parametrize(
    "kind", ["NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe", "Unknown Accelerator 9000"]
)
def test_peak_table(kind):
    """Known cards return their data-sheet peaks; any other kind raises
    instead of falling back to a default."""
    from msm_tpu.utils.benchmarks import PEAKS, peaks_for

    if kind not in PEAKS:
        with pytest.raises(ValueError, match="no published peaks"):
            peaks_for(kind)
        return
    peaks = peaks_for(kind)
    assert set(peaks) == {
        "hbm_gbps", "fp32_tflops", "tf32_tflops", "bf16_tflops", "nvlink_gbps"
    }
    # tensor-core rates order as the data sheet lists them
    assert peaks["bf16_tflops"] > peaks["tf32_tflops"] > peaks["fp32_tflops"] > 0

