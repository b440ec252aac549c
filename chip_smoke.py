#!/usr/bin/env python
"""Bring-up check: the simulate -> synthesize path on one NVIDIA GPU.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py                 # phases a-e on one card
    python chip_smoke.py --four-cards    # only the four-card mesh phase

Everything runs in THIS process through the entry points a user calls
(`msm_tpu.cli.main`): a JAX process reserves most of a card's memory when
it starts, so a second process on the same card would fail. Output goes
under one directory (`--out`, default `<repo>/.smoke`).

Phases:

a. device     — JAX's first device must be a GPU; prints nvidia-smi's name
                and power limit, the device kind and the JAX version.
b. single run — examples/production-512.toml (512^3 c64 MFT, the largest
                grid the reference configures) with two cuts: dumps 20 -> 2
                and final_sim_time 20 -> 10. `simulate
                --verbose --debug-checks` in the default optimistic dt mode,
                then with --dt-mode exact; every psi dump's shape and norm
                and the manifest's step count are checked.
c. ensemble   — examples/tophat-collapse.toml (64^3, 8 Wigner streams + MFT)
                with dumps 100 -> 4 (final_sim_time 40 -> 1.6, same dump
                spacing): `simulate --online-synthesis`, then offline
                `synthesize` over the same dumps; the two -combined/ outputs
                must agree. Then examples/cold-gauss-cosmo.toml (expanding,
                32^3) with dumps 60 -> 3 (final_sim_time 30 -> 1.5): the
                scale factor must grow.
d. reference  — 20 steps of the 128^3 tophat step in c64 and c128 on the GPU
                against the same steps in c128 on the CPU backend of this
                process; the compiled step must hold no matrix product.
e. card tests — the tests marked `gpu` (tests/test_gpu.py), in-process.

The last stdout line is one JSON object, {"ok": true, "device": {...}}; a
failed phase raises and the script exits non-zero without printing it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(ROOT, "examples")

# Phase b: simulated time of the cut 512^3 run — half the config's 20, so
# the collapse has started and dt is potential-bound for part of the run.
SINGLE_RUN_TIME = 10.0
# Phase d: max|psi_c64 - psi_c128|/max|psi| of 20 steps of the 128^3
# tophat step, both on the CPU backend (XLA's CPU FFT), measured once on
# an x86 host. The GPU's c64 run must stay within 10x of this gap: cuFFT
# in f32 may round differently from the CPU FFT, not worse by an order.
CPU_C64_GAP_128 = 3.5e-6
C64_GAP_FACTOR = 10.0
# Phase d: the GPU's c128 run must match the CPU's c128 run to this
# relative max difference (FFT rounding in f64, 20 steps).
C128_LIMIT = 1e-10
# Phase c: online (in-jit, f32) vs offline (synthesize, f32) combined
# fields: max difference relative to each field's max magnitude; Qx
# (a difference of two unit-scale sums) absolute.
SYNTHESIS_RTOL = 1e-5
QX_ATOL = 1e-5
# Four-card phase: mesh vs one-card dumps in f32, relative to max|psi|.
# The mesh FFTs are pencil decompositions with their own rounding, and
# the dt sequence follows max|phi| reduced in another order.
MESH_RTOL = 1e-4

BACKEND_COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"


class SmokeFailure(AssertionError):
    pass


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# ---------------------------------------------------------------- helpers


class CompileClock:
    """Sums XLA backend compile time while the `with` block runs (a
    jax.monitoring listener; persistent-cache hits do not count)."""

    def __init__(self):
        self.secs = 0.0

    def _on_duration(self, event: str, secs: float, **_):
        if event == BACKEND_COMPILE_EVENT:
            self.secs += secs

    def __enter__(self):
        import jax

        jax.monitoring.register_event_duration_secs_listener(self._on_duration)
        return self

    def __exit__(self, *exc):
        import jax

        jax.monitoring.unregister_event_duration_listener(self._on_duration)


def nvidia_smi() -> str | None:
    """`name, power.limit` of every card as nvidia-smi prints them (a child
    process that does not touch JAX), or None without nvidia-smi."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip() if r.returncode == 0 else None


def cut_toml(example: str, out_dir: str, **overrides) -> str:
    """Copy examples/<example>.toml into out_dir with top-level keys
    replaced (`key = value` lines); returns the new path."""
    with open(os.path.join(EXAMPLES, f"{example}.toml")) as f:
        text = f.read()
    for key, value in overrides.items():
        text, n = re.subn(
            rf"^{key}\s*=.*$", f"{key} = {value}", text, count=1, flags=re.M
        )
        _check(n == 1, f"{example}.toml has no top-level {key}")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{example}.toml")
    with open(path, "w") as f:
        f.write(text)
    return path


def simulate(toml_path: str, data_root: str, *flags: str) -> float:
    """`python -m msm_tpu simulate` in-process; returns its wall time."""
    from msm_tpu import cli

    t0 = time.perf_counter()
    rc = cli.main(
        ["simulate", "--toml", toml_path, "--data-root", data_root, *flags]
    )
    _check(rc == 0, f"simulate {toml_path} returned {rc}")
    return time.perf_counter() - t0


def _manifest(run_dir: str) -> dict:
    with open(os.path.join(run_dir, "manifest.json")) as f:
        return json.load(f)


def _load_psi(run_dir: str, dump: int):
    from msm_tpu.io.npy import load_complex_pair

    return load_complex_pair(
        os.path.join(run_dir, f"psi_{dump:05d}"), dtype="complex64"
    )


def _peak_bytes() -> str:
    import jax

    stats = jax.devices()[0].memory_stats()
    if not stats or "peak_bytes_in_use" not in stats:
        return "n/a on this backend"
    return f"{stats['peak_bytes_in_use'] / 2**30:.2f} GiB"


def interval_memory(toml_path: str, dt_mode: str) -> str:
    """AOT-compile the run's interval program (the jit that
    Stepper.evolve_intervals dispatches, with run_single's stepper
    options and block size) on abstract inputs; returns its compile time
    and `memory_analysis()`."""
    import jax
    import jax.numpy as jnp

    from msm_tpu import config as cfg
    from msm_tpu import simulator
    from msm_tpu.stepper import Stepper

    params = list(cfg.iter_stream_parameters(cfg.read_toml(toml_path)))[-1]
    st = Stepper(params, jnp.complex64, dt_mode=dt_mode, debug_checks=True)
    state = jax.eval_shape(
        st._jit_init, jax.ShapeDtypeStruct(params.shape, st.dtype), st.consts
    )
    k = simulator._interval_block_k(params, 1, jnp.complex64, st)
    fn = st.interval_fn(k, with_potential=bool(params.output_potential))
    t0 = time.perf_counter()
    compiled = fn.lower(state, st.consts).compile()
    secs = time.perf_counter() - t0
    ma = compiled.memory_analysis()
    fields = (
        "argument_size_in_bytes", "output_size_in_bytes",
        "alias_size_in_bytes", "temp_size_in_bytes",
        "generated_code_size_in_bytes",
    )
    mem = ", ".join(
        f"{f.replace('_size_in_bytes', '')}={getattr(ma, f) / 2**20:.1f} MiB"
        for f in fields
        if ma is not None and hasattr(ma, f)
    )
    return f"k={k}, compile {secs:.2f} s, memory_analysis: {mem or ma}"


def rel_diff(a, b) -> float:
    import numpy as np

    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# ----------------------------------------------------------------- phases


def phase_device(require_gpu: bool = True) -> dict:
    """(a) The device JAX runs on; a GPU unless this is a CPU rehearsal."""
    import jax

    dev = jax.devices()[0]
    info = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }
    if require_gpu and dev.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX found no GPU (platform {dev.platform!r})"
        )
    smi = nvidia_smi()
    if require_gpu:
        _check(smi is not None, "nvidia-smi did not answer")
    _say("a", f"nvidia-smi name, power.limit: {smi or 'not available'}")
    _say(
        "a",
        f"jax {jax.__version__}: platform={info['platform']} "
        f"kind={info['kind']!r} count={info['count']}",
    )
    from msm_tpu.io import native

    _say("a", f"native npy writer used: {native.available()}")
    return info


def phase_single(
    out_dir: str,
    size: int | None = None,
    final_time: float = SINGLE_RUN_TIME,
    dt_modes=("optimistic", "exact"),
) -> dict:
    """(b) The production config at full width, both dt modes."""
    import numpy as np

    from msm_tpu import config as cfg
    from msm_tpu import simulator

    over = {"num_data_dumps": 2, "final_sim_time": final_time}
    if size is not None:
        over["size"] = size
    path = cut_toml("production-512", os.path.join(out_dir, "single"), **over)
    params = list(cfg.iter_stream_parameters(cfg.read_toml(path)))[-1]
    n = params.size
    eps = simulator._resolve_check_eps(None, np.complex64)
    _say("b", f"{params.sim_name}: {n}^3 c64, dumps 20 -> 2, "
              f"final_sim_time 20 -> {final_time}; check-eps {eps:g}")
    out = {}
    for mode in dt_modes:
        root = os.path.join(out_dir, "single", mode)
        shutil.rmtree(root, ignore_errors=True)
        with CompileClock() as clock:
            wall = simulate(path, root, "--verbose", "--debug-checks",
                            "--dt-mode", mode)
        run_dir = os.path.join(root, params.sim_name)
        man = _manifest(run_dir)
        _check(man["n_steps"] > 0, f"{mode}: manifest n_steps = {man['n_steps']}")
        _check(man["current_dumps"] == 2, f"{mode}: {man['current_dumps']} dumps")
        norms = []
        for i in range(3):
            for plane in ("real", "imag"):
                f = os.path.join(run_dir, f"psi_{i:05d}_{plane}")
                _check(os.path.exists(f), f"missing {f}")
                arr = np.load(f, mmap_mode="r")
                _check(arr.shape == (n, n, n, 1), f"{f}: shape {arr.shape}")
            psi = _load_psi(run_dir, i)
            norm = float(np.sum(np.abs(psi.astype(np.complex128)) ** 2)
                         * params.dx**3)
            _check(np.isfinite(norm) and abs(norm - 1.0) < eps,
                   f"{mode}: dump {i} norm {norm}")
            norms.append(norm)
        _say("b", f"{mode}: wall {wall:.2f} s, steps {man['n_steps']}, "
                  f"replays {man.get('replays', 0)}, backend compile "
                  f"{clock.secs:.2f} s, peak device memory "
                  f"{_peak_bytes()}, max |norm-1| "
                  f"{max(abs(x - 1) for x in norms):.3g}")
        _say("b", f"{mode}: interval program: {interval_memory(path, mode)}")
        out[mode] = {"wall_s": wall, "steps": man["n_steps"]}
        shutil.rmtree(root, ignore_errors=True)  # 1 GiB per dump at 512^3
    return out


def compare_combined(root: str, name: str, n_dumps: int, online_dir: str) -> dict:
    """Max relative difference of each -combined/ field (and Qx) between
    an online directory and the offline `synthesize` output."""
    import numpy as np

    from msm_tpu.io.npy import load_complex_pair

    offline_dir = os.path.join(root, f"{name}-combined")
    worst = {}
    for field in ("psi", "psi2", "psik", "psik2"):
        for i in range(n_dumps + 1):
            a = load_complex_pair(os.path.join(online_dir, f"{field}_{i:05d}"))
            b = load_complex_pair(os.path.join(offline_dir, f"{field}_{i:05d}"))
            worst[field] = max(worst.get(field, 0.0), rel_diff(a, b))
    qa = load_complex_pair(os.path.join(online_dir, "Qx"))
    qb = load_complex_pair(os.path.join(offline_dir, "Qx"))
    _check(qa.shape == qb.shape == (n_dumps + 1, 1, 1, 1),
           f"Qx shapes {qa.shape} {qb.shape}")
    worst["Qx_abs"] = float(np.abs(qa - qb).max())
    return worst


def phase_ensemble(
    out_dir: str,
    size: int | None = None,
    cosmo_size: int | None = None,
) -> dict:
    """(c) The 8-stream ensemble online and offline, then the expanding
    config."""
    import numpy as np

    from msm_tpu import cli

    over = {"num_data_dumps": 4, "final_sim_time": 1.6}
    if size is not None:
        over["size"] = size
    base = os.path.join(out_dir, "ensemble")
    shutil.rmtree(base, ignore_errors=True)
    path = cut_toml("tophat-collapse", base, **over)
    root = os.path.join(base, "data")
    name = "tophat-collapse"
    wall = simulate(path, root, "--online-synthesis", "--debug-checks")
    online = os.path.join(root, f"{name}-combined-online")
    os.rename(os.path.join(root, f"{name}-combined"), online)
    t0 = time.perf_counter()
    _check(cli.main(["synthesize", "--toml", path, "--data-root", root]) == 0,
           "synthesize failed")
    syn_wall = time.perf_counter() - t0
    worst = compare_combined(root, name, 4, online)
    steps = max(
        _manifest(os.path.join(root, d))["n_steps"]
        for d in os.listdir(root)
        if os.path.exists(os.path.join(root, d, "manifest.json"))
    )
    _say("c", f"{name}: 8 streams + MFT, dumps 100 -> 4, final_sim_time "
              f"40 -> 1.6: simulate --online-synthesis wall {wall:.2f} s "
              f"({steps} steps), synthesize wall {syn_wall:.2f} s, peak "
              f"device memory {_peak_bytes()}")
    _say("c", "online vs offline -combined/: " + ", ".join(
        f"{k} {v:.2e}" for k, v in worst.items()))
    for field in ("psi", "psi2", "psik", "psik2"):
        _check(worst[field] <= SYNTHESIS_RTOL,
               f"{field}: online vs offline {worst[field]:.3g} > {SYNTHESIS_RTOL}")
    _check(worst["Qx_abs"] <= QX_ATOL,
           f"Qx: online vs offline {worst['Qx_abs']:.3g} > {QX_ATOL}")

    over = {"num_data_dumps": 3, "final_sim_time": 1.5}
    if cosmo_size is not None:
        over["size"] = cosmo_size
    cpath = cut_toml("cold-gauss-cosmo", base, **over)
    croot = os.path.join(base, "cosmo")
    cwall = simulate(cpath, croot, "--debug-checks")
    man = _manifest(os.path.join(croot, "cold-gauss-cosmo"))
    a0 = 1.0 / (1.0 + 9.0)  # the config's z0 = 9
    _check(man["current_dumps"] == 3, f"cosmo: {man['current_dumps']} dumps")
    _check(man["a"] > a0 and man["tau"] > 0,
           f"cosmo: a {man['a']} (a0 {a0}), tau {man['tau']}")
    for i in range(4):
        _check(bool(np.isfinite(_load_psi(
            os.path.join(croot, "cold-gauss-cosmo"), i)).all()),
            f"cosmo dump {i} not finite")
    _say("c", f"cold-gauss-cosmo: dumps 60 -> 3, final_sim_time 30 -> 1.5: "
              f"wall {cwall:.2f} s, {man['n_steps']} steps, a {a0:.4f} -> "
              f"{man['a']:.6f}")
    shutil.rmtree(base, ignore_errors=True)
    return {"online_offline": worst, "a": man["a"]}


def _materialized_psi(state, params):
    """psi(x) in c128 from psik with any deferred closing kick applied
    (lagged/optimistic steps leave psi stale between dumps)."""
    import numpy as np

    from msm_tpu.grid import spec_grid

    spec = spec_grid(params.dx, params.dims, params.size)
    pend = float(np.asarray(state.pending_k))
    psik = np.asarray(state.psik).astype(np.complex128) * np.exp(1j * pend * spec)
    return np.fft.ifftn(psik, norm="ortho")


def phase_reference(size: int = 128, steps: int = 20, device=None) -> dict:
    """(d) c64 and c128 steps on `device` (the GPU) against c128 steps on
    the CPU backend of this process, from the same psi0."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from msm_tpu import config as cfg
    from msm_tpu.models.ics import build_ics
    from msm_tpu.stepper import Stepper

    jax.config.update("jax_enable_x64", True)
    device = device or jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    toml = dataclasses.replace(
        cfg.read_toml(os.path.join(EXAMPLES, "tophat-collapse.toml")), size=size
    )
    params = list(cfg.iter_stream_parameters(toml))[-1]
    psi0 = build_ics(params)

    def run(dtype, dev):
        with jax.default_device(dev):
            st = Stepper(params, dtype, dt_mode="optimistic")
            s = st.init_state(psi0)
            chain = jax.jit(st._chain_n_steps, static_argnums=2)
            compiled = chain.lower(s, st.consts, steps).compile()
            s = jax.block_until_ready(compiled(s, st.consts))
        return s, compiled.as_text()

    ref, _ = run(jnp.complex128, cpu)
    ref_psi = _materialized_psi(ref, params)
    out = {}
    for label, dtype in (("c64", jnp.complex64), ("c128", jnp.complex128)):
        s, hlo = run(dtype, device)
        dots = re.findall(r"\bdot\(|cublas", hlo)
        _check(not dots, f"{label}: compiled step holds matrix products {dots[:3]}")
        psi = _materialized_psi(s, params)
        gap = rel_diff(psi, ref_psi)
        drift = abs(float(np.sum(np.abs(psi) ** 2) * params.dx**3) - 1.0)
        out[label] = {"rel": gap, "norm_drift": drift}
        _say("d", f"{size}^3 tophat, {steps} optimistic steps, {label} on "
                  f"{device.platform} vs c128 on cpu: max|dpsi|/max|psi| "
                  f"{gap:.3e}, |norm-1| {drift:.3e}, time "
                  f"{float(np.asarray(s.time)):.6g} vs "
                  f"{float(np.asarray(ref.time)):.6g}; no dot in HLO")
    limit64 = C64_GAP_FACTOR * CPU_C64_GAP_128
    _check(out["c64"]["rel"] <= limit64,
           f"c64 gap {out['c64']['rel']:.3g} > {limit64:.3g}")
    _check(out["c128"]["rel"] <= C128_LIMIT,
           f"c128 gap {out['c128']['rel']:.3g} > {C128_LIMIT:.3g}")
    return out


class _Count:
    def __init__(self):
        self.passed = self.failed = self.skipped = 0

    def pytest_runtest_logreport(self, report):
        if report.passed and report.when == "call":
            self.passed += 1
        elif report.failed:
            self.failed += 1
        elif report.skipped:
            self.skipped += 1


def phase_tests() -> int:
    """(e) The `gpu`-marked tests in this process; every one must run."""
    import pytest

    os.environ["MSM_TEST_GPU"] = "1"
    count = _Count()
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider",
         os.path.join(ROOT, "tests", "test_gpu.py")],
        plugins=[count],
    )
    _say("e", f"gpu tests: {count.passed} passed, {count.failed} failed, "
              f"{count.skipped} skipped (pytest rc {int(rc)})")
    _check(int(rc) == 0 and count.passed > 0 and not count.skipped,
           "gpu-marked tests did not all pass")
    return count.passed


def phase_four_cards(
    out_dir: str,
    size: int | None = None,
    final_time: float = SINGLE_RUN_TIME,
    ens_size: int | None = None,
    only: str | None = None,
) -> dict:
    """Four-card phase: the production config over a (1, 2, 2) pencil
    (`--mesh space`) and the ensemble over `--mesh auto`, each compared
    dump by dump with the same config on one card. `only` picks one of
    the two ("space" or "auto")."""
    import jax

    from msm_tpu import config as cfg

    _check(len(jax.devices()) > 1, "needs several devices")
    base = os.path.join(out_dir, "mesh")
    shutil.rmtree(base, ignore_errors=True)
    out = {}
    over = {"num_data_dumps": 2, "final_sim_time": final_time}
    if size is not None:
        over["size"] = size
    single = cut_toml("production-512", base, **over)
    over = {"num_data_dumps": 4, "final_sim_time": 1.6}
    if ens_size is not None:
        over["size"] = ens_size
    ens = cut_toml("tophat-collapse", base, **over)
    for label, path, mesh in (("space", single, "space"), ("auto", ens, "auto")):
        if only not in (None, label):
            continue
        toml = cfg.read_toml(path)
        runs = [p.sim_name for p in cfg.iter_stream_parameters(toml)]
        roots = {m: os.path.join(base, f"{label}-{m}") for m in (mesh, "none")}
        walls = {m: simulate(path, r, "--mesh", m) for m, r in roots.items()}
        worst = 0.0
        for name in runs:
            for i in range(toml.num_data_dumps + 1):
                a = _load_psi(os.path.join(roots[mesh], name), i)
                b = _load_psi(os.path.join(roots["none"], name), i)
                worst = max(worst, rel_diff(a, b))
            ma = _manifest(os.path.join(roots[mesh], name))
            mb = _manifest(os.path.join(roots["none"], name))
            _check(ma["current_dumps"] == mb["current_dumps"]
                   == toml.num_data_dumps, f"{name}: dump counts differ")
        _say("mesh", f"{toml.sim_name} {toml.size}^3 x {len(runs)} runs, "
                     f"--mesh {mesh} on {len(jax.devices())} devices: wall "
                     f"{walls[mesh]:.2f} s vs one device {walls['none']:.2f} "
                     f"s; max|dpsi|/max|psi| over all dumps {worst:.3e} "
                     f"(limit {MESH_RTOL:g})")
        _check(worst <= MESH_RTOL, f"--mesh {mesh}: {worst:.3g} > {MESH_RTOL}")
        out[label] = worst
        shutil.rmtree(base + f"/{label}-{mesh}", ignore_errors=True)
        shutil.rmtree(base + f"/{label}-none", ignore_errors=True)
    return out


def result_line(device: dict) -> str:
    """The final stdout line."""
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"],
        "kind": device["kind"],
        "count": device["count"],
    }})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, ".smoke"),
                    help="output directory (default <repo>/.smoke)")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    import msm_tpu  # noqa: F401  (fails here when the script stands alone)

    device = phase_device()
    os.makedirs(args.out, exist_ok=True)
    if args.four_cards:
        _check(device["count"] == 4, f"--four-cards needs 4 GPUs, got {device['count']}")
        phase_four_cards(args.out)
    else:
        phase_single(args.out)
        phase_ensemble(args.out)
        phase_reference()
        phase_tests()
    _say("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(result_line(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
