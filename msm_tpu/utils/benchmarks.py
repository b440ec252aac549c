"""Benchmark helpers (shared by /bench.py and `python -m msm_tpu bench`).

Metrics: grid-updates/s/chip for the KDK step and streams/s for the
ensemble. Every record names the device it ran on; a run that finds no
GPU with published peaks refuses to measure unless it is an explicit
CPU rehearsal (`--rehearsal`).
"""

from __future__ import annotations

import json
import sys
import time


def _log(msg: str) -> None:
    """Progress/heartbeat lines go to STDERR so stdout stays a clean
    stream of JSON records for the driver to parse."""
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _emit(record: dict) -> None:
    """Print one COMPLETE JSON record per line, flushed immediately.

    The bench contract: a valid, parseable JSON line exists on stdout as
    soon as the FIRST measurement finishes. Later, richer records re-print
    the merged result as the new last line; a timeout anywhere after the
    first _emit degrades the artifact to the most recent complete record,
    never to silence."""
    print(json.dumps(record), flush=True)


# Published peaks of the cards this benchmark knows, keyed by
# jax.devices()[0].device_kind. Source: NVIDIA H100 Tensor Core GPU data
# sheet — dense tensor-core rates (without sparsity), HBM bandwidth and
# NVLink bandwidth (both directions summed) at the card's full power
# limit. A card below its limit (nvidia-smi power.limit) cannot hold these.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {  # SXM5 part
        "hbm_gbps": 3350.0,
        "fp32_tflops": 67.0,
        "tf32_tflops": 495.0,
        "bf16_tflops": 989.0,
        "nvlink_gbps": 900.0,
    },
    "NVIDIA H100 PCIe": {
        "hbm_gbps": 2000.0,
        "fp32_tflops": 51.0,
        "tf32_tflops": 378.0,
        "bf16_tflops": 756.0,
        "nvlink_gbps": 600.0,
    },
}


def peaks_for(device_kind: str) -> dict:
    """The published peaks of `device_kind`; an unknown card is an error,
    never a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; "
            f"known kinds: {sorted(PEAKS)}"
        ) from None


def device_record() -> dict:
    """The device every record names: platform, kind and count as JAX
    reports them."""
    import jax

    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }


def require_device(rehearsal: bool = False, prog: str = "bench") -> dict:
    """Refuse to measure anything but a GPU with published peaks. With
    `rehearsal` any platform runs (CPU rehearsals of the control flow);
    such records carry no peaks and no roofline share. `prog` names the
    caller in the refusal."""
    dev = device_record()
    if rehearsal:
        return dev
    if dev["platform"] != "gpu":
        hint = (
            "; pass --rehearsal to run the control flow on this backend"
            if prog == "bench" else ""
        )
        raise SystemExit(
            f"{prog}: no GPU found (platform {dev['platform']!r}){hint}"
        )
    peaks_for(dev["kind"])
    return dev


def _tophat_toml(size: int, dims: int, sim_name: str, **kw):
    from .. import config as cfg

    fields = dict(
        axis_length=30.0,
        final_sim_time=1e9,  # never dump-limited during the bench
        cfl=0.5,
        num_data_dumps=1,
        total_mass=1e11,
        sim_name=sim_name,
        k2_cutoff=0.95,
        alias_threshold=1e9,  # alias check runs but never trips
        dims=dims,
        size=size,
        ics=cfg.SphericalTophat(radius=5.0, delta=100.0, slope=50.0),
        hbar_=0.05,
    )
    fields.update(kw)
    return cfg.TomlParameters(**fields)


def run_kdk_bench(
    size: int, dims: int, streams: int, steps: int, dt_mode: str = "lagged"
) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from .. import config as cfg
    from ..models.ics import build_ics
    from ..stepper import Stepper
    from .cache import enable_compilation_cache

    enable_compilation_cache()
    params = cfg.resolve_parameters(_tophat_toml(size, dims, "bench"))
    stepper = Stepper(params, jnp.complex64, dt_mode=dt_mode)

    psi0 = build_ics(params)
    if streams > 1:
        psi0 = np.broadcast_to(psi0[None], (streams,) + psi0.shape)
    state = stepper.init_state(psi0, batched=streams > 1)

    # The whole step chain runs inside ONE program (fori_loop), exactly
    # like the production per-dump-interval while_loop.
    chain = jax.jit(stepper._chain_n_steps, static_argnums=2)
    state = jax.block_until_ready(chain(state, stepper.consts, steps))  # compile

    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        state = jax.block_until_ready(chain(state, stepper.consts, steps))
        best = min(best, time.perf_counter() - t0)

    cells = streams * size**dims
    out = {
        "metric": "grid_updates_per_s_per_chip",
        "value": round(cells * steps / best, 1),
        "unit": f"cell-updates/s (size={size}^{dims} x {streams} streams, c64 KDK)",
        "steps_per_s": round(steps / best, 3),
        "dt_mode": dt_mode,
        "device": device_record(),
    }
    if dt_mode == "optimistic":
        # A replayed iteration does FFT work but advances no physics, so
        # the headline value is deflated to ACCEPTED-step throughput.
        replays = int(np.asarray(state.replays).sum())
        accepted = max(int(np.asarray(state.n_steps).sum()), 1)
        rate = replays / accepted
        out["replay_rate"] = round(rate, 5)
        out["iteration_updates_per_s"] = out["value"]
        out["value"] = round(out["value"] / (1.0 + rate), 1)
    return out


def run_ensemble_bench(
    size: int = 16, dims: int = 3, streams: int = 128, dumps: int = 8
) -> dict:
    """streams/s on the reference's headline ensemble shape (128 Wigner
    streams at 16^3): full evolve-to-dump chunks, batched."""
    import jax
    import jax.numpy as jnp

    from .. import config as cfg
    from ..models.ics import build_ics
    from ..models.sampling import sample_stream_batch
    from ..stepper import Stepper
    from .cache import enable_compilation_cache

    enable_compilation_cache()
    toml = _tophat_toml(
        size, dims, "bench-ens",
        final_sim_time=float(dumps) * 0.2, num_data_dumps=dumps, ntot=1e10,
    )
    params = cfg.resolve_parameters(toml)
    # production default dt semantics (simulator.run_config)
    stepper = Stepper(params, jnp.complex64, dt_mode="optimistic")
    psi0 = jnp.asarray(build_ics(params), jnp.complex64)

    def make_state(seed0: int):
        seeds = jnp.arange(seed0, seed0 + streams, dtype=jnp.uint32)
        batch = sample_stream_batch(psi0, params, seeds, "Wigner")
        return jax.block_until_ready(stepper.init_state(batch, batched=True))

    # Production path: all dump intervals in ONE dispatch (evolve_intervals
    # scan — the driver's interval blocking). Compile on one seed batch,
    # time another.
    jax.block_until_ready(stepper.evolve_intervals(make_state(1), dumps))
    state = make_state(1 + streams)
    t0 = time.perf_counter()
    state, _ = jax.block_until_ready(stepper.evolve_intervals(state, dumps))
    elapsed = time.perf_counter() - t0
    total_steps = int(jnp.sum(state.n_steps))
    return {
        "metric": "streams_per_s",
        "value": round(streams * dumps / elapsed, 2),
        "unit": f"stream-dump-intervals/s ({streams} Wigner streams, {size}^{dims})",
        "ensemble_steps_per_s": round(total_steps / elapsed, 1),
        "device": device_record(),
    }


def run_scaling_bench(size: int = 64, dims: int = 3, steps: int = 5) -> dict:
    """Weak-scaling sweep: fixed per-device grid load, 1..N devices.

    Each point runs the KDK step over a (stream=1, x, y) pencil mesh with
    the GLOBAL grid scaled so every device holds a (size^dims) pencil;
    efficiency = t(1 device) / t(n devices) at constant per-device work.
    On the CPU virtual-device mesh it exercises the same collective
    structure (numbers then measure XLA CPU collectives, not NCCL).

    Runs single- OR multi-process (bench.py --processes N spawns the
    2-process CPU rehearsal with the same jax.distributed bootstrap as
    tests/test_multihost_spatial.py): points with n >= process_count
    split devices evenly across processes so the all_to_alls cross the
    process boundary; the 1-device baseline runs process-locally on
    every process.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from .. import config as cfg
    from ..models.ics import build_ics
    from ..parallel.mesh import SPACE2_AXIS, SPACE_AXIS, STREAM_AXIS
    from ..parallel.sharded import MeshStepper
    from .cache import enable_compilation_cache

    enable_compilation_cache()
    devices = jax.devices()
    n_proc = jax.process_count()
    by_proc: dict = {}
    for d in devices:
        by_proc.setdefault(d.process_index, []).append(d)
    local = by_proc.get(jax.process_index(), devices)

    def pick_devices(n: int):
        if n_proc == 1:
            return devices[:n]
        if n < n_proc:
            # process-local baseline: every process times its own copy
            return local[:n]
        per = n // n_proc
        return [d for pi in sorted(by_proc) for d in by_proc[pi][:per]]

    # Device counts to visit: the 1-device baseline, then powers of two
    # (single process) or every multiple of the process count (multi
    # process — a power-of-two walk would skip ALL multi-device points
    # when n_proc is not a power of two and silently report a baseline-
    # only table with efficiency 1.0).
    if n_proc == 1:
        counts, n = [1], 2
        while n <= len(devices):
            counts.append(n)
            n *= 2
    else:
        counts = [1] + [
            k * n_proc for k in range(1, len(devices) // n_proc + 1)
        ]
    points = []
    for n in counts:
        # pencil split: px >= py, px*py = n
        py = int(n**0.5)
        while n % py:
            py -= 1
        px = n // py
        # scale the global grid to keep per-device volume constant
        gsize = size
        while (gsize // px) * (gsize // py) * gsize < size**dims or gsize % max(px, py):
            gsize += size
        params = cfg.resolve_parameters(_tophat_toml(gsize, dims, "bench-scale"))
        mesh = Mesh(
            np.asarray(pick_devices(n)).reshape(1, px, py),
            (STREAM_AXIS, SPACE_AXIS, SPACE2_AXIS),
        )
        stepper = MeshStepper(params, mesh, jnp.complex64)
        psi0 = build_ics(params)[None]
        state = stepper.init_state(psi0)
        state = jax.block_until_ready(stepper.step(state))  # compile
        t0 = time.perf_counter()
        for _ in range(steps):
            state = stepper.step(state)
        jax.block_until_ready(state)
        dt = (time.perf_counter() - t0) / steps
        points.append(
            {
                "devices": n,
                "mesh": f"(1,{px},{py})",
                "global_grid": gsize,
                "step_ms": round(dt * 1e3, 2),
                "cell_updates_per_s": round(gsize**dims / dt, 1),
            }
        )
    # cubic grids cannot hold per-device volume exactly constant across
    # device counts, so efficiency is per-device THROUGHPUT normalized to
    # the single-device point (load-invariant)
    base = points[0]["cell_updates_per_s"]
    for pt in points:
        pt["weak_scaling_efficiency"] = round(
            (pt["cell_updates_per_s"] / pt["devices"]) / base, 3
        )
        # measured collective share (1 - efficiency at constant per-device
        # load) — on a CPU virtual mesh it reflects XLA CPU collectives
        pt["comm_fraction_measured"] = round(
            max(0.0, 1.0 - pt["weak_scaling_efficiency"]), 3
        )
    # Label the collective transport so a CPU-rehearsal number can never
    # be quoted as an NCCL measurement.
    dev = device_record()
    transport = "nccl" if dev["platform"] == "gpu" else f"{dev['platform']}-gloo"
    return {
        "metric": "weak_scaling",
        "value": points[-1]["weak_scaling_efficiency"],
        "unit": (
            f"per-device throughput at {points[-1]['devices']} devices / "
            "1-device throughput"
        ),
        "processes": n_proc,
        "transport": transport,
        "device": dev,
        "points": points,
    }


def _spawn_scaling_procs(args) -> None:
    """Self-bootstrap the 2-process CPU weak-scaling rehearsal: spawn N
    workers with the same jax.distributed loopback bootstrap the
    multihost tests use; worker 0 inherits stdout and prints the JSON."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    # repo checkout: three dirs up is /bench.py; installed package: fall
    # back to `-m msm_tpu bench` (same flags via the CLI bench subcommand)
    bench = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "bench.py",
    )
    entry = [bench] if os.path.exists(bench) else ["-m", "msm_tpu", "bench"]
    dpp = int(getattr(args, "devices_per_proc", 4) or 4)
    procs = []
    for i in range(args.processes):
        env = dict(os.environ)
        env.update(
            MSM_BENCH_PROC_ID=str(i),
            MSM_BENCH_NPROCS=str(args.processes),
            MSM_BENCH_COORD=f"127.0.0.1:{port}",
            JAX_PLATFORMS="cpu",
            XLA_FLAGS=f"--xla_force_host_platform_device_count={dpp}",
        )
        cmd = [
            sys.executable, *entry, "--metric", "scaling",
            "--size", str(args.size), "--steps", str(args.steps),
            "--processes", str(args.processes), "--rehearsal",
        ]
        procs.append(
            subprocess.Popen(
                cmd,
                env=env,
                stdout=None if i == 0 else subprocess.DEVNULL,
                stderr=None if i == 0 else subprocess.DEVNULL,
            )
        )
    rcs = [p.wait() for p in procs]
    if any(rcs):
        raise RuntimeError(f"scaling workers failed: rc={rcs}")


def resolve_metric_defaults(args) -> None:
    """Per-metric size/steps defaults (bench.py passes None): the scaling
    sweep holds size^dims per DEVICE and scales the GLOBAL grid up to
    match, so it needs a much smaller base than the single-chip kdk grid
    (inheriting kdk's 256 once built >=512^3 global CPU grids)."""
    metric = getattr(args, "metric", "kdk")
    if getattr(args, "size", None) is None:
        args.size = 64 if metric == "scaling" else 256
    if getattr(args, "steps", None) is None:
        args.steps = 5 if metric == "scaling" else 100


def main(args) -> None:
    metric = getattr(args, "metric", "kdk")
    resolve_metric_defaults(args)
    rehearsal = bool(getattr(args, "rehearsal", False))
    if metric == "scaling" and int(getattr(args, "processes", 1) or 1) > 1:
        if not rehearsal:
            raise SystemExit(
                "bench: --processes spawns CPU workers; it runs only with "
                "--rehearsal"
            )
    else:
        dev = require_device(rehearsal)
        _log(f"device: {dev}")
    if metric == "streams":
        _emit(run_ensemble_bench(streams=args.streams or 128))
        return
    if metric == "scaling":
        import os

        n_procs = int(getattr(args, "processes", 1) or 1)
        if n_procs > 1 and os.environ.get("MSM_BENCH_PROC_ID") is None:
            _spawn_scaling_procs(args)
            return
        if os.environ.get("MSM_BENCH_PROC_ID") is not None:
            import jax

            jax.distributed.initialize(
                coordinator_address=os.environ["MSM_BENCH_COORD"],
                num_processes=int(os.environ["MSM_BENCH_NPROCS"]),
                process_id=int(os.environ["MSM_BENCH_PROC_ID"]),
            )
        out = run_scaling_bench(size=args.size, steps=args.steps)
        import jax

        if jax.process_index() == 0:
            _emit(out)
        return
    dt_mode = getattr(args, "dt_mode", "all")
    if dt_mode not in ("both", "all"):
        _emit(
            run_kdk_bench(
                args.size, args.dims, args.streams or 1, args.steps,
                dt_mode=dt_mode,
            )
        )
        return
    # All dt modes in one run. The HEADLINE is the optimistic mode — the
    # CLI/production DEFAULT (validated-CFL semantics at the lagged
    # interior's cost) — so the advertised number is the number users get.
    # The reference-parity exact mode (two Poisson solves per step, the
    # strict --dt-mode exact semantics) and the unvalidated lagged mode
    # ride along as sub-records.
    #
    # FAIL-SOFT STRUCTURE: the headline record is emitted the moment it
    # exists; each sub-mode re-emits the merged record as the new last
    # line. Sub-modes only run while the remaining wall budget
    # (MSM_BENCH_BUDGET_S, measured from the device check) predicts they
    # can finish — each costs about what the headline did (same grid,
    # compile included) — otherwise they are recorded as skipped. A driver timeout therefore loses at
    # most the not-yet-finished sub-modes, never the headline.
    import os

    budget_s = float(os.environ.get("MSM_BENCH_BUDGET_S", "900"))
    t0 = time.monotonic()
    sub_keys = ("value", "steps_per_s")
    _log("measuring headline (optimistic dt)...")
    out = run_kdk_bench(
        args.size, args.dims, args.streams or 1, args.steps, dt_mode="optimistic"
    )
    t_head = time.monotonic() - t0
    out["bench_budget_s"] = budget_s
    _emit(out)
    _log(f"headline done in {t_head:.0f}s: {out['value']:.3e} {out['metric']}")
    for mode, key in (("exact", "exact_dt"), ("lagged", "lagged_dt")):
        remaining = budget_s - (time.monotonic() - t0)
        # self-calibrating cost estimate: a sub-mode compiles+runs the
        # same grid, so the headline's own wall time (x1.3 margin) is
        # the best predictor available
        need = 1.3 * t_head + 30.0
        if remaining < need:
            out[key] = {
                "skipped": (
                    f"wall budget: {remaining:.0f}s left < {need:.0f}s "
                    f"predicted (MSM_BENCH_BUDGET_S={budget_s:.0f})"
                )
            }
            _emit(out)
            _log(f"{mode} dt skipped ({remaining:.0f}s left < {need:.0f}s needed)")
            continue
        _log(f"measuring {mode} dt sub-mode ({remaining:.0f}s budget left)...")
        sub = run_kdk_bench(
            args.size, args.dims, args.streams or 1, args.steps, dt_mode=mode
        )
        out[key] = {k: sub[k] for k in sub_keys}
        _emit(out)

    # Budget-gated EXTRAS, same fail-soft contract (each re-emits the
    # merged record): the ensemble streams/s point (the reference's
    # headline ensemble shape — its seeds loop runs streams sequentially,
    # main.rs:43-79) and the large-grid point at 2x the headline size
    # (512^3 for the default — the reference's largest configured grid).
    # One artifact then carries the whole performance picture instead of
    # needing separate bench invocations.
    def _extra(key, need, fn):
        remaining = budget_s - (time.monotonic() - t0)
        if remaining < need:
            out[key] = {
                "skipped": (
                    f"wall budget: {remaining:.0f}s left < {need:.0f}s "
                    f"predicted (MSM_BENCH_BUDGET_S={budget_s:.0f})"
                )
            }
        else:
            _log(f"measuring {key} extra ({remaining:.0f}s budget left)...")
            try:
                out[key] = fn()
            except Exception as e:  # noqa: BLE001 - extras must not kill the artifact
                out[key] = {"error": f"{type(e).__name__}: {e}"}
                _log(f"{key} extra failed: {out[key]['error']}")
        _emit(out)

    _extra(
        "streams",
        max(60.0, 1.5 * t_head) + 60.0,
        lambda: run_ensemble_bench(streams=args.streams or 128),
    )
    _extra(
        "large_grid",
        # 8x the cells of the headline grid, plus compile slack
        8.0 * 1.3 * t_head + 120.0,
        lambda: run_kdk_bench(
            2 * args.size, args.dims, args.streams or 1, args.steps,
            dt_mode="optimistic",
        ),
    )
