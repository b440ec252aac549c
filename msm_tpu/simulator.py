"""Simulation drivers: single-run and batched stream-ensemble execution.

Counterpart of `simulator/src/main.rs:21-89`. Two execution modes:

- `run_single`: one stream (or the MFT), reference-sequential semantics.
- `run_config`: the batched path — every stream of the ensemble plus the
  MFT run as ONE batched state, vmapped over a leading stream axis. The
  reference runs a full simulation per seed sequentially on one GPU
  (`main.rs:43-79`); here the ensemble advances together, chunked from dump
  boundary to dump boundary inside jit, and the host only does npy writes.

Aliasing in a batched run freezes and reports the offending stream instead
of killing the batch (the reference panics: `simulation_object.rs:607-617`).
"""

from __future__ import annotations

import contextlib as _contextlib
import dataclasses
import logging
import os
import time as _time
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .config import (
    SimulationParameters,
    TomlParameters,
    iter_stream_parameters,
)
from .errors import FourierAliasingError
from .io.checkpoint import load_manifest, write_manifest
from .io.npy import AsyncGridWriter, dump_dir, load_complex_pair, psi_path
from .models.ics import build_ics
from .models.sampling import sample_quantum_perturbation, sample_stream_batch
from .stepper import SimState, Stepper

log = logging.getLogger(__name__)


def _dump_array(psi_np: np.ndarray, params: SimulationParameters) -> np.ndarray:
    """Reshape a grid to the 4-D npy dump shape (io.rs:34-97)."""
    return np.ascontiguousarray(psi_np).reshape(params.dump_shape)


class SimulationRun:
    """One named simulation run: dump paths, manifests, psi dumps.

    With a `backend` (built from `[remote_storage_parameters]`), grids go to
    the storage backend under flat keys with seed-rotated accounts instead
    of the local npy layout, like the reference's default-on remote-storage
    feature (`simulator/src/utils/io.rs:352-465`,
    `simulation_object.rs:1186-1205`). Checkpoint manifests stay local
    either way (resume state is this build's extension).
    """

    def __init__(
        self,
        params: SimulationParameters,
        data_root: str = "sim-data",
        writer: Optional[AsyncGridWriter] = None,
        backend=None,
    ):
        self.params = params
        self.dir = dump_dir(params.sim_name, data_root)
        self.writer = writer
        self.backend = backend
        self.seed = params.sampling.seed if params.sampling is not None else None
        # destination URL of the latest upload per field (remote backends
        # return one from submit_grid; recorded in the manifest like the
        # reference's upload_grid URL, io.rs:427-465)
        self._urls: dict = {}

    def dump_field(self, psi_np: np.ndarray, dump_index: int, field: str = "psi"):
        arr = _dump_array(psi_np, self.params)
        if self.backend is not None:
            self._urls[f"{field}_url"] = self.backend.submit_grid(
                self.params.sim_name, field, dump_index, arr, seed=self.seed
            )
            return
        base = psi_path(self.dir, dump_index, field)
        if self.writer is not None:
            self.writer.submit(base, arr)
        else:
            from .io.npy import write_complex_pair

            write_complex_pair(base, arr)

    def psi_base(self, dump_index: int) -> str:
        """Base path of a written psi dump (local or backend layout)."""
        if self.backend is not None:
            return self.backend.grid_path(
                self.params.sim_name, "psi", dump_index, seed=self.seed
            )
        return psi_path(self.dir, dump_index)

    def load_psi(self, dump_index: int) -> np.ndarray:
        """Read a psi dump back, whatever storage it went to (the resume
        path works against the object store too — GET on the transport)."""
        if self.backend is not None:
            arr = self.backend.load_grid(
                self.params.sim_name, "psi", dump_index, seed=self.seed
            )
        else:
            arr = load_complex_pair(self.psi_base(dump_index))
        return arr.reshape(self.params.shape)

    def write_manifest(self, state_slice: dict):
        write_manifest(self.dir, extra=self._urls or None, **state_slice)


def storage_backend_for(
    params_or_toml, data_root: str, writer: Optional[AsyncGridWriter] = None
):
    """ObjectBackend from a config's `[remote_storage_parameters]`, or None.

    The backend root (the stand-in for the remote drive) is
    `$MSM_REMOTE_ROOT` or `{data_root}/remote-storage`.
    """
    rs = getattr(params_or_toml, "remote_storage", None) or getattr(
        params_or_toml, "remote_storage_parameters", None
    )
    if rs is None:
        return None
    from .io.storage import ObjectBackend

    root = os.environ.get(
        "MSM_REMOTE_ROOT", os.path.join(data_root, "remote-storage")
    )
    return ObjectBackend.from_config(rs, root, writer=writer)


def _interval_block_k(
    params, n_batch: int, dtype, stepper, online: bool = False
) -> int:
    """Dump intervals advanced+fetched per dispatch (stepper.evolve_intervals).

    Block size is compute-neutral (the scan body IS the per-interval
    program) but removes the per-interval dispatch and host round trip
    that dominate small-grid runs. Plain Stepper blocks when
    single-process; MeshStepper blocks on any process count — its stacked
    payload leaves the program with replicated scalars and stream-sharded,
    space-gathered grids, so multi-host fetches stay process-local
    (MeshStepper.evolve_intervals). Bounded by the stacked dump payload
    (k × batch × grid psi planes, ×1.5 with output_potential):
    MSM_INTERVAL_BLOCK overrides directly, MSM_INTERVAL_BLOCK_MB sets the
    budget (default 512 MB, cap 32).
    """
    max_k = max(1, int(params.num_data_dumps))
    if type(stepper) is Stepper and jax.process_count() > 1:
        return 1
    if not hasattr(stepper, "evolve_intervals"):
        return 1
    env = os.environ.get("MSM_INTERVAL_BLOCK")
    if env:
        return max(1, min(int(env), max_k))
    per_interval = (
        n_batch * int(np.prod(params.shape)) * jnp.dtype(dtype).itemsize
    )
    if params.output_potential:
        per_interval += per_interval // 2
    if online:
        # the in-payload online-synthesis row: 6 real planes (= 3 complex
        # grids) per interval (Stepper._combine_row)
        per_interval += 3 * int(np.prod(params.shape)) * jnp.dtype(dtype).itemsize
    budget = float(os.environ.get("MSM_INTERVAL_BLOCK_MB", "512")) * 2**20
    return max(1, min(int(budget // max(per_interval, 1)), 32, max_k))


def _speculation_ok(
    params, n_batch: int, dtype, kblock: int, donated: bool = True
) -> bool:
    """Whether dispatching block i+1 before fetching block i fits memory.

    Each interval dispatch DONATES its input state (evolve_intervals), so
    speculation keeps ONE in-place psi+psik state plus two blocks' stacked
    dump payloads live (without donation, two full states). Budget via
    MSM_SPECULATE_MB: the defaults (4096 MB with donation, 3072 without)
    are untuned for the current card — they bound the live set, not a
    measured limit. Below the budget the driver overlaps transfers+writes
    with the next block's compute, above it blocks are dispatched
    synchronously after the fetch."""
    from .stepper import _donate_enabled

    grid = n_batch * int(np.prod(params.shape)) * jnp.dtype(dtype).itemsize
    payload = kblock * grid * (3 if params.output_potential else 2) // 2
    states = 1 if (donated and _donate_enabled()) else 2
    live = states * (2 * grid) + 2 * payload
    default_mb = 4096 if states == 1 else 3072
    budget = float(os.environ.get("MSM_SPECULATE_MB", default_mb)) * 2**20
    return live <= budget


class _BlockedOutsView:
    """Host view of a stacked k-interval dump payload, single- or
    multi-host (the blocked analogue of _EnsembleHostView).

    Plain single-process payloads are fully addressable; mesh payloads
    arrive with replicated per-stream scalars and stream-sharded,
    space-replicated grids (MeshStepper.evolve_intervals), so each process
    fetches exactly the streams it owns.
    """

    def __init__(self, outs: dict, n: int, want_pot: bool):
        from .parallel.mesh import (
            fetch_stacked_slices,
            host_local_value,
            write_owner_indices_axis1,
        )

        self.n = n
        # comb_* full-grid mean fields are written by process 0 only
        # (OnlineCombiner.write_row): don't pay kblock x 6 grids of
        # device->host transfer on the processes that discard them.
        # comb_n / comb_qx stay fetched everywhere (tiny, and the write
        # gate reads comb_n).
        skip_grids = {"psi", "pot"}
        if jax.process_index() != 0:
            skip_grids |= {
                name
                for name in outs
                if name.startswith("comb_") and name not in ("comb_n", "comb_qx")
            }
        self.scal = {
            name: host_local_value(v)
            for name, v in outs.items()
            if name not in skip_grids
        }
        psi = outs["psi"]
        self._sliced = not getattr(psi, "is_fully_addressable", True)
        if self._sliced:
            self.owned = [i for i in write_owner_indices_axis1(psi) if i < n]
            self._psi = fetch_stacked_slices(psi, self.owned)
            self._pot = (
                fetch_stacked_slices(outs["pot"], self.owned) if want_pot else None
            )
        else:
            self.owned = list(range(n))
            self._psi = np.asarray(psi)
            self._pot = np.asarray(outs["pot"]) if want_pot else None

    def scalar(self, name: str) -> np.ndarray:
        return self.scal[name]

    def psi(self, j: int, i: int) -> np.ndarray:
        return self._psi[i][j] if self._sliced else self._psi[j, i]

    def pot(self, j: int, i: int) -> np.ndarray:
        return self._pot[i][j] if self._sliced else self._pot[j, i]


def _telemetry_suffix(d_steps: int, dt_min: float, dt_max: float, replays: int) -> str:
    """Per-dump step telemetry for --verbose lines (the reference's
    per-update visibility, `simulation_object.rs:482,1210-1222`, recovered
    from the in-jit payload with zero extra host syncs)."""
    if d_steps <= 0:
        return ""
    s = f" [{d_steps} steps, dt {dt_min:.3g}..{dt_max:.3g}"
    if replays:
        s += f", replays {replays}"
    return s + "]"


def _state_scalars(state: SimState, i: Optional[int] = None) -> dict:
    def pick(x):
        x = np.asarray(x)
        return x if i is None else x[i]

    return {
        "current_dumps": int(pick(state.current_dumps)),
        "time": float(pick(state.time)),
        "tau": float(pick(state.tau)),
        "a": float(pick(state.a)),
        "n_steps": int(pick(state.n_steps)),
        "aliased": bool(pick(state.aliased)),
        "replays": int(pick(state.replays)),
    }


class _EnsembleHostView:
    """Host-side view of a batched state that works single- and multi-host.

    Single host: direct transfers. Multi host: per-stream scalar leaves are
    allgathered (they are sharded over processes along the stream axis) and
    each process fetches only the psi streams whose shards it holds — dump
    ownership follows data ownership, so no cross-host field traffic.
    """

    def __init__(
        self, state: SimState, n: int, fetch_psi: bool = True, stepper=None
    ):
        self.n = n
        self.multihost = jax.process_count() > 1
        self.state = state
        if not self.multihost:
            self.owned = list(range(n))
            self._psi = None
            return
        from jax.experimental import multihost_utils

        from .parallel.mesh import fetch_batch_slices, write_owner_indices

        def gather(x):
            return multihost_utils.process_allgather(x, tiled=True)

        self.scalars = {
            name: np.asarray(gather(getattr(state, name))).reshape(-1)[:n]
            for name in (
                "time",
                "tau",
                "a",
                "current_dumps",
                "n_steps",
                "just_dumped",
                "aliased",
                "alias_mass",
                "max_norm_err",
                "dt_min",
                "dt_max",
                "replays",
            )
        }
        # grids that span hosts are gathered to stream-only sharding first
        # (space axes replicated), then each stream is written by exactly
        # one process; indices >= n are internal padding rows, never dumped
        psi_src = state.psi
        if fetch_psi and getattr(stepper, "shard_space", False):
            psi_src = stepper.gather_spatial(state.psi)
        self.owned = [i for i in write_owner_indices(psi_src) if i < n]
        if fetch_psi:
            self._psi = fetch_batch_slices(psi_src, self.owned)
        else:
            self._psi = None

    def scalar(self, name: str) -> np.ndarray:
        if self.multihost:
            return self.scalars[name]
        return np.asarray(getattr(self.state, name))

    def psi(self, i: int) -> np.ndarray:
        if self.multihost:
            return self._psi[i]
        if self._psi is None:
            self._psi = np.asarray(self.state.psi)
        return self._psi[i]

    def run_scalars(self, i: int) -> dict:
        return {
            "current_dumps": int(self.scalar("current_dumps")[i]),
            "time": float(self.scalar("time")[i]),
            "tau": float(self.scalar("tau")[i]),
            "a": float(self.scalar("a")[i]),
            "n_steps": int(self.scalar("n_steps")[i]),
            "aliased": bool(self.scalar("aliased")[i]),
            "replays": int(self.scalar("replays")[i]),
        }


def _try_resume_batch(runs, stepper: Stepper, pad_to: int):
    """Rebuild a batched SimState from per-run manifests + last psi dumps.

    Returns None when any run lacks a usable checkpoint (fresh start).
    Padding rows (mesh=auto layouts) are copies of the last (MFT) run.
    """
    manifests = []
    for r in runs:
        m = load_manifest(r.dir)
        if m is None:
            return None
        manifests.append(m)
    if all(m["current_dumps"] == 0 for m in manifests):
        return None

    psis = []
    for r, m in zip(runs, manifests):
        psis.append(r.load_psi(m["current_dumps"]))
    psis += [psis[-1]] * (pad_to - len(runs))
    manifests += [manifests[-1]] * (pad_to - len(runs))
    state = stepper.init_state(np.stack(psis), batched=True)

    def arr(key, dtype):
        return jnp.asarray([m[key] for m in manifests], dtype)

    return dataclasses.replace(
        state,
        time=arr("time", stepper.tdtype),
        tau=arr("tau", stepper.tdtype),
        a=arr("a", stepper.tdtype),
        current_dumps=arr("current_dumps", jnp.int32),
        n_steps=arr("n_steps", jnp.int32),
        aliased=jnp.asarray(
            [bool(m.get("aliased", False)) for m in manifests], jnp.bool_
        ),
        # cumulative replay telemetry survives resume (manifests carry it)
        replays=arr("replays", jnp.int32)
        if all("replays" in m for m in manifests)
        else state.replays,
    )


def _resolve_check_eps(check_eps, dtype) -> float:
    """Unitarity tolerance for --debug-checks.

    The reference's check_norm uses eps = 1e-4 (`grid.rs:35-64`) — that is
    the default where precision allows (f64). In f32 the rounding of each
    FFT pass accumulates over thousands of steps, so the f32 default keeps
    a 10x wider 1e-3 envelope (PARITY.md); pass --check-eps to override
    either way.
    """
    if check_eps is not None:
        return float(check_eps)
    return 1e-4 if jnp.dtype(dtype) == jnp.complex128 else 1e-3


def _debug_validate(
    psi_np: np.ndarray, params: SimulationParameters, where: str, eps: float
):
    """Runtime sanitizers: norm + NaN/Inf checks at dump boundaries.

    The reference's debug_assert!(check_norm...) / check_complex_for_nans
    invariants (`simulation_object.rs:485-529`, SURVEY.md §5) as an opt-in
    runtime flag instead of a debug-build compile feature.
    """
    if not np.all(np.isfinite(psi_np.real)) or not np.all(np.isfinite(psi_np.imag)):
        raise FloatingPointError(f"NaN/Inf in psi at {where}")
    norm = float(np.sum(np.abs(psi_np) ** 2) * params.dx**params.dims)
    if abs(norm - 1.0) > eps:
        raise FloatingPointError(
            f"norm violation at {where}: sum|psi|^2 dV = {norm:.6g} "
            f"(eps = {eps:g})"
        )


@_contextlib.contextmanager
def _closing(resource):
    """contextlib.closing that tolerates None (no remote backend)."""
    try:
        yield resource
    finally:
        if resource is not None:
            resource.close()


def _report_aliasing(params: SimulationParameters, mass: float, strict: bool):
    err = FourierAliasingError(
        threshold=params.alias_threshold,
        k2_cutoff=params.k2_cutoff,
        p_mass=mass,
        stream=params.sim_name,
    )
    if strict:
        raise err
    log.error("%s", err)


def _make_stepper(
    params, dtype, dt_mode: str, mesh: str, n_runs: int, debug_checks: bool = False
):
    """Pick the execution engine for the batched ensemble.

    mesh="auto" compiles the run over all visible devices via MeshStepper
    (stream axis when the run count divides it, otherwise spatial slabs);
    mesh="none" (default) stays single-device like the reference.

    Returns (stepper, pad_to): when no layout divides the run count, the
    stream batch is padded internally to `pad_to` rows (extra rows are
    copies of the MFT whose dumps are discarded) instead of pushing a
    "pad the seed list" error onto the user.
    """
    if mesh == "none" or len(jax.devices()) <= 1:
        return Stepper(params, dtype, dt_mode=dt_mode, debug_checks=debug_checks), n_runs
    from .parallel.sharded import MeshStepper

    n_dev = len(jax.devices())
    n_proc = jax.process_count()
    best, pad_to = None, n_runs
    if mesh == "space":
        # forced spatial decomposition: every device shards the grid, the
        # stream batch rides unsharded on a size-1 stream axis
        if params.dims >= 2:
            best = (1, n_dev)
    else:
        # prefer stream-axis data parallelism when the run count divides
        # evenly; prefer whole streams per process, but fall back to
        # cross-host grids (the dump path gathers over space axes)
        for whole_streams in (True, False) if n_proc > 1 else (True,):
            for n_stream in range(min(n_dev, n_runs), 0, -1):
                if n_runs % n_stream == 0 and n_dev % n_stream == 0:
                    n_space = n_dev // n_stream
                    if n_space == 1 or (
                        params.dims >= 2 and params.size % n_space == 0
                    ):
                        if whole_streams and n_proc > 1 and n_stream % n_proc:
                            continue
                        best = (n_stream, n_space)
                        break
            if best is not None:
                break
        if best is None:
            # pad the batch up to the next multiple of a workable stream axis
            for n_stream in range(min(n_dev, n_runs + n_dev), 0, -1):
                if n_dev % n_stream:
                    continue
                n_space = n_dev // n_stream
                if n_space > 1 and (params.dims < 2 or params.size % n_space):
                    continue
                best = (n_stream, n_space)
                pad_to = -(-n_runs // n_stream) * n_stream
                break
    if best is None:
        log.warning("mesh=auto: no workable layout; running single-device")
        return Stepper(params, dtype, dt_mode=dt_mode, debug_checks=debug_checks), n_runs
    import numpy as _np
    from jax.sharding import Mesh

    from .parallel.mesh import SPACE2_AXIS, SPACE_AXIS, STREAM_AXIS

    # Split the space factor into a 2-D pencil (px, py) when the grid is
    # 3-D: px >= py, both dividing the grid size. py == 1 degenerates to a
    # slab. A pencil scales to px*py devices (vs `size` for a slab) and
    # quarters the per-stage all_to_all message size.
    n_stream, n_space = best
    px, py = n_space, 1
    if params.dims == 3:
        for cand in range(int(n_space**0.5), 0, -1):
            if n_space % cand == 0 and params.size % cand == 0 and params.size % (
                n_space // cand
            ) == 0:
                px, py = n_space // cand, cand
                break
    devs = _np.asarray(jax.devices()).reshape(n_stream, px, py)
    m = Mesh(devs, (STREAM_AXIS, SPACE_AXIS, SPACE2_AXIS))
    log.info(
        "mesh=auto: (stream=%d, x=%d, y=%d) over %d devices%s",
        n_stream,
        px,
        py,
        n_dev,
        f", batch padded {n_runs}->{pad_to}" if pad_to != n_runs else "",
    )
    return (
        MeshStepper(params, m, dtype, dt_mode=dt_mode, debug_checks=debug_checks),
        pad_to,
    )


def run_single(
    params: SimulationParameters,
    dtype=jnp.complex64,
    data_root: str = "sim-data",
    verbose: bool = False,
    test_only: bool = False,
    resume: bool = False,
    strict_alias: bool = True,
    writer: Optional[AsyncGridWriter] = None,
    dt_mode: str = "optimistic",
    backend=None,
    use_remote_storage: bool = True,
    debug_checks: bool = False,
    check_eps: float | None = None,
) -> SimState:
    """Run one simulation to completion, dumping psi at every boundary."""
    eps = _resolve_check_eps(check_eps, dtype)
    stepper = Stepper(params, dtype, dt_mode=dt_mode, debug_checks=debug_checks)
    own_backend = backend is None and use_remote_storage
    if own_backend:
        backend = storage_backend_for(params, data_root, writer)
        own_backend = backend is not None
    run = SimulationRun(params, data_root, writer, backend=backend)

    start_dump = 0
    if resume:
        manifest = load_manifest(run.dir)
        if manifest is not None and manifest["current_dumps"] > 0:
            start_dump = manifest["current_dumps"]
            psi0 = run.load_psi(start_dump)
            state = stepper.init_state(psi0)
            state = dataclasses.replace(
                state,
                time=jnp.asarray(manifest["time"], stepper.tdtype),
                tau=jnp.asarray(manifest["tau"], stepper.tdtype),
                a=jnp.asarray(manifest["a"], stepper.tdtype),
                current_dumps=jnp.asarray(start_dump, jnp.int32),
                n_steps=jnp.asarray(manifest["n_steps"], jnp.int32),
            )
            log.info("resuming %s from dump %d", params.sim_name, start_dump)
        else:
            resume = False
    if not resume:
        psi0 = build_ics(params)
        if params.sampling is not None:
            psi0 = sample_quantum_perturbation(
                jnp.asarray(psi0, dtype),
                params,
                params.sampling.seed,
                params.sampling.scheme,
            )
        state = stepper.init_state(psi0)

    if verbose:
        from .constants import HBAR, POIS_CONST

        print(f"\nWorking on simulation {params.sim_name}")
        print(f"Simulation Parameters\n{params}")
        print(f"Physical Constants\nHBAR = {HBAR:.5e}\nPOIS_CONSTANT = {POIS_CONST:.5e}")

    if test_only:
        return state

    own_writer = writer is None
    if own_writer:
        writer = AsyncGridWriter()
        run.writer = writer

    t_start = _time.monotonic()
    try:
        if not resume:
            run.dump_field(np.asarray(state.psi), 0)
            if params.output_potential:
                run.dump_field(np.asarray(stepper.potential(state.psi)), 0, "potential")
            run.write_manifest(_state_scalars(state))

        kblock = _interval_block_k(params, 1, dtype, stepper)
        want_pot = bool(params.output_potential)
        prev_steps = int(np.asarray(state.n_steps))

        def _advance(s):
            # One dispatch advances kblock dump intervals (lax.scan) and
            # returns their stacked dump payloads — the per-dump host round
            # trip is paid once per block. snap (inside the scan body) is
            # just_dumped-gated, so it is a no-op on alias-aborted
            # mid-interval states.
            return stepper.evolve_intervals(s, kblock, with_potential=want_pot)

        speculate = _speculation_ok(params, 1, dtype, kblock)
        inflight = _advance(state) if stepper.not_finished(state) else None
        aborted = False
        while inflight is not None:
            state, outs = inflight
            # Dispatch block i+1 BEFORE any host-blocking fetch of block
            # i's results: the device executes in order, so the psi
            # transfers + npy writes below overlap with i+1's compute.
            # A wrong speculation (final block or alias abort) costs one
            # no-op dispatch — the evolve while_loop's condition fails
            # immediately on finished/aliased states and snap no-ops.
            # Big states dispatch synchronously instead (_speculation_ok).
            # NB: the dispatch DONATES `state` (stepper.evolve_intervals),
            # so from here on this iteration reads only `outs`; the
            # finished check below is outs-based for the same reason.
            speculative = _advance(state) if speculate else None
            # one host fetch per payload leaf (no per-row device indexing)
            host = {name: np.asarray(v) for name, v in outs.items()}
            jd, al = host["just_dumped"], host["aliased"]
            for j in range(kblock):
                scalars = {
                    "current_dumps": int(host["current_dumps"][j]),
                    "time": float(host["time"][j]),
                    "tau": float(host["tau"][j]),
                    "a": float(host["a"][j]),
                    "n_steps": int(host["n_steps"][j]),
                    "aliased": bool(al[j]),
                    "replays": int(host["replays"][j]),
                }
                if al[j]:
                    run.write_manifest(scalars)
                    _report_aliasing(
                        params, float(host["alias_mass"][j]), strict_alias
                    )
                    aborted = True
                    break
                if not jd[j]:
                    continue  # post-finish no-op interval
                if debug_checks:
                    err = float(host["max_norm_err"][j])
                    if not err < eps:
                        raise FloatingPointError(
                            f"in-step unitarity violation in {params.sim_name}: "
                            f"max |norm/norm0 - 1| = {err:.3g}"
                        )
                    # record the running in-jit unitarity monitor alongside
                    # the resume state (observability: drift vs check_norm
                    # budgets without re-reading dumps)
                    scalars["max_norm_err"] = err
                idx = scalars["current_dumps"]
                run.dump_field(host["psi"][j], idx)
                if want_pot:
                    run.dump_field(host["pot"][j], idx, "potential")
                scalars["wall_time_ms"] = (_time.monotonic() - t_start) * 1e3
                run.write_manifest(scalars)
                if verbose:
                    print(
                        f"({params.sim_name}) dump {idx}/{params.num_data_dumps} "
                        f"t = {scalars['time']:.6g}"
                        + _telemetry_suffix(
                            scalars["n_steps"] - prev_steps,
                            float(host["dt_min"][j]),
                            float(host["dt_max"][j]),
                            scalars["replays"],
                        )
                    )
                prev_steps = scalars["n_steps"]
            finished = aborted or (
                int(host["current_dumps"][-1]) >= params.num_data_dumps
                or bool(host["aliased"][-1])
            )
            if finished:
                if speculative is not None:
                    # the speculative dispatch consumed (donated) `state`;
                    # its output IS the final state (a finished/aliased
                    # state's evolve is a bit-exact no-op)
                    state, _ = speculative
                inflight = None
            else:
                inflight = speculative if speculate else _advance(state)
    finally:
        try:
            if own_writer:
                writer.close()
        finally:
            if own_backend:
                # drain the backend's own upload pool and surface any
                # stashed upload failure — run_single returning implies
                # remote dumps are durable, like the local writer's close
                backend.close()
    return state


def run_config(
    toml: TomlParameters,
    dtype=jnp.complex64,
    data_root: str = "sim-data",
    verbose: bool = False,
    test_only: bool = False,
    batch_streams: bool = True,
    strict_alias: bool = False,
    online_synthesis: bool = False,
    resume: bool = False,
    dt_mode: str = "optimistic",
    debug_checks: bool = False,
    check_eps: Optional[float] = None,
    profile_dir: Optional[str] = None,
    mesh: str = "none",
    use_remote_storage: bool = True,
) -> Sequence[SimState]:
    """Run every stream of a config plus the MFT.

    With `batch_streams` (default) the whole ensemble advances as one
    batched state; otherwise runs are sequential like the reference.
    With `online_synthesis` the `-combined/` ensemble averages and the Qx
    series are reduced on-device at every dump boundary during the run
    (synthesis.OnlineCombiner), so no offline synthesize pass is needed.
    With `resume`, every run restarts from its checkpoint manifest + last
    psi dump (the reference cannot do this: its dumps lack counter state,
    SURVEY.md §5).
    """
    all_params = list(iter_stream_parameters(toml))
    eps = _resolve_check_eps(check_eps, dtype)
    if online_synthesis and (not batch_streams or len(all_params) == 1):
        raise ValueError("online synthesis requires batched streams")
    backend = (
        storage_backend_for(toml, data_root) if use_remote_storage else None
    )
    # a single run stays on the reference-like sequential path unless a
    # device mesh was requested (mesh="space" shards even one run's grid)
    if not batch_streams or (len(all_params) == 1 and mesh == "none"):
        states = []
        try:
            with AsyncGridWriter() as writer:
                for p in all_params:
                    states.append(
                        run_single(
                            p,
                            dtype,
                            data_root,
                            verbose,
                            test_only,
                            resume=resume,
                            strict_alias=strict_alias and len(all_params) == 1,
                            writer=writer,
                            dt_mode=dt_mode,
                            backend=backend,
                            use_remote_storage=use_remote_storage,
                            debug_checks=debug_checks,
                            check_eps=check_eps,
                        )
                    )
        finally:
            if backend is not None:
                backend.close()
        return states

    # ---------------- batched ensemble path ----------------
    mft_params = all_params[-1]
    stream_params = all_params[:-1]
    stepper, pad_to = _make_stepper(
        mft_params, dtype, dt_mode, mesh, len(all_params), debug_checks=debug_checks
    )
    runs = [SimulationRun(p, data_root, backend=backend) for p in all_params]

    resumed_state = (
        _try_resume_batch(runs, stepper, pad_to) if resume else None
    )
    if resumed_state is not None:
        state = resumed_state
        if verbose:
            print(
                f"Resuming batch of {len(all_params)} from dumps "
                f"{np.asarray(state.current_dumps).tolist()}"
            )
    else:
        resume = False
        base_psi = jnp.asarray(build_ics(mft_params), dtype)
        if stream_params:
            seeds = jnp.asarray(
                [p.sampling.seed for p in stream_params], jnp.uint32
            )
            scheme = stream_params[0].sampling.scheme
            sampled = sample_stream_batch(base_psi, mft_params, seeds, scheme)
        else:  # MFT-only config on a device mesh (mesh="space")
            sampled = jnp.zeros((0,) + base_psi.shape, base_psi.dtype)
        n_pad = pad_to - len(all_params)

        @jax.jit
        def assemble(streams, base):
            # streams + MFT (+ MFT copies padding the batch to the mesh)
            return jnp.concatenate(
                [streams, jnp.broadcast_to(base[None], (1 + n_pad,) + base.shape)],
                axis=0,
            )

        state = stepper.init_state(assemble(sampled, base_psi), batched=True)

    if verbose and not resume:
        scheme_txt = (
            f"{stream_params[0].sampling.scheme} " if stream_params else ""
        )
        print(
            f"Running {len(stream_params)} {scheme_txt}"
            f"streams + MFT as one batch of {len(all_params)}"
        )
    if test_only:
        return [state]

    n = len(all_params)
    # a stream already frozen at resume time was reported (and its
    # manifest written) by the original run — re-reporting it here would
    # log/raise with the fresh state's alias_mass of 0.0 (manifests do
    # not carry the offending mass)
    if resume and getattr(state.aliased, "is_fully_addressable", True):
        resumed_aliased = np.asarray(state.aliased)
        reported_alias = [bool(resumed_aliased[i]) for i in range(n)]
    else:
        # multihost: the aliased leaf is stream-sharded (a local shard's
        # indices are not global stream indices) — keep the conservative
        # re-report rather than misalign
        reported_alias = [False] * n
    t_start = _time.monotonic()
    from .utils.profiling import ProgressReporter, StepTimer, profiler_trace

    progress = ProgressReporter(
        total_dumps=toml.num_data_dumps, sim_name=toml.sim_name, enabled=verbose
    )
    timer = StepTimer(cells_per_step=n * toml.size**toml.dims)
    timer.start()
    # the backend (own upload pool) closes LAST on every exit path —
    # exceptions included — so queued remote PUTs drain and stashed
    # upload failures surface instead of dying with the interpreter
    with _closing(backend), AsyncGridWriter() as writer, profiler_trace(
        profile_dir
    ):
        for r in runs:
            r.writer = writer

        combiner = None
        if online_synthesis:
            from .synthesis import online_combiner_for

            combiner = online_combiner_for(toml, data_root, writer)

        process0 = jax.process_index() == 0

        def combine_dump(valid_streams: np.ndarray, dump_idx: int):
            # weights: streams that produced this dump; the MFT (last batch
            # element) never participates in the ensemble average. The
            # reduction is collective (runs on every process); only process
            # 0 writes the combined files.
            if combiner is None or not valid_streams[: n - 1].any():
                return
            # only the real sampled streams (global index < n-1) are ever
            # averaged: the MFT sits at n-1 and internal padding rows
            # (mesh=auto, single-host views are NOT truncated to n) at
            # >= n — masking just the last element of valid_streams would
            # zero a padding row and average in the MFT + its copies
            weights = np.zeros(state.psi.shape[0], bool)
            m = min(len(valid_streams), n - 1)
            weights[:m] = valid_streams[:m]
            psi_dev = state.psi
            if jax.process_count() > 1 and getattr(stepper, "shard_space", False):
                # replicate grids over space axes so the combined outputs
                # are fully addressable on the writing process
                psi_dev = stepper.gather_spatial(state.psi)
            combiner.on_dump(psi_dev, weights, dump_idx, write=process0)

        def dump_potentials(mask: np.ndarray, dumps_idx: np.ndarray, owned):
            """Dump phi for runs with output_potential (simulation_object.rs:1166-1180)."""
            if not toml.output_potential:
                return
            pot = stepper.potential(state.psi)
            if jax.process_count() > 1:
                from .parallel.mesh import fetch_batch_slices

                if getattr(stepper, "shard_space", False):
                    pot = stepper.gather_spatial(pot)
                pots = fetch_batch_slices(pot, list(owned))
            else:
                pot_np = np.asarray(pot)
                pots = {i: pot_np[i] for i in owned}
            for i in owned:
                if mask[i]:
                    arr = pots[i]
                    cdtype = np.complex64 if arr.dtype == np.float32 else np.complex128
                    runs[i].dump_field(arr.astype(cdtype), int(dumps_idx[i]), "potential")

        if not resume:
            view = _EnsembleHostView(state, n, stepper=stepper)
            for i in view.owned:
                runs[i].dump_field(view.psi(i), 0)
                runs[i].write_manifest(view.run_scalars(i))
            dump_potentials(np.ones(n, bool), np.zeros(n, int), view.owned)
            combine_dump(np.ones(n, bool), 0)

        total_steps = 0
        # seed from the resumed counters (run_single does the same) so the
        # first telemetry suffix reports this interval's steps, not the
        # whole historical count of a resumed run
        if resume:
            from .parallel.mesh import host_local_value

            prev_steps_batch = int(host_local_value(state.n_steps).max())
        else:
            prev_steps_batch = 0

        # Interval blocking (k dump intervals per dispatch, see
        # stepper.evolve_intervals): single-process plain-Stepper runs —
        # the dominant production shape — fetch k dumps per host round
        # trip. Online synthesis rides the SAME path: the `-combined/`
        # reductions travel in the scan payload (Stepper._combine_row), so
        # a combiner no longer forces the one-interval host loop — on the
        # mesh too (MeshStepper.evolve_intervals psums the combine row over
        # the stream axis and gathers the mean fields with the dump planes;
        # every process reads them from the payload, process 0 writes).
        # Only multi-process plain-Stepper layouts (kblock forced to 1)
        # keep the one-interval loop below.
        from .parallel.sharded import MeshStepper as _MeshStepper

        combine_cfg = None
        if combiner is not None and (
            type(stepper) is Stepper
            and jax.process_count() == 1
            or isinstance(stepper, _MeshStepper)
        ):
            combine_cfg = (n, combiner.dv)
        kblock = (
            _interval_block_k(
                mft_params,
                int(state.psi.shape[0]),
                dtype,
                stepper,
                online=combine_cfg is not None,
            )
            if combiner is None or combine_cfg is not None
            else 1
        )
        if kblock > 1:
            want_pot = bool(toml.output_potential)

            def _advance_blocks(s):
                return stepper.evolve_intervals(
                    s, kblock, with_potential=want_pot, combine=combine_cfg
                )

            speculate = _speculation_ok(
                mft_params, int(state.psi.shape[0]), dtype, kblock
            )
            inflight = _advance_blocks(state) if stepper.not_finished(state) else None
            while inflight is not None:
                state, outs = inflight
                # dispatch block i+1 before block i's host fetches (same
                # speculation-safety argument as the one-interval loop);
                # big states dispatch synchronously (_speculation_ok)
                # NB: the dispatch DONATES `state`; this iteration reads
                # only the payload view from here on (finished check incl.)
                speculative = _advance_blocks(state) if speculate else None
                view = _BlockedOutsView(outs, n, want_pot)
                owned = set(view.owned)
                for j in range(kblock):
                    jd = view.scalar("just_dumped")[j]
                    al = view.scalar("aliased")[j]
                    # skip rows with nothing to do: no dumps and no NEWLY
                    # aliased stream (the latched aliased flag stays True
                    # on every row after a freeze)
                    if not (
                        jd[:n].any()
                        or (al[:n] & ~np.asarray(reported_alias)).any()
                    ):
                        continue  # post-finish / frozen no-op interval
                    total_steps = max(
                        total_steps, int(view.scalar("n_steps")[j].max())
                    )
                    dumps_j = view.scalar("current_dumps")[j]

                    def row_scalars(i, j=j, dumps_j=dumps_j, al=al):
                        return {
                            "current_dumps": int(dumps_j[i]),
                            "time": float(view.scalar("time")[j][i]),
                            "tau": float(view.scalar("tau")[j][i]),
                            "a": float(view.scalar("a")[j][i]),
                            "n_steps": int(view.scalar("n_steps")[j][i]),
                            "aliased": bool(al[i]),
                            "replays": int(view.scalar("replays")[j][i]),
                        }

                    for i in range(n):
                        r = runs[i]
                        if al[i]:
                            if not reported_alias[i]:
                                reported_alias[i] = True
                                # The strict abort must raise on EVERY
                                # process (the alias scalars are replicated):
                                # an owner-only raise leaves the peers
                                # blocked in the next collective dispatch —
                                # a distributed hang instead of an abort.
                                # Non-strict logging + manifest stay
                                # owner-only.
                                # manifest BEFORE the (possibly raising)
                                # strict report: a resume after the abort
                                # must see aliased=True + final counters,
                                # not restart the stream into the same
                                # abort (run_single's order, :663-666)
                                if i in owned:
                                    r.write_manifest(row_scalars(i))
                                if i in owned or strict_alias:
                                    _report_aliasing(
                                        all_params[i],
                                        float(view.scalar("alias_mass")[j][i]),
                                        strict_alias,
                                    )
                            continue
                        if not jd[i] or i not in owned:
                            continue
                        psi_ji = view.psi(j, i)
                        if debug_checks:
                            _debug_validate(
                                psi_ji, all_params[i], f"{r.params.sim_name} dump", eps
                            )
                            err = float(view.scalar("max_norm_err")[j][i])
                            if not err < eps:
                                raise FloatingPointError(
                                    f"in-step unitarity violation in "
                                    f"{r.params.sim_name}: max |norm/norm0 - 1| "
                                    f"= {err:.3g} during the last dump interval"
                                )
                        r.dump_field(psi_ji, int(dumps_j[i]))
                        scalars = row_scalars(i)
                        if debug_checks:
                            scalars["max_norm_err"] = err
                        scalars["wall_time_ms"] = (_time.monotonic() - t_start) * 1e3
                        r.write_manifest(scalars)
                        if want_pot:
                            r.dump_field(
                                view.pot(j, i).astype(psi_ji.dtype),
                                int(dumps_j[i]),
                                "potential",
                            )
                    if combine_cfg is not None and process0:
                        valid = jd[: n - 1] & ~al[: n - 1]
                        if valid.any() and float(view.scalar("comb_n")[j]) > 0:
                            combiner.write_row(
                                {
                                    name: view.scalar(name)[j]
                                    for name in view.scal
                                    if name.startswith("comb_")
                                },
                                int(dumps_j[int(np.flatnonzero(valid)[0])]),
                            )
                    done = int(dumps_j[:n].min())
                    steps_j = view.scalar("n_steps")[j][:n]
                    extra = _telemetry_suffix(
                        int(steps_j.max()) - prev_steps_batch,
                        float(view.scalar("dt_min")[j][:n].min()),
                        float(view.scalar("dt_max")[j][:n].max()),
                        int(view.scalar("replays")[j][:n].sum()),
                    )
                    prev_steps_batch = max(prev_steps_batch, int(steps_j.max()))
                    if toml.cosmology is not None:
                        progress.update(
                            done,
                            redshift=1.0 / float(view.scalar("a")[j][:n].min()) - 1.0,
                            extra=extra,
                        )
                    else:
                        progress.update(
                            done,
                            sim_time=float(view.scalar("time")[j][:n].min()),
                            extra=extra,
                        )
                dumps_last = view.scalar("current_dumps")[-1]
                al_last = view.scalar("aliased")[-1]
                if bool(
                    np.all((dumps_last >= mft_params.num_data_dumps) | al_last)
                ):
                    if speculative is not None:
                        # adopt the no-op speculative output: its input
                        # (the final state) was donated to it
                        state, _ = speculative
                    inflight = None
                else:
                    inflight = (
                        speculative if speculate else _advance_blocks(state)
                    )

        def _advance_batched(s):
            raw = stepper.evolve_to_next_dump(s, batched=True)
            return raw, stepper.snap_after_dump(raw)

        # the one-interval fallback's speculation is budgeted like the
        # blocked path's (its evolve entry does NOT donate — the loop
        # re-reads the state — so TWO resident states plus payloads)
        speculate1 = _speculation_ok(
            mft_params, int(state.psi.shape[0]), dtype, 1, donated=False
        )
        inflight = (
            _advance_batched(state)
            if kblock == 1 and stepper.not_finished(state)
            else None
        )
        while inflight is not None:
            raw, state = inflight
            # Dispatch interval i+1 BEFORE the host-blocking fetches below:
            # the per-stream psi transfers + npy writes overlap with i+1's
            # compute (see the single-run loop for the speculation safety
            # argument — evolve no-ops on finished/aliased states).
            # Big states dispatch synchronously instead (_speculation_ok).
            speculative = _advance_batched(state) if speculate1 else None
            pre_view = _EnsembleHostView(raw, n, fetch_psi=False)
            total_steps = int(np.asarray(pre_view.scalar("n_steps")).max())
            aliased = pre_view.scalar("aliased")
            just_dumped = pre_view.scalar("just_dumped")
            view = _EnsembleHostView(state, n, stepper=stepper)
            dumps_np = view.scalar("current_dumps")
            for i in view.owned:
                r = runs[i]
                if aliased[i]:
                    if not reported_alias[i]:
                        reported_alias[i] = True
                        # manifest before the (possibly raising) strict
                        # report — see the blocked loop
                        r.write_manifest(view.run_scalars(i))
                        _report_aliasing(
                            all_params[i],
                            float(view.scalar("alias_mass")[i]),
                            strict_alias,
                        )
                    continue
                if just_dumped[i]:
                    if debug_checks:
                        _debug_validate(
                            view.psi(i), all_params[i], f"{r.params.sim_name} dump", eps
                        )
                        err = float(view.scalar("max_norm_err")[i])
                        if not err < eps:
                            raise FloatingPointError(
                                f"in-step unitarity violation in "
                                f"{r.params.sim_name}: max |norm/norm0 - 1| "
                                f"= {err:.3g} during the last dump interval"
                            )
                    r.dump_field(view.psi(i), int(dumps_np[i]))
                    scalars = view.run_scalars(i)
                    if debug_checks:
                        scalars["max_norm_err"] = err
                    scalars["wall_time_ms"] = (_time.monotonic() - t_start) * 1e3
                    r.write_manifest(scalars)
            if strict_alias:
                # Strict abort must fire on EVERY process, not just the
                # stream's owner (the aliased/alias_mass scalars are
                # replicated): an owner-only raise leaves the peers blocked
                # in the next collective dispatch. Owners raised inside the
                # loop above; this covers the streams this process does not
                # own.
                owned_set = set(view.owned)
                for i in range(n):
                    if aliased[i] and not reported_alias[i] and i not in owned_set:
                        _report_aliasing(
                            all_params[i],
                            float(view.scalar("alias_mass")[i]),
                            True,
                        )
            if just_dumped.any():
                dump_potentials(just_dumped & ~aliased, dumps_np, view.owned)
                combine_dump(
                    just_dumped & ~aliased, int(dumps_np[just_dumped.argmax()])
                )
            done = int(dumps_np.min())
            # [:n]: single-host views are not truncated — padding rows are
            # MFT copies whose replays would inflate the sum (the blocked
            # loop already slices [:n])
            extra = _telemetry_suffix(
                total_steps - prev_steps_batch,
                float(np.asarray(pre_view.scalar("dt_min"))[:n].min()),
                float(np.asarray(pre_view.scalar("dt_max"))[:n].max()),
                int(np.asarray(pre_view.scalar("replays"))[:n].sum()),
            )
            prev_steps_batch = max(prev_steps_batch, total_steps)
            if toml.cosmology is not None:
                progress.update(
                    done,
                    redshift=1.0 / float(view.scalar("a").min()) - 1.0,
                    extra=extra,
                )
            else:
                progress.update(
                    done, sim_time=float(view.scalar("time").min()), extra=extra
                )
            if not stepper.not_finished(state):
                inflight = None
            else:
                inflight = (
                    speculative
                    if speculative is not None
                    else _advance_batched(state)
                )
        if combiner is not None and process0:
            combiner.finalize()
        timer.stop(n_steps=total_steps)
        if verbose:
            print(timer.summary(), flush=True)
        progress.finish()
    if jax.process_count() > 1:
        # Returning from run_config on ANY process implies EVERY process's
        # outputs (dumps, manifests, combined fields, Qx) are durable: the
        # async writer pool drained at the `with` exit above and process-0-
        # only writes (combiner.finalize) happened before it, so one global
        # barrier gives peers read-your-peers'-writes semantics on a shared
        # filesystem (e.g. an immediate synthesize pass over the run).
        # Without it a fast peer can race a slower writer — observed when
        # the blocked-payload fetch got cheaper on non-zero processes.
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("msm_tpu.run_config.done")
    return [state]


def run_toml(
    toml: TomlParameters,
    dtype=jnp.complex64,
    **kwargs,
):
    """Entry point matching `msm-simulator --toml` semantics."""
    return run_config(toml, dtype, **kwargs)
