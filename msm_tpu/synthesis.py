"""Ensemble synthesis: reduce per-stream dumps into ensemble averages.

Counterpart of the `msm-synthesizer` crate
(`synthesizer/src/main.rs`, `synthesizer/src/lib.rs:106-609`):

- `analyze_sims`: for every dump, average registered per-stream functions
  (psi, |psi|^2, psik, |psik|^2 by default — `main.rs:63-93`) over all
  streams and write them to `{sim}-combined/{name}_{dump:05}_{real,imag}`.
- `post_combine`: evaluate post-combine scalars on the combined fields —
  by default the quantum-breaking measure
  Qx = sum(<|psi|^2> - |<psi>|^2) * dV (`main.rs:161-173`) — and write each
  series as `{sim}-combined/{name}_{real,imag}`.

Where the reference fans dumps over MPI ranks and streams over threads with
a hand-rolled Balancer (`balancer.rs`), this build stacks streams into a
device batch and reduces with one jitted `mean` per dump (chunked to bound
memory); multi-host operation shards the dump list by process index
(`parallel.mesh.local_dump_range`).

File-format quirk preserved deliberately: the reference synthesizer
recomputes psik with UNnormalized per-axis FFTs (`lib.rs:206-213`) even
though the simulator dumps ortho-normalized fields, so combined psik/psik2
differ from the simulator convention by N^(d/2) powers. We match the
synthesizer's output convention for file parity (SURVEY.md §7).
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .config import (
    TomlParameters,
    determine_pmass_hbar,
    get_supercomoving_boxsize,
)
from .io.npy import AsyncGridWriter, load_complex_pair, write_complex_pair

# Streams are reduced in device batches of this many grids to bound memory.
DEFAULT_STREAM_CHUNK = 16

ArrayFn = Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]
ScalarFn = Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]
PostArrayFn = Callable[
    [np.ndarray, np.ndarray, np.ndarray, np.ndarray], np.ndarray
]
PostScalarFn = Callable[..., complex]


def _host_complex(x) -> np.ndarray:
    """Fetch a device array as a complex host array (real results gain a
    zero imaginary part: every combined field is written as a pair)."""
    arr = np.asarray(x)
    if np.iscomplexobj(arr):
        return arr
    return arr.astype(np.complex64 if arr.dtype == np.float32 else np.complex128)


def default_array_functions() -> dict[str, ArrayFn]:
    """The reference's array reduction registry (`main.rs:63-93`)."""
    return {
        "psi": lambda psi, psik: psi,
        "psi2": lambda psi, psik: psi * jnp.conj(psi),
        "psik": lambda psi, psik: psik,
        "psik2": lambda psi, psik: psik * jnp.conj(psik),
    }


def qx_post_scalar(dv: float) -> PostScalarFn:
    """Qx = sum(<|psi|^2> - |<psi>|^2) * dV (`main.rs:161-173`)."""

    def qx(dump, psi, psi2, psik, psik2):
        return complex(np.sum(psi2 - psi * np.conj(psi)) * dv)

    return qx


@dataclass
class SynthesisFunctions:
    """Function registry (reference `Functions` + `PostCombineFunctions`,
    `lib.rs:632-1063`, `main.rs:61-187`).

    - ``array_functions``: per-stream (psi, psik) -> array, averaged over
      streams per dump, written `{name}_{dump:05}` (`main.rs:63-93`).
    - ``scalar_functions``: per-stream (psi, psik) -> complex scalar,
      averaged over streams per dump, written `{name}_{dump:05}` with
      shape (1,1,1,1) (`main.rs:96-110`, `lib.rs:242-331`; empty by
      default — the extension point the reference's commented-out Qk used).
    - ``post_array_functions``: (psi, psi2, psik, psik2) -> array per dump,
      written `{name}_{dump:05}` (`main.rs:133-146`; the reference left the
      dump body as todo!(), `lib.rs:421-433` — implemented here).
    - ``post_scalar_functions``: (dump, psi, psi2, psik, psik2) -> complex,
      collected into a `{name}` time series (`main.rs:148-173`).
    """

    array_functions: dict[str, ArrayFn] = field(default_factory=default_array_functions)
    scalar_functions: dict[str, ScalarFn] = field(default_factory=dict)
    post_array_functions: dict[str, PostArrayFn] = field(default_factory=dict)
    post_scalar_functions: dict[str, PostScalarFn] = field(default_factory=dict)


def _unnormalized_fft(psi: jnp.ndarray, dims: int) -> jnp.ndarray:
    """Per-axis unnormalized FFT, matching ndrustfft::ndfft (`lib.rs:206-213`)."""
    return jnp.fft.fftn(psi, axes=tuple(range(-dims, 0)), norm="backward")


def find_stream_dirs(sim_base: str) -> list[str]:
    """Glob `{sim_base}-stream*/` (reference `lib.rs:185-188`)."""
    dirs = sorted(
        d for d in glob.glob(f"{sim_base}-stream*") if os.path.isdir(d)
    )
    return dirs


def combined_dir(sim_base: str) -> str:
    out = f"{sim_base}-combined"
    os.makedirs(out, exist_ok=True)
    return out


def analyze_sims(
    functions: SynthesisFunctions,
    sim_base: str,
    dumps: Sequence[int],
    dims: int,
    dtype=jnp.complex64,
    stream_chunk: int = DEFAULT_STREAM_CHUNK,
    writer: Optional[AsyncGridWriter] = None,
) -> None:
    """Average registered array functions over streams for each dump.

    Reference: `analyze_sims` (`synthesizer/src/lib.rs:106-342`).
    """
    stream_dirs = find_stream_dirs(sim_base)
    if not stream_dirs:
        raise FileNotFoundError(f"no stream directories match {sim_base}-stream*")
    out_dir = combined_dir(sim_base)

    names = list(functions.array_functions)
    scalar_names = list(functions.scalar_functions)

    @jax.jit
    def reduce_chunk(psi_chunk):
        psik_chunk = _unnormalized_fft(psi_chunk, dims)
        arrays = {
            name: jnp.sum(fn(psi_chunk, psik_chunk), axis=0)
            for name, fn in functions.array_functions.items()
        }
        # per-stream scalar reductions, summed over the chunk
        # (reference ScalarFunctions accumulation, lib.rs:242-262)
        scalars = {
            name: jnp.sum(
                jax.vmap(fn)(psi_chunk, psik_chunk)
            )
            for name, fn in functions.scalar_functions.items()
        }
        return arrays, scalars

    own_writer = writer is None
    if own_writer:
        writer = AsyncGridWriter()
    try:
        for dump in dumps:
            totals = {name: None for name in names}
            scalar_totals = {name: 0.0 + 0.0j for name in scalar_names}
            nsims = 0
            for lo in range(0, len(stream_dirs), stream_chunk):
                batch_dirs = stream_dirs[lo : lo + stream_chunk]
                grids = []
                for d in batch_dirs:
                    g = load_complex_pair(os.path.join(d, f"psi_{dump:05d}"))
                    size = g.shape[0]
                    grids.append(g.reshape((size,) * dims))
                psi_chunk = jnp.asarray(np.stack(grids), dtype)
                partial, partial_scalars = reduce_chunk(psi_chunk)
                for name in names:
                    totals[name] = (
                        partial[name]
                        if totals[name] is None
                        else totals[name] + partial[name]
                    )
                for name in scalar_names:
                    scalar_totals[name] += complex(
                        np.asarray(partial_scalars[name])
                    )
                nsims += len(batch_dirs)
            assert nsims > 0
            for name in names:
                avg = _host_complex(totals[name]) / nsims
                size = avg.shape[0]
                pad = (1,) * (4 - dims)
                avg4 = avg.reshape((size,) * dims + pad)
                writer.submit(os.path.join(out_dir, f"{name}_{dump:05d}"), avg4)
            for name in scalar_names:
                avg = np.asarray(scalar_totals[name] / nsims).reshape(1, 1, 1, 1)
                writer.submit(os.path.join(out_dir, f"{name}_{dump:05d}"), avg)
        writer.wait()
    finally:
        if own_writer:
            writer.close()


def _eval_post_dumps(
    functions: SynthesisFunctions, out_dir: str, dumps: Sequence[int]
) -> dict[str, dict[int, complex]]:
    """Evaluate post-combine functions on the combined fields of `dumps`.

    Post-array outputs are written immediately as `{name}_{dump:05d}`
    (implementing the extension point the reference left as todo!(),
    `lib.rs:421-433`); post-scalar values are returned per dump.
    """
    results: dict[str, dict[int, complex]] = {
        n: {} for n in functions.post_scalar_functions
    }
    for dump in dumps:
        fields = {
            name: load_complex_pair(os.path.join(out_dir, f"{name}_{dump:05d}"))
            for name in ("psi", "psi2", "psik", "psik2")
        }
        args = (fields["psi"], fields["psi2"], fields["psik"], fields["psik2"])
        for name, fn in functions.post_array_functions.items():
            arr = np.asarray(fn(*args))
            write_complex_pair(
                os.path.join(out_dir, f"{name}_{dump:05d}"),
                arr.reshape(arr.shape + (1,) * (4 - arr.ndim)),
            )
        for name, fn in functions.post_scalar_functions.items():
            results[name][dump] = complex(fn(dump, *args))
    return results


def _gather_scalar_series(
    local: dict[int, complex], all_dumps: Sequence[int]
) -> np.ndarray:
    """Assemble the full (sorted-by-dump) series from per-process chunks.

    Multi-process counterpart of the reference's MPI gather of
    `Scalar{dump, re, im}` payloads with round-robin leaders
    (`lib.rs:467-583`): every process contributes the dumps it owns and the
    merged series is available on every process (allgather instead of a
    gather-to-leader; the write still happens once, on process 0).
    """
    import jax

    n = len(all_dumps)
    index = {d: i for i, d in enumerate(all_dumps)}
    if jax.process_count() == 1:
        out = np.zeros(n, np.complex128)
        for d, v in local.items():
            out[index[d]] = v
        return out
    from jax.experimental import multihost_utils

    buf = np.zeros((n, 3))
    for d, v in local.items():
        buf[index[d]] = (v.real, v.imag, 1.0)
    gathered = np.asarray(
        multihost_utils.process_allgather(buf)
    ).reshape(jax.process_count(), n, 3)
    out = np.zeros(n, np.complex128)
    seen = np.zeros(n, bool)
    for pr in range(gathered.shape[0]):
        owned = gathered[pr, :, 2] > 0.0
        out[owned] = gathered[pr, owned, 0] + 1j * gathered[pr, owned, 1]
        seen |= owned
    assert seen.all(), "some dumps were produced by no process"
    return out


def post_combine(
    functions: SynthesisFunctions,
    sim_base: str,
    dumps: Sequence[int],
    all_dumps: Optional[Sequence[int]] = None,
) -> dict[str, np.ndarray]:
    """Evaluate post-combine functions on combined fields and write series.

    Reference: `post_combine` (`synthesizer/src/lib.rs:351-609`). The output
    series is shaped (n_dumps, 1, 1, 1) like the reference's non-MPI path
    (`lib.rs:586-605`). With `all_dumps` set (multi-process mode), `dumps`
    is this process's chunk: the scalar series is gathered across processes
    (`lib.rs:467-583`) and written by process 0 only.
    """
    import jax

    out_dir = combined_dir(sim_base)
    results = _eval_post_dumps(functions, out_dir, dumps)
    if all_dumps is None:
        all_dumps = list(dumps)
    out = {}
    write = jax.process_index() == 0
    for name in sorted(results):
        arr = _gather_scalar_series(results[name], all_dumps).reshape(-1, 1, 1, 1)
        if write:
            write_complex_pair(os.path.join(out_dir, name), arr)
        out[name] = arr
    return out


def volume_element(toml: TomlParameters) -> float:
    """dv = (L/N)^d, or the supercomoving version when expanding
    (`synthesizer/src/main.rs:51-58`)."""
    if toml.cosmology is not None:
        _, hbar_ = determine_pmass_hbar(toml)
        box = get_supercomoving_boxsize(hbar_, toml.cosmology, toml.axis_length)
        return (box / toml.size) ** toml.dims
    return (toml.axis_length / toml.size) ** toml.dims


def synthesize_toml(
    toml: TomlParameters,
    data_root: str = "sim-data",
    dtype=jnp.complex64,
    stream_chunk: int = DEFAULT_STREAM_CHUNK,
    dump_range: Optional[tuple[int, int]] = None,
    multihost: bool = False,
    functions: Optional[SynthesisFunctions] = None,
) -> dict[str, np.ndarray]:
    """Full synthesizer pipeline for a config (`synthesizer/src/main.rs:30-190`).

    `functions` overrides the default registry (array psi/psi2/psik/psik2 +
    the Qx post scalar) — the caller-registration shape of the reference's
    `main.rs:61-187`.

    `dump_range=(lo, hi)` restricts analyze_sims to dumps lo..=hi (the
    cluster-parallel shape of the reference's per-dump SLURM jobs,
    `gen_sbatch.py:6-51`) and skips the Qx post-combine unless the range
    covers every dump. `multihost` splits the dump list by process index
    (the Balancer's local_set, `balancer.rs:75-83`) and then gathers the
    post-combine scalar series across processes (`lib.rs:467-583`) — no
    separate `--post-only` pass is needed.
    """
    all_dumps = list(range(toml.num_data_dumps + 1))
    dumps = all_dumps
    if dump_range is not None:
        lo, hi = dump_range
        dumps = [d for d in all_dumps if lo <= d <= hi]
    elif multihost:
        from .parallel.mesh import local_dump_range

        dumps = list(local_dump_range(all_dumps))

    if functions is None:
        functions = SynthesisFunctions()
        functions.post_scalar_functions["Qx"] = qx_post_scalar(volume_element(toml))

    sim_base = os.path.join(data_root, toml.sim_name)
    analyze_sims(functions, sim_base, dumps, toml.dims, dtype, stream_chunk)
    if multihost:
        return post_combine(functions, sim_base, dumps, all_dumps=all_dumps)
    if dumps != all_dumps:
        return {}
    return post_combine(functions, sim_base, dumps)


def synthesize_post_only(
    toml: TomlParameters, data_root: str = "sim-data"
) -> dict[str, np.ndarray]:
    """Evaluate only the post-combine scalars from existing combined dumps
    (the final job of a cluster-parallel analysis, tools/jobs.py)."""
    functions = SynthesisFunctions()
    functions.post_scalar_functions["Qx"] = qx_post_scalar(volume_element(toml))
    sim_base = os.path.join(data_root, toml.sim_name)
    return post_combine(functions, sim_base, range(toml.num_data_dumps + 1))


# ---------------------------------------------------------------------------
# Online synthesis: combine during the batched run (no dump re-read)
# ---------------------------------------------------------------------------


class OnlineCombiner:
    """Ensemble reductions computed on-device at each dump boundary.

    The reference synthesizer is a second program that re-reads every stream
    dump from disk (`synthesizer/src/lib.rs:106-342`). When the ensemble
    runs as one batched state, the combined fields are a masked mean over
    the stream axis already resident on device — so this combiner evaluates
    psi / psi2 / psik / psik2 (and the Qx series) during the simulation and
    writes the identical `-combined/` layout, skipping the offline pass.

    Aliased (frozen) streams drop out of the average from the dump at which
    they aliased, via the validity weights.
    """

    def __init__(
        self,
        sim_base: str,
        dims: int,
        dv: float,
        writer: Optional[AsyncGridWriter] = None,
    ):
        self.dims = dims
        self.dv = dv
        self.out_dir = combined_dir(sim_base)
        self.writer = writer
        self.qx_series: dict[int, complex] = {}

        @jax.jit
        def combine(psi_streams, weights):
            w = weights.reshape((-1,) + (1,) * dims)
            n = jnp.maximum(jnp.sum(weights), 1.0)
            psik = _unnormalized_fft(psi_streams, dims)
            out = {
                "psi": jnp.sum(psi_streams * w, axis=0) / n,
                "psi2": jnp.sum(psi_streams * jnp.conj(psi_streams) * w, axis=0) / n,
                "psik": jnp.sum(psik * w, axis=0) / n,
                "psik2": jnp.sum(psik * jnp.conj(psik) * w, axis=0) / n,
            }
            return out

        self._combine = combine

    def on_dump(
        self, psi_streams, valid: np.ndarray, dump: int, write: bool = True
    ) -> None:
        """Reduce the (n_streams, *grid) device batch and write the dump.

        The reduction is a collective over any mesh the batch is sharded on
        — call from every process; pass write=True only on the one that
        owns the combined files (process 0 in multi-host runs)."""
        weights = jnp.asarray(valid.astype(np.float32 if psi_streams.dtype == jnp.complex64 else np.float64))
        fields = self._combine(psi_streams, weights)
        if not write:
            return
        host = {name: _host_complex(arr) for name, arr in fields.items()}
        self._write_fields(host, dump)
        self.qx_series[dump] = complex(
            np.sum(host["psi2"] - host["psi"] * np.conj(host["psi"])) * self.dv
        )

    def write_row(self, row: dict, dump: int) -> None:
        """Write one interval row of the IN-JIT combined payload
        (`Stepper._combine_row`, the blocked `--online-synthesis` path) in
        the identical `-combined/` layout `on_dump` produces."""
        fields = {
            name: _host_complex(row[f"comb_{name}"])
            for name in ("psi", "psi2", "psik", "psik2")
        }
        self._write_fields(fields, dump)
        self.qx_series[dump] = complex(float(np.asarray(row["comb_qx"])))

    def _write_fields(self, fields: dict, dump: int) -> None:
        """The one copy of the `-combined/` file layout (4-D padded npy
        pairs via the async writer when present) both the one-interval
        (`on_dump`) and blocked (`write_row`) paths share."""
        size = fields["psi"].shape[0]
        pad = (1,) * (4 - self.dims)
        for name, arr in fields.items():
            arr4 = arr.reshape((size,) * self.dims + pad)
            dest = os.path.join(self.out_dir, f"{name}_{dump:05d}")
            if self.writer is not None:
                self.writer.submit(dest, arr4)
            else:
                write_complex_pair(dest, arr4)

    def finalize(self) -> None:
        """Write the Qx time series (`synthesizer/src/main.rs:161-173`)."""
        if not self.qx_series:
            return
        dumps = sorted(self.qx_series)
        arr = np.asarray([self.qx_series[d] for d in dumps], np.complex128).reshape(
            len(dumps), 1, 1, 1
        )
        write_complex_pair(os.path.join(self.out_dir, "Qx"), arr)


def online_combiner_for(
    toml: TomlParameters,
    data_root: str = "sim-data",
    writer: Optional[AsyncGridWriter] = None,
) -> OnlineCombiner:
    if toml.cosmology is not None:
        _, hbar_ = determine_pmass_hbar(toml)
        box = get_supercomoving_boxsize(hbar_, toml.cosmology, toml.axis_length)
        dv = (box / toml.size) ** toml.dims
    else:
        dv = (toml.axis_length / toml.size) ** toml.dims
    return OnlineCombiner(
        os.path.join(data_root, toml.sim_name), toml.dims, dv, writer
    )
