"""Command-line interface.

Mirrors the reference binaries (`simulator/src/main.rs:9-17`,
`synthesizer/src/main.rs:18-28`):

    python -m msm_tpu simulate  --toml path.toml [--verbose] [--test]
    python -m msm_tpu synthesize --toml path.toml [--verbosity LEVEL]
    python -m msm_tpu bench ...

plus runtime flags replacing the reference's compile-time cargo features
(precision, stream batching, data root).
"""

from __future__ import annotations

import argparse
import logging
import sys
import time


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--toml", required=True, help="path to the simulation toml")
    p.add_argument(
        "--data-root", default="sim-data", help="output root (default sim-data)"
    )
    p.add_argument(
        "--precision",
        choices=("f32", "f64"),
        default="f32",
        help="runtime precision: f32 (complex64 state) or f64 (complex128)",
    )


def _dtype_for(precision: str):
    import jax
    import jax.numpy as jnp

    from .utils.cache import enable_compilation_cache

    enable_compilation_cache()
    if precision == "f64":
        jax.config.update("jax_enable_x64", True)
        return jnp.complex128
    return jnp.complex64


def cmd_simulate(args) -> int:
    from . import config as cfg
    from . import simulator

    dtype = _dtype_for(args.precision)
    toml = cfg.read_toml(args.toml)
    start = time.monotonic()
    simulator.run_config(
        toml,
        dtype=dtype,
        data_root=args.data_root,
        verbose=args.verbose,
        test_only=args.test,
        batch_streams=not args.sequential_streams,
        strict_alias=args.strict_alias,
        online_synthesis=args.online_synthesis,
        resume=args.resume,
        dt_mode="lagged" if args.fast_dt else args.dt_mode,
        debug_checks=args.debug_checks,
        check_eps=args.check_eps,
        profile_dir=args.profile_dir,
        mesh=args.mesh,
        use_remote_storage=not args.ignore_remote_storage,
    )
    n = cfg.stream_count(toml)
    if n > 1:
        print(f"Finished all streams in {time.monotonic() - start:.1f} seconds")
    return 0


# env_logger-style verbosity levels (synthesizer/src/main.rs:34-41 wires
# --verbosity straight into the logger); "trace" has no Python analogue
# below DEBUG so it maps to DEBUG.
_VERBOSITY_LEVELS = {
    "off": logging.CRITICAL + 10,
    "error": logging.ERROR,
    "warn": logging.WARNING,
    "info": logging.INFO,
    "debug": logging.DEBUG,
    "trace": logging.DEBUG,
}


def cmd_synthesize(args) -> int:
    from . import config as cfg
    from .synthesis import synthesize_post_only, synthesize_toml

    logging.getLogger().setLevel(_VERBOSITY_LEVELS[args.verbosity])
    if args.distributed:
        import jax

        jax.distributed.initialize()
    dtype = _dtype_for(args.precision)
    toml = cfg.read_toml(args.toml)
    if args.post_only:
        synthesize_post_only(toml, data_root=args.data_root)
        return 0
    dump_range = None
    if args.dump_range:
        lo, hi = args.dump_range.split(":")
        dump_range = (int(lo), int(hi))
    synthesize_toml(
        toml,
        data_root=args.data_root,
        dtype=dtype,
        dump_range=dump_range,
        multihost=args.multihost,
    )
    return 0


def cmd_bench(args) -> int:
    from .utils import benchmarks

    benchmarks.main(args)
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="msm_tpu")
    sub = parser.add_subparsers(dest="command", required=True)

    sim = sub.add_parser("simulate", help="run the simulator (msm-simulator)")
    _add_common(sim)
    sim.add_argument("--verbose", "-v", action="store_true")
    sim.add_argument(
        "--test", action="store_true", help="construct sims without evolving"
    )
    sim.add_argument(
        "--sequential-streams",
        action="store_true",
        help="run streams one-by-one (reference semantics) instead of batched",
    )
    sim.add_argument(
        "--strict-alias",
        action="store_true",
        help="abort on Fourier aliasing instead of freezing the stream",
    )
    sim.add_argument(
        "--online-synthesis",
        action="store_true",
        help="reduce -combined/ ensemble averages on-device during the run",
    )
    sim.add_argument(
        "--resume",
        action="store_true",
        help="resume every run from its checkpoint manifest + last dump",
    )
    sim.add_argument(
        "--dt-mode",
        choices=("optimistic", "exact", "lagged"),
        default="optimistic",
        help="adaptive-dt semantics. optimistic (default): propose dt from "
        "the carried max|phi| and VALIDATE it against the step's own fresh "
        "midpoint potential, replaying the rare violating step — the CFL "
        "bound holds against fresher data than the reference's pre-step "
        "phi(t) at roughly half the exact mode's cost. exact: solve the "
        "potential twice per step like the reference (update :497,:530). "
        "lagged: bound dt with the previous step's potential, never "
        "validated",
    )
    sim.add_argument(
        "--fast-dt",
        action="store_true",
        help="alias for --dt-mode lagged (kept for compatibility)",
    )
    sim.add_argument(
        "--mesh",
        choices=("none", "auto", "space"),
        default="none",
        help="auto: compile the ensemble over all visible devices (stream "
        "data-parallel + spatial pencils); space: force full spatial "
        "decomposition of every grid (2-D pencil over all devices)",
    )
    sim.add_argument(
        "--ignore-remote-storage",
        action="store_true",
        help="write local npy dumps even when the toml has a "
        "[remote_storage_parameters] table",
    )
    sim.add_argument(
        "--debug-checks",
        action="store_true",
        help="validate norm and finiteness at every dump boundary",
    )
    sim.add_argument(
        "--check-eps",
        type=float,
        default=None,
        help="unitarity tolerance for --debug-checks: |norm - 1| must stay "
        "below this. Default 1e-4 at f64 (the reference's check_norm eps, "
        "grid.rs:35-64) and 1e-3 at f32 (a 10x wider envelope for f32 FFT "
        "rounding; PARITY.md)",
    )
    sim.add_argument(
        "--profile-dir",
        default=None,
        help="capture a jax.profiler trace of the run into this directory",
    )
    sim.set_defaults(fn=cmd_simulate)

    syn = sub.add_parser("synthesize", help="combine stream dumps (msm-synthesizer)")
    _add_common(syn)
    syn.add_argument(
        "--verbosity",
        default="off",
        choices=tuple(_VERBOSITY_LEVELS),
        help="log level (env_logger levels; synthesizer/src/main.rs:34-41)",
    )
    syn.add_argument(
        "--dump-range",
        default=None,
        metavar="LO:HI",
        help="combine only dumps lo..=hi (cluster-parallel job shape)",
    )
    syn.add_argument(
        "--post-only",
        action="store_true",
        help="evaluate only post-combine scalars (Qx) from existing combines",
    )
    syn.add_argument(
        "--multihost",
        action="store_true",
        help="split the dump list across jax processes",
    )
    syn.add_argument(
        "--distributed",
        action="store_true",
        help="call jax.distributed.initialize() before anything else",
    )
    syn.set_defaults(fn=cmd_synthesize)

    bench = sub.add_parser("bench", help="run performance benchmarks")
    # size/steps default per metric (utils/benchmarks.main): kdk 256/100,
    # scaling 64/5 (the sweep scales the GLOBAL grid to keep size^dims
    # per device)
    bench.add_argument("--size", type=int, default=None)
    bench.add_argument("--dims", type=int, default=3)
    bench.add_argument("--streams", type=int, default=1)
    bench.add_argument("--steps", type=int, default=None)
    bench.add_argument(
        "--metric", choices=("kdk", "streams", "scaling"), default="kdk"
    )
    bench.add_argument(
        "--dt-mode",
        choices=("optimistic", "exact", "lagged", "all", "both"),
        default="all",
        dest="dt_mode",
    )
    bench.add_argument(
        "--processes", type=int, default=1,
        help="scaling metric: spawn N jax.distributed CPU workers",
    )
    bench.add_argument(
        "--devices-per-proc", type=int, default=4, dest="devices_per_proc"
    )
    bench.add_argument(
        "--rehearsal",
        action="store_true",
        help="run on a backend without published peaks (CPU rehearsal)",
    )
    bench.set_defaults(fn=cmd_bench)

    return parser


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
