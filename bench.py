#!/usr/bin/env python
"""Benchmark entry: 3-D KDK grid-update throughput on one GPU.

Prints JSON lines {"metric", "value", "unit", "device", ...} to stdout —
FAIL-SOFT: the optimistic-dt headline record is flushed the moment that
first measurement completes; each sub-mode (exact/lagged dt) then
re-prints the merged record as the new last line. Parse the LAST complete
JSON line. Sub-modes are gated by a wall budget (MSM_BENCH_BUDGET_S,
default 900 s from the device check) and recorded as {"skipped": reason}
when the budget predicts they cannot finish. Progress lines go to stderr.

Without a GPU whose peaks the benchmark knows it exits non-zero;
`--rehearsal` runs the same control flow on any backend (CPU records
carry their platform and no roofline share).
"""

import argparse
import sys


def main() -> None:
    parser = argparse.ArgumentParser()
    # size/steps default PER METRIC (benchmarks.main): kdk 256/100,
    # scaling 64/5 — the scaling sweep scales the GLOBAL grid to keep
    # size^dims per device, so kdk's 256 default would build >=512^3
    # global grids on the CPU rehearsal (hours, not minutes)
    parser.add_argument("--size", type=int, default=None)
    parser.add_argument("--dims", type=int, default=3)
    # default: 1 stream for the kdk metric, 128 for the ensemble metric
    parser.add_argument("--streams", type=int, default=None)
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument(
        "--dt-mode",
        choices=("optimistic", "exact", "lagged", "all", "both"),
        default="all",
        dest="dt_mode",
        help="all (default): headline = optimistic (the CLI/production "
        "default dt semantics) with the reference-parity exact mode and "
        "the lagged mode as sub-records; or one mode alone. 'both' is a "
        "legacy alias for all",
    )
    parser.add_argument(
        "--metric",
        choices=("kdk", "streams", "scaling"),
        default="kdk",
        help="kdk: grid-updates/s on one big grid; streams: ensemble "
        "streams/s; scaling: weak-scaling sweep over the device mesh",
    )
    parser.add_argument(
        "--processes",
        type=int,
        default=1,
        help="scaling metric only: spawn N jax.distributed CPU processes "
        "(needs --rehearsal; workers bootstrap over loopback like "
        "tests/test_multihost_spatial.py)",
    )
    parser.add_argument(
        "--devices-per-proc",
        type=int,
        default=4,
        dest="devices_per_proc",
        help="virtual CPU devices per spawned process (scaling rehearsal)",
    )
    parser.add_argument(
        "--rehearsal",
        action="store_true",
        help="run on a backend without published peaks (CPU rehearsal of "
        "the control flow; the numbers are not device measurements)",
    )
    args = parser.parse_args()

    from msm_tpu.utils import benchmarks

    benchmarks.main(args)


if __name__ == "__main__":
    sys.exit(main())
