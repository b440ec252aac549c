#!/usr/bin/env python
"""Profile a few KDK steps on the device and list where the time goes.

    python scripts/trace_step.py [--size 256] [--steps 5] [--out DIR]

Compiles one program of `--steps` production (optimistic-dt, c64) steps of
the tophat config, runs it once to warm up, then traces one more call with
`jax.profiler` into DIR and reduces the trace: the device's busy share of
the traced call, the kernels and XLA ops that take the most device time,
and the share of FFT kernels. It measures only a GPU with published peaks
(`require_device`): on any other backend, or when the trace holds no GPU
kernels, it exits non-zero.
"""

from __future__ import annotations

import argparse
import collections
import glob
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FFT_KERNEL = re.compile(r"fft", re.I)


def _union_ns(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(path: str, top: int = 12) -> dict:
    """Busy share, top kernels/ops and FFT share from an .xplane.pb."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(path)
    planes = [p for p in data.planes if p.name.startswith("/device:GPU")]
    if not planes:
        return {}
    plane = planes[0]
    kernels = collections.Counter()
    ops = collections.Counter()
    spans = []
    for line in plane.lines:
        events = list(line.events)
        if line.name == "XLA Ops":
            for ev in events:
                ops[ev.name] += ev.duration_ns
        elif line.name.startswith("Stream"):
            for ev in events:
                kernels[ev.name] += ev.duration_ns
                spans.append((ev.start_ns, ev.end_ns))
    if not spans:
        return {"lines": [line.name for line in plane.lines]}
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    busy = _union_ns(spans)
    k_total = sum(kernels.values())
    fft = sum(v for k, v in kernels.items() if FFT_KERNEL.search(k))
    return {
        "plane": plane.name,
        "lines": [line.name for line in plane.lines],
        "window_ms": window / 1e6,
        "busy_share": busy / window if window else 0.0,
        "kernel_ms": k_total / 1e6,
        "fft_share": fft / k_total if k_total else 0.0,
        "top_kernels": [(k, v / 1e6) for k, v in kernels.most_common(top)],
        "top_ops": [(k, v / 1e6) for k, v in ops.most_common(top)],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default="chiprun_out/trace")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from msm_tpu import config as cfg
    from msm_tpu.models.ics import build_ics
    from msm_tpu.stepper import Stepper
    from msm_tpu.utils.benchmarks import _tophat_toml, require_device

    dev = require_device(prog="trace_step")
    print(f"device: {dev['platform']} {dev['kind']!r}", flush=True)
    params = cfg.resolve_parameters(_tophat_toml(args.size, 3, "trace"))
    st = Stepper(params, jnp.complex64, dt_mode="optimistic")
    state = st.init_state(build_ics(params))
    chain = jax.jit(st._chain_n_steps, static_argnums=2)
    state = jax.block_until_ready(chain(state, st.consts, args.steps))  # compile
    t0 = time.perf_counter()
    state = jax.block_until_ready(chain(state, st.consts, args.steps))
    wall = time.perf_counter() - t0
    print(f"{args.size}^3 c64, {args.steps} steps untraced: {wall * 1e3:.2f} ms "
          f"({wall * 1e3 / args.steps:.2f} ms/step)", flush=True)
    with jax.profiler.trace(args.out):
        state = jax.block_until_ready(chain(state, st.consts, args.steps))
    files = sorted(glob.glob(os.path.join(args.out, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not files:
        print("no trace written")
        return 1
    red = reduce_trace(files[-1])
    if "window_ms" not in red:
        print(f"no device kernels in the trace ({red or 'no GPU plane'})")
        return 1
    print(f"trace {files[-1]}: window {red['window_ms']:.3f} ms, device busy "
          f"{red['busy_share']:.3f}, kernel time {red['kernel_ms']:.3f} ms, "
          f"FFT kernels {red['fft_share']:.3f} of kernel time")
    print(f"device plane lines: {red['lines']}")
    print("top kernels (ms):")
    for name, ms in red["top_kernels"]:
        print(f"  {ms:9.3f}  {name[:110]}")
    print("top XLA ops (ms):")
    for name, ms in red["top_ops"]:
        print(f"  {ms:9.3f}  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
