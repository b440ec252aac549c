"""Observability: progress reporting, per-step timing, profiler traces.

Counterpart of the reference's instrumentation (SURVEY.md §5):
`indicatif` progress bar with ETA and live t/z readout
(`simulation_object.rs:440-447,1210-1222`), wall timers around the run and
each update (`main.rs:32,64`, `simulation_object.rs:482`), accumulated
`sim_wall_time` (`:633-635`) — plus what the reference lacks: a structured
`jax.profiler` trace hook and a steps/s / cell-updates/s counter (the
north-star metric, BASELINE.md).
"""

from __future__ import annotations

import contextlib
import sys
import time
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class ProgressReporter:
    """Dump-count progress line with ETA and live time/redshift readout."""

    total_dumps: int
    sim_name: str
    stream: "object" = sys.stdout
    enabled: bool = True
    _start: float = field(default_factory=time.monotonic)

    def update(
        self,
        dumps_done: int,
        sim_time: Optional[float] = None,
        redshift: Optional[float] = None,
        extra: str = "",
    ) -> None:
        if not self.enabled:
            return
        elapsed = time.monotonic() - self._start
        frac = dumps_done / max(self.total_dumps, 1)
        eta = elapsed * (1.0 - frac) / frac if frac > 0 else float("inf")
        bar_n = int(20 * frac)
        bar = "#" * bar_n + "-" * (20 - bar_n)
        msg = f"({self.sim_name})"
        if redshift is not None:
            msg += f" z = {redshift:.4g}"
        elif sim_time is not None:
            msg += f" t = {sim_time:.6g}"
        eta_s = f"{eta:.0f}s" if eta != float("inf") else "?"
        print(
            f"[{elapsed:7.1f}s; eta {eta_s:>6}] [{bar}] "
            f"{dumps_done:>5}/{self.total_dumps} {msg} {extra}",
            file=self.stream,
            flush=True,
        )

    def finish(self) -> None:
        if self.enabled:
            print(
                f"({self.sim_name}) finished in "
                f"{time.monotonic() - self._start:.1f}s",
                file=self.stream,
                flush=True,
            )


@dataclass
class StepTimer:
    """Accumulates wall time and step counts; reports cells-updated/s."""

    cells_per_step: int = 0
    steps: int = 0
    wall_s: float = 0.0
    _t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, n_steps: int = 1) -> None:
        assert self._t0 is not None
        self.wall_s += time.perf_counter() - self._t0
        self.steps += n_steps
        self._t0 = None

    @property
    def steps_per_s(self) -> float:
        return self.steps / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def cell_updates_per_s(self) -> float:
        return self.steps_per_s * self.cells_per_step

    def summary(self) -> str:
        return (
            f"{self.steps} steps in {self.wall_s:.2f}s "
            f"({self.steps_per_s:.1f} steps/s, "
            f"{self.cell_updates_per_s:.3e} cell-updates/s)"
        )


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """Capture a jax.profiler trace into log_dir (no-op when None)."""
    if not log_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
