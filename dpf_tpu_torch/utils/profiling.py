"""Structured timing and tracing for the port.

The port's counterpart of ``dpf_tpu/utils/profiling.py``:

- ``PhaseTimer`` — named wall-clock phases (key packing, dispatch, D2H,
  reply), a copy of the original; the sidecar's phase counters and the
  streamed EvalFull's timer use it.
- ``trace`` — context manager around ``torch.profiler`` that writes a
  Chrome trace (``trace.json``) into a directory, the analogue of the
  reference's ``-cpuprofile``.
- ``leaves_per_sec`` — the BASELINE.json headline metric helper.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class PhaseTimer:
    """Accumulates named phase durations; one instance per measured run."""

    phases: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, dt: float, n: int = 1) -> None:
        """Record a duration measured elsewhere (the serving path times
        phases across threads and merges under its own lock)."""
        self.phases[name] = self.phases.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + n

    def as_dict(self) -> dict:
        """JSON-able snapshot (the sidecar's /v1/stats payload): per-phase
        total seconds and event counts."""
        return {
            name: {"seconds": round(dt, 6), "count": self.counts[name]}
            for name, dt in self.phases.items()
        }

    def total(self) -> float:
        return sum(self.phases.values())

    def report(self) -> str:
        """Fixed-width per-phase breakdown with shares of total."""
        tot = self.total() or 1.0
        lines = [
            f"  {name:<16} {dt * 1e3:10.2f} ms  {dt / tot * 100:5.1f}%"
            f"  (x{self.counts[name]})"
            for name, dt in sorted(self.phases.items(), key=lambda kv: -kv[1])
        ]
        lines.append(f"  {'total':<16} {tot * 1e3:10.2f} ms")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str | None):
    """``torch.profiler`` capture around a code region when ``log_dir`` is
    set (CPU operators, and the card's kernels and copies when CUDA is
    up), written to ``log_dir/trace.json``; no-op otherwise.  View it in
    chrome://tracing or Perfetto."""
    if not log_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def leaves_per_sec(n_keys: int, log_n: int, seconds: float) -> float:
    """The BASELINE.json throughput metric: domain leaves produced per
    second across the key batch."""
    return n_keys * float(1 << log_n) / seconds
