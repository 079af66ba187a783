"""Timing helpers: phase timers, profiler traces, throughput metrics."""

from .profiling import PhaseTimer, leaves_per_sec, trace

__all__ = ["PhaseTimer", "leaves_per_sec", "trace"]
