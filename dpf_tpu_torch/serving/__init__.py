"""Serving-layer machinery of the port's sidecar, the counterpart of
``dpf_tpu/serving``: the dynamic micro-batcher (batcher.py) that coalesces
concurrent requests into one plan call, the host-repack LRU (keycache.py),
and the load-survival layer — structured serving errors (errors.py), the
device-failure circuit breaker (breaker.py), and the knob-gated fault
injection harness (faults.py).  All of it sits BETWEEN
``dpf_tpu_torch/server.py`` and the plan cache (core/plans.py); the
handler core (handlers.py) ties it together.  The wire2 front
(``serving/wire2.py`` in the JAX package) comes with a later slice."""

from .batcher import Batcher, HHWork, IntervalWork, PirWork, PointsWork
from .breaker import CircuitBreaker
from .errors import (
    DeadlineError, OverloadedError, ServingError, ShedError,
)
from .keycache import KeyCache

__all__ = [
    "Batcher", "PointsWork", "IntervalWork", "HHWork", "PirWork",
    "KeyCache", "CircuitBreaker", "ServingError", "ShedError",
    "OverloadedError", "DeadlineError",
]
