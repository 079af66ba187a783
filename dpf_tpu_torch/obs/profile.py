"""On-demand profiler capture for a running sidecar (``POST /v1/profile``).

The port's counterpart of ``dpf_tpu/obs/profile.py``, on
``torch.profiler`` in place of ``jax.profiler``.  Restarting the sidecar
to wrap it in ``utils.profiling.trace`` would destroy the very state being
debugged; this module starts and stops a capture inside the live process:

  * **gated** — refused (``ProfileForbidden`` -> HTTP 403) unless the
    operator set ``DPF_CUDA_PROFILE_ALLOW``: a capture records every
    operator and kernel and costs real overhead, so it must be an
    explicit deployment decision, like fault injection;
  * **bounded** — every capture stops itself after
    ``min(requested, DPF_CUDA_PROFILE_MAX_S)`` seconds via a daemon
    timer, so a forgotten ``start`` can never profile a sidecar for hours;
  * **exclusive** — one capture at a time (``ProfileBusy`` -> 409);
  * the reply always reports the trace **directory**; stop writes the
    capture there as a Chrome trace, ``trace.json`` (CPU operators, and
    the card's kernels and copies when CUDA is up).
"""

from __future__ import annotations

import os
import tempfile
import threading
import time

from ..core import knobs


class ProfileError(RuntimeError):
    """Capture lifecycle error (no capture active, ...) -> HTTP 400."""


class ProfileForbidden(ProfileError):
    """DPF_CUDA_PROFILE_ALLOW is not set -> HTTP 403."""


class ProfileBusy(ProfileError):
    """A capture is already running -> HTTP 409."""


class _Capture:
    __slots__ = ("log_dir", "started_at", "max_s", "timer", "prof")

    def __init__(self, log_dir: str, max_s: float, prof):
        self.log_dir = log_dir
        self.started_at = time.perf_counter()
        self.max_s = max_s
        self.timer: threading.Timer | None = None
        self.prof = prof


def _start_profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


_LOCK = threading.Lock()
_ACTIVE: _Capture | None = None


def start(log_dir: str | None = None,
          seconds: float | None = None) -> dict:
    """Begin a capture; returns ``{status, dir, max_seconds}``."""
    if not knobs.is_set("DPF_CUDA_PROFILE_ALLOW"):
        raise ProfileForbidden(
            "profiling refused: set DPF_CUDA_PROFILE_ALLOW on the sidecar "
            "to enable on-demand profiler capture"
        )
    cap_s = knobs.get_float("DPF_CUDA_PROFILE_MAX_S")
    max_s = min(float(seconds), cap_s) if seconds else cap_s
    if max_s <= 0:
        raise ProfileError("profile duration must be positive")
    global _ACTIVE
    with _LOCK:
        if _ACTIVE is not None:
            raise ProfileBusy(
                f"a capture is already running (dir {_ACTIVE.log_dir})"
            )
        if not log_dir:
            log_dir = tempfile.mkdtemp(prefix="dpf-cuda-profile-")
        os.makedirs(log_dir, exist_ok=True)
        cap = _Capture(log_dir, max_s, _start_profiler())
        cap.timer = threading.Timer(max_s, _auto_stop, args=(cap,))
        cap.timer.daemon = True
        cap.timer.start()
        _ACTIVE = cap
    return {"status": "started", "dir": log_dir,
            "max_seconds": round(max_s, 3)}


def stop() -> dict:
    """End the capture; returns ``{status, dir, seconds}``."""
    global _ACTIVE
    with _LOCK:
        cap = _ACTIVE
        if cap is None:
            raise ProfileError("no capture active")
        return _stop_locked(cap)


def _stop_locked(cap: _Capture) -> dict:
    global _ACTIVE
    if cap.timer is not None:
        cap.timer.cancel()
    # Clear the active slot BEFORE stopping: if the profiler raises
    # (device died mid-capture), the endpoint must not wedge in a
    # permanent "running"/409 state with the auto-stop timer already
    # cancelled — a failed stop means the capture is over either way.
    _ACTIVE = None
    cap.prof.stop()
    cap.prof.export_chrome_trace(os.path.join(cap.log_dir, "trace.json"))
    return {
        "status": "stopped",
        "dir": cap.log_dir,
        "seconds": round(time.perf_counter() - cap.started_at, 3),
    }


def _auto_stop(cap: _Capture) -> None:
    """Duration-bound enforcement: stop the capture iff it is still THE
    active one (a manual stop may have raced the timer)."""
    with _LOCK:
        if _ACTIVE is cap:
            try:
                _stop_locked(cap)
            except Exception:  # noqa: BLE001 — the timer thread must not die loud
                pass


def status() -> dict:
    with _LOCK:
        if _ACTIVE is None:
            return {"status": "idle"}
        return {
            "status": "running",
            "dir": _ACTIVE.log_dir,
            "seconds": round(time.perf_counter() - _ACTIVE.started_at, 3),
            "max_seconds": round(_ACTIVE.max_s, 3),
        }
