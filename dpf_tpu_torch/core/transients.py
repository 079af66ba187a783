"""Transient-vs-wedge failure classification for the port, on the card.

The port's counterpart of ``dpf_tpu/core/transients.py``.  The JAX list
(``UNAVAILABLE``, ``DEADLINE_EXCEEDED``, connection failures) is the TPU
transport's; the card fails differently, so the port keeps its own list.
Its one user is the sidecar's circuit breaker (``serving/breaker.py``):
a transient failure is retried in place and counts toward tripping; any
other failure passes through to its request untouched.

Transient (the environment, not the code; the same call can succeed
again in the same process):

  * ``UNAVAILABLE``: the signature the fault-injection harness raises
    (``serving/faults.py``), kept so an injected dispatch fault takes the
    same path on both packages;
  * ``out of memory``: ``torch.OutOfMemoryError`` (cudaErrorMemoryAllocation)
    is not sticky.  Under concurrent requests the caching allocator can
    run short while other dispatches hold their intermediates; a retry
    after they free succeeds;
  * ``busy or unavailable``: cudaErrorDevicesUnavailable, another process
    holds the card in exclusive mode for now;
  * ``Connection refused`` / ``Connection reset``: a transport between
    the sidecar and a peer (the multi-GPU slice) going away and back.

Never transient, whatever else the text carries: a **sticky** CUDA error.
An illegal address, an unspecified launch failure, a device-side assert,
a misaligned address, an illegal instruction, a hardware stack error, an
uncorrectable ECC error or a launch timeout leaves the CUDA context
unusable: every later call in the process fails with the same error.
Retrying one in place only multiplies the failure, so the breaker passes
it straight through (500 ``internal``) and the process must be restarted:
the sidecar marks itself wedged on the first one (``is_sticky``), and its
``/readyz`` and ``/healthz`` answer 503 from then on, so an orchestrator
takes it out of rotation and restarts it.

Matched against ``"TypeName: message"`` text, as in the reference.
"""

from __future__ import annotations

# Substrings that mark a failure as environment-transient.
TRANSIENT_SIGNATURES = (
    "UNAVAILABLE",
    "out of memory",
    "busy or unavailable",
    "Connection refused",
    "Connection reset",
)

# Substrings of the sticky CUDA errors (cudaErrorIllegalAddress,
# cudaErrorLaunchFailure, cudaErrorAssert, cudaErrorMisalignedAddress,
# cudaErrorIllegalInstruction, cudaErrorHardwareStackError,
# cudaErrorECCUncorrectable, cudaErrorLaunchTimeout): they override any
# transient signature in the same text.
STICKY_SIGNATURES = (
    "illegal memory access",
    "unspecified launch failure",
    "device-side assert",
    "misaligned address",
    "illegal instruction",
    "hardware stack error",
    "uncorrectable ECC error",
    "launch timed out",
)


def is_sticky_text(text: str) -> bool:
    """True when ``text`` carries a sticky CUDA error signature."""
    return any(sig in text for sig in STICKY_SIGNATURES)


def is_sticky(exc: BaseException) -> bool:
    """True when ``exc``, or an exception it was raised from, carries a
    sticky CUDA error (a failed replay arrives as a ``PlanError`` raised
    from the CUDA error)."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if is_sticky_text(f"{type(exc).__name__}: {exc}"):
            return True
        exc = exc.__cause__ or exc.__context__
    return False


def is_transient_text(text: str) -> bool:
    """True when ``text`` carries a transient signature and no sticky one."""
    if is_sticky_text(text):
        return False
    return any(sig in text for sig in TRANSIENT_SIGNATURES)


def is_transient(exc: BaseException) -> bool:
    """True when ``exc`` is transient (classified on type name + message)."""
    return is_transient_text(f"{type(exc).__name__}: {exc}")
