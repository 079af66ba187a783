"""Central registry of the port's ``DPF_CUDA_*`` environment knobs.

The port's counterpart of ``dpf_tpu/core/knobs.py``, for the knobs that
steer the port's own routes.  Every knob is **declared** once (name, kind,
default, doc line, owning module), and every read goes through the typed
accessors below (:func:`get_str`, :func:`get_int`, :func:`get_float`,
:func:`get_bool`, :func:`get_enum`, :func:`get_raw`, :func:`is_set`):
reading an undeclared name raises ``KeyError`` at the call site, so a typo
fails loudly instead of quietly returning a default.  :func:`audit_environ` lists ``DPF_CUDA_*``
variables present in the environment but not declared here.

Value semantics (every accessor but :func:`get_raw` and :func:`is_set`): an
unset or empty variable means the declared default.  An explicit keyword
argument of an entry point still wins over a knob, as in the JAX package.

:func:`overrides` layers values over the environment for the current thread
(nesting; the innermost layer wins), as the JAX package's tuned plans do.
The JAX package's ``DPF_TPU_*`` variables are never read here.

The JAX package's knobs with no counterpart in the port, each with its
reason, are listed in ROADMAP.md (A.7).  This module imports no numpy and no
torch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from collections.abc import Iterator, Mapping

PREFIX = "DPF_CUDA_"

# Spellings that mean "off" for boolean knobs (get_bool).
_FALSE_WORDS = ("off", "0", "false")


@dataclasses.dataclass(frozen=True)
class Knob:
    """One declared env knob."""

    name: str  # full env var name (DPF_CUDA_*)
    kind: str  # "enum" | "int" | "float" | "bool" | "str" | "flag"
    default: str  # raw string form; what an unset/empty var means
    doc: str
    module: str  # owning module (repo-relative path)
    choices: tuple[str, ...] = ()  # closed value set (get_enum enforces)
    values: str = ""  # display form; defaults to "|".join(choices)

    def values_doc(self) -> str:
        return self.values or "|".join(self.choices) or f"<{self.kind}>"


REGISTRY: dict[str, Knob] = {}


def _declare(
    name: str, kind: str, default: str, doc: str, module: str,
    choices: tuple[str, ...] = (), values: str = "",
) -> None:
    if not name.startswith(PREFIX):
        raise ValueError(f"knob {name} must start with {PREFIX}")
    if name in REGISTRY:
        raise ValueError(f"knob {name} declared twice")
    REGISTRY[name] = Knob(name, kind, default, doc, module, choices, values)


# ---------------------------------------------------------------------------
# Declarations
# ---------------------------------------------------------------------------

_declare(
    "DPF_CUDA_PRG", "str", "",
    "Compat-profile PRG backend when a call passes backend=None; unset "
    "keeps pallas_bm (prg_bm_kernel and leaf_words_bm_kernel on the card).",
    "dpf_tpu_torch/models/dpf.py",
    values="xla|pallas|pallas_bm|pallas_bm_il (unset = pallas_bm)",
)
_declare(
    "DPF_CUDA_FUSE", "str", "off",
    "Level-fused compat expansion when a call passes fuse=None (EvalFull and "
    "the PIR selection expansion): off, auto (groups of "
    "aes_cuda.FUSE_MAX_LEVELS = 4 levels, the most one fused_levels_bm_kernel "
    "launch runs), or a group size.  The fast profile's routes are the same "
    "for every value.",
    "dpf_tpu_torch/models/dpf.py", values="off|auto|<levels>",
)
_declare(
    "DPF_CUDA_PLAN_KFLOOR", "int", "1",
    "Minimum K bucket of the dispatch plans (a deployment may pin a lane "
    "quantum, e.g. 32 for the compat planes, so single-key requests share "
    "one plan).",
    "dpf_tpu_torch/core/plans.py",
)
_declare(
    "DPF_CUDA_PIR_CHUNK_ROWS", "int", str(1 << 16),
    "Database rows per parity-product chunk of a PIR scan (the int8 unpack "
    "granularity of torch._int_mm); rounded down to a power of two of at "
    "least 128 and at most the domain.",
    "dpf_tpu_torch/models/pir.py",
)
_declare(
    "DPF_CUDA_PIR_DB_CHUNK_BYTES", "int", str(1 << 28),
    "Resident database bytes above which a PIR scan streams slab by slab "
    "into one accumulator; also the row count of one upload read "
    "(apps/pir_store.upload_chunk_rows).  0 disables streaming.",
    "dpf_tpu_torch/models/pir.py",
)


# The sidecar (server.py, serving/, obs/): the counterparts of the JAX
# package's serving knobs, each with the same default.  The wire2 knobs
# come with the port's wire2 front.
_SRV = "dpf_tpu_torch/server.py"
_declare(
    "DPF_CUDA_BATCH", "bool", "on",
    "Sidecar micro-batcher for the pointwise, DCF, heavy-hitter, gen and PIR "
    "routes (off = direct per-request dispatch).", _SRV,
)
_declare(
    "DPF_CUDA_BATCH_WINDOW_US", "float", "200",
    "Burst-collection window per batcher lane, in microseconds (0 = collect "
    "only what already queued).", "dpf_tpu_torch/serving/batcher.py",
)
_declare(
    "DPF_CUDA_BATCH_MAX_KEYS", "int", "1024",
    "Maximum key-rows coalesced into one batcher dispatch.",
    "dpf_tpu_torch/serving/batcher.py",
)
_declare(
    "DPF_CUDA_BATCH_TIMEOUT_S", "float", "600",
    "Hard wall-clock bound a request waits on its batcher lane before failing "
    "(the backstop behind the deadlines).", "dpf_tpu_torch/serving/batcher.py",
)
_declare(
    "DPF_CUDA_QUEUE_MAX_DEPTH", "int", "256",
    "Requests queued per batcher lane beyond which new arrivals are shed "
    "(429 + Retry-After).", "dpf_tpu_torch/serving/batcher.py",
)
_declare(
    "DPF_CUDA_QUEUE_MAX_AGE_MS", "float", "2000",
    "Age of the oldest queued request of a lane beyond which new arrivals are "
    "shed (429).", "dpf_tpu_torch/serving/batcher.py",
)
_declare(
    "DPF_CUDA_DEADLINE_MS", "float", "0",
    "Default per-request deadline when the client sends no X-DPF-Deadline-Ms "
    "header (0 = none).", _SRV,
)
_declare(
    "DPF_CUDA_DISPATCH_RETRIES", "int", "2",
    "Retries in place of a dispatch that failed with a transient signature "
    "(core/transients.py) before the failure counts toward the breaker.",
    "dpf_tpu_torch/serving/breaker.py",
)
_declare(
    "DPF_CUDA_RETRY_BACKOFF_MS", "float", "50",
    "Base backoff between transient-dispatch retries, milliseconds (doubles "
    "per attempt, capped at 1000 ms).", "dpf_tpu_torch/serving/breaker.py",
)
_declare(
    "DPF_CUDA_BREAKER_THRESHOLD", "int", "3",
    "Consecutive transient dispatch failures (after retries) that trip the "
    "circuit breaker open.", "dpf_tpu_torch/serving/breaker.py",
)
_declare(
    "DPF_CUDA_BREAKER_COOLDOWN_MS", "float", "1000",
    "Open-circuit cooldown before a half-open trial dispatch (also the "
    "probe's re-warm period).", "dpf_tpu_torch/serving/breaker.py",
)
_declare(
    "DPF_CUDA_BREAKER_PROBE", "bool", "on",
    "Background probe while the breaker is open: re-drives the recent plans "
    "(graph replays on the card) and moves the breaker to half-open on "
    "success (off = time-based half-open only).",
    "dpf_tpu_torch/serving/breaker.py",
)
_declare(
    "DPF_CUDA_FAULTS", "str", "",
    "Fault-injection spec (serving/faults.py): semicolon-separated "
    "site:kind[:ms=V][:times=N][:after=N] clauses; refused outside pytest "
    "unless DPF_CUDA_FAULTS_ALLOW is set.  Empty = no faults.",
    "dpf_tpu_torch/serving/faults.py", values="<site:kind[:opts];...>",
)
_declare(
    "DPF_CUDA_FAULTS_ALLOW", "flag", "",
    "Explicit opt-in that lets DPF_CUDA_FAULTS activate outside a pytest "
    "process.", "dpf_tpu_torch/serving/faults.py",
)
_declare(
    "DPF_CUDA_HH_STATE", "enum", "auto",
    "Incremental heavy-hitter descent for /v1/hh/eval?session=: cache each "
    "session's frontier on the card (apps/hh_state.py); off = always from "
    "the root.", "dpf_tpu_torch/apps/hh_state.py", choices=("off", "auto", "on"),
)
_declare(
    "DPF_CUDA_HH_STATE_MAX_SESSIONS", "int", "64",
    "Cap on cached descent sessions; the oldest-idle is evicted first.",
    "dpf_tpu_torch/apps/hh_state.py",
)
_declare(
    "DPF_CUDA_HH_STATE_MAX_BYTES", "int", str(1 << 28),
    "Card-byte budget across cached descent frontiers (the last live session "
    "is never evicted).", "dpf_tpu_torch/apps/hh_state.py",
)
_declare(
    "DPF_CUDA_HH_STATE_TTL_S", "int", "600",
    "Idle seconds before a cached descent session is evicted.",
    "dpf_tpu_torch/apps/hh_state.py",
)
_declare(
    "DPF_CUDA_KEY_CACHE_ENTRIES", "int", "32",
    "Host-repack LRU capacity in whole key batches (0 disables).",
    "dpf_tpu_torch/serving/keycache.py",
)
_declare(
    "DPF_CUDA_METRICS_BUCKETS_MS", "str", "0.5,1,2,5,10,20,50,100,200,500,1000,2000,5000",
    "Histogram bucket bounds (ms, comma-separated) of the per-phase latency "
    "histograms on GET /v1/metrics.", "dpf_tpu_torch/obs/metrics.py",
    values="<ms,ms,...>",
)
_declare(
    "DPF_CUDA_PROFILE_ALLOW", "flag", "",
    "Explicit opt-in for POST /v1/profile (torch.profiler capture); unset, "
    "the route answers 403.", "dpf_tpu_torch/obs/profile.py",
)
_declare(
    "DPF_CUDA_PROFILE_MAX_S", "float", "60",
    "Upper bound on one profiler capture, seconds (each capture stops itself "
    "at min(requested, this)).", "dpf_tpu_torch/obs/profile.py",
)
_declare(
    "DPF_CUDA_STREAM", "str", "auto",
    "Streamed /v1/evalfull default: on, off, or auto (stream replies of at "
    "least DPF_CUDA_STREAM_MIN_BYTES).", _SRV, values="off|auto|on",
)
_declare(
    "DPF_CUDA_STREAM_MIN_BYTES", "int", str(1 << 20),
    "auto-streaming threshold of /v1/evalfull, in reply bytes.", _SRV,
)
_declare(
    "DPF_CUDA_TRACE", "bool", "on",
    "Per-request span tracing and flight recorder (GET /v1/trace); off makes "
    "every instrumentation point an is-None check.", "dpf_tpu_torch/obs/trace.py",
)
_declare(
    "DPF_CUDA_TRACE_RING", "int", "256",
    "Flight-recorder capacity in finished request traces.",
    "dpf_tpu_torch/obs/trace.py",
)
_declare(
    "DPF_CUDA_WIRE_FORMAT", "enum", "bits",
    "Default reply format of the pointwise routes when a request omits "
    "format= (the request's param wins).", _SRV, choices=("bits", "packed"),
)


# ---------------------------------------------------------------------------
# Typed accessors
# ---------------------------------------------------------------------------


def knob(name: str) -> Knob:
    """Declaration lookup; KeyError on an undeclared name."""
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"undeclared knob {name!r}: declare it in dpf_tpu_torch/core/knobs.py"
        ) from None


# Thread-local override stack: a read on this thread resolves against the
# innermost layer holding the name, then os.environ.
_TLS = threading.local()


def _override_get(name: str) -> str | None:
    for layer in reversed(getattr(_TLS, "layers", ())):
        if name in layer:
            return layer[name]
    return None


@contextlib.contextmanager
def overrides(values: Mapping[str, str]) -> Iterator[None]:
    """Apply ``values`` as this thread's knob reads until exit.  Every name
    must be declared (KeyError otherwise).  Layers nest; the innermost value
    wins.  '' means "unset -> default" to the typed accessors."""
    layer = {knob(name).name: str(value) for name, value in values.items()}
    layers = getattr(_TLS, "layers", None)
    if layers is None:
        layers = _TLS.layers = []
    layers.append(layer)
    try:
        yield
    finally:
        layers.pop()


def get_raw(name: str) -> str | None:
    """The raw value (None when unset, '' kept); an active
    :func:`overrides` layer wins over os.environ."""
    k = knob(name)
    ov = _override_get(k.name)
    return ov if ov is not None else os.environ.get(k.name)


def is_set(name: str) -> bool:
    """True when the variable is present and non-empty."""
    return bool(get_raw(name))


def get_str(name: str) -> str:
    raw = get_raw(name)
    return knob(name).default if raw is None or raw == "" else raw


def get_int(name: str) -> int:
    return int(get_str(name))


def get_float(name: str) -> float:
    return float(get_str(name))


def get_bool(name: str) -> bool:
    return get_str(name).lower() not in _FALSE_WORDS


def get_enum(name: str) -> str:
    k = knob(name)
    v = get_str(name)
    if v not in k.choices:
        raise ValueError(f"{k.name}={v!r} unknown (use {'|'.join(k.choices)})")
    return v


# ---------------------------------------------------------------------------
# Environment audit
# ---------------------------------------------------------------------------


def audit_environ(environ=None) -> list[str]:
    """``DPF_CUDA_*`` names present in ``environ`` (default ``os.environ``)
    but not declared here: a deployment's typo'd knobs."""
    env = os.environ if environ is None else environ
    return sorted(n for n in env if n.startswith(PREFIX) and n not in REGISTRY)


def snapshot(names=None) -> dict[str, str]:
    """Raw values of declared knobs as they sit in the environment ('' when
    unset).  ``DPF_CUDA_*`` names must be declared (KeyError on a typo);
    other names pass through raw."""
    out = {}
    for n in sorted(REGISTRY) if names is None else names:
        if n.startswith(PREFIX):
            knob(n)
        out[n] = os.environ.get(n, "")
    return out
