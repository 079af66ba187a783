"""The cross-language wire vocabulary: header and pseudo-param names.

The port's copy of ``dpf_tpu/serving/headers.py``: the same names.

One module owns every ``X-DPF-*`` header name and its wire2 pseudo-param
twin, imported by ``handlers.py``, ``wire2.py``, and ``server.py`` — the
string can no longer drift between the fronts.  The Go bridge keeps its
literals (``bridge/go/dpftpu/client.go`` / ``wire2.go``); the
``surface-contract`` analysis pass pins those against this module and
the committed ``docs/CONTRACT.json`` (docs/DESIGN.md §22).
"""

from __future__ import annotations

# Per-request deadline: remaining budget in milliseconds.  The
# ``DPF_CUDA_DEADLINE_MS`` knob sets the server default for requests that
# omit it (0 = no default deadline).
DEADLINE_HEADER = "X-DPF-Deadline-Ms"

# Per-request trace id (obs/trace.py): propagated from the client (the
# Go client stamps one per request) or generated at ingress.
TRACE_HEADER = "X-DPF-Trace"

# Error-reply backoff hint, whole seconds rounded up by the front —
# derived from observed dispatch latency (serving/errors.py).
RETRY_AFTER_HEADER = "Retry-After"

# The wire2 front has no header block of its own: it carries the same
# two values as pseudo-params in its HEADERS frame's query string
# (serving/wire2.py strips them before route dispatch).
DEADLINE_PARAM = "_deadline_ms"
TRACE_PARAM = "_trace"
