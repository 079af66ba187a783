"""Observability plane of the port's sidecar: per-request tracing with a
bounded flight recorder (trace.py, ``GET /v1/trace``), Prometheus
text-format exposition rendered from the same snapshot ``/v1/stats`` reads
(metrics.py, ``GET /v1/metrics``), a strict exposition parser (promtext.py)
and gated on-demand ``torch.profiler`` capture (profile.py,
``POST /v1/profile``).  The counterpart of ``dpf_tpu/obs``; trace.py and
promtext.py are copies of the framework-free originals."""

from . import metrics, profile, promtext, trace

__all__ = ["metrics", "profile", "promtext", "trace"]
