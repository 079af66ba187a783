"""Strict Prometheus text-format (v0.0.4) parser.

The port's copy of ``dpf_tpu/obs/promtext.py`` (stdlib only).

This is the consumer-side half of the metrics plane: the test suite
parses ``/v1/metrics`` through it with ``strict=True`` (so the renderer
in ``obs/metrics.py`` is held to the format, not to "whatever our own
parser accepts" — the grammar below is written from the exposition
spec, and violations raise), and ``chip_smoke.py``'s sidecar phase
uses it to read counters back.

Strict mode enforces, beyond the line grammar:

  * a ``# TYPE`` line precedes a family's first sample, with a known
    type, at most once per family;
  * counter family names end in ``_total`` and never decrease below 0;
  * histogram families expose ``_bucket``/``_sum``/``_count`` series,
    cumulative buckets are monotonically non-decreasing, and the
    ``le="+Inf"`` bucket equals ``_count``;
  * no duplicate (name, labels) sample;
  * the exposition ends with a newline.

Import-light (stdlib only): bench harnesses import it before any
backend initializes.
"""

from __future__ import annotations

import re

_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_HELP_RE = re.compile(rf"^# HELP ({_NAME}) (.*)$")
_TYPE_RE = re.compile(rf"^# TYPE ({_NAME}) (\w+)$")
_SAMPLE_RE = re.compile(
    rf"^({_NAME})(?:\{{(.*)\}})? "
    r"(-?(?:[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?|Inf|NaN)|[+-]Inf)$"
)
_LABEL_RE = re.compile(rf'({_NAME})="((?:[^"\\]|\\.)*)"')
_TYPES = ("counter", "gauge", "histogram", "summary", "untyped")
_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


class PromFormatError(ValueError):
    """The exposition violated the text format (strict mode)."""


def _unescape(v: str) -> str:
    return v.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")


def _base_name(name: str, types: dict) -> str:
    """Map a histogram series name back to its family name."""
    for suffix in _HIST_SUFFIXES:
        if name.endswith(suffix):
            base = name[: -len(suffix)]
            if types.get(base) == "histogram":
                return base
    return name


class Scrape:
    """One parsed exposition: ``samples`` maps (name, labels-tuple) ->
    float; ``value()`` / ``family()`` are the lookup helpers."""

    def __init__(self):
        self.types: dict[str, str] = {}
        self.help: dict[str, str] = {}
        self.samples: dict[tuple[str, tuple], float] = {}

    @staticmethod
    def _key(name: str, labels: dict | None) -> tuple[str, tuple]:
        return (name, tuple(sorted((labels or {}).items())))

    def value(self, name: str, labels: dict | None = None,
              default: float | None = None) -> float:
        key = self._key(name, labels)
        if key in self.samples:
            return self.samples[key]
        if default is not None:
            return default
        raise KeyError(f"no sample {name}{labels or ''}")

    def family(self, name: str) -> dict[tuple, float]:
        """Every (labels-tuple -> value) sample of one metric name."""
        return {
            lbl: v for (n, lbl), v in self.samples.items() if n == name
        }

    def counters(self) -> dict[tuple[str, tuple], float]:
        """Samples of counter-typed families (incl. histogram buckets'
        implicit counters are EXCLUDED — just explicit counter types)."""
        return {
            (n, lbl): v
            for (n, lbl), v in self.samples.items()
            if self.types.get(_base_name(n, self.types)) == "counter"
        }


def _parse_labels(raw: str | None, line: str) -> dict:
    if not raw:
        return {}
    labels: dict[str, str] = {}
    rest = raw
    while rest:
        m = _LABEL_RE.match(rest)
        if m is None:
            raise PromFormatError(f"bad label syntax: {line!r}")
        name, value = m.group(1), _unescape(m.group(2))
        if name in labels:
            raise PromFormatError(f"duplicate label {name!r}: {line!r}")
        labels[name] = value
        rest = rest[m.end():]
        if rest.startswith(","):
            rest = rest[1:]
        elif rest:
            raise PromFormatError(f"bad label separator: {line!r}")
    return labels


def _to_float(tok: str) -> float:
    if tok in ("Inf", "+Inf"):
        return float("inf")
    if tok == "-Inf":
        return float("-inf")
    if tok == "NaN":
        return float("nan")
    return float(tok)


def parse(text: str, strict: bool = True) -> Scrape:
    """Parse one exposition.  ``strict=False`` keeps the line grammar
    but skips the family-level conformance checks (useful for diffing
    foreign expositions)."""
    if strict and not text.endswith("\n"):
        raise PromFormatError("exposition must end with a newline")
    scrape = Scrape()
    seen_sample_of: set[str] = set()
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            if strict:
                raise PromFormatError(f"line {lineno}: blank line")
            continue
        if line.startswith("#"):
            mh = _HELP_RE.match(line)
            if mh is not None:
                scrape.help[mh.group(1)] = mh.group(2)
                continue
            mt = _TYPE_RE.match(line)
            if mt is not None:
                name, kind = mt.group(1), mt.group(2)
                if kind not in _TYPES:
                    raise PromFormatError(
                        f"line {lineno}: unknown type {kind!r}"
                    )
                if strict and name in scrape.types:
                    raise PromFormatError(
                        f"line {lineno}: duplicate TYPE for {name}"
                    )
                if strict and name in seen_sample_of:
                    raise PromFormatError(
                        f"line {lineno}: TYPE for {name} after its samples"
                    )
                scrape.types[name] = kind
                continue
            if strict:
                raise PromFormatError(
                    f"line {lineno}: malformed comment {line!r}"
                )
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise PromFormatError(f"line {lineno}: bad sample {line!r}")
        name, raw_labels, raw_value = m.groups()
        labels = _parse_labels(raw_labels, line)
        base = _base_name(name, scrape.types)
        if strict and base not in scrape.types:
            raise PromFormatError(
                f"line {lineno}: sample {name} has no preceding TYPE"
            )
        seen_sample_of.add(base)
        key = Scrape._key(name, labels)
        if key in scrape.samples:
            raise PromFormatError(
                f"line {lineno}: duplicate sample {name}{labels}"
            )
        scrape.samples[key] = _to_float(raw_value)
    if strict:
        _conformance(scrape)
    return scrape


def _conformance(scrape: Scrape) -> None:
    for name, kind in scrape.types.items():
        if kind == "counter":
            if not name.endswith("_total"):
                raise PromFormatError(
                    f"counter {name} must end in _total"
                )
            for lbl, v in scrape.family(name).items():
                if v < 0:
                    raise PromFormatError(
                        f"counter {name}{dict(lbl)} is negative"
                    )
        elif kind == "histogram":
            _check_histogram(scrape, name)


def _check_histogram(scrape: Scrape, name: str) -> None:
    buckets = scrape.family(f"{name}_bucket")
    sums = scrape.family(f"{name}_sum")
    counts = scrape.family(f"{name}_count")
    if not buckets or not sums or not counts:
        raise PromFormatError(
            f"histogram {name} missing _bucket/_sum/_count series"
        )
    # Group bucket series by their non-le labels.
    grouped: dict[tuple, list[tuple[float, float]]] = {}
    for lbl, v in buckets.items():
        le = dict(lbl).get("le")
        if le is None:
            raise PromFormatError(
                f"histogram {name} bucket without le label"
            )
        rest = tuple(kv for kv in lbl if kv[0] != "le")
        grouped.setdefault(rest, []).append((_to_float(le), v))
    for rest, series in grouped.items():
        series.sort(key=lambda bv: bv[0])
        bounds = [b for b, _ in series]
        values = [v for _, v in series]
        if bounds[-1] != float("inf"):
            raise PromFormatError(
                f"histogram {name}{dict(rest)} lacks an le=+Inf bucket"
            )
        if any(b > a for a, b in zip(values[1:], values[:-1])):
            raise PromFormatError(
                f"histogram {name}{dict(rest)} buckets are not cumulative"
            )
        if rest not in counts:
            raise PromFormatError(
                f"histogram {name}{dict(rest)} lacks a _count sample"
            )
        if values[-1] != counts[rest]:
            raise PromFormatError(
                f"histogram {name}{dict(rest)} +Inf bucket != _count"
            )
        if rest not in sums:
            raise PromFormatError(
                f"histogram {name}{dict(rest)} lacks a _sum sample"
            )
