"""Named PIR databases on the card: 2-server PIR as a served workload.

The port's counterpart of ``dpf_tpu/apps/pir_store.py``, single card.
``models/pir.py`` owns the math (the selection expansion and the parity
scan); this module owns the lifecycle a serving deployment needs:

  * named databases loaded once and kept: the packed public host rows, and
    the ``PirServer`` built from them at the first scan on a device
    (:meth:`PirDB.server`), whose database words stay resident there;
  * scan accounting: databases resident, queries answered, database bytes
    scanned, and the streamed-slabs-per-scan histogram.

The database is public (both servers hold identical copies), so its name,
shape and counters are exportable metadata; the query is the secret, and
exists only as DPF key material.  ``core/plans.run_pir`` and a warmup spec
``{"route": "pir", "db": name, "k": K}`` scan a registered database.  The
reference's serving mesh (a sharded placement per shard count) comes with
the port's multi-GPU slice: here :meth:`PirDB.dispatch_shards` is 0.
"""

from __future__ import annotations

import bisect
import re
import threading

import numpy as np

from ..core import knobs
from ..core.device import resolve_device
from ..models.pir import _LEAF_LOG, PirServer, row_domain

__all__ = ["PirDB", "PirRegistry", "registry", "reset", "validate_name", "upload_chunk_rows"]

_NAME_RE = re.compile(r"^[A-Za-z0-9_.-]{1,64}$")


def validate_name(name: str) -> str:
    """Raise ValueError unless ``name`` is a legal database name (before any
    upload byte is read)."""
    if not _NAME_RE.match(name or ""):
        raise ValueError("pir: db name must be 1-64 chars of [A-Za-z0-9_.-]")
    return name


# Streamed-slabs-per-scan histogram bounds (1 = one-shot scan).
CHUNK_BOUNDS = (1, 2, 4, 8, 16, 32, 64, 128)


class PirDB:
    """One named database and its scan counters.

    The packed public host rows are kept; :meth:`server` returns, building
    it at first use, the ``PirServer`` of a placement on a device."""

    def __init__(self, name: str, db: np.ndarray, profile: str = "compat"):
        validate_name(name)
        db = np.ascontiguousarray(np.asarray(db, dtype=np.uint8))
        if db.ndim != 2:
            raise ValueError("pir: db must be [n_rows, row_bytes]")
        self.name = name
        self.profile = profile
        self.n_rows, self.row_bytes = db.shape
        self.log_n, self.dom = row_domain(self.n_rows, profile)
        self.nu = max(self.log_n - _LEAF_LOG[profile], 0)
        self._db = db
        self._servers: dict[tuple, PirServer] = {}
        self._lock = threading.Lock()
        self.queries = 0
        self.scans = 0
        self.bytes_scanned = 0
        self.chunk_hist = [0] * (len(CHUNK_BOUNDS) + 1)
        self.chunk_sum = 0  # total streamed slabs across scans

    @property
    def db_bytes(self) -> int:
        """Padded resident bytes: what one full scan reads."""
        return self.dom * self.row_bytes

    def server(self, shards: int = 0, *, device=None) -> PirServer:
        """The ``PirServer`` of a placement on ``device`` (None: the card),
        built once per (shards, device): the database words go to the
        device at the build.  ``shards`` must be 0 (one card)."""
        if shards:
            raise ValueError("pir: the port has no serving mesh yet (shards must be 0)")
        dev = resolve_device(device)
        with self._lock:
            srv = self._servers.get((shards, dev))
        if srv is not None:
            return srv
        # Build outside the lock: placement copies the whole database to the
        # card, and note_scan and stats() must not wait behind it.
        built = PirServer(self._db, profile=self.profile, device=dev)
        with self._lock:
            # Keep-first on a racing build: every caller converges on one.
            return self._servers.setdefault((shards, dev), built)

    def dispatch_shards(self) -> int:
        """Shard count for the current dispatch: 0 (one card)."""
        return 0

    def note_scan(self, k: int, stream_chunks: int) -> None:
        """One answered query batch: ``k`` queries rode one full-database
        scan of ``stream_chunks`` streamed slabs."""
        with self._lock:
            self.queries += int(k)
            self.scans += 1
            self.bytes_scanned += self.db_bytes
            self.chunk_sum += int(stream_chunks)
            self.chunk_hist[bisect.bisect_left(CHUNK_BOUNDS, int(stream_chunks))] += 1

    def stats(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "profile": self.profile,
                "log_n": self.log_n,
                "rows": self.n_rows,
                "row_bytes": self.row_bytes,
                "db_bytes": self.db_bytes,
                "placements": sorted({s for s, _ in self._servers}),
                "queries": self.queries,
                "scans": self.scans,
                "bytes_scanned": self.bytes_scanned,
            }


class PirRegistry:
    """Process-wide name -> :class:`PirDB` map plus the aggregate scan
    counters."""

    def __init__(self):
        self._dbs: dict[str, PirDB] = {}
        self._lock = threading.Lock()

    def load(self, name: str, db: np.ndarray, profile: str = "compat") -> PirDB:
        """Register (or replace) a named database.  Placement happens at the
        entry's first ``server()`` call: warm it with
        ``plans.warmup([{"route": "pir", "db": name, "k": K}])``."""
        entry = PirDB(name, db, profile=profile)
        with self._lock:
            self._dbs[name] = entry
        return entry

    def get(self, name: str) -> PirDB:
        with self._lock:
            entry = self._dbs.get(name)
        if entry is None:
            raise KeyError(f"pir: unknown db {name!r} (load it first)")
        return entry

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._dbs)

    def drop(self, name: str) -> bool:
        with self._lock:
            return self._dbs.pop(name, None) is not None

    def stats(self) -> dict:
        """Databases resident, bytes scanned and the streamed-slab
        histogram (non-cumulative counts; the last bucket is overflow)."""
        with self._lock:
            dbs = list(self._dbs.values())
        per_db = [d.stats() for d in dbs]
        hist = [0] * (len(CHUNK_BOUNDS) + 1)
        chunk_sum = 0
        for d in dbs:
            with d._lock:
                chunk_sum += d.chunk_sum
                for i, c in enumerate(d.chunk_hist):
                    hist[i] += c
        return {
            "dbs_resident": len(per_db),
            "db_bytes_resident": sum(d["db_bytes"] for d in per_db),
            "queries": sum(d["queries"] for d in per_db),
            "scans": sum(d["scans"] for d in per_db),
            "bytes_scanned": sum(d["bytes_scanned"] for d in per_db),
            "scan_chunks": {
                "bounds": list(CHUNK_BOUNDS),
                "counts": hist,
                "sum": float(chunk_sum),
                "count": sum(hist),
            },
            "resident": per_db,
        }


_REGISTRY = PirRegistry()
_REGISTRY_LOCK = threading.Lock()


def registry() -> PirRegistry:
    # A racing reset() hands the caller the pre-reset registry, which stays
    # usable on its own.
    return _REGISTRY


def reset() -> None:
    """Drop every registered database (frees the host and device copies once
    nothing else holds the servers)."""
    global _REGISTRY
    with _REGISTRY_LOCK:
        _REGISTRY = PirRegistry()


def upload_chunk_rows(row_bytes: int) -> int:
    """Rows per read of a database upload: one ``DPF_CUDA_PIR_DB_CHUNK_BYTES``
    chunk's worth (>= 1; 4 MiB when the knob is 0)."""
    chunk = knobs.get_int("DPF_CUDA_PIR_DB_CHUNK_BYTES")
    if chunk <= 0:
        chunk = 1 << 22
    return max(1, chunk // max(int(row_bytes), 1))
