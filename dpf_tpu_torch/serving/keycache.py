"""Host-repack LRU: repeated keys skip validation + SoA packing.

The sidecar's ``blob`` / ``keys_at`` closures used to rebuild the full
key arrays on EVERY request — canonical-form validation, byte slicing,
struct-of-arrays views — even when a client (a PIR server re-querying
the same DB keys, a retrying proxy) sends byte-identical key material
each time.  This cache keys the parsed batch on a digest of the raw key
bytes, so a repeat hit returns the SAME batch object — which also
carries the device-resident operand memos (``_point_masks`` /
``_device_args``), so the repack, the canonical checks, AND the
key-material H2D upload are all skipped.

Capacity is ``DPF_CUDA_KEY_CACHE_ENTRIES`` batches (default 32; 0
disables).  Entries are whole request key-sets, not individual keys —
the serving hot case is the same batch re-sent verbatim.

The port's counterpart of ``dpf_tpu/serving/keycache.py``, on one
device: the reference's cache key also carries the serving mesh's shard
count, which the port leaves out until its multi-GPU slice (ROADMAP A.6).
A cached batch keeps the device operands the plans memoize on it
(``_plan_padded``, ``_cached_device_keys``), so a repeat also skips the
key upload to the card.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

from ..core import knobs


class KeyCache:
    def __init__(self, entries: int | None = None, lock=None):
        if entries is None:
            entries = knobs.get_int("DPF_CUDA_KEY_CACHE_ENTRIES")
        self.entries = max(int(entries), 0)
        self._lru: OrderedDict = OrderedDict()
        # ``lock`` lets the serving state share its single stats RLock
        # (consistent /v1/stats + /v1/metrics snapshots); standalone
        # caches keep their own.
        self._lock = lock if lock is not None else threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, kind: str, log_n: int, blob, build):
        """Return the parsed batch for ``blob`` (the request's raw key
        bytes — ANY buffer-protocol object: ``bytes``, or the wire2
        front's ``memoryview`` slices of its receive buffer), building
        it via ``build()`` on a miss.  The digest hashes the buffer
        directly (``hashlib.sha256`` takes buffer views), so a lookup
        never copies the key material; byte-identical ``bytes`` and
        ``memoryview`` inputs hit the same entry.  Parse failures
        propagate and are never cached."""
        if not self.entries:
            return build()
        key = (kind, int(log_n), hashlib.sha256(blob).digest())
        with self._lock:
            hit = self._lru.get(key)
            if hit is not None:
                self._lru.move_to_end(key)
                self.hits += 1
                return hit
            self.misses += 1
        val = build()
        with self._lock:
            self._lru[key] = val
            self._lru.move_to_end(key)
            while len(self._lru) > self.entries:
                self._lru.popitem(last=False)
        return val

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._lru),
                "capacity": self.entries,
                "hits": self.hits,
                "misses": self.misses,
            }
