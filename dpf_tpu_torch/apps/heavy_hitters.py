"""Prefix-tree heavy hitters over batched DPF keys.

The port's counterpart of ``dpf_tpu/apps/heavy_hitters.py``.  The protocol
(the DPF half of Poplar-style private heavy hitters, in a trusted-dealer /
two-aggregator model): every client ``c`` holds a private value ``x_c`` in
``[0, 2^n)`` and uploads one DPF key to each of two aggregators; the
aggregators descend the prefix tree level by level, counting how many
clients' values start with each surviving prefix, and keep only prefixes
whose count clears a PUBLIC threshold.  After the leaf round the survivors
ARE the heavy hitters, with exact counts.

Key layout, the models/fss.py comparison-gate layout: client ``c``'s share
is ``n`` full-domain DPF keys, level-major across the batch (key ``i * G +
c`` is client ``c``'s level-``i`` key), where the level-``i`` key's point is
the client's ``(i+1)``-bit prefix shifted back up to ``n`` bits.  Testing
"does ``x_c`` start with prefix ``p``" is then ONE pointwise evaluation of
the level key at ``p << (n - 1 - i)``, and a whole stateless round is one
``eval_points_level_grouped(..., levels=(i,))`` walk launch of all clients
x all candidates.  The incremental descent (``apps/hh_state.py``) extends
the cached frontier of every client's level-``(n-1)`` key instead.

Dealing (:func:`gen_shares`) is ONE batched ``gen_batch`` of ``log_n * G``
level keys on the card (``models/keys_gen.py``).  Reconstruction XORs the
two aggregators' per-(client, candidate) share bits and sums them into
per-candidate counts (:func:`reconstruct_counts`, on the card by default:
``models/hh_fold.py``); the counts, the threshold compare and the surviving
candidate set are public by construction, and the compare runs on the host.

The JAX package's knobs are this module's constants and keyword parameters,
with its defaults: ``DPF_TPU_HH_LEVELS_PER_ROUND`` (:data:`LEVELS_PER_ROUND`),
``DPF_TPU_HH_MAX_CANDIDATES`` (:data:`MAX_CANDIDATES`), ``DPF_TPU_HH_STATE``
(``state=None``: the incremental descent), ``DPF_TPU_HH_FOLD``
(``fold="auto"``: the count fold on the evaluation device) and
``DPF_TPU_HH_THRESHOLD`` (:data:`THRESHOLD`, 0: the caller must pass one).
The rounds go through the plan cache, as the reference's do:
``core/plans.run_hh_level`` (a stateless round), ``run_hh_fold`` (the count
fold on the card) and, in ``apps/hh_state.py``, ``run_hh_extend``.  A device
failure propagates: the reference's finish-stateless recovery has no
counterpart.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..core import bitpack, plans
from ..core.device import resolve_device
from . import hh_state

__all__ = [
    "HHShare",
    "HHRound",
    "HHResult",
    "gen_shares",
    "share_to_blob",
    "share_from_blob",
    "eval_level_shares",
    "reconstruct_counts",
    "find_heavy_hitters",
]

LEVELS_PER_ROUND = 4  # DPF_TPU_HH_LEVELS_PER_ROUND
MAX_CANDIDATES = 4096  # DPF_TPU_HH_MAX_CANDIDATES
THRESHOLD = 0  # DPF_TPU_HH_THRESHOLD: 0 = the caller must pass one

# The struct-of-arrays key-batch field tuple (KeyBatch and KeyBatchFast both
# declare exactly these, in this order): the apps' sub-batch slicing.
BATCH_FIELDS = ("seeds", "ts", "scw", "tcw", "fcw")


def slice_batch(kb, cls, idx):
    """Row-slice a struct-of-arrays key batch into a new ``cls`` batch
    (``idx``: slice or index array over the key axis)."""
    return cls(kb.log_n, *(np.ascontiguousarray(getattr(kb, f)[idx]) for f in BATCH_FIELDS))


def _profile_api(profile: str):
    """(gen_batch, batch_cls, key_len) for a profile."""
    if profile == "fast":
        from ..core.chacha_np import key_len
        from ..core.keys_chacha import KeyBatchFast, gen_batch

        return gen_batch, KeyBatchFast, key_len
    if profile == "compat":
        from ..core.keys import KeyBatch, gen_batch
        from ..core.spec import key_len

        return gen_batch, KeyBatch, key_len
    raise ValueError(f"heavy_hitters: unknown profile {profile!r}")


@dataclass
class HHShare:
    """One aggregator's share of G clients' heavy-hitters keys.

    ``levels`` holds ``log_n * G`` DPF keys, level-major (key ``i*G + c`` is
    client ``c``'s level-``i`` key: the models/fss.py layout)."""

    log_n: int
    levels: object  # KeyBatch | KeyBatchFast, K = log_n * G
    profile: str = "compat"
    # Level sub-batches are sliced once and cached: each carries its own
    # device-operand memos, which must survive across the descent's rounds.
    _level_cache: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def g(self) -> int:
        return self.levels.k // self.log_n

    def level_keys(self, level: int):
        """The G-key sub-batch of every client's level-``level`` key."""
        lv = int(level)
        if not 0 <= lv < self.log_n:
            raise ValueError("heavy_hitters: level out of range")
        sub = self._level_cache.get(lv)
        if sub is None:
            G = self.g
            _, cls, _ = _profile_api(self.profile)
            sub = slice_batch(self.levels, cls, slice(lv * G, (lv + 1) * G))
            self._level_cache[lv] = sub
        return sub


def gen_shares(
    values: np.ndarray | list[int],
    log_n: int,
    profile: str = "compat",
    rng: np.random.Generator | None = None,
    gen=None,
    *,
    device=None,
) -> tuple[HHShare, HHShare]:
    """Trusted-dealer generation of both aggregators' share batches for G
    client values: ONE batched ``gen_batch`` over all ``log_n * G`` level
    DPFs (the per-client point of level ``i`` is the client's ``(i+1)``-bit
    prefix, low bits zeroed), its tower on ``device`` (None: the card;
    ``"cpu"``: the host tower).  ``gen(points, log_n, rng=None)`` overrides
    the profile's gen_batch, as in the reference: the sidecar injects its
    coalescing gen lane (which carries its own device) so /v1/hh/gen rides
    the same dealer dispatch as /v1/gen."""
    if gen is None:
        gen_batch, _, _ = _profile_api(profile)
        dev = resolve_device(device)

        def gen(points, n, rng=None):
            return gen_batch(points, n, rng=rng, device=dev)

    values = np.asarray(values, dtype=np.uint64)
    if values.ndim != 1 or values.shape[0] == 0:
        raise ValueError("heavy_hitters: values must be a non-empty vector")
    if log_n < 1 or log_n > 63:
        raise ValueError("heavy_hitters: log_n out of range")
    if (values >> np.uint64(log_n)).any():
        raise ValueError("heavy_hitters: value out of domain")
    n = log_n
    shifts = (n - 1 - np.arange(n, dtype=np.uint64))[:, None]  # [n, 1]
    points = ((values[None, :] >> shifts) << shifts).reshape(n * values.shape[0])
    ka, kb = gen(points, n, rng=rng)
    return HHShare(n, ka, profile), HHShare(n, kb, profile)


def share_to_blob(share: HHShare) -> bytes:
    """Serialize a share batch CLIENT-major: client ``c``'s blob is its
    ``log_n`` level keys concatenated in level order; clients concatenate in
    order.  ``len == G * log_n * key_len(log_n)``."""
    rows = share.levels.to_bytes()  # level-major: i*G + c
    G, n = share.g, share.log_n
    return b"".join(rows[i * G + c] for c in range(G) for i in range(n))


def share_from_blob(data: bytes, log_n: int, g: int, profile: str = "compat") -> HHShare:
    """Parse the client-major wire blob back into a level-major share batch
    (inverse of :func:`share_to_blob`)."""
    _, cls, key_len = _profile_api(profile)
    kl = key_len(log_n)
    if len(data) != g * log_n * kl:
        raise ValueError(f"heavy_hitters: blob must be {g}*{log_n}*{kl} bytes")
    keys = [
        bytes(data[(c * log_n + i) * kl : (c * log_n + i + 1) * kl])
        for i in range(log_n)
        for c in range(g)
    ]
    return HHShare(log_n, cls.from_bytes(keys, log_n), profile)


def eval_level_shares(share: HHShare, level: int, candidates: np.ndarray,
                      device=None) -> np.ndarray:
    """Single-aggregator round primitive: evaluate every client's
    level-``level`` key at every candidate on ``device`` (None: the card) ->
    packed share words uint32[G, ceil(Q/32)] (core/bitpack contract;
    candidate ``q`` of client row ``c`` at word q//32, bit q%32).  One walk
    launch (``walk_bm_kernel`` or ``walk_kernel``), through the plan cache
    (``core/plans.run_hh_level``: one plan per (G, Q) bucket covers every
    level of a descent).

    ``candidates`` are RAW n-bit domain values; bits below the level's
    prefix are masked off on the way in (a depth-``level+1`` prefix ``p`` is
    passed as ``p << (log_n - 1 - level)``)."""
    candidates = np.asarray(candidates, dtype=np.uint64).reshape(-1)
    kb = share.level_keys(level)
    xs = np.broadcast_to(candidates[None, :], (kb.k, candidates.shape[0]))
    hh_state.PRG_EVALS.add(hh_state.stateless_round_evals(kb.nu, kb.k, candidates.shape[0]))
    return plans.run_hh_level(share.profile, kb, xs, int(level), device=device)


def _host_counts(x: np.ndarray, q: int) -> np.ndarray:
    """Per-bit popcounts over the packed word columns -> int64[q]: peak
    host memory O(clients), never the unpacked [clients, q] bit matrix."""
    counts = np.zeros(q, np.int64)
    for w in range(min(x.shape[1], bitpack.packed_words(q))):
        col = x[:, w]
        for j in range(min(32, q - 32 * w)):
            counts[32 * w + j] = np.count_nonzero(col & np.uint32(1 << j))
    return counts


def reconstruct_counts(rows_a: np.ndarray, rows_b: np.ndarray, q: int, fold: str = "auto",
                       device=None) -> np.ndarray:
    """XOR-reconstruct the two aggregators' packed share rows and sum over
    clients -> PUBLIC per-candidate counts int64[q].

    ``fold`` (the JAX package's ``DPF_TPU_HH_FOLD``): ``"device"`` sums on
    ``device`` (None: the card; ``plans.run_hh_fold``), ``"host"``
    takes per-bit popcounts on the host, ``"auto"`` the device fold on the
    card and the host popcounts for ``device="cpu"``.  Counts are additive
    over disjoint client partitions."""
    if rows_a.shape != rows_b.shape:
        raise ValueError("heavy_hitters: share row shapes differ")
    if fold not in ("auto", "host", "device"):
        raise ValueError(f"heavy_hitters: unknown fold {fold!r} (auto|host|device)")
    x = rows_a ^ rows_b
    q = int(q)
    if fold == "auto":
        fold = "host" if resolve_device(device).type == "cpu" else "device"
    if fold == "host":
        return _host_counts(x, q)
    qq = min(q, x.shape[1] * 32)  # short rows count 0, as on the host
    counts = np.zeros(q, np.int64)
    if qq:
        counts[:qq] = plans.run_hh_fold(
            np.ascontiguousarray(x[:, : bitpack.packed_words(qq)]), qq, device=device)
    return counts


@dataclass
class HHRound:
    """Public per-round protocol record."""

    depth: int  # prefix length AFTER this round
    levels: int  # tree levels descended this round
    n_candidates: int
    n_survivors: int
    truncated: bool  # frontier clipped to max_candidates
    eval_s: float  # wall seconds in the two share evaluations
    key_evals: int  # clients x candidates x 2 aggregators
    # PRG level-evaluations this round (both aggregators; hh_state.PRG_EVALS
    # delta).  Stateless rounds pay clients x candidates x (nu + 1) per
    # aggregator; incremental rounds pay clients x surviving parents per
    # extended level and ZERO for intra-leaf folds.
    prg_level_evals: int = 0


@dataclass
class HHResult:
    values: np.ndarray  # uint64 [H]: the heavy hitters
    counts: np.ndarray  # int64 [H]: their exact client counts
    rounds: list  # list[HHRound]


def _resolve_threshold(threshold) -> int:
    if threshold is None:
        threshold = THRESHOLD
    threshold = int(threshold)
    if threshold < 1:
        raise ValueError("heavy_hitters: threshold must be >= 1 (pass one explicitly)")
    return threshold


def find_heavy_hitters(
    eval_a,
    eval_b,
    log_n: int | None = None,
    threshold: int | None = None,
    levels_per_round: int | None = None,
    max_candidates: int | None = None,
    state: bool | None = None,
    *,
    fold: str = "auto",
    device=None,
) -> HHResult:
    """Two-aggregator protocol driver: thresholded prefix-tree descent.

    ``eval_a`` / ``eval_b`` are the aggregators: :class:`HHShare` batches
    (evaluated in-process on ``device``, None: the card) or callables
    ``(level, candidates) -> packed rows`` (``log_n`` is required for
    those).  Each round descends ``levels_per_round`` levels (None:
    :data:`LEVELS_PER_ROUND`): the frontier's survivors extend to ``2^R``
    candidates each, both aggregators evaluate all candidates against every
    client, the XOR-reconstructed counts (``fold`` as in
    :func:`reconstruct_counts`) are thresholded on the host, and the
    survivors become the next frontier.  ``R`` shrinks (down to 1) when the
    extension would exceed ``max_candidates`` (None: :data:`MAX_CANDIDATES`);
    if even the 2-way extension exceeds the cap at ``R = 1`` the
    lowest-count survivors are dropped and the round is flagged
    ``truncated``.

    ``state`` (None: on) selects the incremental descent
    (apps/hh_state.py): each aggregator's frontier stays on the card and
    every round extends only the surviving parents.  It needs in-process
    :class:`HHShare` aggregators; callables always evaluate stateless.  The
    recovered hitter set and counts are IDENTICAL either way."""
    if isinstance(eval_a, HHShare):
        if isinstance(eval_b, HHShare):
            if (
                eval_a.log_n != eval_b.log_n
                or eval_a.g != eval_b.g
                or eval_a.profile != eval_b.profile
            ):
                raise ValueError("heavy_hitters: share batches disagree")
        log_n = eval_a.log_n
    if log_n is None:
        raise ValueError("heavy_hitters: log_n required with callables")
    n = int(log_n)
    threshold = _resolve_threshold(threshold)
    if levels_per_round is None:
        levels_per_round = LEVELS_PER_ROUND
    levels_per_round = max(int(levels_per_round), 1)
    if max_candidates is None:
        max_candidates = MAX_CANDIDATES
    max_candidates = max(int(max_candidates), 2)

    if state is None:
        state = True
    frontiers: dict = {}
    if state and isinstance(eval_a, HHShare) and isinstance(eval_b, HHShare):
        for agg in (eval_a, eval_b):
            frontiers[id(agg)] = hh_state.FrontierState(
                agg.profile, agg.level_keys(n - 1), device=device)

    def advance(fstate, cands, depth):
        try:
            return fstate.advance(cands, depth)
        except hh_state.StaleState:
            fstate.reset()  # replant at the root; the replay is byte-identical
            return fstate.advance(cands, depth)

    def run(agg, level, cand_values):
        if isinstance(agg, HHShare):
            return eval_level_shares(agg, level, cand_values, device=device)
        return agg(level, cand_values)

    def run_round(level, cands, cand_values):
        # A round's two row sets come from the SAME key pair: the
        # incremental path evaluates both aggregators' level-(n-1) keys, the
        # stateless path both aggregators' level-`level` keys.
        if frontiers:
            return (advance(frontiers[id(eval_a)], cands, level + 1),
                    advance(frontiers[id(eval_b)], cands, level + 1))
        return run(eval_a, level, cand_values), run(eval_b, level, cand_values)

    depth = 0
    frontier = np.zeros(1, np.uint64)  # the empty prefix
    frontier_counts = np.zeros(1, np.int64)
    rounds: list[HHRound] = []
    while depth < n and frontier.size:
        r = min(levels_per_round, n - depth)
        while r > 1 and (frontier.size << r) > max_candidates:
            r -= 1
        truncated = False
        if (frontier.size << r) > max_candidates:  # r == 1, frontier huge
            keep_n = max_candidates >> r
            order = np.argsort(frontier_counts, kind="stable")[::-1][:keep_n]
            sel = np.sort(order)
            frontier = frontier[sel]
            frontier_counts = frontier_counts[sel]
            truncated = True
        ext = np.arange(1 << r, dtype=np.uint64)
        cands = ((frontier[:, None] << np.uint64(r)) | ext[None, :]).reshape(-1)
        depth += r
        level = depth - 1
        cand_values = cands << np.uint64(n - depth)
        t0 = time.perf_counter()
        prg0 = hh_state.PRG_EVALS.value
        rows_a, rows_b = run_round(level, cands, cand_values)
        eval_s = time.perf_counter() - t0
        rows_a = _as_words(rows_a, cands.size)
        rows_b = _as_words(rows_b, cands.size)
        counts = reconstruct_counts(rows_a, rows_b, cands.size, fold, device)
        keep = counts >= threshold
        frontier = cands[keep]
        frontier_counts = counts[keep]
        rounds.append(
            HHRound(
                depth=depth,
                levels=r,
                n_candidates=int(cands.size),
                n_survivors=int(frontier.size),
                truncated=truncated,
                eval_s=eval_s,
                key_evals=2 * int(rows_a.shape[0]) * int(cands.size),
                prg_level_evals=hh_state.PRG_EVALS.value - prg0,
            )
        )
    return HHResult(values=frontier, counts=frontier_counts, rounds=rounds)


def _as_words(rows, q: int) -> np.ndarray:
    """Normalize an aggregator reply to packed words uint32[G, wq]: a
    callable aggregator may return packed wire bytes (the row length gives
    the client count) or word arrays."""
    if isinstance(rows, (bytes, bytearray)):
        row = bitpack.packed_bytes(q)
        if row == 0 or len(rows) % row:
            raise ValueError("heavy_hitters: packed reply length mismatch")
        return bitpack.wire_to_words(rows, len(rows) // row, q)
    return np.asarray(rows)
