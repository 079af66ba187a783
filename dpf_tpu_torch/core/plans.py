"""Persistent dispatch plans, each full-domain and pointwise plan a CUDA graph.

The port's counterpart of ``dpf_tpu/core/plans.py``, the dispatch seam that
the apps, the dealer and (later) the sidecar call.  It pins the shape space
of serving traffic down to a small closed set of **plans**:

  * a plan is keyed on ``(route, profile, log_n, K-bucket, Q-bucket,
    packed, fuse, sbox, mesh, tuned, variant)`` (:class:`PlanKey`).  K is
    bucketed to powers of two (requests pad up with zero keys and slice the
    padding back off: "pad + mask"), Q to power-of-two multiples of 32 (the
    packed-word quantum), so the number of live plans is logarithmic in the
    request-shape space.
  * on the card, the plan of a full-domain (``evalfull``) or pointwise
    (``points``, ``dcf_points``) route owns a captured CUDA graph: the
    counterpart of the reference's compiled executable.  Its first use (or
    :func:`warmup`) builds static input tensors of the bucket's shape on the
    card (the key operands of ``k_bucket`` keys, the queries of
    ``q_bucket``), runs the model's device body once eagerly on a side
    stream, then captures it once with ``torch.cuda.graph``.  A hit copies
    the request's padded operands into the static inputs on the current
    stream, replays the graph, copies the output out and slices it to K
    (and Q).  The host work stays outside the graph: key packing (cached
    per padded batch), the query split into 32-bit halves, the D2H copy and
    the tail masking.
  * the other routes (``dcf_interval``, ``hh_*``, ``agg_*``, ``pir``,
    ``gen``) keep the same bucket, pad and cache bookkeeping and run their
    model calls eagerly.
  * on the CPU every route runs eagerly on the plain versions, and
    :func:`capture_count` stays 0.
  * :func:`warmup` builds the plans for a deployment's expected shapes
    before traffic arrives; after it, traffic inside those buckets captures
    nothing (:func:`capture_count` does not move): the reference's
    zero-retrace contract (``trace_count``) carried onto the card.

There is no fallback: a capture or replay that fails on the card raises,
naming the plan key; the eager body never runs in its place.  The kernel
wrappers' launch counters advance at the warm run and the capture, never at
a replay; a plan counts its own ``replays``.  Each graph keeps a private
memory pool (``pool_bytes``: the allocator segments the pool owns);
``cache().clear()`` drops the graphs and their pools.

Every ``run_*`` takes a trailing ``device=None``: the card, raising without
one unless the caller passes ``device="cpu"``.  Each returns what the
reference's returns, sliced back to K (and Q).  Not yet here: the mesh
branches (ROADMAP A.6), tuned plans and ``forced_tuned`` and the trace
events (A.9), and buffer donation (no counterpart: a graph's pool is its
own).  ``PlanKey.mesh`` is always 0 and ``PlanKey.tuned`` always ``""``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from ..ops.aes_bitslice import from_carrier, to_carrier
from . import bitpack, knobs
from .device import resolve_device

# The port's one S-box (ops/sbox_circuit.sbox_bp113, csrc/sbox_bp113.cuh).
SBOX = "bp113"


def k_floor() -> int:
    """Minimum K bucket (``DPF_CUDA_PLAN_KFLOOR``, default 1)."""
    return knobs.get_int("DPF_CUDA_PLAN_KFLOOR")


def _pow2_bucket(n: int, floor: int = 1) -> int:
    n = max(int(n), int(floor), 1)
    return 1 << (n - 1).bit_length()


def k_bucket(k: int) -> int:
    return _pow2_bucket(k, k_floor())


def q_bucket(q: int) -> int:
    """Query-count bucket: power-of-two multiples of the 32-bit packed word
    (so the packed word count is itself stable per bucket)."""
    return _pow2_bucket(q, 32)


# ---------------------------------------------------------------------------
# Plan identity
# ---------------------------------------------------------------------------

# The closed set of plan-cacheable dispatch routes (the reference's).
PLAN_ROUTES = frozenset(
    {
        "points", "dcf_points", "dcf_interval", "evalfull", "hh_level",
        "hh_extend", "hh_fold", "agg_xor", "agg_add", "pir", "gen",
    }
)


class PlanKey(NamedTuple):
    route: str  # one of PLAN_ROUTES
    profile: str  # "compat" | "fast" (gen: the key family; "agg", "public")
    log_n: int
    k_bucket: int
    q_bucket: int  # 0 for full-domain routes
    packed: bool
    fuse: str  # DPF_CUDA_FUSE in force
    sbox: str  # the port's one S-box
    mesh: int = 0  # always 0: the mesh comes with ROADMAP A.6
    tuned: str = ""  # always "": tuned plans come with A.9
    variant: str = ""  # sub-route tag (hh_extend phase/shape; compat evalfull backend)


def plan_key(
    route: str, profile: str, log_n: int, k: int, q: int = 0,
    packed: bool = True, mesh: int = 0, variant: str = "",
) -> PlanKey:
    if route not in PLAN_ROUTES:
        raise ValueError(
            f"plans: unknown route {route!r} (registered: "
            f"{'/'.join(sorted(PLAN_ROUTES))})"
        )
    if mesh:
        raise ValueError("plans: the port has no serving mesh yet (mesh must be 0)")
    return PlanKey(
        route, profile, int(log_n), k_bucket(k), q_bucket(q) if q else 0,
        bool(packed), knobs.get_str("DPF_CUDA_FUSE"), SBOX, 0, "", str(variant),
    )


def _key_str(key: PlanKey) -> str:
    return "/".join(str(f) for f in key)


class Plan:
    """One cached dispatch plan: shape bucket, counters and, for a graph
    route on the card, the captured graph with its static inputs and
    output.  ``lock`` serializes copy-in, replay and copy-out, since the
    static tensors are shared."""

    __slots__ = ("key", "hits", "misses", "compile_s", "last_used", "lock", "graph",
                 "static_in", "static_out", "replays", "pool_bytes", "capture_s")

    def __init__(self, key: PlanKey):
        self.key = key
        self.hits = 0
        self.misses = 0
        self.compile_s = 0.0
        self.last_used = 0.0
        self.lock = threading.Lock()
        self.graph = None
        self.static_in: tuple = ()
        self.static_out = None
        self.replays = 0
        self.pool_bytes = 0
        self.capture_s = 0.0

    def as_dict(self) -> dict:
        return {
            "key": _key_str(self.key),
            "hits": self.hits,
            "misses": self.misses,
            "compile_s": round(self.compile_s, 3),
            "graph": self.graph is not None,
            "replays": self.replays,
            "pool_bytes": self.pool_bytes,
            "capture_s": round(self.capture_s, 3),
        }

    def release(self) -> None:
        """Drop the graph and its static tensors (its pool goes with them)."""
        with self.lock:
            if self.graph is not None:
                self.graph.reset()
            self.graph, self.static_in, self.static_out = None, (), None


class PlanCache:
    def __init__(self):
        self._plans: dict[PlanKey, Plan] = {}
        self._lock = threading.Lock()

    def get(self, key: PlanKey) -> tuple[Plan, bool]:
        """-> (plan, first_use).  ``first_use`` marks the warmup/capture
        visit (the caller stamps compile_s on it)."""
        with self._lock:
            plan = self._plans.get(key)
            if plan is None:
                plan = self._plans[key] = Plan(key)
                plan.misses += 1
                return plan, True
            plan.hits += 1
            return plan, False

    def stats(self) -> dict:
        with self._lock:
            plans = [p.as_dict() for p in self._plans.values()]
        return {
            "plans": plans,
            "hits": sum(p["hits"] for p in plans),
            "misses": sum(p["misses"] for p in plans),
            "graphs": sum(p["graph"] for p in plans),
            "replays": sum(p["replays"] for p in plans),
            "pool_bytes": sum(p["pool_bytes"] for p in plans),
        }

    def clear(self) -> None:
        """Forget every plan, releasing the graphs and their pools."""
        with self._lock:
            plans = list(self._plans.values())
            self._plans.clear()
        for p in plans:
            p.release()
        if any(p.pool_bytes for p in plans):
            torch.cuda.empty_cache()


_CACHE = PlanCache()


def cache() -> PlanCache:
    return _CACHE


def capture_count() -> int:
    """CUDA graphs captured and held by the plan cache: the port's retrace
    detector (the reference's ``trace_count``).  After :func:`warmup` of a
    deployment's shapes, traffic inside those buckets must not move it."""
    with _CACHE._lock:
        return sum(p.graph is not None for p in _CACHE._plans.values())


def _stamp(plan: Plan, first: bool, t0: float) -> None:
    if first:
        plan.compile_s = time.perf_counter() - t0
    plan.last_used = time.time()


# ---------------------------------------------------------------------------
# Graph capture and replay
# ---------------------------------------------------------------------------


def _capture(plan: Plan, body, operands: tuple, dev: torch.device) -> None:
    """Capture ``body`` over static copies of ``operands`` (None stays
    None) into ``plan``: one eager warm run on a side stream first (it
    builds and loads the kernels' libraries and makes the per-device
    constants, none of which a capture may do), then the capture, whose
    private pool holds the body's intermediates and output."""
    try:
        with torch.cuda.device(dev):
            static = tuple(None if x is None else x.to(dev, copy=True) for x in operands)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                body(*static)
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = body(*static)
            torch.cuda.synchronize()
            plan.capture_s = time.perf_counter() - t0
            plan.pool_bytes = _pool_bytes(graph)
    except Exception as e:
        raise RuntimeError(f"plans: capturing {_key_str(plan.key)} failed: {e}") from e
    plan.graph, plan.static_in, plan.static_out = graph, static, out


def _pool_bytes(graph) -> int:
    """Card memory held by ``graph``'s private pool: the caching
    allocator's segments that the pool owns."""
    pool = tuple(graph.pool())
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == pool)


def _graph_run(plan: Plan, dev: torch.device, body, operands: tuple) -> torch.Tensor:
    """``body(*operands)`` through ``plan``: eagerly on the CPU; on the card,
    the plan's graph (captured at the first call) replayed over the
    operands copied into its static inputs.  The caller holds
    ``plan.lock`` until it has copied the returned tensor out."""
    if dev.type != "cuda":
        return body(*operands)
    if plan.graph is None:
        _capture(plan, body, operands, dev)
    else:
        for s, x in zip(plan.static_in, operands, strict=True):
            if s is not None:
                s.copy_(x)
    try:
        plan.graph.replay()
    except Exception as e:
        raise RuntimeError(f"plans: replaying {_key_str(plan.key)} failed: {e}") from e
    plan.replays += 1
    return plan.static_out


# ---------------------------------------------------------------------------
# Pad + mask execution helpers
# ---------------------------------------------------------------------------


def _pad_keys(kb, pad: int):
    """Zero-pad a struct-of-arrays key batch (``KeyBatch``, ``KeyBatchFast``
    or ``DcfKeyBatch``) by ``pad`` keys, memoized on the batch: zero keys
    are canonical in every profile, and the memo keeps repeated dispatches
    of one batch on the SAME padded object, so its device operand caches
    survive across calls.  The reference pads its two DPF batches in
    ``parallel/sharding.py``, not ported yet; this is the port's own."""
    if not pad:
        return kb
    memo = kb.__dict__.setdefault("_plan_padded", {})
    padded = memo.get(pad)
    if padded is None:
        arrays = {f.name: getattr(kb, f.name) for f in dataclasses.fields(kb)
                  if not f.name.startswith("_") and f.name != "log_n"}
        padded = memo[pad] = type(kb)(log_n=kb.log_n, **{
            n: np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
            for n, a in arrays.items()
        })
    return padded


def _pad_queries(xs: np.ndarray, kb_: int, qb: int) -> np.ndarray:
    """Pad the query tensor to its plan bucket on BOTH axes (padded keys
    evaluate at index 0; padded queries are masked off the output)."""
    k, q = xs.shape
    if k == kb_ and q == qb:
        return xs
    out = np.zeros((kb_, qb), np.uint64)
    out[:k, :q] = xs
    return out


def _checked_queries(what: str, kb, xs) -> np.ndarray:
    xs = np.asarray(xs, dtype=np.uint64)
    if xs.ndim != 2 or xs.shape[0] != kb.k:
        raise ValueError(f"{what}: xs must be [K, Q], K the key count")
    if (xs >> np.uint64(kb.log_n)).any():
        raise ValueError(f"{what}: query index out of domain")
    return xs


def _points_body(route: str, profile: str, kbp, xs_p: np.ndarray, dev):
    """(body, operands) of a pointwise plan: the model's device body over
    the key operands of the padded batch (cached on it, on ``dev``) and the
    padded queries' 32-bit halves (host tensors, copied in) -> packed words
    int32[Kb, Qb / 32]."""
    from ..models import dpf as mdpf
    from ..ops import chacha_cuda as cp

    log_n, nu = kbp.log_n, kbp.nu
    xs_hi, xs_lo = mdpf._split_words(xs_p, log_n, "cpu")  # [Kb, Qb] each
    if route == "points" and profile == "compat":
        walk = mdpf._WALK_IMPLS[None]

        def body(seed_m, t_m, scw_m, tl_m, tr_m, fcw_m, lo, hi):
            return mdpf._eval_points_walk_body(nu, log_n, seed_m, t_m, scw_m, tl_m, tr_m,
                                               fcw_m, hi, lo, walk)

        return body, (*mdpf._point_masks(kbp, dev), xs_lo, xs_hi)

    def queries(lo, hi):  # the fast walks' [Q, K] layout
        return lo.T.contiguous(), None if hi is None else hi.T.contiguous()

    if route == "points":
        def body(meta, seeds_t, scw_t, tcw_t, fcw_t, lo, hi):
            bits = cp.walk(meta, seeds_t, scw_t, tcw_t, fcw_t, *queries(lo, hi), log_n, nu)
            return bitpack.pack_bits_qmajor_torch(bits)

        return body, (*cp.walk_operands(kbp, 0, dev), xs_lo, xs_hi)

    def body(meta, seeds_t, scw_t, tcw_t, vcw_t, fcw_t, lo, hi):
        bits = cp.walk_dcf(meta, seeds_t, scw_t, tcw_t, vcw_t, fcw_t, *queries(lo, hi),
                           log_n, nu)
        return bitpack.pack_bits_qmajor_torch(bits)

    return body, (*cp.dcf_walk_operands(kbp, dev), xs_lo, xs_hi)


def _evalfull_body(profile: str, kbp, dev, backend: str):
    """(body, operands) of a full-domain plan: the model's
    ``eval_full_device`` over the padded batch's key tensors (cached on it,
    on ``dev``) -> leaf words, int32[Kp, 2^nu, 4] (compat, on ``backend``)
    or int32[K8, 2^nu, 16] (fast)."""
    from ..models import dpf as mdpf
    from ..models import dpf_chacha as mdc

    if profile == "compat":
        dk = mdpf._cached_device_keys(kbp, dev)

        def body(*tensors):
            return mdpf.eval_full_device(dk.with_tensors(tensors), mdpf.MAX_PLANE_WORDS, backend)
    else:
        dk = mdpf._cached_device_keys(kbp, dev, mdc._padded_device_keys)

        def body(*tensors):
            return mdc.eval_full_device(dk.with_tensors(tensors))

    return body, dk.tensors()


# ---------------------------------------------------------------------------
# The routes
# ---------------------------------------------------------------------------


def run_points(route: str, profile: str, kb, xs: np.ndarray, device=None) -> np.ndarray:
    """Plan-cached pointwise evaluation -> packed words uint32[K,
    ceil(Q/32)] (core/bitpack contract).  ``route`` is "points" (profile
    selects compat/fast) or "dcf_points".  On the card the plan's graph
    runs one walk launch (``walk_bm_kernel``, ``walk_kernel`` or
    ``walk_dcf_kernel``) over the padded batch."""
    if route not in ("points", "dcf_points"):
        raise ValueError(f"run_points: route {route!r} is not points|dcf_points")
    if route == "points" and profile not in ("compat", "fast"):
        raise ValueError(f"run_points: unknown profile {profile!r}")
    xs = _checked_queries(route, kb, xs)
    K, Q = xs.shape
    dev = resolve_device(device)
    if not xs.size:  # no keys or no queries: nothing to dispatch
        return bitpack.empty_rows(K, Q, True)
    key = plan_key(route, profile, kb.log_n, K, Q, packed=True)
    plan, first = _CACHE.get(key)
    t0 = time.perf_counter()
    kbp = _pad_keys(kb, key.k_bucket - K)
    body, operands = _points_body(route, profile, kbp,
                                  _pad_queries(xs, key.k_bucket, key.q_bucket), dev)
    with plan.lock:
        out = _graph_run(plan, dev, body, operands)
        words = from_carrier(out[:K, : bitpack.packed_words(Q)])
    _stamp(plan, first, t0)
    return bitpack.mask_tail(words, Q)


def run_interval(ik, xs: np.ndarray, device=None) -> np.ndarray:
    """Plan-cached DCF interval evaluation (``ik`` = one party's (upper,
    lower, const) triple) -> packed words uint32[K, ceil(Q/32)].  Eager:
    one ``walk_dcf_kernel`` launch over the fused 2K-key batch."""
    from ..models import dcf

    upper, lower, const = ik[0], ik[1], ik[2]
    xs = _checked_queries("dcf_interval", upper, xs)
    K, Q = xs.shape
    dev = resolve_device(device)
    key = plan_key("dcf_interval", "fast", upper.log_n, K, Q, packed=True)
    plan, first = _CACHE.get(key)
    t0 = time.perf_counter()
    pad = key.k_bucket - K
    if pad:
        # The padded triple memoizes on the upper batch so a re-queried
        # gate set reuses its fused 2K-key device operands.
        cached = upper.__dict__.get("_plan_interval_padded")
        if cached is not None and cached[0] is lower and cached[1] == pad:
            up, lp, cp_ = cached[2]
        else:
            up, lp = _pad_keys(upper, pad), _pad_keys(lower, pad)
            cp_ = np.concatenate([np.asarray(const, np.uint8), np.zeros(pad, np.uint8)])
            upper._plan_interval_padded = (lower, pad, (up, lp, cp_))
    else:
        up, lp, cp_ = upper, lower, const
    words = dcf.eval_interval_points((up, lp, cp_), _pad_queries(xs, key.k_bucket, key.q_bucket),
                                     packed=True, device=dev)
    _stamp(plan, first, t0)
    return bitpack.mask_tail(np.ascontiguousarray(words[:K, : bitpack.packed_words(Q)]), Q)


def run_hh_level(profile: str, kb, xs: np.ndarray, level: int, device=None) -> np.ndarray:
    """Plan-cached heavy-hitters round: every client's level-``level`` key
    (``kb``, K keys) at every candidate (``xs`` uint64[K, Q]) -> packed
    share words uint32[K, ceil(Q/32)].  Dispatches through
    ``eval_points_level_grouped(..., levels=(level,))``: the level only
    steers the host-side query masking, so one plan per (K, Q) bucket
    covers every level of a descent.  Eager: one walk launch."""
    xs = np.asarray(xs, dtype=np.uint64)
    K, Q = xs.shape
    if K != kb.k:
        raise ValueError("hh: xs first axis must match key batch")
    dev = resolve_device(device)
    key = plan_key("hh_level", profile, kb.log_n, K, Q, packed=True)
    plan, first = _CACHE.get(key)
    t0 = time.perf_counter()
    kbp = _pad_keys(kb, key.k_bucket - K)
    if profile == "fast":
        from ..models.dpf_chacha import eval_points_level_grouped
    else:
        from ..models.dpf import eval_points_level_grouped
    words = eval_points_level_grouped(
        kbp, _pad_queries(xs, key.k_bucket, key.q_bucket), groups=1, packed=True,
        levels=(int(level),), device=dev,
    )
    _stamp(plan, first, t0)
    return bitpack.mask_tail(np.ascontiguousarray(words[:K, : bitpack.packed_words(Q)]), Q)


def run_hh_extend(
    profile: str, log_n: int, k: int, phase: str, state: tuple, args: tuple,
    *, q: int, m: int = 0, ibits: int = 0, device=None,
):
    """Plan-cached incremental frontier extension (apps/hh_state.py): expand
    the cached descent frontier ``state`` (tensors on the card) ONE level.
    ``args`` are the public operands (the survivor selector or leaf gather
    index, int64 on the state's device, and the level's correction words),
    ``q`` the bucketed candidate width.  Phases: ``tree`` (one GGM level
    step over the gathered parents), ``leaf_first`` (the leaf conversion of
    the gathered seeds, folded to the first intra-leaf depth), ``leaf_fold``
    (XOR folds over the resident leaf state: zero PRG evaluations).
    Returns ``(new_state, rows)``: ``rows`` the packed candidate share words
    uint32[Kp, q // 32] on the host, ``new_state`` still on the card.
    Eager."""
    if phase not in ("tree", "leaf_first", "leaf_fold"):
        raise ValueError(f"hh_extend: unknown phase {phase!r}")
    resolve_device(device)
    fast = profile == "fast"
    if phase == "tree":
        variant = f"tree{state[0].shape[2] if fast else state[1].shape[0]}"
    elif phase == "leaf_first":
        variant = "leaf1"
    else:
        variant = f"fold{m}x{state[0].shape[1]}"
    key = plan_key("hh_extend", profile, log_n, k, q, packed=True, variant=variant)
    plan, first = _CACHE.get(key)
    t0 = time.perf_counter()
    if fast:
        from ..models import dpf_chacha as _m

        bodies = (_m._hh_extend_cc_body, _m._hh_leaf_first_cc_body, _m._hh_leaf_fold_cc_body)
    else:
        from ..models import dpf as _m

        bodies = (_m._hh_extend_body, _m._hh_leaf_first_body, _m._hh_leaf_fold_body)
    if phase == "tree":
        out = bodies[0](*state, *args)
        new_state, rows_dev = tuple(out[:-1]), out[-1]
    elif phase == "leaf_first":
        out = bodies[1](ibits, *state, *args)
        new_state, rows_dev = (out[0],), out[1]
    else:
        new_state, rows_dev = state, bodies[2](m, ibits, *state, *args)
    # The new frontier stays on the card; only the packed rows cross.
    rows = from_carrier(rows_dev)
    _stamp(plan, first, t0)
    return new_state, rows


def run_hh_fold(rows_xor: np.ndarray, q: int | None = None, device=None) -> np.ndarray:
    """Plan-cached count fold: XOR-reconstructed PUBLIC predicate rows
    uint32[G, W] -> int64[q] per-candidate counts (``models/hh_fold``).
    Rows and word columns are bucketed like every plan (zero rows add zero
    counts).  Secret share rows must never reach this route un-XORed.
    Eager."""
    from ..models import hh_fold

    rows_xor = np.asarray(rows_xor, dtype=np.uint32)
    if rows_xor.ndim != 2:
        raise ValueError("hh_fold: rows must be [G, W]")
    G, W = rows_xor.shape
    q = W * 32 if q is None else int(q)
    if q > W * 32:
        raise ValueError("hh_fold: q exceeds packed row width")
    dev = resolve_device(device)
    key = plan_key("hh_fold", "public", 0, G, W * 32, packed=True)
    plan, first = _CACHE.get(key)
    t0 = time.perf_counter()
    rows_p = np.zeros((key.k_bucket, key.q_bucket // 32), np.uint32)
    rows_p[:G, :W] = rows_xor
    counts = hh_fold.count_fold(rows_p, dev)
    _stamp(plan, first, t0)
    return np.ascontiguousarray(counts[:q])


def run_agg_fold(op: str, carry: np.ndarray | None, rows, device=None) -> np.ndarray:
    """Plan-cached aggregation fold: uint32[R, W] share rows into the
    uint32[W] carry (zeros when None) -> uint32[W].  Rows and words are
    bucketed like every other plan (zero rows and zero word columns are the
    identity of both ops).  ``rows`` may also be int32 carriers already on
    the card (``aggregate_eval_full``'s expansions), folded where they are.
    Eager."""
    from ..apps import aggregation as agg

    if op not in agg.OPS:
        raise ValueError(f"agg: unknown op {op!r} (use xor|add)")
    on_card = isinstance(rows, torch.Tensor)
    if not on_card:
        rows = np.asarray(rows, dtype=np.uint32)
    if rows.ndim != 2:
        raise ValueError("agg: rows must be [R, W]")
    R, W = rows.shape
    dev = resolve_device(device)
    key = plan_key(f"agg_{op}", "agg", 0, R, W * 32, packed=True)
    plan, first = _CACHE.get(key)
    t0 = time.perf_counter()
    rb, wb = key.k_bucket, key.q_bucket // 32
    if on_card:
        rows_t = torch.nn.functional.pad(rows, (0, wb - W, 0, rb - R))
    else:
        rows_p = np.zeros((rb, wb), np.uint32)
        rows_p[:R, :W] = rows
        rows_t = to_carrier(rows_p, dev)
    carry_p = np.zeros(wb, np.uint32)
    if carry is not None:
        carry = np.asarray(carry, dtype=np.uint32)
        if carry.shape != (W,):
            raise ValueError("agg: carry must be [W]")
        carry_p[:W] = carry
    out = from_carrier(agg._fold_body(op, to_carrier(carry_p, rows_t.device), rows_t))
    _stamp(plan, first, t0)
    return np.ascontiguousarray(out[:W])


def run_pir(db, kb, device=None) -> np.ndarray:
    """Plan-cached 2-server PIR answer: ``db`` a registered
    :class:`~dpf_tpu_torch.apps.pir_store.PirDB`, ``kb`` a query key batch
    in the database's profile -> uint8[K, row_bytes].  Keyed on the
    database's shape, ``(log_n, row bits)``, not its name.  Eager: the
    selection expansion and the parity scan of ``models/pir.py``."""
    K = kb.k
    if kb.log_n != db.log_n:
        raise ValueError(f"pir: query domain 2^{kb.log_n} != db domain 2^{db.log_n}")
    dev = resolve_device(device)
    shards = db.dispatch_shards()
    key = PlanKey("pir", db.profile, int(db.log_n), k_bucket(K), int(db.row_bytes) * 8,
                  True, knobs.get_str("DPF_CUDA_FUSE"), SBOX, shards, "")
    plan, first = _CACHE.get(key)
    t0 = time.perf_counter()
    srv = db.server(shards, device=dev)
    rows = srv.answer(_pad_keys(kb, key.k_bucket - K))
    _stamp(plan, first, t0)
    db.note_scan(K, srv.stream_chunks)
    return np.ascontiguousarray(rows[:K])


def run_gen(
    kind: str, alphas: np.ndarray, log_n: int,
    s0: np.ndarray, t0: np.ndarray, s1: np.ndarray, t1: np.ndarray, device=None,
) -> tuple:
    """Plan-cached key generation (the dealer route): drawn root seeds +
    secret alphas -> one (key_a, key_b) batch pair, byte-identical to the
    host tower on the same seeds.  ``kind`` ("compat", "fast" or "dcf")
    rides the PlanKey profile slot.  The caller draws the roots for the
    actual K in the reference's order (the CSPRNG boundary); this route
    pads them with zero rows to the plan bucket (the compat tower to at
    least one 32-key lane word), so padding never changes the draw.  On
    the card: one ``gen_tower_cc_kernel`` launch (fast, DCF) or ``nu + 1``
    ``prg_canon_kernel`` launches (compat); ``device="cpu"`` runs the
    plain torch towers.  Eager."""
    from ..models import keys_gen

    if kind not in ("compat", "fast", "dcf"):
        raise ValueError(f"gen: unknown kind {kind!r} (compat|fast|dcf)")
    alphas = np.asarray(alphas, dtype=np.uint64)
    K = alphas.shape[0]
    dev = resolve_device(device)
    key = plan_key("gen", kind, log_n, K, 0, packed=True)
    plan, first = _CACHE.get(key)
    t0_wall = time.perf_counter()
    kp = key.k_bucket if K else 0  # no keys: nothing to launch
    if kind == "compat":
        out = keys_gen.gen_device_compat(alphas, log_n, s0, t0, s1, t1, max(kp, 32) if K else 0,
                                         device=dev)
    else:
        out = keys_gen.gen_device_cc(kind, alphas, log_n, s0, t0, s1, t1, kp, device=dev)
    _stamp(plan, first, t0_wall)
    return out


def run_evalfull(profile: str, kb, device=None) -> np.ndarray:
    """Plan-cached full-domain expansion -> uint8[K, out_bytes].  On the
    card the plan's graph runs the model's device body over the padded
    batch's key operands: compat ``eval_full_device`` (13
    ``prg_bm_kernel`` + 1 ``leaf_words_bm_kernel`` at n=20 by default; the
    backend, resolved from ``DPF_CUDA_PRG``, rides ``PlanKey.variant``, the
    fuse knob ``PlanKey.fuse``), fast ``eval_full_device`` (its prefix and
    tail launches)."""
    from ..models import dpf as mdpf

    if profile not in ("compat", "fast"):
        raise ValueError(f"run_evalfull: unknown profile {profile!r}")
    K = kb.k
    dev = resolve_device(device)
    backend = mdpf._resolve_backend(None) if profile == "compat" else ""
    key = plan_key("evalfull", profile, kb.log_n, K, 0, packed=True, variant=backend)
    plan, first = _CACHE.get(key)
    t0 = time.perf_counter()
    body, operands = _evalfull_body(profile, _pad_keys(kb, key.k_bucket - K), dev, backend)
    with plan.lock:
        words = from_carrier(_graph_run(plan, dev, body, operands)[:K])
    _stamp(plan, first, t0)
    return np.ascontiguousarray(words).view("<u1").reshape(K, -1)


# ---------------------------------------------------------------------------
# Warmup
# ---------------------------------------------------------------------------


def _gen_batch(profile: str):
    if profile == "fast":
        from .keys_chacha import gen_batch
    else:
        from .keys import gen_batch
    return gen_batch


def warmup(shapes: list[dict], device=None) -> list[dict]:
    """Build the plans for a deployment's expected request shapes, so that
    no first-request capture lands on user traffic.

    Each spec: ``{"route": "points"|"dcf_points"|"dcf_interval"|
    "evalfull"|"hh_level"|"hh_extend"|"hh_fold"|"agg_xor"|"agg_add"|"gen",
    "profile": "compat"|"fast", "log_n": N, "k": K, "q": Q}`` (``q``
    ignored for evalfull and gen; ``profile`` ignored for the DCF routes; a
    gen spec's profile is the key family, "compat"|"fast"|"dcf").  A
    ``pir`` spec names a registered database instead, ``{"route": "pir",
    "db": name, "k": K}`` (apps/pir_store.py).  An evalfull spec with
    ``"stream": true`` also drives ``eval_full_stream`` once.  The keys are
    zero alphas from ``default_rng(0)``, dealt on ``device``.  Returns one
    summary dict per spec (the buckets, wall seconds)."""
    dev = resolve_device(device)
    out = []
    rng = np.random.default_rng(0)
    for spec in shapes:
        route = spec.get("route", "points")
        profile = spec.get("profile", "compat")
        if route in ("agg_xor", "agg_add", "pir"):
            log_n = int(spec.get("log_n", 0))
        else:
            log_n = int(spec["log_n"])
        k = int(spec.get("k", 1))
        q = int(spec.get("q", 32))
        t0 = time.perf_counter()
        kb_count = k_bucket(k)
        alphas = np.zeros(kb_count, np.uint64)
        if route == "pir":
            from ..apps import pir_store

            db = pir_store.registry().get(str(spec["db"]))
            kb, _ = _gen_batch(db.profile)(alphas, db.log_n, rng=rng, device=dev)
            run_pir(db, kb, device=dev)
            out.append({"route": "pir", "profile": db.profile, "db": db.name,
                        "log_n": db.log_n, "k_bucket": kb_count,
                        "q_bucket": db.row_bytes * 8,
                        "seconds": round(time.perf_counter() - t0, 3)})
            continue
        if route in ("agg_xor", "agg_add"):
            run_agg_fold(route[4:], None,
                         np.zeros((kb_count, max(q_bucket(q) // 32, 1)), np.uint32), device=dev)
        elif route == "hh_level":
            kb, _ = _gen_batch(profile)(alphas, log_n, rng=rng, device=dev)
            run_hh_level(profile, kb, np.zeros((kb_count, q), np.uint64), 0, device=dev)
        elif route == "hh_extend":
            from ..apps import hh_state

            hh_state.warm_ladder(profile, log_n, kb_count, q, device=dev)
        elif route == "hh_fold":
            run_hh_fold(np.zeros((kb_count, max(q_bucket(q) // 32, 1)), np.uint32), device=dev)
        elif route == "evalfull":
            kb, _ = _gen_batch(profile)(alphas, log_n, rng=rng, device=dev)
            run_evalfull(profile, kb, device=dev)
            if spec.get("stream"):
                # The stream is not K-bucketed: warm it at the spec's K.
                if profile == "fast":
                    from ..models.dpf_chacha import eval_full_stream
                else:
                    from ..models.dpf import eval_full_stream
                kb_s = kb if kb.k == k else _gen_batch(profile)(
                    np.zeros(k, np.uint64), log_n, rng=rng, device=dev)[0]
                for _ in eval_full_stream(kb_s, device=dev):
                    pass
        elif route == "gen":
            from ..models import keys_gen

            keys_gen.warm(profile, log_n, kb_count, rng, device=dev)
        elif route == "dcf_interval":
            from ..models import dcf

            ia, _ = dcf.gen_interval_batch(alphas, alphas, log_n, rng=rng, device=dev)
            run_interval(ia, np.zeros((kb_count, q), np.uint64), device=dev)
        elif route == "dcf_points":
            from ..models import dcf

            da, _ = dcf.gen_lt_batch(alphas, log_n, rng=rng, device=dev)
            run_points(route, "fast", da, np.zeros((kb_count, q), np.uint64), device=dev)
        elif route == "points":
            kb, _ = _gen_batch(profile)(alphas, log_n, rng=rng, device=dev)
            run_points(route, profile, kb, np.zeros((kb_count, q), np.uint64), device=dev)
        else:
            raise ValueError(f"warmup: unknown route {route!r}")
        out.append({"route": route, "profile": profile, "log_n": log_n,
                    "k_bucket": kb_count,
                    "q_bucket": q_bucket(q) if route not in ("evalfull", "gen") else 0,
                    "seconds": round(time.perf_counter() - t0, 3)})
    return out


def recent_shapes(limit: int = 4) -> list[dict]:
    """Warmup-style specs of the most recently used plans: what a
    recovering deployment was serving.  ``pir`` plans are left out (keyed
    on a database's shape, not its name: the spec cannot name the database)
    and so are ``hh_extend`` plans (keyed on a session's live state), as in
    the reference."""
    with _CACHE._lock:
        recent = sorted(_CACHE._plans.values(), key=lambda p: p.last_used,
                        reverse=True)[: max(int(limit), 0)]
    out = []
    for p in recent:
        key = p.key
        if key.route in ("pir", "hh_extend"):
            continue
        spec = {"route": key.route, "profile": key.profile, "log_n": key.log_n,
                "k": key.k_bucket}
        if key.q_bucket:
            spec["q"] = key.q_bucket
        spec["tuned"] = key.tuned
        out.append(spec)
    return out


def rewarm_recent(limit: int = 4, device=None) -> int:
    """Re-drive the most recently used plans through :func:`warmup` (a real
    dispatch per plan); returns the number of shapes warmed."""
    shapes = recent_shapes(limit)
    if shapes:
        warmup(shapes, device=device)
    return len(shapes)
