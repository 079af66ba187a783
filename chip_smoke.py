#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dpf_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one nvcc
per source, side by side), holds each against its plain PyTorch version on
the card, runs the golden vectors, and drives both profiles' main paths (host
``gen_batch`` -> ``eval_full_batch`` at n=20 with 1024 keys: the compat
profile, BASELINE.json's config, then the ChaCha fast profile,
``dpf_tpu_torch.fast``), then pointwise evaluation of both profiles
(``eval_points_batch`` at BASELINE.json's config 3, n=30 with 256 keys at
4096 queries each, and the level-grouped walk at config 5's shape, n=32 with
32 levels of 128 gates), then config 5 itself: the one-key-per-gate DCF
(``fast.dcf_eval_lt_points`` over 4096 gates and
``fast.dcf_eval_interval_points`` over 2048, 1024 queries a gate) and the
FSS comparison and interval gates of both profiles (``dpf_tpu_torch.fss``,
4096 level keys a launch), and ``fss.ge_full_from_dpf`` of both profiles at
n=20, with launch counters zeroed just before each path and read just
after.  The compat EvalFull options run after the other paths' traces:
every route of ``OPTION_ROUTES`` at config 2 traced and timed through
``eval_full_device(dk, backend=..., fuse=...)`` (phase 29), then driven
through ``eval_full_batch(kb, backend=..., fuse=...)``, each counted and
held to the default route's bytes and the spec (phase 28); the kernels of
those options (``prg_canon_kernel``, ``mmo_canon_kernel``,
``prg_bm_il_kernel``, ``fused_levels_bm_kernel``) are held against their
plain versions and timed last (phases 30-31).  It checks each kernel
path against the plain path and the chunked split against the unchunked
one (and the fast profile's deep-tree and whole-tree routes), and times the paths and each kernel with CUDA events
(a kernel's ``ms`` in the kernels line: its runs queued back to back behind
a sleep kernel, so the host's launch time between them does not count; its
``event_ms``: one call at a time, events around each).
Each kernel's bound counts its instructions (``dpf_tpu_torch/ops/op_count.py``:
LOP3 for AES-MMO, IADD/LOP3/SHF for ChaCha12; the walks: their ciphers) over
the card's issue rate, and
the build phase prints the built kernels' SASS instruction counts, and the
registers and spills of the two PRG kernels (``prg_bm_kernel``,
``prg_canon_kernel``: one MMO a thread), failing if either spills; phase 31
times those two beside ``prg_bm_il_kernel`` (the same function) in turns.  Every
check is exact: this is integer cryptography, the tolerance is zero.

Any failed phase raises, so the script exits nonzero.  Without CUDA, or
without the package beside it, it exits nonzero and prints no result.  The
last line of standard output is one JSON object naming the card; the line
before the card's name and power limit lists every kernel with its
measurements.  Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import functools
import hashlib
import json
import statistics
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

# The frozen vectors of tests/test_golden_vectors.py::VECTORS:
# (log_n, alpha, rng_seed, key_a_hex_or_sha256, sha256(eval_full(key_a))).
VECTORS = [
    (
        3,
        1,
        11,
        "4ecc402210fae920677a0dcc8aacd07f007da72c7fe386d92c5cfa7fd103356318",
        "0ca3d84dfd7ab04264265605cf8925d1cb9bd4e9f09cd9a6bea652c57afd3971",
    ),
    (
        8,
        123,
        42,
        "8826d916cdfb21c6c1ff91a761565a70002a47ad53865f609411a01045eadcd7"
        "a000004747897a6d99505683480d6616a08dcb",
        "8e7a1d8b7443fd4e6ccfa6dc663b62580ab8159125f432f192bbdffb562f6725",
    ),
    (
        12,
        2048,
        7,
        "b5da2238d05bb625a7ffe90379ea65a63952db204f3d88ea5d6c32ce7d24a78a",
        "b71cbb8775bd46e44d9e8928ff17eeeb81f2ff7a67248442bdb0e01101f1e4ed",
    ),
    (
        20,
        777777,
        99,
        "f6e5e8e4f793edee2559404ab8f1bb7d06473faeb1e718606e6b128627f1dba0",
        "265f964f51148ea7818184c90e6efc8c883c848d1b84d2597985932771c990b7",
    ),
]

LOG_N, K = 20, 1024  # BASELINE.json: batched 1024-key EvalFull, n=20
PRG_B, LEAF_B = 1 << 17, 1 << 18  # the last PRG level and the leaf level at LOG_N, K
CHECK_WIDTHS = (32, 100, 4096, PRG_B, LEAF_B)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published HBM3 rate
LOP3_PER_SM_CLOCK = 64  # logic instructions per SM per clock (Hopper: 4 x 16 INT32 lanes)
# ChaCha's bound, by pipe (assumed rates for sm_90a): LOP3 and SHF (the
# funnel-shift rotate) run on the integer ALU pipe at the LOP3 rate above; an
# add may instead issue as IMAD on the FMA pipe, as the built SASS shows the
# compiler doing; and an SM issues at most 4 warp instructions, 128 lanes,
# per clock.
ISSUE_PER_SM_CLOCK = 128
SOURCE = "dpf_tpu_torch/ops/csrc/aes_mmo.cu"
FUSED_SOURCE = "dpf_tpu_torch/ops/csrc/aes_fused.cu"
FAST_SOURCE = "dpf_tpu_torch/ops/csrc/chacha_expand.cu"
WALK_SOURCE = "dpf_tpu_torch/ops/csrc/aes_walk.cu"
FAST_WALK_SOURCE = "dpf_tpu_torch/ops/csrc/chacha_walk.cu"
# BASELINE.json config 3: pointwise Eval at 2^20 random indices, n=30, 256 keys.
POINT_LOG_N, POINT_K, POINT_Q = 30, 256, 4096
# Config 5's shape: n=32 FSS gates, 4096 keys = 32 levels x 128 gates, groups=1,
# 1024 queries per gate.
GATE_LOG_N, GATE_G, GATE_Q = 32, 128, 1024
# BASELINE config 5 for the DCF: one key a gate, 4096 gates (comparison) or
# 2048 (interval: one fused 4096-key launch); the FSS gates' intervals: 64
# gates (2 x 32 levels x 64 = 4096 keys).
DCF_G, DCF_IV_G, FSS_IV_G = 4096, 2048, 64
# walk_dcf_kernel's checks against its plain version: every (log_n, K, Q).
DCF_CHECK_LOG_N, DCF_CHECK_K, DCF_CHECK_Q = (5, 13, 34), (1, 129), (1, 33)
# ge_full_from_dpf: checked at every point of 64 keys, timed at config 2's batch.
GE_LOG_N, GE_CHECK_K, GE_K = 20, 64, 1024
# The walks' kernel checks: every (log_n, K, Q) of these (compat), every
# (log_n, K) at Q = 100 (fast).
COMPAT_WALK_LOG_N, COMPAT_WALK_K, COMPAT_WALK_Q = (6, 13, 33), (5, 8, 256), (13, 100, 4096)
FAST_WALK_LOG_N, FAST_WALK_K, FAST_WALK_Q = (9, 14, 34), (9, 128, 256), 100
# The fast profile's kernel checks, (K, W, levels): every W in {1, 3, 128,
# 4096}, L in {0, 1, 5} and K in {1, 9, 1024}, the headline tail (1024 keys,
# 128 entry nodes, 4 levels) and the headline prefix groups (W 1 for 5
# levels, W 32 for 2).
# The compat EvalFull options at config 2 (phases 28-31): (backend, fuse,
# max_plane_words) -> launches per evaluation.  nu = 13; fuse=g runs levels
# 0-6 per level, then _fuse_schedule's groups of levels 7-12; the chunked
# route (2^17 words a plane) one prefix level and two subtrees of 12.
OPTION_ROUTES = {
    ("pallas", None, None): {"prg_canon_kernel": 13, "mmo_canon_kernel": 1},
    ("xla", None, None): {"prg_canon_kernel": 13, "mmo_canon_kernel": 1},
    ("pallas_bm_il", None, None): {"prg_bm_il_kernel": 13, "mmo_bm_canon_kernel": 1},
    ("pallas_bm", 1, None): {"prg_bm_kernel": 7, "fused_levels_bm_kernel": 6,
                             "mmo_bm_canon_kernel": 1},
    ("pallas_bm", 2, None): {"prg_bm_kernel": 7, "fused_levels_bm_kernel": 3,
                             "mmo_bm_canon_kernel": 1},
    ("pallas_bm", 3, None): {"prg_bm_kernel": 7, "fused_levels_bm_kernel": 2,
                             "mmo_bm_canon_kernel": 1},
    ("pallas_bm", 4, None): {"prg_bm_kernel": 7, "fused_levels_bm_kernel": 2,
                             "mmo_bm_canon_kernel": 1},
    ("pallas_bm_il", 2, None): {"prg_bm_il_kernel": 7, "fused_levels_bm_kernel": 3,
                                "mmo_bm_canon_kernel": 1},
    ("pallas", None, 1 << 17): {"prg_canon_kernel": 25, "mmo_canon_kernel": 2},
}
# The route whose launches and fused groups the kernels line gives for
# fused_levels_bm_kernel; the odd shapes of its checks (Kp, W, g).
FUSED_ROUTE = ("pallas_bm", 4, None)
FUSED_CHECKS = ((1, 1, 1), (1, 1, 4), (3, 5, 2), (3, 5, 6))
ODD_WIDTHS = (1, 33, 4097)
# The PRG kernels of one MMO a thread: checked for spills at the build, and
# timed side by side with the interleaved PRG (phase 31).
PRG_KERNELS = ("prg_bm_kernel", "prg_canon_kernel")
FAST_CHECKS = (
    (1, 1, 0), (1, 1, 5), (9, 3, 1), (9, 3, 5), (1, 4096, 1), (9, 4096, 5),
    (1024, 4096, 0), (1024, 128, 1), (1024, 128, 4), (1024, 1, 5), (1024, 32, 2),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_ms(fn, warmup: int = 2, reps: int = 10, trials: int = 5) -> float:
    """Device time of one ``fn`` in ms: ``reps`` runs queued back to back
    behind a sleep kernel, so the host's launch time between them does not
    count; CUDA events around them, median over ``trials``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms of cycles: the host queues the runs meanwhile
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def cuda_ms(fn, warmup: int = 2, reps: int = 10) -> float:
    """Median device time of ``fn`` in ms, by CUDA events around each run."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, warmup: int = 2, reps: int = 10) -> float:
    """Median host time of ``fn`` in ms; ``fn`` must end synchronized."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# Host time traced before and after the call.  torch.profiler keeps only the
# device events whose timestamps, moved to the host's clock, fall inside its
# window; chip runs of this script lost kernels at the edges of a tight
# window (one trace held no device event, others lacked their first kernel).
TRACE_MARGIN_S = 0.02


def device_breakdown(fn, expect: str, attempts: int = 3
                     ) -> tuple[float, float, dict[str, tuple[float, int]]]:
    """Run ``fn`` once under torch.profiler -> (host wall ms of the call,
    device span ms from the first device event's start to the last one's
    end, {device event name: (total device us, count)}) over kernels,
    copies and memsets.  A trace without the kernel ``expect`` is taken
    again, at most ``attempts`` times in all, each miss printed."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_MARGIN_S)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            time.sleep(TRACE_MARGIN_S)
        busy: dict[str, tuple[float, int]] = {}
        starts, ends = [], []
        for evt in prof.events():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us, count = busy.get(evt.name, (0.0, 0))
            busy[evt.name] = (us + evt.time_range.elapsed_us(), count + 1)
            starts.append(evt.time_range.start)
            ends.append(evt.time_range.end)
        if expect in busy:
            return wall_ms, (max(ends) - min(starts)) / 1e3, busy
        log(f"[profile] trace attempt {attempt} of {attempts} holds {len(starts)} device "
            f"events and no {expect}")
    raise AssertionError(f"torch.profiler recorded no {expect} in {attempts} traces")


# The pause between the runs of one traced session, and the device gap that
# splits their events; a chip run saw a 10 ms gap inside one compat
# eval_full_device (its host launch time is 4-11 ms).
TRACE_PAUSE_S = 0.1


def device_breakdowns(fns: list, expects: list[str], attempts: int = 3) -> list[tuple]:
    """:func:`device_breakdown` of each of ``fns`` in ONE torch.profiler
    session: each runs once, synchronized and followed by a pause of
    ``TRACE_PAUSE_S``, and the device events split into one cluster per
    run at the gaps longer than half the pause.  Chip runs whose later
    traces followed many launches lost device events, so a phase that
    traces many paths takes one session.  A trace whose clusters do not
    hold each run's ``expects`` kernel is taken again."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        walls = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_MARGIN_S)
            for fn in fns:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                time.sleep(TRACE_PAUSE_S)
        evts = sorted((e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      key=lambda e: e.time_range.start)
        clusters, end = [], None
        for e in evts:
            if end is None or e.time_range.start - end > TRACE_PAUSE_S * 5e5:
                clusters.append([])
                end = e.time_range.end
            clusters[-1].append(e)
            end = max(end, e.time_range.end)
        out = []
        for wall_ms, cluster in zip(walls, clusters):
            busy: dict[str, tuple[float, int]] = {}
            for e in cluster:
                us, count = busy.get(e.name, (0.0, 0))
                busy[e.name] = (us + e.time_range.elapsed_us(), count + 1)
            span_ms = (max(e.time_range.end for e in cluster)
                       - cluster[0].time_range.start) / 1e3
            out.append((wall_ms, span_ms, busy))
        if len(clusters) == len(fns) and all(x in b for x, (_, _, b) in zip(expects, out)):
            return out
        log(f"[profile] trace attempt {attempt} of {attempts}: {len(evts)} device events in "
            f"{len(clusters)} clusters for {len(fns)} runs, expected kernels "
            f"{[x in b for x, (_, _, b) in zip(expects, out)]}")
    raise AssertionError(f"torch.profiler did not record {expects} in {attempts} traces")


def log_breakdown(card: str, entry: str, fn, expect: str) -> None:
    """Print :func:`device_breakdown` of one run of ``fn``."""
    wall_ms, span_ms, busy = device_breakdown(fn, expect)
    total = sum(us for us, _ in busy.values()) / 1e3
    n_events = sum(count for _, count in busy.values())
    log(f"[profile] {card}: {entry} traced: wall {wall_ms:.3f} ms, device span "
        f"{span_ms:.3f} ms, busy {total:.3f} ms in {n_events} device events, idle "
        f"{100 - 100 * total / span_ms:.1f} % of the span, "
        f"{100 - 100 * total / wall_ms:.1f} % of the wall")
    for kname, (us, count) in sorted(busy.items(), key=lambda kv: -kv[1][0])[:15]:
        log(f"[profile]   {us / 1e3:9.3f} ms {count:5d}x  {kname[:110]}")


def enqueue_ms(fn, warmup: int = 2, reps: int = 10) -> float:
    """Median host time for ``fn`` to return, with the card idle at each
    call: the time the host takes to launch ``fn``'s device work."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


# Each kernel's wrapper, by the name the kernels line gives it.
def _wrappers() -> dict:
    from dpf_tpu_torch.ops import aes_cuda, chacha_cuda

    return {
        "prg_bm_kernel": aes_cuda.prg_planes_bm,
        "mmo_bm_canon_kernel": aes_cuda.mmo_planes_bm_canon,
        "prg_canon_kernel": aes_cuda.prg_planes_canon,
        "mmo_canon_kernel": aes_cuda.mmo_planes_canon,
        "prg_bm_il_kernel": aes_cuda.prg_planes_bm_il,
        "fused_levels_bm_kernel": aes_cuda.fused_levels_planes,
        "fused_levels_kernel": chacha_cuda.fused_levels,
        "expand_tail_kernel": chacha_cuda.expand_tail,
        "walk_bm_kernel": aes_cuda.eval_points_walk_planes,
        "walk_kernel": chacha_cuda.walk,
        "walk_dcf_kernel": chacha_cuda.walk_dcf,
    }


def zero_launches() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def read_launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in _wrappers().items()}


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def assert_one_bit_at_alphas(rec: np.ndarray, alphas: np.ndarray) -> None:
    """Raise unless row i of the XOR of both shares has exactly bit alphas[i]."""
    nz = np.flatnonzero(rec)
    rows, cols = np.divmod(nz, rec.shape[1])
    a = alphas.astype(np.int64)
    if not (
        len(nz) == len(a)
        and np.array_equal(rows, np.arange(len(a)))
        and np.array_equal(cols, a // 8)
        and np.array_equal(rec[rows, cols], (1 << (a % 8)).astype(np.uint8))
    ):
        raise AssertionError("shares do not reconstruct to one bit at each alpha")


def fast_operands(rng, k: int, w: int, levels: int, dev):
    """Random fast-profile level state int32[5, k, w] (t bits 0/1) and
    ``levels`` levels of CWs for k keys, on ``dev``."""
    from dpf_tpu_torch.ops.aes_bitslice import to_carrier

    words = lambda *shape: rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)  # noqa: E731
    st = words(5, k, w)
    st[0] &= ~np.uint32(1)
    st[4] &= np.uint32(1)
    scw = words(k, levels, 4)
    scw[:, :, 0] &= ~np.uint32(1)
    tcw = words(k, levels, 2) & np.uint32(1)
    return tuple(to_carrier(a, dev) for a in (st, scw, tcw, words(k, 16)))


# ---------------------------------------------------------------------------
# The compat EvalFull options: backend= and fuse= (phases 28-31)
# ---------------------------------------------------------------------------


def route_name(route) -> str:
    backend, fuse, max_words = route
    return backend + (f" fuse={fuse}" if fuse else "") + (
        f" max_plane_words=2^{max_words.bit_length() - 1}" if max_words else "")


def route_kwargs(route) -> dict:
    backend, fuse, max_words = route
    kw = {"backend": backend, "fuse": fuse}
    return kw if max_words is None else {**kw, "max_plane_words": max_words}


def option_routes(dev, card: str, ka, kb, alphas, out_a) -> dict:
    """Phase 28: every route of OPTION_ROUTES through
    ``eval_full_batch(kb, backend=, fuse=)`` for both parties at config 2,
    launch counters zeroed just before and read just after each, held to
    the default route's bytes, the spec and the reconstruction -> {route:
    its launches}."""
    import dpf_tpu_torch as P
    from dpf_tpu_torch.core import spec

    blobs = ka.to_bytes()
    launches = {}
    for route, per_eval in OPTION_ROUTES.items():  # 28
        name = route_name(route)
        kw = route_kwargs(route)
        (ra, rb), got = counted(
            f"{name} n={LOG_N} K={K}, 2 evaluations",
            lambda: (P.eval_full_batch(ka, **kw), P.eval_full_batch(kb, **kw)),
            {k: 2 * n for k, n in per_eval.items()})
        if not np.array_equal(ra, out_a):
            raise AssertionError(f"{name}: bytes != the default route's")
        for i in (0, 1, K // 2, K - 1):
            if ra[i].tobytes() != spec.eval_full(blobs[i], LOG_N):
                raise AssertionError(f"{name}: key {i} != spec.eval_full")
        assert_one_bit_at_alphas(ra ^ rb, alphas)
        launches[route] = got
        log(f"[options] {name}: bytes == the default route's; keys 0, 1, K/2, K-1 == "
            f"spec.eval_full; both shares reconstruct to one bit at each alpha")
        del ra, rb
    return launches


def option_times(dev, card: str, ka) -> None:
    """Phase 29: each route's ``eval_full_device`` at config 2 traced (all
    in one profiler session, after the other paths' traces and before any
    plain version's run in phases 19 on), timed with CUDA events, and its
    host launch time.  Phase 28 checks the same routes' bytes after."""
    from dpf_tpu_torch.models import dpf as mdpf

    dk = mdpf.DeviceKeys(ka, dev)
    leaves = K << LOG_N
    routes = [("pallas_bm", None, None), *OPTION_ROUTES]
    fns = [functools.partial(mdpf.eval_full_device, dk, **route_kwargs(r)) for r in routes]
    expects = [next(k for k in ("fused_levels_bm_kernel", "prg_bm_il_kernel",
                                "prg_canon_kernel", "prg_bm_kernel") if k in
                    OPTION_ROUTES.get(r, {"prg_bm_kernel": 13})) for r in routes]
    for route, fn, (wall_ms, span_ms, busy) in zip(routes, fns,
                                                   device_breakdowns(fns, expects)):
        total = sum(us for us, _ in busy.values()) / 1e3
        top = ", ".join(f"{kname[:40]} {us / 1e3:.3f} ms {n}x" for kname, (us, n) in
                        sorted(busy.items(), key=lambda kv: -kv[1][0])[:4])
        dev_ms, enq_ms = cuda_ms(fn), enqueue_ms(fn)
        log(f"[options time] {card}: eval_full_device {route_name(route)}: {dev_ms:.4f} "
            f"ms ({leaves / dev_ms / 1e6:.2f} Gleaves/s), host launch time {enq_ms:.3f} "
            f"ms; traced: wall {wall_ms:.3f} ms, busy {total:.3f} ms in "
            f"{sum(n for _, n in busy.values())} device events, idle "
            f"{100 - 100 * total / span_ms:.1f} % of the span; {top}")


def option_kernels(dev, card: str, sm_clocks_per_s: float, ka, launches) -> list[dict]:
    """Phases 30-31: the four new kernels against their plain versions on
    the card (at their config-2 shapes and odd widths), then their times
    beside their bounds and plain versions -> their rows of the kernels
    line."""
    from dpf_tpu_torch.models import dpf as mdpf
    from dpf_tpu_torch.ops import aes_cuda, op_count
    from dpf_tpu_torch.ops.aes_bitslice import to_carrier

    rng = np.random.default_rng(2026)

    def planes(*shape):
        return to_carrier(rng.integers(0, 1 << 32, size=shape, dtype=np.uint32), dev)

    flat = {  # name: (wrapper, plain, TPU kernel, MMOs a column, outputs, B)
        "prg_canon_kernel": (aes_cuda.prg_planes_canon, aes_cuda.prg_planes_canon_plain,
                             "dpf_tpu/ops/aes_pallas.py:121", 2, 2, PRG_B),
        "mmo_canon_kernel": (aes_cuda.mmo_planes_canon, aes_cuda.mmo_planes_canon_plain,
                             "dpf_tpu/ops/aes_pallas.py:128", 1, 1, LEAF_B),
        "prg_bm_il_kernel": (aes_cuda.prg_planes_bm_il, aes_cuda.prg_planes_bm_il_plain,
                             "dpf_tpu/ops/aes_pallas.py:237", 2, 2, PRG_B),
    }
    err = {}
    for kname, (wrapper, plain, _, _, _, B) in flat.items():  # 30
        err[kname] = 0
        for b in (*ODD_WIDTHS, B):
            S = planes(128, b)
            got, want = wrapper(S), plain(S)
            for g_, w_ in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
                err[kname] = max(err[kname], check_equal(kname, g_, w_, f"[128, {b}]"))
        log(f"[kernel] {kname} == plain at [128, B] for B in {(*ODD_WIDTHS, B)}")

    # The fused groups at the config-2 entry: level 7's [128, 32, 128] state.
    dk = mdpf.DeviceKeys(ka, dev)
    seeds, scw = mdpf._to_bm(dk.seed_planes, dk.scw_planes)
    first = mdpf._FUSE_FLOOR
    S7, T7 = mdpf._expand(first, 0, seeds, dk.t_words, scw, dk.tl_words, dk.tr_words,
                          aes_cuda.prg_planes_bm)
    S7, T7 = S7.transpose(1, 2).contiguous(), T7.transpose(0, 1).contiguous()
    kp, w7 = T7.shape
    err["fused_levels_bm_kernel"] = 0
    checks = [(kp, w7, g, True) for g in (1, 2, 3, 4)] + [(*c, False) for c in FUSED_CHECKS]
    for kp_, w_, g, real in checks:
        if real:  # the real entry state and CWs of levels 7 .. 6 + g
            ops = (S7, T7, scw[first : first + g], dk.tl_words[first : first + g],
                   dk.tr_words[first : first + g])
        else:  # random words, plane 0 of the seed CWs zero as Gen makes it
            cw = planes(g, 128, kp_)
            cw[:, 0] = 0
            ops = (planes(128, kp_, w_), planes(kp_, w_), cw, planes(g, kp_), planes(g, kp_))
        got, want = aes_cuda.fused_levels_planes(*ops), aes_cuda.fused_levels_planes_plain(*ops)
        for g_, w_2 in zip(got, want):
            err["fused_levels_bm_kernel"] = max(err["fused_levels_bm_kernel"], check_equal(
                "fused_levels_bm_kernel", g_, w_2, f"Kp={kp_} W={w_} g={g}"))
        del got, want
    log(f"[kernel] fused_levels_bm_kernel == plain on config 2's level-7 entry "
        f"[128, {kp}, {w7}] for g = 1, 2, 3, 4 and on random state at (Kp, W, g) in "
        f"{FUSED_CHECKS}")

    rows = []
    int_ops_per_s = LOP3_PER_SM_CLOCK * sm_clocks_per_s
    for kname, (wrapper, plain, replaces, n_mmo, n_out, B) in flat.items():  # 31
        S = planes(128, B)
        k_ms, e_ms = kernel_ms(lambda: wrapper(S)), cuda_ms(lambda: wrapper(S))
        p_ms = cuda_ms(lambda: plain(S))
        ops = op_count.lop3_per_column(n_mmo) * B
        nbytes = (1 + n_out) * 128 * B * 4
        ops_ms, bytes_ms = ops / int_ops_per_s * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        log(f"[time] {card}: {kname} at [128, {B}]: kernel {k_ms:.4f} ms (queued; "
            f"{e_ms:.4f} ms one call at a time), plain {p_ms:.3f} ms, bound "
            f"{bound_ms:.4f} ms ({ops:.3e} LOP3 -> {ops_ms:.4f} ms, {nbytes:.3e} B -> "
            f"{bytes_ms:.4f} ms), {100 * bound_ms / k_ms:.1f} % of the bound")
        route = ("pallas_bm_il", None, None) if kname == "prg_bm_il_kernel" else (
            "pallas", None, None)
        rows.append({
            "name": kname, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches[route][kname], "max_abs_err": err[kname], "ms": k_ms,
            "event_ms": e_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "library_ms": None,
        })

    # The two PRG kernels beside the interleaved PRG (row 5, the same
    # function) on this card, in turns.
    S = planes(128, PRG_B)
    prgs = {"prg_bm_kernel": aes_cuda.prg_planes_bm,
            "prg_canon_kernel": aes_cuda.prg_planes_canon,
            "prg_bm_il_kernel": aes_cuda.prg_planes_bm_il}
    turns = {k: [] for k in prgs}
    for kname in [*prgs, *reversed(prgs)]:
        turns[kname].append(kernel_ms(lambda: prgs[kname](S)))
    bound_ms = op_count.lop3_per_column(2) * PRG_B / int_ops_per_s * 1e3
    log(f"[time] {card}: the PRG at [128, {PRG_B}] in turns (forward, backward), bound "
        f"{bound_ms:.4f} ms: " + "; ".join(
            f"{k} {t[0]:.4f} / {t[1]:.4f} ms ({100 * bound_ms / min(t):.1f} %)"
            for k, t in turns.items()))

    # The fused groups of one evaluation from the level-7 entry, per fuse.
    nu = dk.nu
    for fuse in (1, 2, 3, 4):
        _, groups = mdpf._fuse_schedule(nu, fuse)

        def fused_groups(fused=aes_cuda.fused_levels_planes):
            return mdpf._fused_groups(S7.transpose(1, 2), T7.transpose(0, 1), scw,
                                      dk.tl_words, dk.tr_words, first, groups, fused)

        k_ms, e_ms = kernel_ms(fused_groups), cuda_ms(fused_groups)
        columns = op_count.fused_prg_columns(kp * w7, nu - first)
        ops = op_count.lop3_per_column(2) * columns
        leaf_words = kp * (w7 << (nu - first))
        nbytes = 4 * (129 * kp * w7 + (nu - first) * 130 * kp + 129 * leaf_words)
        ops_ms, bytes_ms = ops / int_ops_per_s * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        log(f"[time] {card}: fused_levels_bm_kernel, fuse={fuse} (groups {groups}) from "
            f"[128, {kp}, {w7}] at level {first}: kernel {k_ms:.4f} ms (queued; {e_ms:.4f} "
            f"ms one call at a time), bound {bound_ms:.4f} ms ({columns} PRG columns, "
            f"{ops:.3e} LOP3 -> {ops_ms:.4f} ms, {nbytes:.3e} B -> {bytes_ms:.4f} ms), "
            f"{100 * bound_ms / k_ms:.1f} % of the bound")
        if (fuse, None) == FUSED_ROUTE[1:]:
            p_ms = cuda_ms(lambda: fused_groups(aes_cuda.fused_levels_planes_plain),
                           warmup=1, reps=3)
            log(f"[time] {card}: fused_levels_planes_plain, the same groups: {p_ms:.3f} ms")
            rows.append({
                "name": "fused_levels_bm_kernel", "route": "cuda", "source": FUSED_SOURCE,
                "replaces": "dpf_tpu/ops/aes_pallas.py:530",
                "launches": launches[FUSED_ROUTE]["fused_levels_bm_kernel"],
                "max_abs_err": err["fused_levels_bm_kernel"], "ms": k_ms, "event_ms": e_ms,
                "plain_ms": p_ms, "bound_ms": bound_ms,
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "library_ms": None,
            })
    return rows


def fast_phases(dev, card: str, sm_clocks_per_s: float) -> list[dict]:
    """Phases 10-15, the fast profile (``dpf_tpu_torch.fast``); returns its
    two kernels' rows of the kernels line."""
    from dpf_tpu_torch import fast
    from dpf_tpu_torch.core import chacha_np
    from dpf_tpu_torch.models import dpf_chacha as mdc
    from dpf_tpu_torch.ops import chacha_cuda as cc_cuda
    from dpf_tpu_torch.ops import op_count

    # 10. Each fast kernel against its plain version, on the card.
    rng = np.random.default_rng(2025)
    err = {"fused_levels_kernel": 0, "expand_tail_kernel": 0}
    for k, w, levels in FAST_CHECKS:
        st, scw, tcw, fcw = fast_operands(rng, k, w, levels, dev)
        for kname, got, want in (
            ("fused_levels_kernel", cc_cuda.fused_levels(st, scw, tcw),
             cc_cuda.fused_levels_plain(st, scw, tcw)),
            ("expand_tail_kernel", cc_cuda.expand_tail(st, scw, tcw, fcw),
             cc_cuda.expand_tail_plain(st, scw, tcw, fcw)),
        ):
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{kname} != plain at K={k} W={w} L={levels}")
            err[kname] = max(err[kname], max_abs_err(got, want))
            del got, want
        log(f"[fast kernel] fused_levels_kernel and expand_tail_kernel == plain "
            f"at K={k}, W={w}, {levels} levels")

    # 11. The fast main path: host gen_batch, then eval_full_batch on the card
    #     for both parties, with every launch counter zeroed just before.
    rng = np.random.default_rng(21)
    alphas = rng.integers(0, 1 << LOG_N, size=K, dtype=np.uint64)
    zero_launches()
    ka, kb = fast.gen_batch(alphas, LOG_N, rng)
    out_a = fast.eval_full_batch(ka)
    out_b = fast.eval_full_batch(kb)
    launches = read_launches()
    log(f"[fast main] n={LOG_N} K={K}: launches over 2 evaluations {launches}")
    if launches != {**{n: 0 for n in launches}, "fused_levels_kernel": 4,
                    "expand_tail_kernel": 2}:
        raise AssertionError("expected 2 fused-levels + 1 tail launch per evaluation")
    if out_a.shape != (K, 1 << (LOG_N - 3)) or out_a.dtype != np.uint8:
        raise AssertionError(f"fast output shape {out_a.shape} {out_a.dtype}")
    assert_one_bit_at_alphas(out_a ^ out_b, alphas)
    log(f"[fast main] both shares reconstruct to exactly one set bit at each of {K} alphas")
    blobs = ka.to_bytes()
    for i in (0, 1, K // 2, K - 1):
        if out_a[i].tobytes() != chacha_np.eval_full(blobs[i], LOG_N):
            raise AssertionError(f"fast key {i} != chacha_np.eval_full")
    log("[fast main] keys 0, 1, K/2, K-1 equal the numpy chacha_np.eval_full")

    # 12. Kernel path against plain path on the card: n=16 (nu=7) runs a
    #     prefix of 5 + 2 levels, n=24 (nu=15) one of 5 + 5 and a 5-level tail.
    for log_n, k in ((16, 256), (24, 64)):
        r = np.random.default_rng(log_n)
        kk, _ = fast.gen_batch(r.integers(0, 1 << log_n, size=k, dtype=np.uint64), log_n, r)
        dk = fast.DeviceKeysFast(kk, dev)
        before = read_launches()
        got = fast.eval_full_device(dk)
        after = read_launches()
        n_fused, n_tail = (after[n] - before[n] for n in ("fused_levels_kernel",
                                                          "expand_tail_kernel"))
        if (n_fused, n_tail) != (2, 1):
            raise AssertionError(f"n={log_n}: {n_fused} fused + {n_tail} tail launches, "
                                 "expected 2 + 1")
        if not torch.equal(got, fast.eval_full_device(dk, impl="plain")):
            raise AssertionError(f"fast kernel path != plain path at n={log_n}, K={k}")
        log(f"[fast path] kernel path == plain path at n={log_n}, K={k} "
            f"({n_fused} fused-levels launches + {n_tail} tail)")
        del got, dk

    # 13. Chunked against unchunked.
    chunked = fast.eval_full_batch(ka, max_leaf_nodes=1 << 19)
    if not np.array_equal(chunked, out_a):
        raise AssertionError(f"fast chunked != unchunked at n={LOG_N}, K={K}")
    log(f"[fast path] chunked (max_leaf_nodes=2^19) == unchunked at n={LOG_N}, K={K}")

    # 14. The whole-tree route (nu < 7, and nu = 0) against the spec.
    for log_n, k in ((14, 3), (9, 5)):
        r = np.random.default_rng(log_n)
        kk, _ = fast.gen_batch(r.integers(0, 1 << log_n, size=k, dtype=np.uint64), log_n, r)
        before = read_launches()
        got = fast.eval_full_batch(kk)
        after = read_launches()
        if (after["fused_levels_kernel"] - before["fused_levels_kernel"],
                after["expand_tail_kernel"] - before["expand_tail_kernel"]) != (0, 1):
            raise AssertionError(f"n={log_n}: expected one tail launch from the root")
        for i, key in enumerate(kk.to_bytes()):
            if got[i].tobytes() != chacha_np.eval_full(key, log_n):
                raise AssertionError(f"whole-tree route: key {i} != spec at n={log_n}")
        log(f"[fast path] whole-tree route (one tail launch from the root) == spec "
            f"at n={log_n}, K={k}")

    # 15. Times.
    leaves = K << LOG_N
    dk = fast.DeviceKeysFast(ka, dev)
    dev_ms = cuda_ms(lambda: fast.eval_full_device(dk))
    e2e_ms = host_ms(lambda: fast.eval_full_batch(ka))
    log(f"[fast time] {card}: eval_full_device n={LOG_N} K={K}: {dev_ms:.4f} ms, "
        f"{leaves / dev_ms / 1e6:.2f} Gleaves/s")
    log(f"[fast time] {card}: eval_full_batch end to end (keys to the card, expand, "
        f"D2H): {e2e_ms:.3f} ms, {leaves / e2e_ms / 1e6:.2f} Gleaves/s")
    nu, entry = dk.nu, cc_cuda.entry_level(dk.nu)
    entry_state = mdc._prefix(cc_cuda.fused_levels, dk, entry)
    tail_args = (entry_state, dk.scw[:, entry:], dk.tcw[:, entry:], dk.fcw)
    root = dk.root_state()
    groups = mdc._groups(entry, cc_cuda.fuse_auto_levels())

    w_entry, tail_levels = 1 << entry, nu - entry
    cw_words = 4 + 2  # seed CW + t CWs per level
    timed = {
        # name: (wrapper call, plain call, expansions, leaf converts, bytes, shape)
        "fused_levels_kernel": (
            lambda: mdc._prefix(cc_cuda.fused_levels, dk, entry, root),
            lambda: mdc._prefix(cc_cuda.fused_levels_plain, dk, entry, root),
            K * ((1 << entry) - 1), 0,
            4 * (5 * K + K * entry * cw_words + 5 * K * w_entry),
            f"levels 0..{entry - 1} from the root as groups {groups}, K={K}",
        ),
        "expand_tail_kernel": (
            lambda: cc_cuda.expand_tail(*tail_args),
            lambda: cc_cuda.expand_tail_plain(*tail_args),
            K * w_entry * ((1 << tail_levels) - 1), leaves >> 9,
            4 * (5 * K * w_entry + K * tail_levels * cw_words + 16 * K)
            + 64 * (leaves >> 9),
            f"[5, {K}, {w_entry}] entry state, {tail_levels} levels + leaf convert",
        ),
    }
    rows = []
    for kname, (kern, plain, n_exp, n_leaf, nbytes, shape) in timed.items():
        k_ms, e_ms, p_ms = kernel_ms(kern), cuda_ms(kern), cuda_ms(plain)
        ops = Counter()
        for kind, n in (("expand", n_exp), ("leaf", n_leaf)):
            for op, c in op_count.chacha_ops(kind).items():
                ops[op] += n * c
        alu, total = ops["LOP3"] + ops["SHF"], sum(ops.values())
        ops_ms = max(alu / LOP3_PER_SM_CLOCK, total / ISSUE_PER_SM_CLOCK) / sm_clocks_per_s * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        log(f"[fast time] {card}: {kname} at {shape}: kernel {k_ms:.4f} ms (queued; "
            f"{e_ms:.4f} ms one call at a time), plain {p_ms:.3f} ms, bound "
            f"{bound_ms:.4f} ms ({n_exp} expansions + {n_leaf} leaf converts = "
            f"{dict(ops)}: {alu:.4e} ALU-pipe at {LOP3_PER_SM_CLOCK}/clk/SM, "
            f"{total:.4e} in all at {ISSUE_PER_SM_CLOCK}/clk/SM -> {ops_ms:.4f} ms; "
            f"{nbytes:.4e} B -> {bytes_ms:.4f} ms)")
        rows.append({
            "name": kname, "route": "cuda", "source": FAST_SOURCE,
            "replaces": {"fused_levels_kernel": "dpf_tpu/ops/chacha_pallas.py:462",
                         "expand_tail_kernel": "dpf_tpu/ops/chacha_pallas.py:448"}[kname],
            "launches": launches[kname], "max_abs_err": err[kname], "ms": k_ms,
            "event_ms": e_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
        })

    # 16. Where the time goes: one traced fast eval_full_device, and the
    #     host's time to launch its work.
    enq_ms = enqueue_ms(lambda: fast.eval_full_device(dk))
    log(f"[fast profile] {card}: eval_full_device host launch time (returns, not "
        f"synchronized): {enq_ms:.3f} ms")
    for entry_name, fn in (
        ("fast eval_full_device", lambda: fast.eval_full_device(dk)),
        ("fast eval_full_batch", lambda: fast.eval_full_batch(ka)),
    ):
        log_breakdown(card, entry_name, fn, "expand_tail_kernel")
    return rows


# ---------------------------------------------------------------------------
# Pointwise evaluation (phases 17-21)
# ---------------------------------------------------------------------------


def compat_walk_args(kb, xs: np.ndarray, dev) -> tuple:
    """The compat walk's operands for xs uint64[K, Q] on ``dev``, as
    ``eval_points`` prepares them (the last one is nu)."""
    from dpf_tpu_torch.models import dpf as mdpf

    xs_hi, xs_lo = mdpf._split_words(mdpf._pad_queries(xs), kb.log_n, dev)
    return mdpf._eval_points_walk_body(kb.nu, kb.log_n, *mdpf._point_masks(kb, dev),
                                       xs_hi, xs_lo, lambda *a: a)


def point_batch(gen, log_n: int, k: int, q: int, seed: int):
    """(alphas, party keys, xs uint64[k, q] random with xs[:, 0] = alphas)."""
    rng = np.random.default_rng(seed)
    alphas = rng.integers(0, 1 << log_n, size=k, dtype=np.uint64)
    ka, kb = gen(alphas, log_n, rng)
    xs = rng.integers(0, 1 << log_n, size=(k, q), dtype=np.uint64)
    xs[:, 0] = alphas
    return alphas, ka, kb, xs


def pack_bits(bits: np.ndarray) -> np.ndarray:
    from dpf_tpu_torch.core import bitpack

    return bitpack.pack_bits(bits)


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor, where: str) -> int:
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{name} != plain at {where}")
    return max_abs_err(got, want)


def point_profiles() -> dict:
    """Walk kernel -> (profile, eval_points_batch, model, gen_batch, spec
    eval_point, kernel source, TPU kernel it replaces)."""
    import dpf_tpu_torch as P
    from dpf_tpu_torch import fast
    from dpf_tpu_torch.core import chacha_np, spec
    from dpf_tpu_torch.models import dpf as mdpf
    from dpf_tpu_torch.models import dpf_chacha as mdc

    return {
        "walk_bm_kernel": ("compat", P.eval_points_batch, mdpf, P.gen_batch,
                           spec.eval_point, WALK_SOURCE, "dpf_tpu/ops/aes_pallas.py:362"),
        "walk_kernel": ("fast", fast.eval_points_batch, mdc, fast.gen_batch,
                        chacha_np.eval_point, FAST_WALK_SOURCE,
                        "dpf_tpu/ops/chacha_pallas.py:127"),
    }


def point_headline(kname: str, name: str, entry, gen, spec_point):
    """Phase 17 for one profile: BASELINE config 3 through its
    ``eval_points_batch``, launch counters zeroed just before the two
    parties' calls -> (their launches, party keys, xs, party 0's bits)."""
    alphas, ka, kb, xs = point_batch(gen, POINT_LOG_N, POINT_K, POINT_Q, seed=30)
    zero_launches()
    out_a = entry(ka, xs)
    out_b = entry(kb, xs)
    launches = read_launches()
    log(f"[{name} points] n={POINT_LOG_N} K={POINT_K} Q={POINT_Q}: launches over 2 "
        f"calls {launches}")
    if launches != {**{n: 0 for n in launches}, kname: 2}:
        raise AssertionError(f"expected one {kname} launch per eval_points_batch call")
    if out_a.shape != (POINT_K, POINT_Q) or out_a.dtype != np.uint8:
        raise AssertionError(f"{name} points output {out_a.shape} {out_a.dtype}")
    if not np.array_equal(out_a ^ out_b, (xs == alphas[:, None]).astype(np.uint8)):
        raise AssertionError(f"{name} points: shares do not reconstruct the indicator")
    if not np.array_equal(entry(ka, xs, packed=True), pack_bits(out_a)):
        raise AssertionError(f"{name} points: packed != pack_bits(unpacked)")
    rng = np.random.default_rng(64)
    blobs = ka.to_bytes()
    for i, j in zip(rng.integers(0, POINT_K, 64), rng.integers(0, POINT_Q, 64)):
        if out_a[i, j] != spec_point(blobs[i], int(xs[i, j]), POINT_LOG_N):
            raise AssertionError(f"{name} points: key {i} query {j} != spec")
    log(f"[{name} points] both parties' bits XOR to xs == alpha (a one at column 0 of "
        f"each row, zero elsewhere); packed == pack_bits(bits); 64 random (key, query) "
        f"pairs equal the numpy spec")
    return launches[kname], ka, xs, out_a


def point_walk(kname: str, ka, xs: np.ndarray, dev):
    """The walk at the headline: (its wrapper's call, the plain version's
    call, the device work of one eval_points_batch with the output left on
    the card, what that work is, the kernel's input tensors, nu)."""
    from dpf_tpu_torch.models import dpf as mdpf
    from dpf_tpu_torch.ops import aes_cuda, chacha_cuda

    if kname == "walk_bm_kernel":
        args = compat_walk_args(ka, xs, dev)
        masks = mdpf._point_masks(ka, dev)
        split = mdpf._split_words(mdpf._pad_queries(xs), POINT_LOG_N, dev)
        return (lambda: aes_cuda.eval_points_walk_planes(*args),
                lambda: aes_cuda.eval_points_walk_planes_plain(*args),
                lambda: mdpf._eval_points_walk_body(
                    ka.nu, POINT_LOG_N, *masks, *split, aes_cuda.eval_points_walk_planes),
                "path words, leaf select and walk from the queries on the card",
                args[:-1], args[-1])
    args = chacha_cuda.walk_args(ka, xs, 0, dev)
    # The high query word is read only above n = 32.
    inputs = list(args[:6]) + ([args[6]] if POINT_LOG_N > 32 else [])
    return (lambda: chacha_cuda.walk(*args), lambda: chacha_cuda.walk_plain(*args),
            lambda: chacha_cuda.walk(*args).T.to(torch.uint8).contiguous(),
            "walk and uint8 transpose from the queries on the card", inputs, args[-1])


def point_times(card: str, kname: str, name: str, entry, ka, xs, device_fn,
                device_work: str) -> None:
    """Phase 18 for one profile: eval_points_batch end to end, its device
    work, and traces of both."""
    q_total = POINT_K * POINT_Q
    e2e = host_ms(lambda: entry(ka, xs), warmup=1, reps=5)
    e2e_packed = host_ms(lambda: entry(ka, xs, packed=True), warmup=1, reps=5)
    dev_ms = cuda_ms(device_fn)
    log(f"[{name} points time] {card}: eval_points_batch end to end (queries to the card, "
        f"walk, D2H): {e2e:.3f} ms = {q_total / e2e / 1e3:.2f} Mpoints/s; packed "
        f"{e2e_packed:.3f} ms = {q_total / e2e_packed / 1e3:.2f} Mpoints/s; device work "
        f"with the output left on the card ({device_work}, CUDA events) "
        f"{dev_ms:.4f} ms = {q_total / dev_ms / 1e3:.2f} Mpoints/s")
    log(f"[{name} points profile] {card}: device work host launch time (returns, not "
        f"synchronized): {enqueue_ms(device_fn):.3f} ms")
    log_breakdown(card, f"{name} points device work", device_fn, kname)
    log_breakdown(card, f"{name} eval_points_batch", lambda: entry(ka, xs), kname)


def walk_kernel_checks(dev) -> dict[str, int]:
    """Phase 19: each walk kernel against its plain version on the card, on
    real key material -> max_abs_err by kernel."""
    import itertools

    import dpf_tpu_torch as P
    from dpf_tpu_torch import fast
    from dpf_tpu_torch.ops import aes_cuda, chacha_cuda

    err = {"walk_bm_kernel": 0, "walk_kernel": 0}
    for log_n, k, q in itertools.product(COMPAT_WALK_LOG_N, COMPAT_WALK_K, COMPAT_WALK_Q):
        _, ka, _, xs = point_batch(P.gen_batch, log_n, k, q, seed=log_n * k + q)
        args = compat_walk_args(ka, xs, dev)
        err["walk_bm_kernel"] = max(err["walk_bm_kernel"], check_equal(
            "walk_bm_kernel", aes_cuda.eval_points_walk_planes(*args),
            aes_cuda.eval_points_walk_planes_plain(*args), f"log_n={log_n} K={k} Q={q}"))
    log(f"[point kernel] walk_bm_kernel == plain at every log_n in {COMPAT_WALK_LOG_N}, "
        f"K in {COMPAT_WALK_K}, Q in {COMPAT_WALK_Q}")
    checks = [(log_n, k, 0) for log_n, k in itertools.product(FAST_WALK_LOG_N, FAST_WALK_K)]
    for log_n, k, groups in checks + [(16, 128, 2)]:
        q = FAST_WALK_Q
        if groups:  # a level-grouped batch: the raw queries of its G gates
            _, ka, _, _ = point_batch(fast.gen_batch, log_n, k, 1, seed=log_n + k)
            xs = np.random.default_rng(k).integers(
                0, 1 << log_n, size=(k // (groups * log_n), q), dtype=np.uint64)
        else:
            _, ka, _, xs = point_batch(fast.gen_batch, log_n, k, q, seed=log_n + k)
        args = chacha_cuda.walk_args(ka, xs, groups, dev)
        err["walk_kernel"] = max(err["walk_kernel"], check_equal(
            "walk_kernel", chacha_cuda.walk(*args), chacha_cuda.walk_plain(*args),
            f"log_n={log_n} K={k} Q={q} groups={groups}"))
    log(f"[point kernel] walk_kernel == plain at every log_n in {FAST_WALK_LOG_N}, K in "
        f"{FAST_WALK_K}, Q={FAST_WALK_Q}, and on grouped operands (n=16, K=128, groups=2)")
    return err


def point_grouped(name: str, model, gen, spec_point, dev) -> None:
    """Phase 20 for one profile: the level-grouped walk at config 5's shape,
    kernel against plain (reduce, packed), spot-checked against the spec at
    the masked queries."""
    k = GATE_LOG_N * GATE_G
    _, kg, _, _ = point_batch(gen, GATE_LOG_N, k, 1, seed=32)
    xs = np.random.default_rng(5).integers(0, 1 << GATE_LOG_N, size=(GATE_G, GATE_Q),
                                           dtype=np.uint64)
    got = model.eval_points_level_grouped(kg, xs, 1, reduce=True, packed=True, device=dev)
    want = model.eval_points_level_grouped(kg, xs, 1, reduce=True, packed=True, device=dev,
                                           impl="plain")
    if got.shape != (GATE_G, GATE_Q // 32) or not np.array_equal(got, want):
        raise AssertionError(f"{name} grouped: kernel != plain (reduce, packed)")
    full = model.eval_points_level_grouped(kg, xs, 1, device=dev)
    fold = np.bitwise_xor.reduce(full.reshape(GATE_LOG_N, GATE_G, GATE_Q), axis=0)
    if not np.array_equal(pack_bits(fold), got):
        raise AssertionError(f"{name} grouped: reduced != the fold of the full rows")
    rng = np.random.default_rng(65)
    blobs = kg.to_bytes()
    for r, j in zip(rng.integers(0, k, 32), rng.integers(0, GATE_Q, 32)):
        shift = np.uint64(GATE_LOG_N - 1 - r // GATE_G)
        x = int((xs[r % GATE_G, j] >> shift) << shift)
        if full[r, j] != spec_point(blobs[r], x, GATE_LOG_N):
            raise AssertionError(f"{name} grouped: row {r} query {j} != spec")
    log(f"[{name} grouped] n={GATE_LOG_N}, {GATE_LOG_N} levels x {GATE_G} gates, "
        f"{GATE_Q} queries: kernel == plain (reduce, packed), reduced == fold of the "
        f"full rows, 32 (key, query) pairs equal the spec at their masked queries")


def walk_bound_ms(kname: str, nu: int, inputs, sm_clocks_per_s: float,
                  q_total: int = POINT_K * POINT_Q):
    """A walk's least time over ``q_total`` (query, key) lanes -> (bound ms,
    "operations" or "bytes", text): its ciphers' instructions
    (ops/op_count.py) over the issue rate, against each input read once and
    the output written once."""
    from dpf_tpu_torch.ops import op_count

    if kname == "walk_bm_kernel":
        columns = q_total // 32
        lop3 = op_count.walk_lop3_per_column(nu) * columns
        ops_ms = lop3 / (LOP3_PER_SM_CLOCK * sm_clocks_per_s) * 1e3
        text = f"{lop3:.4e} LOP3 ({columns} columns of {nu} PRGs + 1 MMO)"
        out_bytes = 4 * columns
    else:
        count = op_count.walk_dcf_ops if kname == "walk_dcf_kernel" else op_count.walk_chacha_ops
        ops = count(nu)
        alu, total = (ops["LOP3"] + ops["SHF"]) * q_total, sum(ops.values()) * q_total
        ops_ms = max(alu / LOP3_PER_SM_CLOCK, total / ISSUE_PER_SM_CLOCK) / sm_clocks_per_s * 1e3
        text = (f"{alu:.4e} ALU-pipe at {LOP3_PER_SM_CLOCK}/clk/SM, {total:.4e} in all at "
                f"{ISSUE_PER_SM_CLOCK}/clk/SM ({q_total} lanes of {nu} expansions + 1 leaf)")
        out_bytes = 4 * q_total
    nbytes = sum(4 * a.numel() for a in inputs) + out_bytes
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    text += f" -> {ops_ms:.4f} ms; {nbytes:.4e} B -> {bytes_ms:.4f} ms"
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes", text


def point_traced(dev, card: str) -> dict:
    """Phases 17-18, pointwise evaluation of both profiles at config 3 with
    their times and traces.  The traces of every path come before any plain
    version runs (phases 19 on): chip runs that traced after the plain
    versions' hundreds of thousands of small launches recorded few or no
    device events."""
    head = {}
    for kname, (name, entry, _, gen, spec_point, _, _) in point_profiles().items():
        n_launch, ka, xs, out_a = point_headline(kname, name, entry, gen, spec_point)  # 17
        kern, plain, device_fn, device_work, inputs, nu = point_walk(kname, ka, xs, dev)
        point_times(card, kname, name, entry, ka, xs, device_fn, device_work)  # 18
        head[kname] = (n_launch, ka, xs, out_a, kern, plain, inputs, nu)
    return head


def point_checked(dev, card: str, sm_clocks_per_s: float, head: dict) -> list[dict]:
    """Phases 19-21, the walks against their plain versions and the kernels'
    times; returns the two walk kernels' rows of the kernels line."""
    profiles = point_profiles()
    err = walk_kernel_checks(dev)  # 19
    rows = []
    for kname, (name, _, model, gen, spec_point, source, replaces) in profiles.items():
        n_launch, ka, xs, out_a, kern, plain, inputs, nu = head[kname]
        # 20. The plain path at the headline, and the level-grouped walk.
        if not np.array_equal(model.eval_points(ka, xs, device=dev, impl="plain"), out_a):
            raise AssertionError(f"{name} points: kernel path != plain path")
        log(f"[{name} points] kernel path == plain path at n={POINT_LOG_N}, K={POINT_K}, "
            f"Q={POINT_Q}")
        point_grouped(name, model, gen, spec_point, dev)

        # 21. The kernel alone at the headline, its bound and its plain version.
        bound_ms, bound_by, text = walk_bound_ms(kname, nu, inputs, sm_clocks_per_s)
        k_ms, e_ms = kernel_ms(kern), cuda_ms(kern)
        p_ms = cuda_ms(plain, warmup=1, reps=3)
        log(f"[{name} points time] {card}: {kname} at n={POINT_LOG_N}, K={POINT_K}, "
            f"Q={POINT_Q}, nu={nu}: kernel {k_ms:.4f} ms (queued; {e_ms:.4f} ms one call at "
            f"a time), plain {p_ms:.3f} ms, bound {bound_ms:.4f} ms ({text}), "
            f"{100 * bound_ms / k_ms:.1f} % of the bound")
        rows.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n_launch, "max_abs_err": err[kname], "ms": k_ms, "event_ms": e_ms,
            "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
        })
    return rows


# ---------------------------------------------------------------------------
# DCF and the FSS gates at BASELINE config 5 (phases 22-27)
# ---------------------------------------------------------------------------


def gate_rate(name: str, card: str, what: str, lanes: int, ms: float) -> None:
    log(f"[{name} time] {card}: {what}: {ms:.4f} ms = {lanes / ms / 1e3:.2f} M gate "
        f"evaluations/s")


def interval_bounds(rng, g: int):
    """(lo, hi) of g interval gates on the n=32 domain: random ranges, the
    first with the wrap edge hi = 2^n - 1, the second one point."""
    ends = np.sort(rng.integers(0, 1 << GATE_LOG_N, size=(2, g), dtype=np.uint64), axis=0)
    lo, hi = ends
    hi[0] = (1 << GATE_LOG_N) - 1
    hi[1] = lo[1]
    return lo, hi


def interval_queries(rng, lo, hi) -> np.ndarray:
    """Random queries of each interval gate, with its bounds and their
    neighbours among them."""
    xs = rng.integers(0, 1 << GATE_LOG_N, size=(len(lo), GATE_Q), dtype=np.uint64)
    top = np.uint64((1 << GATE_LOG_N) - 1)
    xs[:, 0], xs[:, 1] = lo, hi
    xs[:, 2] = np.maximum(lo, np.uint64(1)) - np.uint64(1)
    xs[:, 3] = np.minimum(hi, top - np.uint64(1)) + np.uint64(1)
    return xs


def counted(what: str, fn, expect: dict[str, int]):
    """Run ``fn`` with every launch counter zeroed just before and read just
    after -> (its result, the launches); raise unless they are ``expect``
    (kernel name -> launches) and no other kernel ran."""
    zero_launches()
    out = fn()
    launches = read_launches()
    log(f"[launches] {what}: {launches}")
    if launches != {**{n: 0 for n in launches}, **expect}:
        raise AssertionError(f"{what}: expected the launches {expect}")
    return out, launches


def gate_traced(dev, card: str, sm_clocks_per_s: float) -> dict:
    """Phases 22-24: DCF (comparison and interval) and both profiles' FSS
    gates at config 5 through the entry points, each path with its launch
    counters zeroed just before and read just after, checked exactly, timed
    and traced (before any plain version runs)."""
    from dpf_tpu_torch import fast, fss
    from dpf_tpu_torch.core import bitpack
    from dpf_tpu_torch.models import dcf as mdcf
    from dpf_tpu_torch.models import dpf as mdpf
    from dpf_tpu_torch.ops import aes_cuda, chacha_cuda

    n, q = GATE_LOG_N, GATE_Q
    head = {}

    # 22. DCF comparison at config 5: 4096 gates, one key each.
    rng = np.random.default_rng(50)
    alphas = rng.integers(0, 1 << n, size=DCF_G, dtype=np.uint64)
    alphas[0], alphas[1] = 0, (1 << n) - 1
    xs = rng.integers(0, 1 << n, size=(DCF_G, q), dtype=np.uint64)
    xs[:, 0] = alphas
    xs[:, 1] = np.maximum(alphas, np.uint64(1)) - np.uint64(1)
    def lt_path():
        keys = fast.dcf_gen_lt_batch(alphas, n, rng)
        return (*keys, *(fast.dcf_eval_lt_points(k, xs) for k in keys))

    (ka, kb, sa, sb), launches = counted(f"dcf n={n}, {DCF_G} gates", lt_path,
                                         {"walk_dcf_kernel": 2})  # one a party
    if sa.shape != (DCF_G, q) or sa.dtype != np.uint8:
        raise AssertionError(f"dcf output {sa.shape} {sa.dtype}")
    if not np.array_equal(sa ^ sb, xs < alphas[:, None]):
        raise AssertionError("dcf: shares do not reconstruct xs < alpha")
    if not np.array_equal(fast.dcf_eval_lt_points(ka, xs, packed=True), pack_bits(sa)):
        raise AssertionError("dcf: packed != pack_bits(unpacked)")
    rows = np.sort(rng.choice(DCF_G, 8, replace=False))
    cols = np.sort(rng.choice(q, 64, replace=False))
    sub = mdcf.DcfKeyBatch(n, ka.seeds[rows], ka.ts[rows], ka.scw[rows], ka.tcw[rows],
                           ka.vcw[rows], ka.fvcw[rows])
    if not np.array_equal(mdcf.eval_points_np(sub, xs[rows][:, cols]), sa[rows][:, cols]):
        raise AssertionError("dcf: shares != eval_points_np on 8 gates x 64 queries")
    log(f"[dcf] n={n}, {DCF_G} gates x {q} queries: both parties' shares XOR to "
        f"xs < alpha at every point; packed == pack_bits(bits); 8 gates x 64 queries "
        f"equal the numpy eval_points_np")

    # 23. DCF interval at config 5: 2048 gates, one fused 4096-key launch a party.
    lo, hi = interval_bounds(rng, DCF_IV_G)
    xs_iv = interval_queries(rng, lo, hi)
    def interval_path():
        keys = fast.dcf_gen_interval_batch(lo, hi, n, rng)
        return (*keys, *(fast.dcf_eval_interval_points(k, xs_iv) for k in keys))

    (ia, ib, ra, rb), _ = counted(f"dcf interval, {DCF_IV_G} gates", interval_path,
                                  {"walk_dcf_kernel": 2})
    inside = (lo[:, None] <= xs_iv) & (xs_iv <= hi[:, None])
    if not np.array_equal(ra ^ rb, inside):
        raise AssertionError("dcf interval: shares do not reconstruct lo <= x <= hi")
    if not np.array_equal(fast.dcf_eval_interval_points(ia, xs_iv, packed=True),
                          pack_bits(ra)):
        raise AssertionError("dcf interval: packed != pack_bits(unpacked)")
    log(f"[dcf] interval, {DCF_IV_G} gates (wrap edge, one point) x {q} queries: shares "
        f"XOR to lo <= x <= hi at every point; packed == pack_bits(bits)")

    # Times and traces of the DCF path.
    lanes = DCF_G * q
    args = chacha_cuda.dcf_walk_args(ka, xs, dev)

    def dcf_device():
        return chacha_cuda.walk_dcf(*args).T.to(torch.uint8).contiguous()

    gate_rate("dcf", card, "dcf_eval_lt_points end to end (queries to the card, walk, "
              "D2H)", lanes, host_ms(lambda: fast.dcf_eval_lt_points(ka, xs), 1, 5))
    gate_rate("dcf", card, "dcf_eval_lt_points packed end to end", lanes,
              host_ms(lambda: fast.dcf_eval_lt_points(ka, xs, packed=True), 1, 5))
    gate_rate("dcf", card, "dcf_eval_interval_points end to end", DCF_IV_G * q,
              host_ms(lambda: fast.dcf_eval_interval_points(ia, xs_iv), 1, 5))
    gate_rate("dcf", card, "device work, output left on the card (walk and uint8 "
              "transpose, CUDA events)", lanes, cuda_ms(dcf_device))
    log(f"[dcf profile] {card}: device work host launch time (returns, not "
        f"synchronized): {enqueue_ms(dcf_device):.3f} ms")
    log_breakdown(card, "dcf device work", dcf_device, "walk_dcf_kernel")
    log_breakdown(card, "dcf_eval_lt_points", lambda: fast.dcf_eval_lt_points(ka, xs),
                  "walk_dcf_kernel")
    kern = lambda: chacha_cuda.walk_dcf(*args)  # noqa: E731
    k_ms, e_ms = kernel_ms(kern), cuda_ms(kern)
    inputs = list(args[:7])  # xs_hi is not read at n = 32
    bound_ms, bound_by, text = walk_bound_ms("walk_dcf_kernel", ka.nu, inputs,
                                             sm_clocks_per_s, lanes)
    log(f"[dcf time] {card}: walk_dcf_kernel at n={n}, K={DCF_G}, Q={q}, nu={ka.nu}: "
        f"kernel {k_ms:.4f} ms (queued; {e_ms:.4f} ms one call at a time), bound "
        f"{bound_ms:.4f} ms ({text}), {100 * bound_ms / k_ms:.1f} % of the bound")
    head["dcf"] = dict(ka=ka, xs=xs, sa=sa, ia=ia, xs_iv=xs_iv, args=args,
                       n_launch=launches["walk_dcf_kernel"],
                       k_ms=k_ms, e_ms=e_ms, bound_ms=bound_ms, bound_by=bound_by)

    # 24. The FSS gates of both profiles at config 5: 128 gates x 32 levels
    #     (4096 keys) and 64 interval gates (2 x 32 x 64 = 4096 keys).
    for profile, kname in (("compat", "walk_bm_kernel"), ("fast", "walk_kernel")):
        name = f"fss {profile}"
        rng = np.random.default_rng(51)
        alphas = rng.integers(0, 1 << n, size=GATE_G, dtype=np.uint64)
        alphas[0], alphas[1] = 0, (1 << n) - 1
        xs = rng.integers(0, 1 << n, size=(GATE_G, q), dtype=np.uint64)
        xs[:, 0] = alphas
        xs[:, 1] = np.maximum(alphas, np.uint64(1)) - np.uint64(1)
        def fss_lt_path():
            keys = fss.gen_lt_batch(alphas, n, rng, profile)
            return (*keys, *(fss.eval_lt_points(k, xs) for k in keys))

        (ca, cb, sa, sb), _ = counted(f"{name} n={n}, {GATE_G} gates", fss_lt_path,
                                      {kname: 2})
        if sa.shape != (GATE_G, q) or not np.array_equal(sa ^ sb, xs < alphas[:, None]):
            raise AssertionError(f"{name}: shares do not reconstruct xs < alpha")
        if not np.array_equal(fss.eval_lt_points(ca, xs, packed=True), pack_bits(sa)):
            raise AssertionError(f"{name}: packed != pack_bits(unpacked)")
        lo, hi = interval_bounds(rng, FSS_IV_G)
        xs_iv = interval_queries(rng, lo, hi)
        def fss_interval_path():
            keys = fss.gen_interval_batch(lo, hi, n, rng, profile)
            return (*keys, *(fss.eval_interval_points(k, xs_iv) for k in keys))

        (ia, ib, ra, rb), _ = counted(f"{name} interval, {FSS_IV_G} gates",
                                      fss_interval_path, {kname: 2})
        if not np.array_equal(ra ^ rb, (lo[:, None] <= xs_iv) & (xs_iv <= hi[:, None])):
            raise AssertionError(f"{name} interval: shares do not reconstruct lo <= x <= hi")
        log(f"[{name}] n={n}: {GATE_G} comparison gates ({n * GATE_G} keys) and "
            f"{FSS_IV_G} interval gates ({2 * n * FSS_IV_G} keys) x {q} queries: shares "
            f"reconstruct exactly at every point; packed == pack_bits(bits)")

        lanes = n * GATE_G * q
        levels, nu = ca.levels, ca.levels.nu
        if profile == "compat":
            masks = mdpf._point_masks(levels, dev)
            split = mdpf._split_words(mdpf._pad_queries(xs), n, dev)
            wargs = mdpf._grouped_walk_body(nu, n, 1, GATE_G, *masks, *split, False,
                                            lambda *a: a)
            kern = lambda: aes_cuda.eval_points_walk_planes(*wargs)  # noqa: E731
            inputs = wargs[:-1]

            def device_fn():
                return mdpf._grouped_walk_body(nu, n, 1, GATE_G, *masks, *split, True,
                                               aes_cuda.eval_points_walk_planes)
        else:
            wargs = chacha_cuda.walk_args(levels, xs, 1, dev)
            kern = lambda: chacha_cuda.walk(*wargs)  # noqa: E731
            inputs = wargs[:6]

            def device_fn():
                bits = chacha_cuda.walk(*wargs).view(q, n, GATE_G).sum(1, dtype=torch.int32)
                return bitpack.pack_bits_qmajor_torch(bits & 1)
        gate_rate(name, card, "eval_lt_points end to end (queries to the card, walk, "
                  "fold, D2H)", lanes, host_ms(lambda: fss.eval_lt_points(ca, xs), 1, 5))
        gate_rate(name, card, "eval_lt_points packed end to end", lanes,
                  host_ms(lambda: fss.eval_lt_points(ca, xs, packed=True), 1, 5))
        gate_rate(name, card, "eval_interval_points end to end", 2 * n * FSS_IV_G * q,
                  host_ms(lambda: fss.eval_interval_points(ia, xs_iv), 1, 5))
        gate_rate(name, card, "device work, packed gate shares left on the card (CUDA "
                  "events)", lanes, cuda_ms(device_fn))
        log(f"[{name} profile] {card}: device work host launch time (returns, not "
            f"synchronized): {enqueue_ms(device_fn):.3f} ms")
        log_breakdown(card, f"{name} device work", device_fn, kname)
        log_breakdown(card, f"{name} eval_lt_points", lambda: fss.eval_lt_points(ca, xs),
                      kname)
        k_ms = kernel_ms(kern)
        bound_ms, _, text = walk_bound_ms(kname, nu, inputs, sm_clocks_per_s, lanes)
        log(f"[{name} time] {card}: {kname} at {n * GATE_G} keys x {q} queries, nu={nu}: "
            f"kernel {k_ms:.4f} ms (queued; {cuda_ms(kern):.4f} ms one call at a time), "
            f"bound {bound_ms:.4f} ms ({text}), {100 * bound_ms / k_ms:.1f} % of the bound")
    return head


def gate_checked(dev, card: str, sm_clocks_per_s: float, head: dict) -> list[dict]:
    """Phases 25-27: walk_dcf_kernel against walk_dcf_plain on the card, the
    plain path and time at config 5, and ge_full_from_dpf of both profiles;
    returns walk_dcf_kernel's row of the kernels line."""
    import itertools

    import dpf_tpu_torch as P
    from dpf_tpu_torch import fast, fss
    from dpf_tpu_torch.models import dpf as mdpf
    from dpf_tpu_torch.models import dpf_chacha as mdc
    from dpf_tpu_torch.ops import chacha_cuda

    # 25. The kernel against its plain version, on real keys.
    err = 0
    for log_n, k, q in itertools.product(DCF_CHECK_LOG_N, DCF_CHECK_K, DCF_CHECK_Q):
        _, ka, _, xs = point_batch(fast.dcf_gen_lt_batch, log_n, k, q, seed=log_n * k + q)
        args = chacha_cuda.dcf_walk_args(ka, xs, dev)
        err = max(err, check_equal("walk_dcf_kernel", chacha_cuda.walk_dcf(*args),
                                   chacha_cuda.walk_dcf_plain(*args),
                                   f"log_n={log_n} K={k} Q={q}"))
    h = head["dcf"]
    upper, xs_iv = h["ia"][0], h["xs_iv"]
    both = upper._both[2]
    args = chacha_cuda.dcf_walk_args(both, np.concatenate([xs_iv, xs_iv]), dev)
    err = max(err, check_equal("walk_dcf_kernel", chacha_cuda.walk_dcf(*args),
                               chacha_cuda.walk_dcf_plain(*args),
                               f"the fused interval batch ({both.k} keys)"))
    log(f"[dcf kernel] walk_dcf_kernel == plain at every log_n in {DCF_CHECK_LOG_N}, K in "
        f"{DCF_CHECK_K}, Q in {DCF_CHECK_Q}, and on the fused {both.k}-key interval batch "
        f"at n={GATE_LOG_N}, Q={GATE_Q}")

    # 26. The plain path at config 5, and the plain version's time.
    if not np.array_equal(chacha_cuda.eval_points_walk_dcf(
            h["ka"], h["xs"], device=dev, walk_fn=chacha_cuda.walk_dcf_plain), h["sa"]):
        raise AssertionError("dcf: kernel path != plain path")
    log(f"[dcf] kernel path == plain path at n={GATE_LOG_N}, K={DCF_G}, Q={GATE_Q}")
    p_ms = cuda_ms(lambda: chacha_cuda.walk_dcf_plain(*h["args"]), warmup=1, reps=3)
    log(f"[dcf time] {card}: walk_dcf_plain at n={GATE_LOG_N}, K={DCF_G}, Q={GATE_Q}: "
        f"{p_ms:.3f} ms")
    row = {
        "name": "walk_dcf_kernel", "route": "cuda", "source": FAST_WALK_SOURCE,
        "replaces": "dpf_tpu/ops/chacha_pallas.py:127", "launches": h["n_launch"],
        "max_abs_err": err, "ms": h["k_ms"], "event_ms": h["e_ms"], "plain_ms": p_ms,
        "bound_ms": h["bound_ms"], "bound_by": h["bound_by"], "library_ms": None,
    }

    # 27. ge_full_from_dpf, both profiles, at n=20: every point of 64 keys,
    #     with the launches counted, then the times at config 2's batch.
    #     Per party: compat nu = 13 PRG levels and one leaf convert; fast
    #     two fused-levels groups (5 + 2 levels) and one tail, as at phase 11.
    n = GE_LOG_N
    for profile, gen, dk_cls, full, expect in (
        ("compat", P.gen_batch, mdpf.DeviceKeys, mdpf.eval_full_device,
         {"prg_bm_kernel": 2 * (n - 7), "mmo_bm_canon_kernel": 2}),
        ("fast", fast.gen_batch, mdc.DeviceKeysFast, mdc.eval_full_device,
         {"fused_levels_kernel": 4, "expand_tail_kernel": 2}),
    ):
        rng = np.random.default_rng(27)
        alphas = rng.integers(0, 1 << n, size=GE_CHECK_K, dtype=np.uint64)
        alphas[0], alphas[1] = 0, (1 << n) - 1
        ka, kb = gen(alphas, n, rng)
        (ta, tb), _ = counted(f"ge_full {profile} n={n}, K={GE_CHECK_K}",
                              lambda: (fss.ge_full_from_dpf(ka), fss.ge_full_from_dpf(kb)),
                              expect)
        if ta.shape != (GE_CHECK_K, 1 << (n - 3)):
            raise AssertionError(f"ge_full {profile}: shape {ta.shape}")
        rec = np.unpackbits(ta ^ tb, axis=1, bitorder="little")
        if not np.array_equal(rec, np.arange(1 << n)[None] >= alphas[:, None]):
            raise AssertionError(f"ge_full {profile}: shares do not reconstruct x >= alpha")
        log(f"[ge_full {profile}] n={n}, K={GE_CHECK_K}: both parties' tables XOR to "
            f"x >= alpha at every point of the domain")
        del rec, ta, tb
        kk, _ = gen(rng.integers(0, 1 << n, size=GE_K, dtype=np.uint64), n, rng)
        dk = dk_cls(kk, dev)

        def device_fn():
            return fss._prefix_xor_words(full(dk)[:GE_K].reshape(GE_K, -1))

        leaves = GE_K << n
        dev_ms = cuda_ms(device_fn, warmup=1, reps=5)
        e2e_ms = host_ms(lambda: fss.ge_full_from_dpf(kk), warmup=1, reps=3)
        log(f"[ge_full {profile} time] {card}: n={n} K={GE_K}: device work (eval_full_device "
            f"+ prefix XOR, table left on the card, CUDA events) {dev_ms:.4f} ms = "
            f"{leaves / dev_ms / 1e6:.2f} Gpoints/s; ge_full_from_dpf end to end (D2H "
            f"included) {e2e_ms:.3f} ms = {leaves / e2e_ms / 1e6:.2f} Gpoints/s")
        del dk
    return [row]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import dpf_tpu_torch as P
    from dpf_tpu_torch.core import spec
    from dpf_tpu_torch.models import dpf as mdpf
    from dpf_tpu_torch.ops import aes_cuda, build, op_count
    from dpf_tpu_torch.ops.aes_bitslice import to_carrier

    dev = torch.device("cuda")
    torch.cuda.init()

    # 1. The card.
    name = torch.cuda.get_device_name(0)
    card = smi("name,power.limit")
    max_clock = smi("clocks.max.sm")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"[card] {name} | nvidia-smi: {card} | max SM clock {max_clock} | {n_sm} SMs")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # 2. The build.
    t0 = time.perf_counter()
    paths = build.build_all()
    log(f"[build] {', '.join(p.name for p in paths.values())} in "
        f"{time.perf_counter() - t0:.1f} s (one nvcc each, side by side)")
    ptxas = build.ptxas_report()
    for kern, info in ptxas.items():
        log(f"[build] {kern}: {info}")
    for kern in PRG_KERNELS:  # the redesigned PRG kernels must not spill
        info = ptxas[kern]
        log(f"[build] {kern}: {info['registers']} registers, "
            f"{info['spill_store_bytes']} B spill stores, {info['spill_load_bytes']} B spill loads")
        if info["spill_store_bytes"] or info["spill_load_bytes"]:
            raise AssertionError(f"{kern} spills: {info}")
    for kern, ops in build.sass_report().items():
        top = ", ".join(f"{op} {n}" for op, n in ops.most_common(10))
        log(f"[build] {kern} SASS, static (loop bodies once): {sum(ops.values())} "
            f"instructions: {top}")

    # 3. Each kernel against its plain version, on the card.
    kernels = {
        "prg_bm_kernel": dict(
            wrapper=aes_cuda.prg_planes_bm, plain=aes_cuda.prg_planes_bm_plain,
            replaces="dpf_tpu/ops/aes_pallas.py:213", n_mmo=2, n_out=2, B=PRG_B,
        ),
        "mmo_bm_canon_kernel": dict(
            wrapper=aes_cuda.mmo_planes_bm_canon,
            plain=aes_cuda.mmo_planes_bm_canon_plain,
            replaces="dpf_tpu/ops/aes_pallas.py:253", n_mmo=1, n_out=1, B=LEAF_B,
        ),
    }
    rng = np.random.default_rng(2024)
    for kname, kern in kernels.items():
        kern["err"] = 0
        for B in (*ODD_WIDTHS, *CHECK_WIDTHS):
            S = to_carrier(rng.integers(0, 1 << 32, size=(128, B), dtype=np.uint32), dev)
            got, want = kern["wrapper"](S), kern["plain"](S)
            if kern["n_out"] == 1:
                got, want = (got,), (want,)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                if not torch.equal(g, w):
                    raise AssertionError(f"{kname} != plain at B={B}")
                kern["err"] = max(kern["err"], max_abs_err(g, w))
            log(f"[kernel] {kname} == plain at [128, {B}]")

    # 4. The golden vectors, through gen -> EvalFull on the card.
    for log_n, alpha, seed, key_hex, out_sha in VECTORS:
        ka, _ = P.Gen(alpha, log_n, np.random.default_rng(seed))
        got_key = ka.hex() if len(ka) <= 60 else hashlib.sha256(ka).hexdigest()
        if got_key != key_hex:
            raise AssertionError(f"golden key bytes drifted at n={log_n}")
        if hashlib.sha256(P.EvalFull(ka, log_n)).hexdigest() != out_sha:
            raise AssertionError(f"golden EvalFull output drifted at n={log_n}")
        log(f"[golden] n={log_n} alpha={alpha}: key and EvalFull output match")

    # 5. The main path: host gen_batch, then eval_full_batch on the card for
    #    both parties, with every launch counter zeroed just before.
    rng = np.random.default_rng(20)
    alphas = rng.integers(0, 1 << LOG_N, size=K, dtype=np.uint64)
    zero_launches()
    ka, kb = P.gen_batch(alphas, LOG_N, rng)
    out_a = P.eval_full_batch(ka)
    out_b = P.eval_full_batch(kb)
    launches = read_launches()
    nu = LOG_N - 7
    log(f"[main] n={LOG_N} K={K}: launches over 2 evaluations {launches}")
    if launches != {**{n: 0 for n in launches}, "prg_bm_kernel": 2 * nu,
                    "mmo_bm_canon_kernel": 2}:
        raise AssertionError(f"expected {nu} PRG + 1 leaf launch per evaluation")
    if out_a.shape != (K, 1 << (LOG_N - 3)) or out_a.dtype != np.uint8:
        raise AssertionError(f"output shape {out_a.shape} {out_a.dtype}")
    assert_one_bit_at_alphas(out_a ^ out_b, alphas)
    log(f"[main] both shares reconstruct to exactly one set bit at each of {K} alphas")
    blobs = ka.to_bytes()
    for i in (0, 1, K // 2, K - 1):
        if out_a[i].tobytes() != spec.eval_full(blobs[i], LOG_N):
            raise AssertionError(f"key {i} != spec.eval_full")
    log("[main] keys 0, 1, K/2, K-1 equal the numpy spec.eval_full")

    # 6. Kernel path against plain path on the card.
    rng = np.random.default_rng(16)
    k16, _ = P.gen_batch(rng.integers(0, 1 << 16, size=256, dtype=np.uint64), 16, rng)
    dk16 = mdpf.DeviceKeys(k16, dev)
    if not torch.equal(mdpf.eval_full_device(dk16), mdpf.eval_full_device(dk16, impl="plain")):
        raise AssertionError("kernel path != plain path at n=16, K=256")
    log("[path] kernel path == plain path at n=16, K=256")

    # 7. Chunked against unchunked.
    chunked = mdpf.eval_full(ka, max_plane_words=1 << 17)
    if not np.array_equal(chunked, out_a):
        raise AssertionError("chunked != unchunked at n=20, K=1024")
    log("[path] chunked (max_plane_words=2^17) == unchunked at n=20, K=1024")

    # 8. Times.
    leaves = K << LOG_N
    dk = mdpf.DeviceKeys(ka, dev)
    dev_ms = cuda_ms(lambda: mdpf.eval_full_device(dk))
    e2e_ms = host_ms(lambda: P.eval_full_batch(ka))
    log(f"[time] {card}: eval_full_device n={LOG_N} K={K}: {dev_ms:.3f} ms, "
        f"{leaves / dev_ms / 1e6:.2f} Gleaves/s")
    log(f"[time] {card}: eval_full_batch end to end (pack, expand, D2H): "
        f"{e2e_ms:.3f} ms, {leaves / e2e_ms / 1e6:.2f} Gleaves/s")

    clock_hz = float(max_clock.split()[0]) * 1e6
    int_ops_per_s = n_sm * LOP3_PER_SM_CLOCK * clock_hz
    rows_out = []
    for kname, kern in kernels.items():
        B = kern["B"]
        S = to_carrier(rng.integers(0, 1 << 32, size=(128, B), dtype=np.uint32), dev)
        k_ms = kernel_ms(lambda: kern["wrapper"](S))
        e_ms = cuda_ms(lambda: kern["wrapper"](S))
        p_ms = cuda_ms(lambda: kern["plain"](S))
        ops = op_count.lop3_per_column(kern["n_mmo"]) * B
        nbytes = (1 + kern["n_out"]) * 128 * B * 4
        ops_ms, bytes_ms = ops / int_ops_per_s * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        log(f"[time] {card}: {kname} at [128, {B}]: kernel {k_ms:.4f} ms (queued; "
            f"{e_ms:.4f} ms one call at a time), plain "
            f"{p_ms:.3f} ms, bound {bound_ms:.4f} ms ({ops:.3e} LOP3 -> {ops_ms:.4f} ms, "
            f"{nbytes:.3e} B -> {bytes_ms:.4f} ms)")
        rows_out.append({
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": kern["replaces"], "launches": launches[kname],
            "max_abs_err": kern["err"], "ms": k_ms, "event_ms": e_ms, "plain_ms": p_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
        })

    # 9. Where the time goes: one traced run of each entry point (not in the
    #    times above), and the host's time to launch eval_full_device's work.
    enq_ms = enqueue_ms(lambda: mdpf.eval_full_device(dk))
    log(f"[profile] {card}: eval_full_device host launch time (returns, not "
        f"synchronized): {enq_ms:.3f} ms")
    for entry, fn in (
        ("eval_full_device", lambda: mdpf.eval_full_device(dk)),
        ("eval_full_batch", lambda: P.eval_full_batch(ka)),
    ):
        log_breakdown(card, entry, fn, "prg_bm_kernel")

    rows_out += fast_phases(dev, card, n_sm * clock_hz)
    point_head = point_traced(dev, card)
    gate_head = gate_traced(dev, card, n_sm * clock_hz)
    # The compat options after the other paths' traces, traced first:
    # traces taken after many launches lose device events.
    option_times(dev, card, ka)
    option_launches = option_routes(dev, card, ka, kb, alphas, out_a)
    rows_out += point_checked(dev, card, n_sm * clock_hz, point_head)
    rows_out += gate_checked(dev, card, n_sm * clock_hz, gate_head)
    # The option kernels' plain versions run last: traces after many small
    # plain launches lose device events.
    rows_out += option_kernels(dev, card, n_sm * clock_hz, ka, option_launches)

    print(json.dumps({"kernels": rows_out}), flush=True)
    log(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
