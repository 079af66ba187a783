#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dpf_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--parent DIR] [--seed N]

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
held to the default route's bytes and the spec (phase 28).  Then the
streaming and PIR paths, traced before the plain versions' many launches:
phase 35, both profiles' ``eval_full_stream`` at config 2 (blocks against
``eval_full_batch``'s bytes, both parties' reconstruction, the stream
driver's event order, counted launches; times to the first and the last
block beside the blocking call, the pinned D2H rate), and phase 36, the
2-server PIR of both profiles at BASELINE.json's config 4 (2^24 rows x 32
B from ``--seed``, 1024 queries; ``PirServer.answer`` one-shot and as the
default 2-slab streamed scan, both servers counted, the rows reconstructed,
the streamed answer equal to the one-shot one, 4 queries against a numpy
XOR of the rows that ``eval_full_batch`` selects; of the default scan,
queries/s and DB-GB/s end to end, the expansion, the parity scan and its
int8 products by CUDA events, and one traced answer).  Then the dealer, heavy hitters and aggregation on the card,
each traced before its heavy checks: phase 37, ``gen_batch`` of both
profiles and ``fast.dcf_gen_lt_batch`` (all three families at n=20 with
1024 and 65,536 keys, the DCF at n=32 with 4096) byte-identical to the host
tower on the same roots, every key reconstructing at its alpha, and
``gen_tower_cc_kernel`` against ``gen_tower_plain``; phase 38, heavy
hitters of both profiles at bench_all.py's full size (16384 clients, n=16,
4 x 320 planted, threshold 160): ``gen_shares`` dealing 262,144 keys a
party on the card, ``find_heavy_hitters`` incremental and stateless, each
recovering the planted values with exact counts, and the on-card count
fold against the host popcount; phase 39, ``aggregate_rows`` over 2^20 x
64-word client rows and ``aggregate_eval_full`` of config 2's batch in
both profiles against numpy and ``eval_full_batch``.  Then phase 40, the
dispatch plans on the card (``dpf_tpu_torch.core.plans``): ``warmup``
captures one CUDA graph for each of compat and fast ``evalfull`` at config 2,
compat and fast ``points`` at config 3 and ``dcf_points`` at config 5;
requests inside and on those buckets are byte-identical to the direct eager
model calls, reconstruct at alpha and capture nothing more; one replay of
each graph is traced beside the eager body and shows the same kernels by
name and count; each plan's host enqueue, device work, wall, idle share,
pool bytes and capture seconds are printed beside the eager body's; and the
eager routes (``gen`` of all three families, ``pir`` on a registered
database, ``hh_level``, ``hh_extend``, ``hh_fold``, ``dcf_interval``,
``agg_xor``, ``agg_add``) run once each against their direct model calls.
The kernels of those options (``prg_canon_kernel``, ``leaf_words_canon_kernel``,
``prg_bm_il_kernel``, ``fused_levels_bm_kernel``) are held against their
plain versions and timed last (phases 30-31).  The leaf kernels
(``leaf_words_bm_kernel``, ``leaf_words_canon_kernel``: the leaf MMO, the
final CW and the per-key words in one launch) are held against their plain
versions in both input layouts (level-major, and the fused route's
node-minor), at odd widths and the leaf levels of the main path, of a
stream chunk and of the PIR expansion, and writing two subtrees into one
output at leaf offsets as the chunked route does.  Every kernel that the
stream and PIR paths launch is held against its plain version at each
shape those paths give it (``CHECK_WIDTHS``, ``LEAF_CHECKS``,
``FAST_CHECKS``).  It checks each kernel
path against the plain path and the chunked split against the unchunked
one (and the fast profile's deep-tree and whole-tree routes), and times the paths and each kernel with CUDA events
(a kernel's ``ms`` in the kernels line: its runs queued back to back behind
a sleep kernel, so the host's launch time between them does not count; its
``event_ms``: one call at a time, events around each).
Each kernel's bound counts its instructions (``dpf_tpu_torch/ops/op_count.py``:
LOP3 for AES-MMO, IADD/LOP3/SHF for ChaCha12; the walks: their ciphers) over
the card's issue rate, and
the build phase prints the built kernels' SASS instruction counts, and the
registers and spills of the kernels that run the folded cipher
(``FOLDED_KERNELS``: the three PRG kernels, the two leaf kernels, the walk
and the fused levels) and of the fast expansion kernels
(``STACKLESS_KERNELS``), failing if any of them spills or a fast one has a
stack frame; phase 31 times the two PRG kernels beside
``prg_bm_il_kernel`` (the same function) in turns.  Last, after every
trace (traces taken after many launches lose device events), phases 32-34:
the fast kernels against their plain versions at every split d their rule
picks, the fast subtree route (ROADMAP C.5: configurations neither other
plan takes, and 131,073 keys at log_n 15) against the spec, and the fast
kernels' registers, stack and SASS counts.  ``--parent DIR`` builds DIR's
``dpf_tpu_torch/ops/csrc/chacha_expand.cu`` with this tree's flags and
phase 34 times both fast kernels and the fast device path in turns with
it (parent, tree, tree, parent).  Every
check is exact: this is integer cryptography, the tolerance is zero.

Any failed phase raises, so the script exits nonzero.  Without CUDA, or
without the package beside it, it exits nonzero and prints no result.  The
last line of standard output is one JSON object naming the card; the line
before the card's name and power limit lists every kernel with its
measurements.  Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import hashlib
import json
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

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
# prg_bm_kernel's checks, [128, B]: an odd width and every width the compat
# paths give it, 32 << l for l = 0 .. 16 (the main path's and the stream's
# levels, and config 4's PIR expansion up to its last level, 2^21 columns).
CHECK_WIDTHS = (100, *(32 << l for l in range(17)))
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
# 4096}, L in {0, ..., 6} and K in {1, 9, 1024}, the headline tail (1024 keys,
# 128 entry nodes, 4 levels) and the headline prefix groups (W 1 for 5
# levels, W 32 for 2), the stream's at config 2 (W 1 for 1 level, a chunk's
# W 1 for 5 and W 32 for 5), config 4's PIR tail (W 1024 for 5), and between
# them every split d that either kernel's rule picks
# (csrc/chacha_expand.cu::split_levels: d from L - 2 to L - 1).
# The compat EvalFull options at config 2 (phases 28-31): (backend, fuse,
# max_plane_words) -> launches per evaluation.  nu = 13; fuse=g runs levels
# 0-6 per level, then _fuse_schedule's groups of levels 7-12; the chunked
# route (2^17 words a plane) one prefix level and two subtrees of 12.
OPTION_ROUTES = {
    ("pallas", None, None): {"prg_canon_kernel": 13, "leaf_words_canon_kernel": 1},
    ("xla", None, None): {"prg_canon_kernel": 13, "leaf_words_canon_kernel": 1},
    ("pallas_bm_il", None, None): {"prg_bm_il_kernel": 13, "leaf_words_bm_kernel": 1},
    ("pallas_bm", 1, None): {"prg_bm_kernel": 7, "fused_levels_bm_kernel": 6,
                             "leaf_words_bm_kernel": 1},
    ("pallas_bm", 2, None): {"prg_bm_kernel": 7, "fused_levels_bm_kernel": 3,
                             "leaf_words_bm_kernel": 1},
    ("pallas_bm", 3, None): {"prg_bm_kernel": 7, "fused_levels_bm_kernel": 2,
                             "leaf_words_bm_kernel": 1},
    ("pallas_bm", 4, None): {"prg_bm_kernel": 7, "fused_levels_bm_kernel": 2,
                             "leaf_words_bm_kernel": 1},
    ("pallas_bm_il", 2, None): {"prg_bm_il_kernel": 7, "fused_levels_bm_kernel": 3,
                                "leaf_words_bm_kernel": 1},
    ("pallas", None, 1 << 17): {"prg_canon_kernel": 25, "leaf_words_canon_kernel": 2},
}
# The route whose launches and fused groups the kernels line gives for
# fused_levels_bm_kernel; the odd shapes of its checks (Kp, W, g).
FUSED_ROUTE = ("pallas_bm", 4, None)
FUSED_CHECKS = ((1, 1, 1), (1, 1, 4), (3, 5, 2), (3, 5, 6))
ODD_WIDTHS = (1, 33, 4097)
# The kernels of aes_bm.cuh's folded cipher, checked for spills at the build.
FOLDED_KERNELS = ("prg_bm_kernel", "prg_canon_kernel", "prg_bm_il_kernel",
                  "leaf_words_bm_kernel", "leaf_words_canon_kernel", "walk_bm_kernel",
                  "fused_levels_bm_kernel")
# The fast expansion kernels, whose depth-first stack must stay in registers:
# the build fails if either spills or has a stack frame.
STACKLESS_KERNELS = ("expand_tail_kernel", "fused_levels_kernel")
# The SASS opcodes phase 15 counts in them: the ChaCha adds (IADD3 on the
# ALU pipe, IMAD on the FMA pipe), xors, rotates and local-memory traffic.
SASS_OPS = ("IADD3", "IMAD", "LOP3", "SHF", "PRMT", "SEL", "MOV", "LDL", "STL")
# The leaf kernels' checks, (W, Kp) in both input layouts: odd widths, more
# key words than a block's columns, the main path's leaf level, a stream
# chunk's at config 2 (2^12 leaves) and config 4's PIR leaf level (2^17
# leaves); then two subtrees written into one output at leaf
# offsets 0 and W, at odd widths and at the chunked route's subtree
# (max_plane_words 2^17: 2^12 leaves).
LEAF_CHECKS = ((1, 1), (33, 1), (4097, 1), (5, 3), (3, 100), (1 << (LOG_N - 7), K // 32),
               (1 << (LOG_N - 8), K // 32), (1 << 17, K // 32))
LEAF_CHUNK_CHECKS = ((33, 3), (1 << (LOG_N - 8), K // 32))
# The subtree route's checks (log_n, K, max_leaf_nodes): the CPU tests'
# cases, then the realistic batch at the default cap (K 131,073 at log_n 15:
# 2 chunks of 2^22.0 leaves, c = 1).
SUBTREE_CHECKS = ((14, 3, 16), (12, 9, 16), (10, 1, 1), (12, 8, 8), (15, 9, 1000),
                  (17, 1, 512))
SUBTREE_BIG = (15, 131073)
# eval_full_stream at config 2 (phase 35): c = 1, two chunks.  compat: one
# prefix level, then 12 levels and a leaf convert a chunk; fast: a 1-level
# prefix group, then a 5-level group and a 5-level tail a chunk.
STREAM_LAUNCHES = {
    "compat": {"prg_bm_kernel": 1 + 2 * 12, "leaf_words_bm_kernel": 2},
    "fast": {"fused_levels_kernel": 1 + 2, "expand_tail_kernel": 2},
}
# BASELINE.json config 4 (phase 36): 2-server PIR, 2^24 rows x 32 B, 1024
# batched queries; the selection expansion's launches per answer (compat nu
# = 17; fast nu = 15, entry 10: prefix groups of 5 + 5 levels, a 5-level tail).
PIR_ROWS, PIR_ROW_BYTES, PIR_Q = 1 << 24, 32, 1024
# Phase 37, the dealer (bench_all.py:2416-2417): all three families at n=20
# with K 1024 and 65,536, and the DCF at config 5's gate batch (n=32, K
# 4096).  At K above GEN_SLICE a GEN_SLICE-key slice is compared with the
# host tower on the same roots, and every key reconstructs at its alpha.
GEN_CASES = (("compat", 20, 1024), ("fast", 20, 1024), ("dcf", 20, 1024),
             ("compat", 20, 65536), ("fast", 20, 65536), ("dcf", 20, 65536),
             ("dcf", 32, 4096))
GEN_SLICE = 4096
GEN_SOURCE = "dpf_tpu_torch/ops/csrc/chacha_gen.cu"
# Phase 38, heavy hitters (bench_all.py:1440-1486, the cfg_apps section):
# 16384 clients at n=16, 4 planted values x 320 clients, threshold 160, 4
# levels a round, at most 4096 candidates; the count fold on 16384 x 512
# random rows (bench_all.py:1595-1620).
HH_G, HH_N, HH_PER, HH_Q_FOLD = 16384, 16, 320, 512
HH_PLANTED = (5, 1234, (1 << 16) - 7, (1 << 16) // 3)
# The kernels each descent mode launches, by profile.
HH_KERNELS = {
    ("compat", True): ("prg_canon_kernel",), ("compat", False): ("walk_bm_kernel",),
    ("fast", True): ("fused_levels_kernel", "expand_tail_kernel"),
    ("fast", False): ("walk_kernel",),
}
# Phase 39, aggregation (bench_all.py:1491-1524): 2^20 client rows x 64 words.
AGG_ROWS, AGG_WORDS = 1 << 20, 64
# Phase 40, the plans on the card: the warmed graph plans (BASELINE configs 2,
# 3 and 5), the requests sent inside and on their buckets (K, Q), and the
# hand kernels each replay launches (the eager call's, by name and count).
PLAN_WARM = (
    {"route": "evalfull", "profile": "compat", "log_n": 20, "k": 1024},
    {"route": "evalfull", "profile": "fast", "log_n": 20, "k": 1024},
    {"route": "points", "profile": "compat", "log_n": 30, "k": 256, "q": 4096},
    {"route": "points", "profile": "fast", "log_n": 30, "k": 256, "q": 4096},
    {"route": "dcf_points", "profile": "fast", "log_n": 32, "k": 4096, "q": 1024},
)
PLAN_REQUESTS = {
    ("evalfull", "compat"): ((1024, 0), (1000, 0), (513, 0)),
    ("evalfull", "fast"): ((1024, 0), (1000, 0), (513, 0)),
    ("points", "compat"): ((256, 4096), (200, 4000)),
    ("points", "fast"): ((256, 4096), (200, 4000)),
    ("dcf_points", "fast"): ((4096, 1024), (4000, 1000)),
}
PLAN_KERNELS = {
    ("evalfull", "compat"): {"prg_bm_kernel": 13, "leaf_words_bm_kernel": 1},
    ("evalfull", "fast"): {"fused_levels_kernel": 2, "expand_tail_kernel": 1},
    ("points", "compat"): {"walk_bm_kernel": 1},
    ("points", "fast"): {"walk_kernel": 1},
    ("dcf_points", "fast"): {"walk_dcf_kernel": 1},
}
PLAN_SAMPLE = 64  # keys a request reconstructs at alpha
PIR_LAUNCHES = {
    "compat": {"prg_bm_kernel": 17, "leaf_words_bm_kernel": 1},
    "fast": {"fused_levels_kernel": 2, "expand_tail_kernel": 1},
}
INT8_OPS_PER_S = 1.979e15  # H100 SXM published dense int8 tensor-core rate
FAST_CHECKS = (
    (1, 1, 0), (1, 1, 5), (1, 1, 6), (9, 3, 1), (9, 3, 2), (9, 3, 3), (9, 3, 4), (9, 3, 5),
    (1, 4096, 1), (9, 4096, 5), (1024, 4096, 0), (1024, 128, 1), (1024, 128, 4),
    (1024, 1, 5), (1024, 32, 2), (1024, 64, 2), (1024, 16, 3), (1024, 64, 3), (1024, 1, 6),
    (64, 64, 6), (1024, 1, 1), (1024, 32, 5), (1024, 1024, 5),
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
    copies and memsets.  A trace without a kernel whose name holds
    ``expect`` is taken again, at most ``attempts`` times in all, each miss
    printed."""
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
        if any(expect in name for name in busy):
            return wall_ms, (max(ends) - min(starts)) / 1e3, busy
        log(f"[profile] trace attempt {attempt} of {attempts} holds {len(starts)} device "
            f"events and no {expect}")
    raise AssertionError(f"torch.profiler recorded no {expect} in {attempts} traces")


# The pause between the runs of one traced session, and the device gap that
# splits their events; a chip run saw a 10 ms gap inside one compat
# eval_full_device (its host launch time is 4-11 ms).
TRACE_PAUSE_S = 0.1


def device_breakdowns(fns: list, expects: list[str], attempts: int = 3,
                      lead: int = 0) -> list[tuple]:
    """:func:`device_breakdown` of each of ``fns`` in ONE torch.profiler
    session: each runs once, synchronized and followed by a pause of
    ``TRACE_PAUSE_S``, and the device events split into one cluster per
    run at the gaps longer than half the pause.  Chip runs whose later
    traces followed many launches lost device events, so a phase that
    traces many paths takes one session.  The first ``lead`` runs are not
    read (the clusters are matched to the runs from the last one back: late
    traces lost events near a session's start), and only the others'
    results return.  A trace whose clusters do not hold each read run's
    ``expects`` kernel is taken again."""
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
        n_clusters, keep = len(clusters), len(fns) - lead
        clusters, walls, want = clusters[max(n_clusters - keep, 0):], walls[lead:], expects[lead:]
        out = []
        for wall_ms, cluster in zip(walls, clusters):
            busy: dict[str, tuple[float, int]] = {}
            for e in cluster:
                us, count = busy.get(e.name, (0.0, 0))
                busy[e.name] = (us + e.time_range.elapsed_us(), count + 1)
            span_ms = (max(e.time_range.end for e in cluster)
                       - cluster[0].time_range.start) / 1e3
            out.append((wall_ms, span_ms, busy))
        found = [any(x in name for name in b) for x, (_, _, b) in zip(want, out)]
        if keep <= n_clusters <= len(fns) and all(found):
            return out
        log(f"[profile] trace attempt {attempt} of {attempts}: {len(evts)} device events in "
            f"{n_clusters} clusters for {len(fns)} runs, expected kernels {found}")
    raise AssertionError(f"torch.profiler did not record {expects} in {attempts} traces")


def kernel_launches(busy: dict[str, tuple[float, int]]) -> int:
    """The kernel launches among a trace's device events (not its copies
    and memsets)."""
    return sum(n for name, (_, n) in busy.items() if not name.startswith(("Memcpy", "Memset")))


def log_breakdown(card: str, entry: str, fn, expect: str) -> None:
    """Print :func:`device_breakdown` of one run of ``fn``."""
    wall_ms, span_ms, busy = device_breakdown(fn, expect)
    total = sum(us for us, _ in busy.values()) / 1e3
    n_events = sum(count for _, count in busy.values())
    log(f"[profile] {card}: {entry} traced: wall {wall_ms:.3f} ms, device span "
        f"{span_ms:.3f} ms, busy {total:.3f} ms in {n_events} device events "
        f"({kernel_launches(busy)} kernel launches), idle "
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
        "leaf_words_bm_kernel": aes_cuda.convert_leaves_bm,
        "prg_canon_kernel": aes_cuda.prg_planes_canon,
        "leaf_words_canon_kernel": aes_cuda.convert_leaves_canon,
        "prg_bm_il_kernel": aes_cuda.prg_planes_bm_il,
        "fused_levels_bm_kernel": aes_cuda.fused_levels_planes,
        "fused_levels_kernel": chacha_cuda.fused_levels,
        "expand_tail_kernel": chacha_cuda.expand_tail,
        "walk_bm_kernel": aes_cuda.eval_points_walk_planes,
        "walk_kernel": chacha_cuda.walk,
        "walk_dcf_kernel": chacha_cuda.walk_dcf,
        "gen_tower_cc_kernel": chacha_cuda.gen_tower,
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


def leaf_operands(rng, W: int, kp: int, node_minor: bool, dev):
    """Random leaf planes, control words and final CW planes [128, 1, Kp] on
    ``dev``: S [128, W, Kp] and T [W, Kp], or with ``node_minor`` S
    [128, Kp, W] and T [Kp, W].  Random words, not only lane masks: the
    kernel and the plain version compute the same function of any words."""
    from dpf_tpu_torch.ops.aes_bitslice import to_carrier

    def words(*shape):
        return to_carrier(rng.integers(0, 1 << 32, size=shape, dtype=np.uint32), dev)

    cols = (kp, W) if node_minor else (W, kp)
    return words(128, *cols), words(*cols), words(128, 1, kp)


def leaf_checks(kname: str, wrapper, plain, dev) -> int:
    """A leaf kernel against its plain version on the card: every (W, Kp) of
    LEAF_CHECKS in both input layouts, then LEAF_CHUNK_CHECKS' two subtrees
    into one output at leaf offsets 0 and W -> the largest error (0)."""
    rng = np.random.default_rng(2025)
    err = 0
    for W, kp in LEAF_CHECKS:
        for node_minor in (False, True):
            ops = leaf_operands(rng, W, kp, node_minor, dev)
            err = max(err, check_equal(kname, wrapper(*ops, node_minor=node_minor),
                                       plain(*ops, node_minor=node_minor),
                                       f"W={W} Kp={kp} node_minor={node_minor}"))
    for W, kp in LEAF_CHUNK_CHECKS:
        for node_minor in (False, True):
            got = torch.zeros((32 * kp, 2 * W + 1, 4), dtype=torch.int32, device=dev)
            want = torch.zeros_like(got)
            for half in range(2):
                ops = leaf_operands(rng, W, kp, node_minor, dev)
                wrapper(*ops, node_minor=node_minor, out=got, leaf_offset=half * W)
                plain(*ops, node_minor=node_minor, out=want, leaf_offset=half * W)
            err = max(err, check_equal(kname, got, want, f"two subtrees of W={W} at leaf "
                                       f"offsets 0, {W} of {2 * W + 1}, Kp={kp}, "
                                       f"node_minor={node_minor}"))
    log(f"[kernel] {kname} == plain at (W, Kp) in {LEAF_CHECKS}, both input layouts, and "
        f"writing two subtrees at leaf offsets for (W, Kp) in {LEAF_CHUNK_CHECKS}")
    return err


def leaf_row(card: str, kname: str, wrapper, plain, replaces: str, launches: int, err: int,
             int_ops_per_s: float, dev) -> dict:
    """A leaf kernel timed at the main path's leaf level ([128, 2^13, 32]
    level-major; the node-minor layout, the fused route's, beside it) next
    to its bound and its plain version -> its row of the kernels line."""
    from dpf_tpu_torch.ops import op_count

    W, kp = 1 << (LOG_N - 7), K // 32
    rng = np.random.default_rng(2026)
    S, T, fcw = leaf_operands(rng, W, kp, False, dev)
    k_ms, e_ms = kernel_ms(lambda: wrapper(S, T, fcw)), cuda_ms(lambda: wrapper(S, T, fcw))
    p_ms = cuda_ms(lambda: plain(S, T, fcw), warmup=1, reps=3)
    Sn, Tn, fcwn = leaf_operands(rng, W, kp, True, dev)
    n_ms = kernel_ms(lambda: wrapper(Sn, Tn, fcwn, node_minor=True))
    n = W * kp
    ops = op_count.leaf_words_per_column() * n
    nbytes = 4 * (128 * n + n + 128 * kp) + 16 * 32 * n  # planes, t, fcw in; words out
    ops_ms, bytes_ms = ops / int_ops_per_s * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    log(f"[time] {card}: {kname} at [128, {W}, {kp}]: kernel {k_ms:.4f} ms (queued; "
        f"{e_ms:.4f} ms one call at a time; node-minor [128, {kp}, {W}] {n_ms:.4f} ms), "
        f"plain {p_ms:.3f} ms, bound {bound_ms:.4f} ms ({ops:.3e} instructions: "
        f"{op_count.lop3_per_column(1)} MMO LOP3 + {sum(op_count.LEAF_EPILOGUE.values())} "
        f"epilogue a column -> {ops_ms:.4f} ms, {nbytes:.3e} B -> {bytes_ms:.4f} ms), "
        f"{100 * bound_ms / k_ms:.1f} % of the bound")
    return {
        "name": kname, "route": "cuda", "source": SOURCE, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": k_ms, "event_ms": e_ms,
        "plain_ms": p_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "library_ms": None,
    }


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
            f"{sum(n for _, n in busy.values())} device events ({kernel_launches(busy)} kernel "
            f"launches), idle "
            f"{100 - 100 * total / span_ms:.1f} % of the span; {top}")


def option_kernels(dev, card: str, sm_clocks_per_s: float, ka, launches) -> list[dict]:
    """Phases 30-31: the options' four kernels against their plain versions
    on the card (at their config-2 shapes and odd widths), then their times
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
    err["leaf_words_canon_kernel"] = leaf_checks(
        "leaf_words_canon_kernel", aes_cuda.convert_leaves_canon,
        aes_cuda.convert_leaves_canon_plain, dev)

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
    rows.append(leaf_row(card, "leaf_words_canon_kernel", aes_cuda.convert_leaves_canon,
                         aes_cuda.convert_leaves_canon_plain, "dpf_tpu/ops/aes_pallas.py:128",
                         launches[("pallas", None, None)]["leaf_words_canon_kernel"],
                         err["leaf_words_canon_kernel"], int_ops_per_s, dev))

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


def parent_expand_build(parent: str):
    """Build ``parent``'s ``dpf_tpu_torch/ops/csrc/chacha_expand.cu`` with
    this tree's flags -> (the library with its C functions bound, (its
    ptxas report, its SASS counts))."""
    import ctypes

    from dpf_tpu_torch.ops import build

    src = Path(parent) / "dpf_tpu_torch" / "ops" / "csrc" / "chacha_expand.cu"
    so = build.BUILD_DIR / "parent" / "chacha_expand.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(src.parent), "-o",
                           str(so), str(src)], capture_output=True, text=True, timeout=600,
                          check=True)
    sass = subprocess.run([str(Path(build._nvcc()).with_name("cuobjdump")), "-sass", str(so)],
                          capture_output=True, text=True, timeout=120, check=True)
    lib = ctypes.CDLL(str(so))
    for fn in ("dpf_chacha_tail", "dpf_chacha_fused"):
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = (
            build._SIGNATURES["chacha_expand"][fn])
    return lib, (build.parse_ptxas(proc.stdout + proc.stderr), build.parse_sass(sass.stdout))


def raw_expand(lib):
    """(fused, tail): the contracts of ``chacha_cuda.fused_levels`` and
    ``expand_tail`` (contiguous operands) on ``lib``'s kernels, uncounted:
    the parent's build in phase 15's turns."""

    def run(fn, *args):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"the parent's {fn.__name__}: CUDA error {rc}")

    def fused(st, scw, tcw):
        K, W, L = st.shape[1], st.shape[2], scw.shape[1]
        out = torch.empty((5, K, W << L), dtype=torch.int32, device=st.device)
        run(lib.dpf_chacha_fused, st.data_ptr(), st.stride(0), st.stride(1), K, W, L,
            scw.data_ptr(), scw.stride(0), tcw.data_ptr(), tcw.stride(0), out.data_ptr(),
            out.stride(0), out.stride(1))
        return out

    def tail(st, scw, tcw, fcw, out=None):
        K, W, L = st.shape[1], st.shape[2], scw.shape[1]
        if out is None:
            out = torch.empty((K, W << L, 16), dtype=torch.int32, device=st.device)
        run(lib.dpf_chacha_tail, st.data_ptr(), st.stride(0), st.stride(1), K, W, L,
            scw.data_ptr(), scw.stride(0), tcw.data_ptr(), tcw.stride(0), fcw.data_ptr(),
            fcw.stride(0), out.data_ptr(), out.stride(0))
        return out

    return fused, tail


def subtree_run(kb, cap: int):
    """``fast.eval_full_batch(kb, max_leaf_nodes=cap)`` on the card through
    the subtree route -> (its output, its launches, its wall in ms), raising
    unless both other plans refuse and the launches are the plan's."""
    from dpf_tpu_torch import fast
    from dpf_tpu_torch.ops import chacha_cuda as cc_cuda

    nu, k = kb.nu, kb.k
    if cc_cuda.expand_plan(nu, k, cap)[0] or cc_cuda.expand_plan_chunked(nu, k, cap)[0]:
        raise AssertionError(f"nu={nu} K={k} cap {cap}: not a subtree-route case")
    plan = cc_cuda.expand_plan_subtrees(nu, k, cap)
    want = {"fused_levels_kernel": len(plan.prefix) + (len(plan.groups) << plan.c),
            "expand_tail_kernel": 1 << plan.c}
    want = {n: v for n, v in want.items() if v}
    torch.cuda.synchronize()
    before = read_launches()
    t0 = time.perf_counter()
    out = fast.eval_full_batch(kb, max_leaf_nodes=cap)
    wall = (time.perf_counter() - t0) * 1e3
    after = read_launches()
    got = {n: after[n] - before[n] for n in after if after[n] != before[n]}
    if got != want:
        raise AssertionError(f"subtree route {plan}: launches {got}, expected {want}")
    return out, got, wall


def fast_phases(dev, card: str, sm_clocks_per_s: float) -> list[dict]:
    """Phases 11-16, the fast profile (``dpf_tpu_torch.fast``); returns its
    two kernels' rows of the kernels line, whose ``max_abs_err`` phase 32
    fills."""
    from dpf_tpu_torch import fast
    from dpf_tpu_torch.core import chacha_np
    from dpf_tpu_torch.models import dpf_chacha as mdc
    from dpf_tpu_torch.ops import chacha_cuda as cc_cuda
    from dpf_tpu_torch.ops import op_count

    # 11. The fast main path: host gen_batch, then eval_full_batch on the card
    #     for both parties, with every launch counter zeroed just before.
    rng = np.random.default_rng(21)
    alphas = rng.integers(0, 1 << LOG_N, size=K, dtype=np.uint64)
    zero_launches()
    ka, kb = fast.gen_batch(alphas, LOG_N, rng, device="cpu")
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
        kk, _ = fast.gen_batch(r.integers(0, 1 << log_n, size=k, dtype=np.uint64), log_n, r, device="cpu")
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
        kk, _ = fast.gen_batch(r.integers(0, 1 << log_n, size=k, dtype=np.uint64), log_n, r, device="cpu")
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
    groups = cc_cuda.level_groups(entry)

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
            "launches": launches[kname], "max_abs_err": None, "ms": k_ms,
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


def fast_late_phases(dev, card: str, parent: str | None, rows: list[dict]) -> None:
    """Phases 32-34, the fast profile's checks that launch the most, run
    after every trace (traces taken after many launches lose device
    events): each kernel against its plain version at every split its rule
    picks (filling the fast rows' ``max_abs_err``), the subtree route
    (ROADMAP C.5) on the card, and the kernels' builds, with ``parent`` (a
    checkout) timed in turns with the parent's build."""
    from dpf_tpu_torch import fast
    from dpf_tpu_torch.core import chacha_np
    from dpf_tpu_torch.models import dpf_chacha as mdc
    from dpf_tpu_torch.ops import build
    from dpf_tpu_torch.ops import chacha_cuda as cc_cuda

    # 32. Each fast kernel against its plain version, on the card, at every
    #     split d its rule picks.
    rng = np.random.default_rng(2025)
    err = {"fused_levels_kernel": 0, "expand_tail_kernel": 0}
    split = build.load("chacha_expand").dpf_chacha_split
    splits = {(leaf, L, d) for leaf in (0, 1) for L in range(7)
              for d in range(max(0, L - 2), max(0, L - 1) + 1)}
    for k, w, levels in FAST_CHECKS:
        splits -= {(leaf, levels, split(k * w, levels, leaf)) for leaf in (0, 1)}
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
        log(f"[fast kernel] fused_levels_kernel (d={split(k * w, levels, 0)}) and "
            f"expand_tail_kernel (d={split(k * w, levels, 1)}) == plain at K={k}, W={w}, "
            f"{levels} levels")
    if splits:
        raise AssertionError(f"FAST_CHECKS miss the splits (tail?, L, d) {sorted(splits)}")
    for row in rows:
        if row["name"] in err:
            row["max_abs_err"] = err[row["name"]]

    # 33. The subtree route (ROADMAP C.5): configurations that neither the
    #     classic or whole-tree plan nor the chunked plan takes, against the
    #     spec, with the launches each plan lists.
    for log_n, k, cap in SUBTREE_CHECKS:
        r = np.random.default_rng(log_n + k)
        kk, _ = fast.gen_batch(r.integers(0, 1 << log_n, size=k, dtype=np.uint64), log_n, r, device="cpu")
        got, n_launch, wall = subtree_run(kk, cap)
        for i, key in enumerate(kk.to_bytes()):
            if got[i].tobytes() != chacha_np.eval_full(key, log_n):
                raise AssertionError(f"subtree route: key {i} != spec at n={log_n}, K={k}, "
                                     f"cap {cap}")
        log(f"[fast subtree] n={log_n} K={k} max_leaf_nodes={cap}: == spec, launches "
            f"{n_launch}, wall {wall:.3f} ms")
    log_n, k = SUBTREE_BIG
    r = np.random.default_rng(0)
    alphas = np.arange(k, dtype=np.uint64) % np.uint64(1 << log_n)
    kk, kq = fast.gen_batch(alphas, log_n, r, device="cpu")
    got, n_launch, wall = subtree_run(kk, mdc.MAX_LEAF_NODES)
    got_b, _, wall_b = subtree_run(kq, mdc.MAX_LEAF_NODES)
    if got.shape != (k, 1 << (log_n - 3)):
        raise AssertionError(f"subtree route: shape {got.shape}")
    blobs = kk.to_bytes()
    for i in (0, k // 2, k - 1):
        if got[i].tobytes() != chacha_np.eval_full(blobs[i], log_n):
            raise AssertionError(f"subtree route: key {i} != spec at n={log_n}, K={k}")
    assert_one_bit_at_alphas(got ^ got_b, alphas)
    log(f"[fast subtree] n={log_n} K={k} at the default max_leaf_nodes: keys 0, "
        f"{k // 2}, {k - 1} == spec, both shares reconstruct at every alpha; launches "
        f"{n_launch} an evaluation, eval_full_batch wall {wall:.1f} / {wall_b:.1f} ms")
    del got, got_b, kk, kq

    # 34. The two kernels' registers, stack and SASS counts, and with
    #     --parent, both kernels and the fast device path at config 2 in
    #     turns with the parent checkout's build (parent, tree, tree,
    #     parent), each launched through the same ctypes calls.
    r = np.random.default_rng(21)
    kk, _ = fast.gen_batch(r.integers(0, 1 << LOG_N, size=K, dtype=np.uint64), LOG_N, r, device="cpu")
    dk = fast.DeviceKeysFast(kk, dev)
    entry, root = cc_cuda.entry_level(dk.nu), dk.root_state()
    tail_args = (mdc._prefix(cc_cuda.fused_levels, dk, entry), dk.scw[:, entry:],
                 dk.tcw[:, entry:], dk.fcw)
    builds = {"tree": (build.ptxas_report(), build.sass_report())}
    if parent is not None:
        plib, builds["parent"] = parent_expand_build(parent)
        fns = {"parent": raw_expand(plib), "tree": raw_expand(build.load("chacha_expand"))}
        if not (torch.equal(fns["parent"][1](*tail_args), fns["tree"][1](*tail_args))
                and torch.equal(mdc._prefix(fns["parent"][0], dk, entry, root),
                                mdc._prefix(fns["tree"][0], dk, entry, root))):
            raise AssertionError("the parent's fast kernels disagree with this tree's")
        turns = {
            "expand_tail_kernel (queued)": (kernel_ms, lambda f: f[1](*tail_args)),
            "fused_levels_kernel, the prefix pair (queued)": (
                kernel_ms, lambda f: mdc._prefix(f[0], dk, entry, root)),
            "eval_full_device's kernels, device work (queued)": (
                kernel_ms, lambda f: mdc._eval_full_kernel_device(f, dk, entry)),
            "eval_full_device's kernels, wall (CUDA events a call)": (
                cuda_ms, lambda f: mdc._eval_full_kernel_device(f, dk, entry)),
        }
        for what, (timer, call) in turns.items():
            got = {"parent": [], "tree": []}
            for who in ("parent", "tree", "tree", "parent"):
                got[who].append(timer(lambda: call(fns[who])))
            log(f"[fast turns] {card}: {what} at n={LOG_N} K={K}, ms in turns parent, tree, "
                f"tree, parent: parent {got['parent'][0]:.4f} / {got['parent'][1]:.4f}, tree "
                f"{got['tree'][0]:.4f} / {got['tree'][1]:.4f}")
    for who, (ptx, sass) in builds.items():
        for kern in STACKLESS_KERNELS:
            ops = sass[kern]
            log(f"[fast build] {who} {kern}: {ptx[kern]['registers']} registers, "
                f"{ptx[kern]['stack_bytes']} B stack, SASS static "
                f"{sum(ops.values())}: " + ", ".join(f"{op} {ops[op]}" for op in SASS_OPS))


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
    ka, kb = gen(alphas, log_n, rng, device="cpu")
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
        keys = fast.dcf_gen_lt_batch(alphas, n, rng, device="cpu")
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
        keys = fast.dcf_gen_interval_batch(lo, hi, n, rng, device="cpu")
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
            keys = fss.gen_lt_batch(alphas, n, rng, profile, device="cpu")
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
            keys = fss.gen_interval_batch(lo, hi, n, rng, profile, device="cpu")
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
         {"prg_bm_kernel": 2 * (n - 7), "leaf_words_bm_kernel": 2}),
        ("fast", fast.gen_batch, mdc.DeviceKeysFast, mdc.eval_full_device,
         {"fused_levels_kernel": 4, "expand_tail_kernel": 2}),
    ):
        rng = np.random.default_rng(27)
        alphas = rng.integers(0, 1 << n, size=GE_CHECK_K, dtype=np.uint64)
        alphas[0], alphas[1] = 0, (1 << n) - 1
        ka, kb = gen(alphas, n, rng, device="cpu")
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
        kk, _ = gen(rng.integers(0, 1 << n, size=GE_K, dtype=np.uint64), n, rng, device="cpu")
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


class PhaseTimer:
    """Host seconds spent in each named phase (the stream driver's
    ``timer``)."""

    def __init__(self):
        self.seconds: Counter = Counter()

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t0


def driver_events(n: int) -> list:
    """The stream driver's event order for n chunks: chunk j+1 dispatched
    before chunk j's copy is waited on."""
    ev = [("dispatch", 0)]
    for j in range(1, n):
        ev += [("dispatch", j), ("d2h_start", j - 1), ("d2h_done", j - 1)]
    return ev + [("d2h_start", n - 1), ("d2h_done", n - 1)]


def stream_phase(dev, card: str) -> None:
    """Phase 35: ``eval_full_stream`` of both profiles at config 2 (n=20,
    K=1024), launch counters zeroed just before and read just after: the
    blocks against ``eval_full_batch``'s bytes, both parties' reconstruction,
    the driver's event order; the times to the first and the last block
    beside the blocking ``eval_full_batch`` in the same run, the host's wait
    for the copies, the pinned D2H rate, and one traced stream."""
    import dpf_tpu_torch as P
    from dpf_tpu_torch import fast
    from dpf_tpu_torch.models import dpf as mdpf
    from dpf_tpu_torch.models import dpf_chacha as mdc

    profiles = {"compat": (P.gen_batch, mdpf, P.eval_full_batch, "prg_bm_kernel"),
                "fast": (fast.gen_batch, mdc, fast.eval_full_batch, "expand_tail_kernel")}
    rng = np.random.default_rng(35)
    alphas = rng.integers(0, 1 << LOG_N, size=K, dtype=np.uint64)
    for name, (gen, model, full_fn, kern) in profiles.items():
        ka, kb = gen(alphas, LOG_N, rng, device="cpu")
        full_a, full_b = full_fn(ka), full_fn(kb)
        ev = []
        blocks, _ = counted(f"{name} eval_full_stream n={LOG_N} K={K}",
                            lambda: list(model.eval_full_stream(ka, events=ev)),
                            STREAM_LAUNCHES[name])
        if ev != driver_events(len(blocks)):
            raise AssertionError(f"{name} stream: events {ev}")
        got_a = np.concatenate(blocks, axis=1)
        got_b = np.concatenate(list(model.eval_full_stream(kb)), axis=1)
        if not (np.array_equal(got_a, full_a) and np.array_equal(got_b, full_b)):
            raise AssertionError(f"{name} stream: blocks != eval_full_batch")
        assert_one_bit_at_alphas(got_a ^ got_b, alphas)
        log(f"[stream] {name}: {len(blocks)} blocks of {blocks[0].shape}, events in the "
            f"driver's order; the blocks == eval_full_batch for both parties, which "
            f"reconstruct to one bit at each of {K} alphas")

        firsts, lasts, timer = [], [], PhaseTimer()
        for rep in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            it = model.eval_full_stream(ka, timer=timer if rep else None)
            next(it)
            t1 = time.perf_counter()
            for _ in it:
                pass
            if rep:  # the first run warms the pinned buffers
                firsts.append((t1 - t0) * 1e3)
                lasts.append((time.perf_counter() - t0) * 1e3)
        blocking = host_ms(lambda: full_fn(ka), warmup=1, reps=5)
        nbytes = sum(b.nbytes for b in blocks)
        src = torch.empty(blocks[0].nbytes // 4, dtype=torch.int32, device=dev)
        pinned = torch.empty(src.shape, dtype=torch.int32, pin_memory=True)
        d2h_ms = cuda_ms(lambda: pinned.copy_(src, non_blocking=True))
        pageable_ms = host_ms(lambda: src.cpu(), warmup=1, reps=5)
        log(f"[stream time] {card}: {name} eval_full_stream n={LOG_N} K={K}: first block "
            f"{statistics.median(firsts):.3f} ms, last block {statistics.median(lasts):.3f} ms "
            f"(median of 5, host clock; {nbytes / 1e6:.1f} MB); blocking eval_full_batch "
            f"{blocking:.3f} ms; host waits per stream: dispatch "
            f"{timer.seconds['dispatch'] * 200:.3f} ms, d2h {timer.seconds['d2h'] * 200:.3f} "
            f"ms; D2H of one {src.numel() * 4 / 1e6:.1f} MB block: pinned "
            f"{src.numel() * 4 / d2h_ms / 1e6:.2f} GB/s ({d2h_ms:.3f} ms, CUDA events), "
            f"pageable .cpu() {src.numel() * 4 / pageable_ms / 1e6:.2f} GB/s")
        log_breakdown(card, f"{name} eval_full_stream", lambda: list(model.eval_full_stream(ka)),
                      kern)
        del blocks, full_a, full_b, got_a, got_b, src, pinned


def first_keys(kb, n: int):
    """The batch's first n keys, as a batch of its own type (any key family:
    its arrays in field order after log_n)."""
    fields = ("seeds", "ts", "scw", "tcw", "fcw", "vcw", "fvcw")
    return type(kb)(kb.log_n, *(getattr(kb, f)[:n] for f in fields if hasattr(kb, f)))


def pir_phase(dev, card: str, seed: int) -> None:
    """Phase 36: 2-server PIR at BASELINE config 4, full size, both profiles:
    2^24 rows x 32 B from ``--seed`` and 1024 random indices, one-shot
    (``db_chunk_bytes=0``: one slab) and the default streamed scan (2 slabs
    of 2^23 rows), both servers' answers with launch counters zeroed just
    before and read just after; the rows reconstructed, the streamed answer
    equal to the one-shot one, 4 queries against a numpy XOR of the rows
    that ``eval_full_batch`` selects.  Times, of the default scan:
    queries/s and DB-GB/s end to end (host clock, median of 3), the device
    work by CUDA events (expansion, parity scan, the scan's
    ``torch._int_mm`` calls alone) and the idle share of one traced
    answer."""
    import dpf_tpu_torch as P
    from dpf_tpu_torch import fast
    from dpf_tpu_torch.models import dpf as mdpf
    from dpf_tpu_torch.models import dpf_chacha as mdc
    from dpf_tpu_torch.models import pir

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    db = rng.integers(0, 256, size=(PIR_ROWS, PIR_ROW_BYTES), dtype=np.uint8)
    idx = rng.integers(0, PIR_ROWS, size=PIR_Q, dtype=np.uint64)
    db_bytes = PIR_ROWS * PIR_ROW_BYTES
    log(f"[pir] config 4: {PIR_ROWS} rows x {PIR_ROW_BYTES} B ({db_bytes / 2**20:.0f} MiB) "
        f"and {PIR_Q} indices from --seed {seed} in {time.perf_counter() - t0:.1f} s")
    profiles = {
        "compat": (lambda kb: mdpf._cached_device_keys(kb, dev), pir._expand_sel_planes,
                   P.eval_full_batch, "prg_bm_kernel"),
        "fast": (lambda kb: mdpf._cached_device_keys(kb, dev, mdc._padded_device_keys),
                 pir._fast_expand_sel, fast.eval_full_batch, "expand_tail_kernel"),
    }
    for profile, (keys, expand, full_fn, kern) in profiles.items():
        qa, qb = pir.pir_query(idx, PIR_ROWS, rng=rng, profile=profile, device="cpu")
        modes = {"one-shot": (0, 1), "streamed": (None, 2)}
        servers, answers = {}, {}
        for mode, (chunk_bytes, slabs) in modes.items():
            sa = pir.PirServer(db, profile=profile, db_chunk_bytes=chunk_bytes)
            sb = pir.PirServer(db, profile=profile, db_chunk_bytes=chunk_bytes)
            if (sa.stream_chunks, sa.dom, sa.chunk_rows) != (slabs, PIR_ROWS, 1 << 16):
                raise AssertionError(f"pir {profile} {mode}: {sa.stream_chunks} slabs, "
                                     f"domain {sa.dom}, chunk {sa.chunk_rows}")
            (a, b), _ = counted(f"pir {profile} {mode}: both servers' answers",
                                lambda: (sa.answer(qa), sb.answer(qb)),
                                {k: 2 * n for k, n in PIR_LAUNCHES[profile].items()})
            if a.shape != (PIR_Q, PIR_ROW_BYTES) or a.dtype != np.uint8:
                raise AssertionError(f"pir {profile} {mode}: answer {a.shape} {a.dtype}")
            if not np.array_equal(pir.pir_reconstruct(a, b), db[idx.astype(np.int64)]):
                raise AssertionError(f"pir {profile} {mode}: reconstruction != db[idx]")
            servers[mode], answers[mode] = sa, (a, b)
            log(f"[pir] {profile} {mode} ({sa.stream_chunks} slab(s) of {sa.stream_rows} "
                f"rows, {sa.chunk_rows}-row products): both servers' answers reconstruct "
                f"db[idx] for all {PIR_Q} queries")
            del sb
        if any(not np.array_equal(x, y) for x, y in zip(answers["one-shot"],
                                                         answers["streamed"])):
            raise AssertionError(f"pir {profile}: streamed answer != one-shot answer")
        bits = np.unpackbits(full_fn(first_keys(qa, 4)), axis=1, bitorder="little")
        words = db.view("<u8")
        for i in range(4):
            want = np.bitwise_xor.reduce(words[bits[i].astype(bool)], axis=0).view(np.uint8)
            if not np.array_equal(answers["one-shot"][0][i], want):
                raise AssertionError(f"pir {profile}: query {i} != XOR of the selected rows")
        log(f"[pir] {profile}: streamed answers == one-shot answers byte for byte; queries "
            f"0-3 of server A == numpy XOR of the rows eval_full_batch selects")

        # Where the time goes, in the default (streamed) mode: one answer
        # traced before the timing runs' many launches, then timed.  The
        # modes differ only in the scan's loop bounds.
        srv = servers["streamed"]
        wall_ms, span_ms, busy = device_breakdowns([functools.partial(srv.answer, qa)],
                                                   [kern])[0]
        dk = keys(qa)
        sel = expand(dk)
        exp_ms = cuda_ms(lambda: expand(dk), warmup=1, reps=5)
        # The scan's int8 products alone, on its operands (the unpacked bits
        # of one chunk, the database's column-major as pir._int_mm_bits
        # gives them), and with the database's bits row-major instead.
        n_mm = srv.dom // srv.chunk_rows
        sel8 = pir._unpack_bits_i8(sel[:, : srv.chunk_rows // 32])
        rows = max(pir._MM_MIN_ROWS, sel8.shape[0] + (-sel8.shape[0]) % 8)
        sel8 = torch.nn.functional.pad(sel8, (0, 0, 0, rows - sel8.shape[0]))
        db8 = pir._unpack_bits_i8_t(srv.db_words[: srv.chunk_rows])
        db8_rows = db8.t().contiguous()
        mm_ms = cuda_ms(lambda: [pir._int_mm_bits(sel8, db8) for _ in range(n_mm)],
                        warmup=1, reps=5)
        mm_rows_ms = cuda_ms(lambda: [torch._int_mm(sel8, db8_rows) for _ in range(n_mm)],
                             warmup=1, reps=3)
        mm_bound = 2 * rows * srv.dom * 8 * PIR_ROW_BYTES / INT8_OPS_PER_S * 1e3
        log(f"[pir time] {card}: {profile}: the scan's {n_mm} int8 products alone "
            f"[{rows} x {srv.chunk_rows}] x [{srv.chunk_rows} x {8 * PIR_ROW_BYTES}]: "
            f"{mm_ms:.3f} ms (CUDA events; int8 bound {mm_bound:.3f} ms); with the "
            f"database's bits row-major: {mm_rows_ms:.3f} ms")
        e2e = host_ms(functools.partial(srv.answer, qa), warmup=1, reps=3)
        scan_ms = cuda_ms(functools.partial(srv._stream_scan, sel), warmup=1, reps=5)
        total = sum(us for us, _ in busy.values()) / 1e3
        log(f"[pir time] {card}: {profile} streamed ({srv.stream_chunks} slabs): answer of "
            f"{PIR_Q} queries {e2e:.3f} ms end to end (host clock, median of 3): "
            f"{PIR_Q / e2e * 1e3:.1f} queries/s, {db_bytes / e2e / 1e6:.2f} DB-GB/s; "
            f"device (CUDA events): expansion {exp_ms:.3f} ms, parity scan "
            f"{scan_ms:.3f} ms, its products {100 * mm_ms / scan_ms:.1f} % of it; "
            f"traced answer: wall {wall_ms:.3f} ms, device span {span_ms:.3f} ms, busy "
            f"{total:.3f} ms in {kernel_launches(busy)} kernel launches, idle "
            f"{100 - 100 * total / span_ms:.1f} % of the span, "
            f"{100 - 100 * total / wall_ms:.1f} % of the wall")
        for kname, (us, count) in sorted(busy.items(), key=lambda kv: -kv[1][0])[:6]:
            log(f"[profile]   {us / 1e3:9.3f} ms {count:5d}x  {kname[:110]}")
        del servers, srv, sa, sel, sel8, db8, db8_rows
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The dealer, heavy hitters and aggregation on the card (phases 37-39)
# ---------------------------------------------------------------------------


def _gen_api(family: str):
    """(batched gen, host tower, root draw, pointwise check) of a key
    family; the check takes both parties' batches and xs uint64[K, Q] and
    returns the reconstructed bits on the card."""
    import dpf_tpu_torch as P
    from dpf_tpu_torch import fast
    from dpf_tpu_torch.core import keys, keys_chacha
    from dpf_tpu_torch.models import dcf

    if family == "compat":
        return (P.gen_batch, keys._gen_from_roots, keys._draw_roots,
                lambda a, b, xs: P.eval_points_batch(a, xs) ^ P.eval_points_batch(b, xs))
    if family == "fast":
        return (fast.gen_batch, keys_chacha._gen_from_roots, keys_chacha._draw_roots,
                lambda a, b, xs: fast.eval_points_batch(a, xs) ^ fast.eval_points_batch(b, xs))
    return (fast.dcf_gen_lt_batch, dcf._gen_lt_from_roots, keys_chacha._draw_roots,
            lambda a, b, xs: fast.dcf_eval_lt_points(a, xs) ^ fast.dcf_eval_lt_points(b, xs))


def gen_tower_operands(family: str, log_n: int, k: int, seed: int, dev) -> tuple:
    """The dealer kernel's operands for k keys drawn as the gen draws them."""
    from dpf_tpu_torch.core import chacha_np, keys_chacha
    from dpf_tpu_torch.models import keys_gen
    from dpf_tpu_torch.ops.aes_bitslice import to_carrier

    rng = np.random.default_rng(seed)
    alphas = rng.integers(0, 1 << log_n, size=k, dtype=np.uint64)
    s0, t0, s1, t1 = keys_chacha._draw_roots(k, rng)
    bits = keys_gen._alpha_bits(alphas, log_n, chacha_np.nu_of(log_n))
    ops = (s0, s1, t0.astype(np.uint32), t1.astype(np.uint32), np.ascontiguousarray(bits))
    return tuple(to_carrier(a, dev) for a in ops) + (family == "dcf",)


def dealer_phase(dev, card: str, sm_clocks_per_s: float) -> dict:
    """Phase 37: the dealer of all three families on the card, through the
    entry points (``gen_batch`` of both profiles, ``fast.dcf_gen_lt_batch``),
    at GEN_CASES, launch counters zeroed just before and read just after the
    dealing runs: every key byte-identical to the host tower on the same
    roots (a GEN_SLICE-key slice at K 65,536, where every key also
    reconstructs at its alpha through a pointwise walk on the card); one
    traced fast deal first; keys/s on the card and on the host; then
    ``gen_tower_cc_kernel`` against ``gen_tower_plain`` at every ChaCha case,
    its time beside its bound, and its registers and spills.  -> the
    kernels line's row."""
    from dpf_tpu_torch.core import chacha_np
    from dpf_tpu_torch.ops import build, chacha_cuda, op_count

    # Where the time goes: one traced deal of each profile at n=20, K
    # 65,536, before the heavy checks' many launches.
    alphas = np.random.default_rng(370).integers(0, 1 << 20, size=65536, dtype=np.uint64)
    for family, kern in (("fast", "gen_tower_cc_kernel"), ("compat", "prg_canon_kernel")):
        gen = _gen_api(family)[0]
        gen(alphas, 20, np.random.default_rng(0))  # warm the library
        log_breakdown(card, f"{family} gen_batch n=20 K=65536",
                      lambda: gen(alphas, 20, np.random.default_rng(0)), kern)

    launches_total = Counter()
    for family, log_n, k in GEN_CASES:
        gen, host, draw, check = _gen_api(family)
        seed = 3700 + log_n + k + len(family)
        alphas = np.random.default_rng(seed).integers(0, 1 << log_n, size=k, dtype=np.uint64)
        zero_launches()
        t0 = time.perf_counter()
        ka, kb = gen(alphas, log_n, np.random.default_rng(seed))
        dev_s = time.perf_counter() - t0
        launches = read_launches()
        launches_total.update(launches)
        nu = log_n - 7 if family == "compat" else chacha_np.nu_of(log_n)
        want = ({"prg_canon_kernel": nu + 1} if family == "compat"
                else {"gen_tower_cc_kernel": 1})
        if launches != {**{n: 0 for n in launches}, **want}:
            raise AssertionError(f"gen {family} n={log_n} K={k}: launches {launches}")
        # The host tower on the same roots: all of them, or a slice.
        n_host = min(k, GEN_SLICE)
        s0, t0_, s1, t1 = draw(k, np.random.default_rng(seed))
        t0 = time.perf_counter()
        ha, hb = host(alphas[:n_host], log_n, s0[:n_host], t0_[:n_host], s1[:n_host],
                      t1[:n_host])
        host_s = time.perf_counter() - t0
        for d, h in ((ka, ha), (kb, hb)):
            if first_keys(d, n_host).to_bytes() != h.to_bytes():
                raise AssertionError(f"gen {family} n={log_n} K={k}: keys != host tower")
        # Every key reconstructs at its alpha (the DCF: 1{x < alpha} at
        # alpha and below it).
        xs = np.stack([alphas, np.maximum(alphas, np.uint64(1)) - np.uint64(1)], axis=1)
        if family != "dcf":
            xs[:, 1] = alphas ^ np.uint64(1)
        want_bits = (xs < alphas[:, None]) if family == "dcf" else (xs == alphas[:, None])
        if not np.array_equal(check(ka, kb, xs), want_bits.astype(np.uint8)):
            raise AssertionError(f"gen {family} n={log_n} K={k}: keys do not reconstruct")
        # keys/s on the card, end to end (roots drawn, tower, keys on the host).
        dev_ms = host_ms(lambda: gen(alphas, log_n, np.random.default_rng(seed)), warmup=1,
                         reps=3)
        extra = ""
        if family == "compat":
            extra = (f"; compat tower: {launches['prg_canon_kernel']} prg_canon_kernel "
                     f"launches, host {dev_ms:.3f} ms a deal")
        log(f"[gen] {card}: {family} n={log_n} K={k}: {n_host} keys of both parties == the "
            f"host tower on the same roots, all {k} reconstruct at alpha; card "
            f"{k / dev_ms * 1e3:.1f} keys/s ({dev_ms:.3f} ms end to end, median of 3; first "
            f"call {dev_s * 1e3:.3f} ms), host tower {n_host / host_s:.1f} keys/s "
            f"({n_host} keys in {host_s * 1e3:.3f} ms){extra}")
    log(f"[gen] launches over the dealing runs: {dict(launches_total)}")

    # The kernel against its plain version at every ChaCha case, and times.
    err, row = 0, None
    for family, log_n, k in GEN_CASES:
        if family == "compat":
            continue
        args = gen_tower_operands(family, log_n, k, 3800 + log_n + k, dev)
        got, want = chacha_cuda.gen_tower(*args), chacha_cuda.gen_tower_plain(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"gen_tower_cc_kernel != plain ({family} n={log_n} K={k})")
            err = max(err, max_abs_err(g, w))
        nu = chacha_np.nu_of(log_n)
        k_ms = kernel_ms(lambda: chacha_cuda.gen_tower(*args))
        e_ms = cuda_ms(lambda: chacha_cuda.gen_tower(*args))
        p_ms = cuda_ms(lambda: chacha_cuda.gen_tower_plain(*args), warmup=1, reps=3)
        ops = op_count.gen_tower_ops(nu, family == "dcf")
        alu, total = (ops["LOP3"] + ops["SHF"]) * k, sum(ops.values()) * k
        ops_ms = max(alu / LOP3_PER_SM_CLOCK, total / ISSUE_PER_SM_CLOCK) / sm_clocks_per_s * 1e3
        nbytes = sum(4 * a.numel() for a in args[:5]) + sum(4 * g.numel() for g in got)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        log(f"[gen time] {card}: gen_tower_cc_kernel {family} n={log_n} K={k} (nu={nu}): "
            f"== plain; kernel {k_ms:.4f} ms (queued; {e_ms:.4f} ms one call at a time), "
            f"plain {p_ms:.3f} ms, bound {bound_ms:.4f} ms ({k} keys of {2 * nu} expansions + "
            f"2 leaf blocks = {dict(ops)} each: {alu:.4e} ALU-pipe at {LOP3_PER_SM_CLOCK}/clk/SM, "
            f"{total:.4e} in all at {ISSUE_PER_SM_CLOCK}/clk/SM -> {ops_ms:.4f} ms; "
            f"{nbytes:.4e} B -> {bytes_ms:.4f} ms)")
        if (family, log_n, k) == ("fast", 20, 65536):
            row = {"name": "gen_tower_cc_kernel", "route": "cuda", "source": GEN_SOURCE,
                   "replaces": "dpf_tpu/models/keys_gen.py:171 (_gen_cc_body, XLA; no Pallas "
                               "kernel)",
                   "ms": k_ms, "event_ms": e_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
                   "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                   "library_ms": None}
    row.update(launches=launches_total["gen_tower_cc_kernel"], max_abs_err=err)
    for kern, info in build.ptxas_report().items():
        if "gen_tower_cc_kernel" in kern:
            log(f"[build] {kern}: {info.get('registers')} registers, "
                f"{info.get('stack_bytes')} B stack, {info.get('spill_store_bytes')} B spill "
                f"stores, {info.get('spill_load_bytes')} B spill loads")
    return row


def hh_values(rng) -> np.ndarray:
    """bench_all.py's client values: uniform, then 4 x HH_PER planted."""
    vals = rng.integers(0, 1 << HH_N, size=HH_G, dtype=np.uint64)
    for i, hv in enumerate(HH_PLANTED):
        vals[i * HH_PER : (i + 1) * HH_PER] = hv
    return vals


def hh_phase(dev, card: str) -> dict[str, int]:
    """Phase 38: heavy hitters of both profiles at bench_all.py's full size,
    through ``gen_shares`` (262,144 keys dealt on the card) and
    ``find_heavy_hitters`` with ``state=True`` (the incremental descent) and
    ``state=False`` (stateless rounds), launch counters zeroed just before
    and read just after each: both recover exactly the planted values with
    exact counts and agree; the on-card count fold equals the host popcount
    on a round's rows and on 16384 x 512 random rows.  -> the launches of
    the descents."""
    from dpf_tpu_torch.apps import heavy_hitters as hh
    from dpf_tpu_torch.apps import hh_state
    from dpf_tpu_torch.models import hh_fold
    from dpf_tpu_torch.ops.aes_bitslice import to_carrier

    thr = HH_PER // 2
    descent_launches = Counter()
    for profile in ("fast", "compat"):
        rng = np.random.default_rng(24)
        vals = hh_values(rng)
        want = {int(v): int((vals == v).sum()) for v in HH_PLANTED}
        zero_launches()
        t0 = time.perf_counter()
        sa, sb = hh.gen_shares(vals, HH_N, profile, rng=rng)
        gen_s = time.perf_counter() - t0
        log(f"[hh] {card}: {profile} gen_shares {HH_G} clients x {HH_N} levels = "
            f"{HH_G * HH_N} keys a party on the card in {gen_s * 1e3:.3f} ms "
            f"({HH_G * HH_N / gen_s:.1f} keys/s), launches {read_launches()}")
        if profile == "fast":  # one traced incremental descent first
            log_breakdown(card, "fast find_heavy_hitters (incremental)",
                          lambda: hh.find_heavy_hitters(sa, sb, threshold=thr),
                          "fused_levels_kernel")
        results = {}
        for state in (True, False):
            hh.find_heavy_hitters(sa, sb, threshold=thr, state=state)  # warm
            hh_state.PRG_EVALS.reset()
            zero_launches()
            t0 = time.perf_counter()
            res = hh.find_heavy_hitters(sa, sb, threshold=thr, state=state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
            descent_launches.update(launches)
            mode = "incremental" if state else "stateless"
            got = {int(v): int(c) for v, c in zip(res.values, res.counts)}
            if got != want:
                raise AssertionError(f"hh {profile} {mode}: found {got}, planted {want}")
            for kern in HH_KERNELS[(profile, state)]:
                if not launches[kern]:
                    raise AssertionError(f"hh {profile} {mode}: no {kern} launch")
            prg = sum(r.prg_level_evals for r in res.rounds)
            results[state] = (got, prg, wall)
            rounds = "; ".join(
                f"depth {r.depth}: {r.n_candidates} candidates -> {r.n_survivors}, "
                f"{r.key_evals / r.eval_s / 1e6:.2f} M key-evals/s" for r in res.rounds)
            log(f"[hh] {card}: {profile} {mode}: the {len(got)} planted values with exact "
                f"counts {got}; descent {wall * 1e3:.3f} ms (host clock), {prg} PRG level "
                f"evaluations; rounds: {rounds}; launches "
                f"{ {k: n for k, n in launches.items() if n} }")
        if results[True][0] != results[False][0]:
            raise AssertionError(f"hh {profile}: incremental != stateless")
        log(f"[hh] {profile}: incremental == stateless; PRG level evaluations stateless / "
            f"incremental = {results[False][1]} / {results[True][1]} = "
            f"{results[False][1] / max(results[True][1], 1):.2f}x")
        # The count fold on a round's rows: the first round's candidates.
        cands = np.arange(16, dtype=np.uint64) << np.uint64(HH_N - 4)
        ra = hh.eval_level_shares(sa, 3, cands)
        rb = hh.eval_level_shares(sb, 3, cands)
        dev_counts = hh.reconstruct_counts(ra, rb, 16, fold="device")
        if not np.array_equal(dev_counts, hh.reconstruct_counts(ra, rb, 16, fold="host")):
            raise AssertionError(f"hh {profile}: the card's count fold != host popcount")
        del sa, sb
    # bench_all.py's fold rows: 16384 clients x 512 candidates.
    rows = np.random.default_rng(26).integers(0, 1 << 32, size=(HH_G, HH_Q_FOLD // 32),
                                              dtype=np.uint64).astype(np.uint32)
    zeros = np.zeros_like(rows)
    host_counts = hh.reconstruct_counts(rows, zeros, HH_Q_FOLD, fold="host")
    if not np.array_equal(hh.reconstruct_counts(rows, zeros, HH_Q_FOLD), host_counts):
        raise AssertionError("hh: the card's count fold != host popcount on random rows")
    x = to_carrier(rows, dev)
    fold_ms = cuda_ms(lambda: hh_fold.count_fold_torch(x))
    fold_e2e = host_ms(lambda: hh.reconstruct_counts(rows, zeros, HH_Q_FOLD))
    host_fold = host_ms(lambda: hh.reconstruct_counts(rows, zeros, HH_Q_FOLD, fold="host"),
                        warmup=0, reps=3)
    log(f"[hh time] {card}: count fold of {HH_G} clients x {HH_Q_FOLD} candidates == host "
        f"popcount; on the card {fold_ms:.3f} ms (CUDA events; {fold_e2e:.3f} ms end to end "
        f"with the XOR and the copies), host popcount {host_fold:.3f} ms")
    log(f"[hh] launches over the four descents: "
        f"{ {k: n for k, n in descent_launches.items() if n} }")
    return dict(descent_launches)


def agg_phase(dev, card: str) -> None:
    """Phase 39: secure aggregation on the card: ``aggregate_rows`` over
    2^20 client rows x 64 words (256 MB) in both folds against numpy, at
    the 4 MiB chunk default; ``aggregate_eval_full`` of a config-2 batch
    (n=20, K 1024) in both profiles against the folds of
    ``eval_full_batch``'s rows, both aggregators' XOR folds reconstructing
    the presence bitmap."""
    import dpf_tpu_torch as P
    from dpf_tpu_torch import fast
    from dpf_tpu_torch.apps import aggregation as agg

    rows = np.random.default_rng(39).integers(0, 1 << 32, size=(AGG_ROWS, AGG_WORDS),
                                              dtype=np.uint64).astype(np.uint32)
    step = agg.chunk_rows(AGG_WORDS)
    n_chunks = -(-AGG_ROWS // step)
    for op, ref in (("xor", np.bitwise_xor.reduce(rows, axis=0)),
                    ("add", rows.astype(np.uint64).sum(0).astype(np.uint32))):
        if not np.array_equal(agg.aggregate_rows(rows, op), ref):
            raise AssertionError(f"agg {op}: fold != numpy")
        ms = host_ms(lambda: agg.aggregate_rows(rows, op), warmup=0, reps=3)
        log(f"[agg] {card}: {op} fold of {AGG_ROWS} client rows x {AGG_WORDS} words == numpy; "
            f"{n_chunks} chunks of {step} rows; {ms:.3f} ms end to end (host clock, median "
            f"of 3): {AGG_ROWS / ms / 1e3:.2f} Mshares/s")
    del rows
    rng = np.random.default_rng(390)
    alphas = rng.integers(0, 1 << LOG_N, size=K, dtype=np.uint64)
    for profile, gen, full in (("compat", P.gen_batch, P.eval_full_batch),
                               ("fast", fast.gen_batch, fast.eval_full_batch)):
        ka, kb = gen(alphas, LOG_N, rng)
        if profile == "fast":  # traced before its checks
            agg.aggregate_eval_full(ka, "xor")
            log_breakdown(card, "fast aggregate_eval_full xor n=20 K=1024",
                          lambda: agg.aggregate_eval_full(ka, "xor"), "expand_tail_kernel")
        words = [full(k).view("<u4") for k in (ka, kb)]
        for op in agg.OPS:
            zero_launches()
            folds = [agg.aggregate_eval_full(k, op) for k in (ka, kb)]
            launches = {k: n for k, n in read_launches().items() if n}
            for f, w in zip(folds, words):
                ref = (np.bitwise_xor.reduce(w, axis=0) if op == "xor"
                       else w.astype(np.uint64).sum(0).astype(np.uint32))
                if not np.array_equal(f, ref):
                    raise AssertionError(f"agg {profile} {op}: eval_full fold != numpy")
            if op == "xor":
                bitmap = np.unpackbits(agg.reconstruct(*folds, op).view(np.uint8),
                                       bitorder="little")
                counts = np.bincount(alphas.astype(np.int64), minlength=1 << LOG_N)
                if not np.array_equal(bitmap, counts % 2):
                    raise AssertionError(f"agg {profile}: folds != the presence bitmap")
            ms = host_ms(lambda: agg.aggregate_eval_full(ka, op), warmup=0, reps=3)
            log(f"[agg] {card}: {profile} aggregate_eval_full {op} n={LOG_N} K={K} == the "
                f"{op} fold of eval_full_batch's rows{' and reconstructs the presence bitmap' if op == 'xor' else ''}; "
                f"{-(-K // agg.chunk_rows(1 << (LOG_N - 5)))} chunks a party, launches over both "
                f"parties {launches}; {ms:.3f} ms end to end: {K / ms / 1e3:.4f} Mshares/s")
        del words


# ---------------------------------------------------------------------------
# The dispatch plans on the card (phase 40)
# ---------------------------------------------------------------------------


def _plan_request(route: str, profile: str, log_n: int, k: int, q: int, seed: int):
    """Both parties' keys dealt on the card for ``k`` random alphas, the
    queries uint64[k, q] (query 0 at alpha, query 1 beside it; None for
    evalfull), and the direct eager model call -> (alphas, ka, kb, xs,
    direct)."""
    import dpf_tpu_torch as P
    from dpf_tpu_torch import fast
    from dpf_tpu_torch.models import dpf as mdpf
    from dpf_tpu_torch.models import dpf_chacha as mdc

    rng = np.random.default_rng(seed)
    alphas = rng.integers(1, 1 << log_n, size=k, dtype=np.uint64)
    gen = {("evalfull", "compat"): P.gen_batch, ("evalfull", "fast"): fast.gen_batch,
           ("points", "compat"): P.gen_batch, ("points", "fast"): fast.gen_batch,
           ("dcf_points", "fast"): fast.dcf_gen_lt_batch}[(route, profile)]
    ka, kb = gen(alphas, log_n, rng)
    xs = None
    if route != "evalfull":
        xs = rng.integers(0, 1 << log_n, size=(k, q), dtype=np.uint64)
        xs[:, 0], xs[:, 1] = alphas, alphas - np.uint64(1)
    direct = {
        ("evalfull", "compat"): P.eval_full_batch,
        ("evalfull", "fast"): fast.eval_full_batch,
        ("points", "compat"): lambda b: mdpf.eval_points(b, xs, packed=True),
        ("points", "fast"): lambda b: mdc.eval_points(b, xs, packed=True),
        ("dcf_points", "fast"): lambda b: fast.dcf_eval_lt_points(b, xs, packed=True),
    }[(route, profile)]
    return alphas, ka, kb, xs, direct


def _plan_call(route: str, profile: str, kb, xs):
    from dpf_tpu_torch.core import plans

    if route == "evalfull":
        return plans.run_evalfull(profile, kb)
    return plans.run_points(route, profile, kb, xs)


def _plan_body(route: str, profile: str, kb, xs, dev):
    """The eager device body of a bucket-sized request and its operands on
    the card: what the plan's graph captured."""
    from dpf_tpu_torch.core import plans
    from dpf_tpu_torch.models import dpf as mdpf

    if route == "evalfull":
        backend = mdpf._resolve_backend(None) if profile == "compat" else ""
        body, ops = plans._evalfull_body(profile, kb, dev, backend)
    else:
        body, ops = plans._points_body(route, profile, kb, xs, dev)
    return body, tuple(None if x is None else x.to(dev) for x in ops)


def _is_copy(name: str) -> bool:
    """A copy or memset event: the runtime's (``Memcpy DtoD ...``) or, in a
    graph, its copy nodes run as kernels (``memcpy32_post``)."""
    return name.lower().startswith(("memcpy", "memset"))


def _sleep_lead() -> None:
    """32 short sleep kernels: the lead of a traced session, whose first
    few device events a late trace may lose."""
    for _ in range(32):
        torch.cuda._sleep(10_000)


def _kernel_counts(busy: dict[str, tuple[float, int]]) -> Counter:
    return Counter({name: n for name, (_, n) in busy.items() if not _is_copy(name)})


def _copy_counts(busy: dict[str, tuple[float, int]]) -> int:
    return sum(n for name, (_, n) in busy.items() if _is_copy(name))


def _hand_kernels(counts: Counter, want: dict[str, int]) -> dict[str, int]:
    """The counts of ``want``'s kernels in a trace's kernel counts (the
    template kernels' names are mangled: matched by substring)."""
    return {k: sum(n for name, n in counts.items() if k in name) for k in want}


def plans_phase(dev, card: str) -> None:
    """Phase 40: the dispatch plans on the card.  ``warmup`` captures one
    CUDA graph a plan of ``PLAN_WARM``; every request of ``PLAN_REQUESTS``
    (both parties) is byte-identical to the direct eager model call on the
    same keys and reconstructs at alpha for ``PLAN_SAMPLE`` keys, and
    ``capture_count()`` does not move across them; one replay of each graph
    is traced beside its eager body in one session and shows the same
    kernels by name and count (``PLAN_KERNELS`` among them); the eager body
    and the replay are timed side by side; then the eager routes run once
    each against their direct model calls."""
    from dpf_tpu_torch.core import plans

    plans.cache().clear()
    t0 = time.perf_counter()
    warmed = plans.warmup(list(PLAN_WARM))
    warm_s = time.perf_counter() - t0
    graphs = plans.capture_count()
    if graphs != len(PLAN_WARM):
        raise AssertionError(f"plans: warmup captured {graphs} graphs, not {len(PLAN_WARM)}")
    by_route = {(p.key.route, p.key.profile): p for p in plans.cache()._plans.values()
                if p.graph is not None}
    for (route, profile), plan in sorted(by_route.items()):
        log(f"[plans] {card}: {route} {profile} {plans._key_str(plan.key)}: graph captured "
            f"in {plan.capture_s:.3f} s (first use {plan.compile_s:.3f} s), pool "
            f"{plan.pool_bytes} B, output {plan.static_out.numel() * 4} B")
    log(f"[plans] {card}: warmup of {len(warmed)} graph plans in {warm_s:.3f} s: "
        f"{[w['seconds'] for w in warmed]}")

    # Requests inside and on the buckets: byte-identical to the eager calls.
    seed = 4000
    bucket_reqs = {}
    for (route, profile), reqs in PLAN_REQUESTS.items():
        spec = next(s for s in PLAN_WARM if (s["route"], s["profile"]) == (route, profile))
        for k, q in reqs:
            seed += 1
            alphas, ka, kb, xs, direct = _plan_request(route, profile, spec["log_n"], k, q,
                                                       seed)
            got = [_plan_call(route, profile, b, xs) for b in (ka, kb)]
            for g, b in zip(got, (ka, kb)):
                if not np.array_equal(g, direct(b)):
                    raise AssertionError(f"plans: {route} {profile} K={k} Q={q} != eager")
            s = PLAN_SAMPLE
            if route == "evalfull":
                assert_one_bit_at_alphas(got[0][:s] ^ got[1][:s], alphas[:s])
            else:
                bits = np.unpackbits((got[0][:s] ^ got[1][:s]).view(np.uint8), axis=1,
                                     bitorder="little")[:, :q]
                want = (xs[:s] < alphas[:s, None]) if route == "dcf_points" else (
                    xs[:s] == alphas[:s, None])
                if not np.array_equal(bits, want.astype(np.uint8)):
                    raise AssertionError(f"plans: {route} {profile} K={k} Q={q}: shares "
                                         "do not reconstruct")
            log(f"[plans] {route} {profile} K={k} Q={q}: both parties == the eager call, "
                f"{s} keys reconstruct at alpha")
            if k == spec["k"]:
                bucket_reqs[(route, profile)] = (ka, xs, direct)
    if plans.capture_count() != graphs:
        raise AssertionError(f"plans: capture_count moved {graphs} -> {plans.capture_count()}")
    stats = plans.cache().stats()
    log(f"[plans] capture_count() {graphs} after warmup and after every request; "
        f"{stats['hits']} hits, {stats['misses']} misses, {stats['replays']} replays, "
        f"pools {stats['pool_bytes']} B in all")

    # One replay of each graph traced beside its eager body, in one session
    # that first runs 32 short sleep kernels, not read: traces taken this
    # late lost the first few device events of a session in chip runs
    # (eager or replayed alike), and a kernel of its own keeps the lead's
    # cluster from passing for a pair's.  A pair whose kernels differ is
    # traced again, at most eight times.
    order = sorted(by_route)
    bodies = {rp: _plan_body(*rp, plans._pad_keys(bucket_reqs[rp][0], 0),
                             bucket_reqs[rp][1], dev) for rp in order}
    for rp in order:
        body, ops = bodies[rp]
        want = PLAN_KERNELS[rp]
        expect = next(iter(want))
        for attempt in range(1, 9):
            try:
                (e_wall, e_span, e_busy), (r_wall, r_span, r_busy) = device_breakdowns(
                    [_sleep_lead, functools.partial(body, *ops),
                     by_route[rp].graph.replay], ["sleep", expect, expect],
                    attempts=1, lead=1)
            except AssertionError as e:  # the session lost a run's kernels
                log(f"[plans trace] attempt {attempt} of 8: {rp}: {e}")
                continue
            eager, replay = _kernel_counts(e_busy), _kernel_counts(r_busy)
            hand = _hand_kernels(replay, want)
            if hand == want == _hand_kernels(eager, want) and replay == eager:
                break
            log(f"[plans trace] attempt {attempt} of 8: {rp} replay kernels "
                f"{sum(replay.values())} ({hand}) != eager {sum(eager.values())} "
                f"({_hand_kernels(eager, want)})")
        else:
            raise AssertionError(f"plans: {rp}: no trace in 8 held the eager body's kernels "
                                 f"and the replay's, equal, with {want}")
        idle = []
        for wall, busy in ((e_wall, e_busy), (r_wall, r_busy)):
            idle.append(100 - 100 * sum(us for us, _ in busy.values()) / 1e3 / wall)
        log(f"[plans trace] {card}: {rp[0]} {rp[1]}: the replay launches the eager body's "
            f"{sum(replay.values())} kernels by name and count ({hand}); copies and "
            f"memsets {_copy_counts(e_busy)} / {_copy_counts(r_busy)}; traced wall "
            f"{e_wall:.3f} / {r_wall:.3f} ms, device span {e_span:.3f} / {r_span:.3f} ms, "
            f"idle {idle[0]:.1f} / {idle[1]:.1f} % of the wall (eager / replay)")

    # The eager body and the replay side by side.
    for rp in order:
        body, ops = bodies[rp]
        plan = by_route[rp]
        run_eager = functools.partial(body, *ops)

        def synced(fn):
            return lambda: (fn(), torch.cuda.synchronize())

        enq = (enqueue_ms(run_eager), enqueue_ms(plan.graph.replay))
        # One run queued behind a sleep kernel: the card never waits on the
        # host's launches, so the events hold the device work alone.
        work = (kernel_ms(run_eager, reps=1), kernel_ms(plan.graph.replay, reps=1))
        wall = (host_ms(synced(run_eager)), host_ms(synced(plan.graph.replay)))
        ka, xs, direct = bucket_reqs[rp]
        e2e = (host_ms(lambda: direct(ka), warmup=1, reps=5),
               host_ms(lambda: _plan_call(*rp, ka, xs), warmup=1, reps=5))
        log(f"[plans time] {card}: {rp[0]} {rp[1]} (plan {plans._key_str(plan.key)}): "
            f"eager body / replay: host enqueue {enq[0]:.4f} / {enq[1]:.4f} ms, device work "
            f"{work[0]:.4f} / {work[1]:.4f} ms (CUDA events, queued behind a sleep), wall "
            f"{wall[0]:.4f} / {wall[1]:.4f} ms (synchronized, median of 10), the card idle "
            f"{100 - 100 * work[0] / wall[0]:.1f} / {100 - 100 * work[1] / wall[1]:.1f} % of "
            f"the wall; pool {plan.pool_bytes} B, capture {plan.capture_s:.3f} s; end to end "
            f"(direct call / run_*, median of 5) {e2e[0]:.3f} / {e2e[1]:.3f} ms")
    del bodies, bucket_reqs
    eager_routes_phase(dev, card)
    plans.cache().clear()


def eager_routes_phase(dev, card: str, k: int = 1000, pir_rows: int = 1 << 20) -> None:
    """Phase 40's eager routes on the card, each once against its direct
    model call: ``gen`` of the three families (n=20, ``k`` keys: 1000 is
    padded to the 1024 bucket), ``pir`` on a registered database (both
    profiles, ``pir_rows`` x 32 B, 100 queries), ``hh_level``, ``hh_extend``
    (n=16, ``k`` clients), ``hh_fold``, ``dcf_interval`` (n=32, ``k``
    gates) and ``agg_xor`` and ``agg_add`` (``k`` x 16 words)."""
    import dpf_tpu_torch as P
    from dpf_tpu_torch import fast
    from dpf_tpu_torch.apps import aggregation as agg
    from dpf_tpu_torch.apps import hh_state, pir_store
    from dpf_tpu_torch.core import keys, keys_chacha, plans
    from dpf_tpu_torch.models import dcf, hh_fold, keys_gen, pir
    from dpf_tpu_torch.models import dpf as mdpf
    from dpf_tpu_torch.models import dpf_chacha as mdc
    from dpf_tpu_torch.ops.aes_bitslice import from_carrier, to_carrier

    rng = np.random.default_rng(41)
    alphas = rng.integers(0, 1 << 20, size=k, dtype=np.uint64)
    for kind, draw in (("compat", keys._draw_roots), ("fast", keys_chacha._draw_roots),
                       ("dcf", keys_chacha._draw_roots)):
        roots = draw(k, np.random.default_rng(42))
        got = plans.run_gen(kind, alphas, 20, *roots)
        want = (keys_gen.gen_device_compat(alphas, 20, *roots) if kind == "compat"
                else keys_gen.gen_device_cc(kind, alphas, 20, *roots))
        if [k.to_bytes() for k in got] != [k.to_bytes() for k in want]:
            raise AssertionError(f"plans: run_gen {kind} != gen_device")
    log(f"[plans eager] gen of compat, fast and dcf at n=20, K={k} (bucket "
        f"{plans.k_bucket(k)}) == the unpadded card tower")

    pir_store.reset()
    db = rng.integers(0, 256, size=(pir_rows, 32), dtype=np.uint8)
    idx = np.linspace(0, pir_rows - 1, 100).astype(np.uint64)
    for profile in ("compat", "fast"):
        entry = pir_store.registry().load(f"db-{profile}", db, profile)
        plans.warmup([{"route": "pir", "db": entry.name, "k": 100}])
        qa, qb = pir.pir_query(idx, pir_rows, rng, profile)
        srv = pir.PirServer(db, profile=profile)
        got = [plans.run_pir(entry, q) for q in (qa, qb)]
        for g, q in zip(got, (qa, qb)):
            if not np.array_equal(g, srv.answer(q)):
                raise AssertionError(f"plans: run_pir {profile} != PirServer.answer")
        if not np.array_equal(pir.pir_reconstruct(*got), db[idx.astype(np.int64)]):
            raise AssertionError(f"plans: run_pir {profile} does not reconstruct")
        log(f"[plans eager] pir {profile} on a registered {pir_rows} x 32 B database, 100 "
            f"queries (bucket 128) == PirServer.answer; "
            f"{pir_store.registry().stats()['scans']} scans")
        del srv
    pir_store.reset()

    for profile, gen, model in (("compat", P.gen_batch, mdpf), ("fast", fast.gen_batch, mdc)):
        ka, _ = gen(rng.integers(0, 1 << 16, size=k, dtype=np.uint64), 16, rng)
        xs = rng.integers(0, 1 << 16, size=(k, 40), dtype=np.uint64)
        if not np.array_equal(plans.run_hh_level(profile, ka, xs, 5),
                              model.eval_points_level_grouped(ka, xs, 1, packed=True,
                                                              levels=(5,))):
            raise AssertionError(f"plans: run_hh_level {profile} != the grouped walk")
        st = hh_state.FrontierState(profile, ka)
        sel = torch.zeros(16, dtype=torch.int64, device=dev)
        dk = st._dk
        level = ((dk.scw[:, :1], dk.tcw[:, :1]) if profile == "fast"
                 else (dk.scw_planes[0], dk.tl_words[0], dk.tr_words[0]))
        new, rows = plans.run_hh_extend(profile, 16, st.kp, "tree", st.seed_state,
                                        (sel, *level), q=32)
        body = model._hh_extend_cc_body if profile == "fast" else model._hh_extend_body
        want = body(*st.seed_state, sel, *level)
        if not (np.array_equal(rows, from_carrier(want[-1]))
                and all(torch.equal(a, b) for a, b in zip(new, want[:-1]))):
            raise AssertionError(f"plans: run_hh_extend {profile} != the extension body")
        log(f"[plans eager] hh_level and hh_extend {profile} (n=16, {k} clients) == the "
            "direct model calls")
    rows = rng.integers(0, 1 << 32, size=(k, 16), dtype=np.uint64).astype(np.uint32)
    if not np.array_equal(plans.run_hh_fold(rows, 500), hh_fold.count_fold(rows)[:500]):
        raise AssertionError("plans: run_hh_fold != count_fold")
    lo = rng.integers(0, 1 << 31, size=k, dtype=np.uint64)
    ia, _ = dcf.gen_interval_batch(lo, lo + np.uint64(12345), 32, rng)
    xs = rng.integers(0, 1 << 32, size=(k, 100), dtype=np.uint64)
    if not np.array_equal(plans.run_interval(ia, xs),
                          dcf.eval_interval_points(ia, xs, packed=True)):
        raise AssertionError("plans: run_interval != eval_interval_points")
    carry = rows[0]
    for op in agg.OPS:
        want = from_carrier(agg._fold_body(op, to_carrier(carry, dev), to_carrier(rows, dev)))
        if not (np.array_equal(plans.run_agg_fold(op, carry, rows), want)
                and np.array_equal(plans.run_agg_fold(op, carry, to_carrier(rows, dev)), want)):
            raise AssertionError(f"plans: run_agg_fold {op} != the fold body")
    log(f"[plans eager] hh_fold ({k} x 16 words), dcf_interval (n=32, {k} gates x 100), "
        f"agg_xor and agg_add ({k} x 16 words, host rows and card rows) == the direct calls; "
        f"{plans.capture_count()} graphs held")


# ---------------------------------------------------------------------------
# The sidecar on the card (phase 41)
# ---------------------------------------------------------------------------

# Phase 41's shapes: BASELINE configs 2-5 at full width (``full``), and a tiny
# set that drives the same code on the CPU (``dry``: the CPU test
# tests/port/test_torch_server.py runs it).  The sidecar runs with the plans'
# K floor pinned to ``kfloor``, so a coalesced batch of 8..256 keys lands on
# one warmed bucket, and every bucket its traffic reaches is warmed first.
SIDECAR_SHAPES = {
    "full": dict(n2=20, k2=1024, n3=30, k3=256, q3=4096, n5=32, k5=4096, q5=1024, ki5=2048,
                 hh_g=16384, hh_n=16, hh_level=11, agg_rows=1 << 20, agg_words=64,
                 pir_rows=1 << 24, pir_row_bytes=32, pir_k=1024, kfloor=256,
                 burst_threads=32, burst_keys3=8, burst_keys5=128, gate_k=2048,
                 lat_clients=16, lat_n1=200, lat_n16=112, lat_n1_big=10, lat_n16_big=16,
                 lat_cap_s=10.0, direct_reps=20, cooldown_ms=1000, pause_s=0.3),
    "dry": dict(n2=9, k2=4, n3=10, k3=8, q3=32, n5=10, k5=16, q5=32, ki5=8,
                hh_g=24, hh_n=7, hh_level=4, agg_rows=100, agg_words=3,
                pir_rows=300, pir_row_bytes=8, pir_k=6, kfloor=8,
                burst_threads=4, burst_keys3=2, burst_keys5=4, gate_k=32,
                lat_clients=2, lat_n1=1, lat_n16=2, lat_n1_big=1, lat_n16_big=2,
                lat_cap_s=5.0, direct_reps=1, cooldown_ms=200, pause_s=0.05),
}
# The kernels a traced served request of each route must show (the table
# of PERF.md section 6; graph replays and eager routes alike).
SIDECAR_ROUTE_KERNELS = {
    "evalfull compat": ("prg_bm_kernel", "leaf_words_bm_kernel"),
    "evalfull fast": ("fused_levels_kernel", "expand_tail_kernel"),
    "points compat": ("walk_bm_kernel",),
    "points fast": ("walk_kernel",),
    "dcf_points": ("walk_dcf_kernel",),
    "dcf_interval": ("walk_dcf_kernel",),
    "gen compat": ("prg_canon_kernel",),
    "gen fast": ("gen_tower_cc_kernel",),
    "dcf_gen": ("gen_tower_cc_kernel",),
    "eval compat": ("walk_bm_kernel",),
    "eval fast": ("walk_kernel",),
    "hh_eval compat": ("walk_bm_kernel",),
    "hh_eval fast": ("walk_kernel",),
    "hh_session compat": ("prg_canon_kernel",),
    "hh_session fast": ("fused_levels_kernel",),
    "pir compat": ("prg_bm_kernel", "leaf_words_bm_kernel"),
    "pir fast": ("fused_levels_kernel", "expand_tail_kernel"),
}
SIDECAR_ENV = {"DPF_CUDA_RETRY_BACKOFF_MS": "5", "DPF_CUDA_FAULTS_ALLOW": "1"}
SIDECAR_HH_THRESHOLD = 160
SIDECAR_TRACE_SPANS = ("admission", "queue_wait", "coalesce", "dispatch", "plan_lookup",
                       "compute", "d2h", "reply")


class _Http:
    """One keep-alive HTTP/1.1 connection to the sidecar."""

    def __init__(self, port: int):
        import http.client

        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)

    def post(self, path: str, body=b"", headers=None) -> tuple[int, bytes, dict]:
        self.conn.request("POST", path, body=body, headers=headers or {})
        r = self.conn.getresponse()
        data = r.read()
        return r.status, data, dict(r.getheaders())

    def get(self, path: str) -> tuple[int, bytes]:
        self.conn.request("GET", path)
        r = self.conn.getresponse()
        return r.status, r.read()

    def ok(self, path: str, body=b"", headers=None) -> bytes:
        status, data, _ = self.post(path, body, headers)
        if status != 200:
            raise AssertionError(f"sidecar {path}: {status} {data[:200]!r}")
        return data

    def close(self) -> None:
        self.conn.close()


def _qs(**params) -> str:
    return "&".join(f"{k}={v}" for k, v in params.items())


def _u8(x: np.ndarray) -> bytes:
    return np.ascontiguousarray(x).astype("<u8").tobytes()


def _same(what: str, got: bytes, want) -> None:
    want = want if isinstance(want, bytes) else np.ascontiguousarray(want).tobytes()
    if got != want:
        raise AssertionError(f"sidecar {what}: reply != direct call ({len(got)} / {len(want)} B)")


def _rec_bits(a: bytes, b: bytes, k: int, q: int) -> np.ndarray:
    """Both parties' bits-format replies -> the reconstructed uint8[k, q]."""
    return (np.frombuffer(a, np.uint8) ^ np.frombuffer(b, np.uint8)).reshape(k, q)


def _rec_packed(a: bytes, b: bytes, k: int, q: int) -> np.ndarray:
    """Both parties' packed replies -> the reconstructed uint8[k, q] bits."""
    x = (np.frombuffer(a, np.uint8) ^ np.frombuffer(b, np.uint8)).reshape(k, -1)
    return np.unpackbits(x, axis=1, bitorder="little")[:, :q]


def _closed_loop(port: int, clients: int, n: int, cap_s: float, path: str,
                 body: bytes) -> list[float]:
    """``clients`` threads, each sending requests back to back on its own
    connection until ``n`` have been sent in all, or ``cap_s`` seconds have
    passed and each client has sent one -> every request's latency in ms."""
    import threading

    lats, errors = [], []
    lock = threading.Lock()
    sent = [0]
    t_end = time.perf_counter() + cap_s

    def run():
        c = _Http(port)
        mine = 0
        try:
            while True:
                with lock:
                    if sent[0] >= n or (mine and time.perf_counter() > t_end):
                        break
                    sent[0] += 1
                mine += 1
                t0 = time.perf_counter()
                c.ok(path, body)
                dt = (time.perf_counter() - t0) * 1e3
                with lock:
                    lats.append(dt)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)
        finally:
            c.close()

    threads = [threading.Thread(target=run) for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise AssertionError(f"closed loop on {path}: {errors[0]!r}")
    return lats


def _pct(lats: list[float], p: float) -> float:
    s = sorted(lats)
    return s[min(len(s) - 1, int(round(p / 100 * (len(s) - 1))))]


# Fewer samples than this give no 99th percentile: their tail is reported
# as the largest of the n.
TAIL_MIN_N = 100


def _tail(lats: list[float]) -> str:
    if len(lats) >= TAIL_MIN_N:
        return f"p99 {_pct(lats, 99):.3f} ms"
    return f"max {max(lats):.3f} ms (too few for a p99)"


# The handler's phase timers of /v1/stats that do not overlap on one
# request: a route runs ``dispatch`` (the evalfull routes, their streamed
# blocks) or ``queue_wait`` + ``compute`` (the batched routes).
SIDECAR_PHASES = ("pack", "dispatch", "d2h", "queue_wait", "compute", "reply")


def _phase_split(before: dict, after: dict, n: int, lat_ms: float) -> str:
    """Each phase's mean ms a request between two /v1/stats snapshots, and
    what the handler's timers do not cover (the HTTP front's parsing and
    body read, the client's send and receive)."""
    got = {p: (after.get(p, {}).get("seconds", 0.0) - before.get(p, {}).get("seconds", 0.0))
           * 1e3 / n for p in SIDECAR_PHASES}
    got = {p: v for p, v in got.items() if v > 0}
    parts = ", ".join(f"{p} {v:.3f}" for p, v in got.items())
    return f"{parts}, outside the handler's timers {lat_ms - sum(got.values()):.3f} ms"


def sidecar_phase(dev, card: str, seed: int, size: str = "full") -> None:
    """Phase 41: the sidecar on the card, through its HTTP front
    (``dpf_tpu_torch.server.serve(port=0)``), at BASELINE configs 2-5.

    Cold ``/readyz`` is 503 ``cold``; ``/v1/warmup`` captures the graph
    plans of every bucket the phase's traffic reaches, then ``/readyz`` is
    200.  Every route of ``docs/CONTRACT.json`` (and ``/v1/evalfull?stream=1``)
    runs once at full width, its reply byte-identical to the port's direct
    call on the same key bytes and both parties' replies reconstructing;
    ``capture_count()`` does not move from the warmup through a coalescing
    burst of 8-key pointwise requests (config 3) and of 128-gate DCF
    requests (config 5), whose replies each equal their direct calls.  A
    request in a new bucket captures while 8 threads replay and run eager
    routes, with no failed request.  A traced served request of each route
    shows its kernels.  A transient dispatch fault trips the breaker, whose
    probe replays the recent graphs, and it recovers.  ``/v1/metrics``
    parses strictly, its counters equal ``/v1/stats``, and it names the 44
    metrics of the contract; a trace's span tree runs from admission to the
    reply.  Then the served latencies, the sidecar's cost over the direct
    call, keys per dispatch and the card's idle share in a burst."""
    import os
    import threading

    import dpf_tpu_torch as P
    from dpf_tpu_torch import fast, server
    from dpf_tpu_torch.apps import hh_state, pir_store
    from dpf_tpu_torch.core import bitpack, plans, spec
    from dpf_tpu_torch.core import chacha_np as cc
    from dpf_tpu_torch.core.keys import KeyBatch
    from dpf_tpu_torch.core.keys_chacha import KeyBatchFast
    from dpf_tpu_torch.models import dcf
    from dpf_tpu_torch.models import dpf as mdpf
    from dpf_tpu_torch.models import dpf_chacha as mdc
    from dpf_tpu_torch.obs import promtext
    from dpf_tpu_torch.serving import faults, handlers

    S = SIDECAR_SHAPES[size]
    t_lap = [time.perf_counter()]

    def step_log(msg: str) -> None:
        """``log`` with the seconds since the previous step's line."""
        now = time.perf_counter()
        log(f"{msg} [{now - t_lap[0]:.1f} s]")
        t_lap[0] = now

    on_card = dev.type == "cuda"
    dname = dev.type
    t_phase = time.perf_counter()
    env = {**SIDECAR_ENV, "DPF_CUDA_PLAN_KFLOOR": str(S["kfloor"]),
           "DPF_CUDA_BREAKER_COOLDOWN_MS": str(S["cooldown_ms"])}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    plans.cache().clear()
    pir_store.reset()
    handlers.reset_serving_state()
    srv = server.serve(port=0, device=None if on_card else "cpu")
    port = srv.server_address[1]
    c = _Http(port)
    rng = np.random.default_rng(seed + 41)
    profiles = {"compat": (P.gen_batch, KeyBatch, spec.key_len, P.eval_full_batch,
                           lambda kb, xs: mdpf.eval_points(kb, xs, packed=True, device=dev)),
                "fast": (fast.gen_batch, KeyBatchFast, cc.key_len, fast.eval_full_batch,
                         lambda kb, xs: mdc.eval_points(kb, xs, packed=True, device=dev))}

    def deal(profile, alphas, log_n):
        return profiles[profile][0](alphas, log_n, rng, device=dev)

    try:
        # 1. Start: not ready before the warmup.
        status, body = c.get("/readyz")
        if status != 503 or json.loads(body)["code"] != "cold":
            raise AssertionError(f"cold /readyz: {status} {body!r}")
        step_log(f"[sidecar] serving on 127.0.0.1:{port} ({dname}); cold /readyz: 503 cold")

        # 2. The warmup of every bucket the traffic below reaches.
        kf = S["kfloor"]
        warm = []
        for prof in ("compat", "fast"):
            warm += [{"route": "evalfull", "profile": prof, "log_n": S["n2"], "k": k}
                     for k in sorted({kf, S["k2"]})]
        # Config 3: compat up to the batcher's 1024-key cap (16 clients' 256-key
        # requests coalesce), fast at the bucket its 64-key replays share.
        k = kf
        while k <= max(S["k3"], 1024 if size == "full" else 4 * S["k3"]):
            warm.append({"route": "points", "profile": "compat", "log_n": S["n3"], "k": k,
                         "q": S["q3"]})
            k *= 2
        warm.append({"route": "points", "profile": "fast", "log_n": S["n3"], "k": S["k3"],
                     "q": S["q3"]})
        k = kf
        while k <= S["k5"]:
            warm.append({"route": "dcf_points", "profile": "fast", "log_n": S["n5"], "k": k,
                         "q": S["q5"]})
            k *= 2
        t0 = time.perf_counter()
        rep = json.loads(c.ok("/v1/warmup", json.dumps({"shapes": warm}).encode()))
        warm_s = time.perf_counter() - t0
        status, body = c.get("/readyz")
        if status != 200 or body != b"ready":
            raise AssertionError(f"/readyz after the warmup: {status} {body!r}")
        captured = plans.capture_count()
        want_graphs = len(warm) if on_card else 0
        if rep["trace_cache_entries"] != captured or captured != want_graphs:
            raise AssertionError(f"warmup: {captured} graphs, reply {rep['trace_cache_entries']}, "
                                 f"expected {want_graphs}")
        step_log(f"[sidecar] warmup of {len(warm)} shapes in {warm_s:.1f} s: capture_count() "
            f"{captured}; /readyz 200 ready")

        # 3. Every route once, at full width.
        zero_launches()
        route_s = {}

        def timed(name, fn):
            t0 = time.perf_counter()
            out = fn()
            route_s[name] = time.perf_counter() - t0
            return out

        keys2, body3 = {}, {}
        for prof in ("compat", "fast"):
            gen, cls, klen, eval_full, eval_points = profiles[prof]
            n2, k2 = S["n2"], S["k2"]
            alphas = rng.integers(0, 1 << n2, size=k2, dtype=np.uint64)
            ka, kb = deal(prof, alphas, n2)
            keys2[prof] = (alphas, ka, kb)
            blob_a, blob_b = b"".join(ka.to_bytes()), b"".join(kb.to_bytes())
            qs = _qs(log_n=n2, k=k2, profile=prof)
            ra = timed(f"evalfull_batch {prof}", lambda: c.ok(f"/v1/evalfull_batch?{qs}", blob_a))
            rb = c.ok(f"/v1/evalfull_batch?{qs}", blob_b)
            out_a = eval_full(ka, device=dev)
            _same(f"evalfull_batch {prof}", ra, out_a)
            _same(f"evalfull_batch {prof} (b)", rb, eval_full(kb, device=dev))
            rows = out_a.shape[1]
            assert_one_bit_at_alphas(np.frombuffer(ra, np.uint8).reshape(k2, rows)
                                     ^ np.frombuffer(rb, np.uint8).reshape(k2, rows), alphas)
            one_a, one_b = ka.to_bytes()[0], kb.to_bytes()[0]
            for stream in ("0", "1"):
                qs1 = _qs(log_n=n2, profile=prof, stream=stream)
                ra1 = timed(f"evalfull {prof} stream={stream}",
                            lambda: c.ok(f"/v1/evalfull?{qs1}", one_a))
                rb1 = c.ok(f"/v1/evalfull?{qs1}", one_b)
                _same(f"evalfull {prof} stream={stream}", ra1, out_a[0])
                assert_one_bit_at_alphas((np.frombuffer(ra1, np.uint8)
                                          ^ np.frombuffer(rb1, np.uint8))[None], alphas[:1])
            x = int(alphas[0])
            bit = c.ok(f"/v1/eval?{_qs(log_n=n2, x=x, profile=prof)}", one_a)
            bit_b = c.ok(f"/v1/eval?{_qs(log_n=n2, x=x, profile=prof)}", one_b)
            # The served point runs the walk on the card; the host spec holds it.
            api = P if prof == "compat" else fast
            if bit != bytes([api.Eval(one_a, x, n2, backend="cpu")]) or bit[0] ^ bit_b[0] != 1:
                raise AssertionError(f"/v1/eval {prof}: {bit!r} {bit_b!r}")
            g = c.ok(f"/v1/gen?{_qs(log_n=n2, alpha=x, profile=prof)}")
            gk = cls.from_bytes([g[: klen(n2)], g[klen(n2):]], n2)
            go = eval_full(gk, device=dev)
            assert_one_bit_at_alphas((go[0] ^ go[1])[None], alphas[:1])
            # Config 3.
            n3, k3, q3 = S["n3"], S["k3"], S["q3"]
            al3 = rng.integers(1, 1 << n3, size=k3, dtype=np.uint64)
            pa, pb = deal(prof, al3, n3)
            xs = rng.integers(0, 1 << n3, size=(k3, q3), dtype=np.uint64)
            xs[:, 0], xs[:, 1] = al3, al3 - np.uint64(1)
            words = eval_points(pa, xs)
            body3[prof] = (b"".join(pa.to_bytes()) + _u8(xs), b"".join(pb.to_bytes()) + _u8(xs))
            for fmt in ("packed", "bits"):
                qs3 = _qs(log_n=n3, k=k3, q=q3, profile=prof, format=fmt)
                r3a = timed(f"points {prof} {fmt}", lambda: c.ok(
                    f"/v1/eval_points_batch?{qs3}", body3[prof][0]))
                r3b = c.ok(f"/v1/eval_points_batch?{qs3}", body3[prof][1])
                want = (bitpack.words_to_wire_rows(words, q3) if fmt == "packed"
                        else bitpack.unpack_bits(words, q3))
                _same(f"points {prof} {fmt}", r3a, want)
                rec = (_rec_packed if fmt == "packed" else _rec_bits)(r3a, r3b, k3, q3)
                if not (rec[:, 0].all() and not rec[:, 1].any()
                        and rec.sum() == (xs == al3[:, None]).sum()):
                    raise AssertionError(f"points {prof} {fmt}: reconstruction")
        step_log(f"[sidecar] evalfull_batch (n={S['n2']}, K={S['k2']}), evalfull (stream 0 and 1), "
            f"eval, gen, eval_points_batch (n={S['n3']}, {S['k3']} x {S['q3']}, packed and "
            f"bits), both profiles: replies == direct calls, both parties reconstruct")

        # Config 5: DCF comparison and interval gates.
        n5, k5, q5, ki5 = S["n5"], S["k5"], S["q5"], S["ki5"]
        al5 = rng.integers(2, 1 << n5, size=k5, dtype=np.uint64)
        g5 = timed("dcf_gen", lambda: c.ok(f"/v1/dcf_gen?{_qs(log_n=n5, k=k5)}", _u8(al5)))
        kl5 = dcf.key_len(n5)
        da = dcf.DcfKeyBatch.from_bytes([g5[i * kl5:(i + 1) * kl5] for i in range(k5)], n5)
        db = dcf.DcfKeyBatch.from_bytes([g5[(k5 + i) * kl5:(k5 + i + 1) * kl5]
                                         for i in range(k5)], n5)
        xs5 = rng.integers(0, 1 << n5, size=(k5, q5), dtype=np.uint64)
        xs5[:, 0], xs5[:, 1] = al5, al5 - np.uint64(1)
        lt = (xs5 < al5[:, None]).astype(np.uint8)
        w5 = fast.dcf_eval_lt_points(da, xs5, packed=True, device=dev)
        qs5 = _qs(log_n=n5, k=k5, q=q5, format="packed")
        r5a = timed("dcf_eval_points", lambda: c.ok(f"/v1/dcf_eval_points?{qs5}",
                                                     g5[: k5 * kl5] + _u8(xs5)))
        r5b = c.ok(f"/v1/dcf_eval_points?{qs5}", g5[k5 * kl5:] + _u8(xs5))
        _same("dcf_eval_points", r5a, bitpack.words_to_wire_rows(w5, q5))
        if not np.array_equal(_rec_packed(r5a, r5b, k5, q5), lt):
            raise AssertionError("dcf_eval_points: reconstruction != 1{x < alpha}")
        del db
        lo = rng.integers(0, 1 << (n5 - 1), size=ki5, dtype=np.uint64)
        hi = lo + rng.integers(0, 1 << (n5 - 2), size=ki5, dtype=np.uint64)
        gi = timed("dcf_interval_gen", lambda: c.ok(f"/v1/dcf_interval_gen?{_qs(log_n=n5, k=ki5)}",
                                                     _u8(lo) + _u8(hi)))
        half = len(gi) // 2
        xsi = rng.integers(0, 1 << n5, size=(ki5, q5), dtype=np.uint64)
        xsi[:, 0], xsi[:, 1], xsi[:, 2] = lo, hi, hi + np.uint64(1)
        inside = ((xsi >= lo[:, None]) & (xsi <= hi[:, None])).astype(np.uint8)

        def triple(blob):
            keys_at = lambda off: dcf.DcfKeyBatch.from_bytes(  # noqa: E731
                [blob[off + i * kl5: off + (i + 1) * kl5] for i in range(ki5)], n5)
            return keys_at(0), keys_at(ki5 * kl5), np.frombuffer(blob[2 * ki5 * kl5:], np.uint8)

        wi = fast.dcf_eval_interval_points(triple(gi[:half]), xsi, packed=True, device=dev)
        qsi = _qs(log_n=n5, k=ki5, q=q5, format="packed")
        ria = timed("dcf_interval_eval", lambda: c.ok(f"/v1/dcf_interval_eval?{qsi}",
                                                       gi[:half] + _u8(xsi)))
        rib = c.ok(f"/v1/dcf_interval_eval?{qsi}", gi[half:] + _u8(xsi))
        _same("dcf_interval_eval", ria, bitpack.words_to_wire_rows(wi, q5))
        if not np.array_equal(_rec_packed(ria, rib, ki5, q5), inside):
            raise AssertionError("dcf_interval_eval: reconstruction != 1{lo <= x <= hi}")
        step_log(f"[sidecar] dcf_gen + dcf_eval_points (n={n5}, {k5} x {q5}) and dcf_interval_gen + "
            f"dcf_interval_eval ({ki5} x {q5}): replies == direct calls, reconstruct exactly")

        # Heavy hitters: the dealer's blob feeds the round routes.
        G, hn, lvl = S["hh_g"], S["hh_n"], S["hh_level"]
        vals = rng.integers(0, 1 << hn, size=G, dtype=np.uint64)
        planted = (5, 1234 % (1 << hn), (1 << hn) - 7)
        per = max(G // 50, 2)
        for i, v in enumerate(planted):
            vals[i * per:(i + 1) * per] = v
        thr = min(SIDECAR_HH_THRESHOLD, per // 2)
        hh_blobs = {}
        for prof in ("compat", "fast"):
            klen = profiles[prof][2]
            cls = profiles[prof][1]
            kl = klen(hn)
            gh = timed(f"hh_gen {prof}", lambda: c.ok(
                f"/v1/hh/gen?{_qs(log_n=hn, k=G, profile=prof)}", _u8(vals)))
            half = len(gh) // 2
            hh_blobs[prof] = gh[:half]

            def level_blob(blob, level):
                a = np.frombuffer(blob, np.uint8).reshape(G, hn, kl)
                return np.ascontiguousarray(a[:, level]).tobytes()

            # Stateless round at ``lvl``: every (lvl+1)-bit prefix a candidate.
            nc = 1 << (lvl + 1)
            cands = np.arange(nc, dtype=np.uint64) << np.uint64(hn - lvl - 1)
            rows = {}
            for party, blob in (("a", gh[:half]), ("b", gh[half:])):
                lb = level_blob(blob, lvl)
                qsh = _qs(log_n=hn, k=G, q=nc, level=lvl, profile=prof, format="packed")
                rows[party] = timed(f"hh_eval {prof}", lambda: c.ok(
                    f"/v1/hh/eval?{qsh}", lb + _u8(cands)))
                kbl = cls.from_bytes([lb[i * kl:(i + 1) * kl] for i in range(G)], hn)
                want = plans.run_hh_level(prof, kbl, np.broadcast_to(cands[None], (G, nc)), lvl,
                                          device=dev)
                _same(f"hh_eval {prof} ({party})", rows[party],
                      bitpack.words_to_wire_rows(want, nc))
            counts = _rec_packed(rows["a"], rows["b"], G, nc).sum(axis=0)
            if not np.array_equal(counts, np.bincount((vals >> np.uint64(hn - lvl - 1))
                                                      .astype(np.int64), minlength=nc)):
                raise AssertionError(f"hh_eval {prof}: counts != the clients' prefixes")
            # An incremental descent (session) over the level-(n-1) keys.
            last = {p: level_blob(b, hn - 1) for p, b in (("a", gh[:half]), ("b", gh[half:]))}
            frontier = {p: hh_state.FrontierState(
                prof, cls.from_bytes([last[p][i * kl:(i + 1) * kl] for i in range(G)], hn),
                device=dev) for p in last}
            surv = np.zeros(1, np.uint64)
            depth = 0
            found = None
            for d in sorted({min(hn, x) for x in (4, 8, 12, hn)}):
                # Every depth-d extension of the survivors.
                ext = d - depth
                cand = ((surv[:, None] << np.uint64(ext))
                        | np.arange(1 << ext, dtype=np.uint64)[None]).reshape(-1)
                raw = cand << np.uint64(hn - d)
                qsd = _qs(log_n=hn, k=G, q=cand.size, level=d - 1, profile=prof,
                          session=f"s41-{prof}", format="packed")
                got = {}
                for p in ("a", "b"):
                    got[p] = timed(f"hh_session {prof}", lambda: c.ok(
                        f"/v1/hh/eval?{qsd.replace('s41', 's41' + p)}", last[p] + _u8(raw)))
                    _same(f"hh_session {prof} depth {d} ({p})", got[p],
                          bitpack.words_to_wire_rows(frontier[p].advance(cand, d), cand.size))
                cnt = _rec_packed(got["a"], got["b"], G, cand.size).sum(axis=0)
                truth = np.array([(vals >> np.uint64(hn - d) == x).sum() for x in cand])
                if not np.array_equal(cnt, truth):
                    raise AssertionError(f"hh_session {prof} depth {d}: counts")
                surv, depth = cand[cnt >= thr], d
                found = {int(v): int(n) for v, n in zip(cand[cnt >= thr], cnt[cnt >= thr])}
            want_found = {int(v): int((vals == v).sum()) for v in np.unique(vals)
                          if (vals == v).sum() >= thr}
            if found != want_found:
                raise AssertionError(f"hh_session {prof}: found {found}, want {want_found}")
        step_log(f"[sidecar] hh/gen ({G} clients x {hn} levels) feeding hh/eval stateless (level "
            f"{lvl}, {1 << (lvl + 1)} candidates) and a session descent, both profiles: replies "
            f"== direct calls, exact counts, the planted values found")

        # Aggregation: the streamed upload.
        R, W = S["agg_rows"], S["agg_words"]
        arows = rng.integers(0, 1 << 32, size=(R, W), dtype=np.uint64).astype(np.uint32)
        for op, want in (("xor", np.bitwise_xor.reduce(arows, axis=0)),
                         ("add", (arows.astype(np.uint64).sum(axis=0) & 0xFFFFFFFF)
                          .astype(np.uint32))):
            ra = timed(f"agg {op}", lambda: c.ok(f"/v1/agg/submit?{_qs(op=op, k=R, words=W)}",
                                                 arows.astype("<u4").tobytes()))
            _same(f"agg/submit {op}", ra, want.astype("<u4"))
        del arows
        step_log(f"[sidecar] agg/submit xor and add over {R} x {W}-word rows == numpy")

        # PIR, config 4: the database from --seed, both profiles.
        nr, rbytes, pk = S["pir_rows"], S["pir_row_bytes"], S["pir_k"]
        db_rows = np.random.default_rng(seed).integers(0, 256, size=(nr, rbytes), dtype=np.uint8)
        for prof in ("compat", "fast"):
            name = f"c4-{prof}"
            info = json.loads(timed(f"pir_db {prof}", lambda: c.ok(
                f"/v1/pir/db?{_qs(name=name, rows=nr, row_bytes=rbytes, profile=prof)}",
                db_rows.tobytes())))
            entry = pir_store.registry().get(name)
            idx = rng.integers(0, nr, size=pk, dtype=np.uint64)
            qa, qb = deal(prof, idx, entry.log_n)
            ans = {}
            for p, kbq in (("a", qa), ("b", qb)):
                ans[p] = timed(f"pir_query {prof}", lambda: c.ok(
                    f"/v1/pir/query?{_qs(db=name, k=pk)}", b"".join(kbq.to_bytes())))
            _same(f"pir/query {prof}", ans["a"], plans.run_pir(entry, qa, device=dev))
            rec = (np.frombuffer(ans["a"], np.uint8) ^ np.frombuffer(ans["b"], np.uint8))
            if not np.array_equal(rec.reshape(pk, rbytes), db_rows[idx.astype(np.int64)]):
                raise AssertionError(f"pir {prof}: reconstruction != the rows")
            step_log(f"[sidecar] pir/db {info} and pir/query ({pk} queries, {prof}): answer == "
                f"direct plan call, both servers' answers XOR to the selected rows")
        del db_rows
        launches = read_launches()
        step_log(f"[sidecar] every route once: launches of eager routes and first uses "
            f"{ {k: n for k, n in launches.items() if n} }; seconds a request "
            + ", ".join(f"{k} {v:.3f}" for k, v in route_s.items()))

        # 4. Coalescing: concurrent 8-key pointwise requests, then 128-gate DCF ones.
        if plans.capture_count() != captured:
            raise AssertionError(f"capture_count() moved: {captured} -> {plans.capture_count()}")
        st = handlers.serving_state()
        for what, nk, q, n, prof in (("points", S["burst_keys3"], S["q3"], S["n3"], "compat"),
                                     ("dcf", S["burst_keys5"], S["q5"], S["n5"], "fast")):
            reqs = []
            for _ in range(S["burst_threads"]):
                al = rng.integers(1, 1 << n, size=nk, dtype=np.uint64)
                xq = rng.integers(0, 1 << n, size=(nk, q), dtype=np.uint64)
                if what == "points":
                    kx, _ = deal(prof, al, n)
                    w = profiles[prof][4](kx, xq)
                    path = f"/v1/eval_points_batch?{_qs(log_n=n, k=nk, q=q, format='packed')}"
                else:
                    kx, _ = fast.dcf_gen_lt_batch(al, n, rng, device=dev)
                    w = fast.dcf_eval_lt_points(kx, xq, packed=True, device=dev)
                    path = f"/v1/dcf_eval_points?{_qs(log_n=n, k=nk, q=q, format='packed')}"
                reqs.append((path, b"".join(kx.to_bytes()) + _u8(xq),
                             bitpack.words_to_wire_rows(w, q).tobytes()))
            before = st.batcher.stats_dict()
            barrier = threading.Barrier(len(reqs))
            errors = []

            def send(r):
                cc_ = _Http(port)
                try:
                    barrier.wait()
                    got = cc_.ok(r[0], r[1])
                    if got != r[2]:
                        errors.append("reply != direct call")
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(repr(e))
                finally:
                    cc_.close()

            threads = [threading.Thread(target=send, args=(r,)) for r in reqs]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            after = st.batcher.stats_dict()
            nd = after["dispatches"] - before["dispatches"]
            nkd = after["keys_dispatched"] - before["keys_dispatched"]
            if errors:
                raise AssertionError(f"coalescing {what}: {errors[:3]}")
            if nd >= len(reqs) or nkd / max(nd, 1) <= nk:
                raise AssertionError(f"coalescing {what}: {len(reqs)} requests in {nd} dispatches")
            step_log(f"[sidecar] coalescing {what}: {len(reqs)} concurrent {nk}-key requests in {nd} "
                f"dispatches, {nkd / nd:.1f} keys a dispatch; every reply == its direct call")
        if plans.capture_count() != captured:
            raise AssertionError(f"capture_count() moved: {captured} -> {plans.capture_count()}")
        step_log(f"[sidecar] capture_count() unmoved since the warmup: {captured}")

        # 5. The capture gate: a new bucket captures under concurrent traffic.
        n3, q3 = S["n3"], S["q3"]
        gk = S["gate_k"]
        alg = rng.integers(1, 1 << n3, size=gk, dtype=np.uint64)
        kgate, _ = deal("compat", alg, n3)
        xg = rng.integers(0, 1 << n3, size=(gk, q3), dtype=np.uint64)
        want_gate = bitpack.words_to_wire_rows(profiles["compat"][4](kgate, xg), q3).tobytes()
        # The replaying threads send a quarter of the warmed bucket each, so
        # that however they coalesce their batches stay inside it.
        kr = max(S["k3"] // 4, 1)
        alr = rng.integers(1, 1 << n3, size=kr, dtype=np.uint64)
        krep, _ = deal("fast", alr, n3)
        xr = rng.integers(0, 1 << n3, size=(kr, q3), dtype=np.uint64)
        want_rep = bitpack.words_to_wire_rows(profiles["fast"][4](krep, xr), q3).tobytes()
        path_rep = f"/v1/eval_points_batch?{_qs(log_n=n3, k=kr, q=q3, profile='fast', format='packed')}"
        body_rep = b"".join(krep.to_bytes()) + _u8(xr)
        arows = rng.integers(0, 1 << 32, size=(1024, 64), dtype=np.uint64).astype(np.uint32)
        want_agg = np.bitwise_xor.reduce(arows, axis=0).astype("<u4").tobytes()
        stop = threading.Event()
        done = Counter()
        errors = []

        def background(kind):
            cc_ = _Http(port)
            try:
                while not stop.is_set():
                    if kind == "replay":
                        ok = cc_.ok(path_rep, body_rep) == want_rep
                    elif kind == "gen":
                        ok = len(cc_.ok(f"/v1/gen?{_qs(log_n=S['n2'], alpha=3, profile='fast')}")) \
                            == 2 * cc.key_len(S["n2"])
                    else:
                        ok = cc_.ok(f"/v1/agg/submit?{_qs(op='xor', k=1024, words=64)}",
                                    arows.astype("<u4").tobytes()) == want_agg
                    if not ok:
                        errors.append(f"{kind}: wrong reply")
                    done[kind] += 1
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"{kind}: {e!r}")
            finally:
                cc_.close()

        kinds = ["replay"] * 4 + ["gen"] * 2 + ["agg"] * 2
        threads = [threading.Thread(target=background, args=(k_,)) for k_ in kinds]
        for t in threads:
            t.start()
        time.sleep(S["pause_s"])
        t0 = time.perf_counter()
        got = c.ok(f"/v1/eval_points_batch?{_qs(log_n=n3, k=gk, q=q3, format='packed')}",
                   b"".join(kgate.to_bytes()) + _u8(xg))
        cap_s = time.perf_counter() - t0
        time.sleep(S["pause_s"])
        stop.set()
        for t in threads:
            t.join()
        if errors:
            raise AssertionError(f"capture gate: {errors[:3]}")
        _same("capture under traffic", got, want_gate)
        new = plans.capture_count()
        if new != captured + (1 if on_card else 0):
            raise AssertionError(f"capture gate: capture_count() {captured} -> {new}")
        captured = new
        step_log(f"[sidecar] capture gate: a {gk}-key request captured a new graph in "
            f"{cap_s * 1e3:.1f} ms (served) while 8 threads ran {dict(done)} requests; no request "
            f"failed, every reply exact; capture_count() {captured}")

        # 6. The served path runs the kernels: one traced request a route.
        if on_card:
            traced = {}
            a20, ka20, _ = keys2["compat"]
            _, kf20, _ = keys2["fast"]
            n2, k2 = S["n2"], S["k2"]
            n5 = S["n5"]
            reqs = {
                "evalfull compat": (f"/v1/evalfull_batch?{_qs(log_n=n2, k=k2)}",
                                    b"".join(ka20.to_bytes())),
                "evalfull fast": (f"/v1/evalfull_batch?{_qs(log_n=n2, k=k2, profile='fast')}",
                                  b"".join(kf20.to_bytes())),
                "points compat": (f"/v1/eval_points_batch?{_qs(log_n=n3, k=gk, q=q3, format='packed')}",
                                  b"".join(kgate.to_bytes()) + _u8(xg)),
                "points fast": (path_rep, body_rep),
                "dcf_points": (f"/v1/dcf_eval_points?{qs5}", g5[: k5 * kl5] + _u8(xs5)),
                "dcf_interval": (f"/v1/dcf_interval_eval?{qsi}", gi[:len(gi) // 2] + _u8(xsi)),
                "gen compat": (f"/v1/gen?{_qs(log_n=n2, alpha=7)}", b""),
                "gen fast": (f"/v1/gen?{_qs(log_n=n2, alpha=7, profile='fast')}", b""),
                "dcf_gen": (f"/v1/dcf_gen?{_qs(log_n=n5, k=k5)}", _u8(al5)),
                "eval compat": (f"/v1/eval?{_qs(log_n=n2, x=int(a20[0]))}", ka20.to_bytes()[0]),
                "eval fast": (f"/v1/eval?{_qs(log_n=n2, x=7, profile='fast')}",
                              kf20.to_bytes()[0]),
            }
            for prof in ("compat", "fast"):
                kl = profiles[prof][2](hn)
                a = np.frombuffer(hh_blobs[prof], np.uint8).reshape(G, hn, kl)
                reqs[f"hh_eval {prof}"] = (
                    f"/v1/hh/eval?{_qs(log_n=hn, k=G, q=16, level=3, profile=prof, format='packed')}",
                    np.ascontiguousarray(a[:, 3]).tobytes()
                    + _u8(np.arange(16, dtype=np.uint64) << np.uint64(hn - 4)))
                # The session is opened untraced (its frontier's operands go to
                # the card then); the traced round extends it 4 levels deeper.
                last = np.ascontiguousarray(a[:, hn - 1]).tobytes()
                sess = f"session=trace-{prof}&format=packed"
                c.ok(f"/v1/hh/eval?{_qs(log_n=hn, k=G, q=16, level=3, profile=prof)}&{sess}",
                     last + _u8(np.arange(16, dtype=np.uint64) << np.uint64(hn - 4)))
                reqs[f"hh_session {prof}"] = (
                    f"/v1/hh/eval?{_qs(log_n=hn, k=G, q=16, level=7, profile=prof)}&{sess}",
                    last + _u8(np.arange(16, dtype=np.uint64) << np.uint64(hn - 8)))
                qp, _ = deal(prof, np.arange(pk, dtype=np.uint64) % np.uint64(nr),
                             pir_store.registry().get(f"c4-{prof}").log_n)
                reqs[f"pir {prof}"] = (f"/v1/pir/query?{_qs(db='c4-' + prof, k=pk)}",
                                       b"".join(qp.to_bytes()))
            for route, (path, body) in reqs.items():
                want = SIDECAR_ROUTE_KERNELS[route]
                # A late trace loses the first device events of its session:
                # sleep kernels lead each traced request (as in phase 40).
                _, _, busy = device_breakdown(lambda: (_sleep_lead(), c.ok(path, body)),
                                              want[0])
                counts = _kernel_counts(busy)
                got = _hand_kernels(counts, {k_: 1 for k_ in want})
                if not all(got.values()):
                    raise AssertionError(f"traced {route}: kernels {dict(counts)}")
                traced[route] = got
            step_log(f"[sidecar] one traced served request a route shows its kernels: {traced}")

        # 7. The breaker: a transient dispatch fault trips it; the probe replays.
        st = handlers.serving_state()
        br = st.breaker
        for prof in ("compat", "fast"):  # the recent plans: graph plans
            c.ok(f"/v1/eval_points_batch?{_qs(log_n=n3, k=S['k3'], q=q3, profile=prof, format='packed')}",
                 body3[prof][0])
        c.ok(path_rep, body_rep)
        n_fail = br.threshold * (br.retries + 1)
        os.environ["DPF_CUDA_FAULTS"] = f"dispatch.points:unavailable:times={n_fail}"
        try:
            faults.install_from_env()
        finally:
            del os.environ["DPF_CUDA_FAULTS"]
        replays0 = plans.cache().stats()["replays"]
        statuses = []
        for _ in range(br.threshold):
            s_, body_, hdr = c.post(path_rep, body_rep)
            statuses.append((s_, json.loads(body_)["code"]))
        s_, body_, hdr = c.post(path_rep, body_rep)
        statuses.append((s_, json.loads(body_)["code"]))
        ready = c.get("/readyz")
        trips = br.stats()
        if (statuses != [(503, "unavailable")] * (br.threshold + 1) or trips["trips"] != 1
                or trips["retries"] != br.threshold * br.retries
                or ready[0] != 503 or json.loads(ready[1])["code"] != "breaker_open"
                or "Retry-After" not in hdr):
            raise AssertionError(f"breaker: {statuses} {trips} {ready}")
        # Wait for the probe thread without reading the state: a read after
        # the cooldown moves open -> half_open by time alone, and the probe
        # then stands down without re-warming.
        t0 = time.perf_counter()
        br._probe_thread.join(timeout=60)
        probe_s = time.perf_counter() - t0
        if br._probe_thread.is_alive() or br.stats()["probe_runs"] != 1 or br.state != "half_open":
            raise AssertionError(f"breaker: the probe did not move it to half_open: {br.stats()}")
        replays = plans.cache().stats()["replays"] - replays0
        if on_card and replays <= 0:
            raise AssertionError("breaker: the probe replayed no graph")
        if plans.capture_count() != captured:
            raise AssertionError("breaker: the probe captured")
        _same("breaker trial", c.ok(path_rep, body_rep), want_rep)
        stats = br.stats()
        ready = c.get("/readyz")
        if stats["state"] != "closed" or stats["recoveries"] != 1 or ready[0] != 200:
            raise AssertionError(f"breaker recovery: {stats} {ready}")
        faults.clear()
        step_log(f"[sidecar] breaker: {br.threshold} requests x {br.retries + 1} attempts of a "
            f"transient fault -> {statuses}, trips 1, /readyz 503 breaker_open; the probe "
            f"({stats['probe_runs']} run) re-warmed through {replays} graph replays, half-open "
            f"after {probe_s:.2f} s; the trial request exact, closed, recoveries 1")

        # 8. Observability: metrics == stats, the contract's names, a trace.
        tid = "phase41-trace"
        c.ok(path_rep, body_rep, {"X-DPF-Trace": tid})
        # The server records a trace after it has written the reply: poll.
        t0 = time.perf_counter()
        while True:
            status, tr = c.get(f"/v1/trace?id={tid}")
            if json.loads(tr)["traces"] or time.perf_counter() - t0 > 30:
                break
            time.sleep(0.02)
        spans = set()

        def walk(node):
            spans.add(node["name"])
            for ch in node.get("children", []):
                walk(ch)

        tr = json.loads(tr)
        for t_ in tr["traces"]:
            for sp in t_["spans"]:
                walk(sp)
        if status != 200 or not tr["traces"] or not set(SIDECAR_TRACE_SPANS) <= spans:
            raise AssertionError(f"trace {tid}: spans {sorted(spans)}")
        status, mtext = c.get("/v1/metrics")
        status2, stext = c.get("/v1/stats")
        scrape = promtext.parse(mtext.decode(), strict=True)
        stats = json.loads(stext)
        contract = json.loads((Path(__file__).resolve().parent / "docs" / "CONTRACT.json")
                              .read_text())["metrics"]
        missing = sorted(n_ for n_ in contract if n_ not in scrape.types
                         and (on_card or n_ != "dpf_device_memory_bytes"))
        b_ = stats["batcher"]
        pairs = {
            ("dpf_requests_total", None): b_["requests"],
            ("dpf_dispatches_total", None): b_["dispatches"],
            ("dpf_keys_dispatched_total", None): b_["keys_dispatched"],
            ("dpf_shed_total", (("kind", "depth"),)): b_["shed_depth"],
            ("dpf_expired_total", (("where", "queue"),)): b_["expired_queue"],
            ("dpf_breaker_transitions_total", (("kind", "trip"),)): stats["breaker"]["trips"],
            ("dpf_breaker_transitions_total", (("kind", "recovery"),)):
                stats["breaker"]["recoveries"],
            ("dpf_breaker_retries_total", None): stats["breaker"]["retries"],
            ("dpf_plan_hits_total", None): stats["plans"]["hits"],
            ("dpf_plan_compiles_total", None): stats["plans"]["misses"],
            ("dpf_keycache_hits_total", None): stats["key_cache"]["hits"],
            ("dpf_pir_queries_total", None): stats["pir"]["queries"],
            ("dpf_hh_session_hits_total", None): stats["hh_state"]["hits"],
        }
        bad = {f"{n_}{dict(lb or ())}": (scrape.value(n_, dict(lb or ())), v)
               for (n_, lb), v in pairs.items() if scrape.value(n_, dict(lb or ())) != v}
        if status != 200 or status2 != 200 or missing or bad:
            raise AssertionError(f"metrics: missing {missing}, != stats {bad}")
        step_log(f"[sidecar] /v1/metrics parses strictly, names all {len(contract)} metrics of the "
            f"contract, and its counters equal /v1/stats; /v1/trace?id= spans {sorted(spans)}")

        # 9. Timings.
        n2, k2 = S["n2"], S["k2"]
        _, ka20, _ = keys2["compat"]
        al3 = rng.integers(1, 1 << n3, size=S["k3"], dtype=np.uint64)
        p3, _ = deal("compat", al3, n3)
        x3 = rng.integers(0, 1 << n3, size=(S["k3"], q3), dtype=np.uint64)
        path3 = f"/v1/eval_points_batch?{_qs(log_n=n3, k=S['k3'], q=q3, format='packed')}"
        body3c = b"".join(p3.to_bytes()) + _u8(x3)

        def synced(fn):
            def run():
                fn()
                if on_card:
                    torch.cuda.synchronize()
            return run

        cases = [
            ("config 2 evalfull_batch (blocking)", f"/v1/evalfull_batch?{_qs(log_n=n2, k=k2)}",
             b"".join(ka20.to_bytes()), True,
             synced(lambda: plans.run_evalfull("compat", ka20, device=dev))),
            ("config 2 evalfull one key (blocking)", f"/v1/evalfull?{_qs(log_n=n2, stream=0)}",
             ka20.to_bytes()[0], False, None),
            ("config 2 evalfull one key (stream)", f"/v1/evalfull?{_qs(log_n=n2, stream=1)}",
             ka20.to_bytes()[0], False, None),
            ("config 3 points compat", path3, body3c, False,
             synced(lambda: plans.run_points("points", "compat", p3, x3, device=dev))),
            ("config 5 dcf_points", f"/v1/dcf_eval_points?{qs5}", g5[: k5 * kl5] + _u8(xs5),
             False, synced(lambda: plans.run_points("dcf_points", "fast", da, xs5, device=dev))),
        ]
        def phases():
            return json.loads(c.get("/v1/stats")[1])["phases"]

        for label, path, body, big, direct in cases:
            ph0 = phases()
            lat1 = _closed_loop(port, 1, S["lat_n1_big"] if big else S["lat_n1"], S["lat_cap_s"],
                                path, body)
            split = _phase_split(ph0, phases(), len(lat1), statistics.fmean(lat1))
            before = st.batcher.stats_dict()
            lat16 = _closed_loop(port, S["lat_clients"],
                                 S["lat_n16_big"] if big else S["lat_n16"], S["lat_cap_s"],
                                 path, body)
            after = st.batcher.stats_dict()
            nd = after["dispatches"] - before["dispatches"]
            row = (f"[sidecar time] {card}: {label}: 1 client p50 {_pct(lat1, 50):.3f} ms "
                   f"{_tail(lat1)} mean {statistics.fmean(lat1):.3f} ms (n={len(lat1)}); "
                   f"{S['lat_clients']} clients p50 {_pct(lat16, 50):.3f} ms {_tail(lat16)} "
                   f"(n={len(lat16)})")
            if nd:
                row += (f", {(after['keys_dispatched'] - before['keys_dispatched']) / nd:.1f} "
                        f"keys a dispatch")
            row += f"; 1 client, mean ms a request: {split}"
            if direct is not None:
                d_ms = host_ms(direct, warmup=1, reps=S["direct_reps"])
                row += (f"; direct plans call {d_ms:.3f} ms (median of {S['direct_reps']}), the "
                        f"sidecar adds {_pct(lat1, 50) - d_ms:.3f} ms at p50")
            step_log(row)
        if plans.capture_count() != captured:
            raise AssertionError(f"timings: capture_count() moved: {captured} -> "
                                 f"{plans.capture_count()}")
        if on_card:
            wall_ms, span_ms, busy = device_breakdown(
                lambda: _closed_loop(port, 16, 32, S["lat_cap_s"], path3, body3c),
                "walk_bm_kernel")
            total = sum(us for us, _ in busy.values()) / 1e3
            step_log(f"[sidecar time] {card}: config 3 burst of 16 clients x 2 requests traced: wall "
                f"{wall_ms:.3f} ms, device busy {total:.3f} ms, idle {100 - 100 * total / wall_ms:.1f} "
                f"% of the wall")
    finally:
        c.close()
        srv.shutdown()
        srv.server_close()
        faults.clear()
        handlers.reset_serving_state()
        for k_, v in saved.items():
            if v is None:
                os.environ.pop(k_, None)
            else:
                os.environ[k_] = v
    log(f"[sidecar] phase 41 in {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout whose fast expansion kernels phase 15 "
                    "times in turns with this tree's")
    ap.add_argument("--seed", type=int, default=4, help="seed of phase 36's PIR database "
                    "and queries (and of phase 41's)")
    args = ap.parse_args()
    parent = args.parent
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
    for kern in FOLDED_KERNELS + STACKLESS_KERNELS:  # the redesigned kernels must not spill
        info = ptxas[kern]
        log(f"[build] {kern}: {info['registers']} registers, {info['stack_bytes']} B stack, "
            f"{info['spill_store_bytes']} B spill stores, {info['spill_load_bytes']} B spill loads")
        if info["spill_store_bytes"] or info["spill_load_bytes"]:
            raise AssertionError(f"{kern} spills: {info}")
        if kern in STACKLESS_KERNELS and info["stack_bytes"]:
            raise AssertionError(f"{kern} has a stack frame: {info}")
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
    }
    rng = np.random.default_rng(2024)
    for kname, kern in kernels.items():
        kern["err"] = 0
        for B in (*ODD_WIDTHS, *CHECK_WIDTHS):
            S = to_carrier(rng.integers(0, 1 << 32, size=(128, B), dtype=np.uint32), dev)
            got, want = kern["wrapper"](S), kern["plain"](S)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                if not torch.equal(g, w):
                    raise AssertionError(f"{kname} != plain at B={B}")
                kern["err"] = max(kern["err"], max_abs_err(g, w))
            log(f"[kernel] {kname} == plain at [128, {B}]")
    leaf_err = leaf_checks("leaf_words_bm_kernel", aes_cuda.convert_leaves_bm,
                           aes_cuda.convert_leaves_bm_plain, dev)

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
    ka, kb = P.gen_batch(alphas, LOG_N, rng, device="cpu")
    out_a = P.eval_full_batch(ka)
    out_b = P.eval_full_batch(kb)
    launches = read_launches()
    nu = LOG_N - 7
    log(f"[main] n={LOG_N} K={K}: launches over 2 evaluations {launches}")
    if launches != {**{n: 0 for n in launches}, "prg_bm_kernel": 2 * nu,
                    "leaf_words_bm_kernel": 2}:
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
    k16, _ = P.gen_batch(rng.integers(0, 1 << 16, size=256, dtype=np.uint64), 16, rng, device="cpu")
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
    rows_out.append(leaf_row(card, "leaf_words_bm_kernel", aes_cuda.convert_leaves_bm,
                             aes_cuda.convert_leaves_bm_plain, "dpf_tpu/ops/aes_pallas.py:253",
                             launches["leaf_words_bm_kernel"], leaf_err, int_ops_per_s, dev))

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

    fast_rows = fast_phases(dev, card, n_sm * clock_hz)
    rows_out += fast_rows
    point_head = point_traced(dev, card)
    gate_head = gate_traced(dev, card, n_sm * clock_hz)
    # The compat options after the other paths' traces, traced first:
    # traces taken after many launches lose device events.
    option_times(dev, card, ka)
    option_launches = option_routes(dev, card, ka, kb, alphas, out_a)
    # Streaming and PIR, traced before the plain versions' many launches.
    stream_phase(dev, card)
    pir_phase(dev, card, args.seed)
    # The dealer, heavy hitters and aggregation, each traced before its
    # heavy checks.
    rows_out.append(dealer_phase(dev, card, n_sm * clock_hz))
    hh_phase(dev, card)
    agg_phase(dev, card)
    # The dispatch plans: their graphs, traced before the plain versions'
    # many launches.
    t0 = time.perf_counter()
    plans_phase(dev, card)
    log(f"[plans] phase 40 in {time.perf_counter() - t0:.1f} s")
    # The sidecar on the card, over the plans.
    sidecar_phase(dev, card, args.seed)
    rows_out += point_checked(dev, card, n_sm * clock_hz, point_head)
    rows_out += gate_checked(dev, card, n_sm * clock_hz, gate_head)
    # The option kernels' plain versions run last: traces after many small
    # plain launches lose device events.
    rows_out += option_kernels(dev, card, n_sm * clock_hz, ka, option_launches)
    fast_late_phases(dev, card, parent, fast_rows)

    print(json.dumps({"kernels": rows_out}), flush=True)
    log(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
