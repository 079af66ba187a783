#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dpf_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one nvcc
per source, side by side), holds each against its plain PyTorch version on
the card, runs the golden vectors, and drives both profiles' main paths (host
``gen_batch`` -> ``eval_full_batch`` at n=20 with 1024 keys: the compat
profile, BASELINE.json's config, then the ChaCha fast profile,
``dpf_tpu_torch.fast``) with launch counters zeroed just before each path and
read just after.  It checks each kernel path against the plain path and the
chunked split against the unchunked one (and the fast profile's deep-tree and
whole-tree routes), and times the paths and each kernel with CUDA events
(a kernel's ``ms`` in the kernels line: its runs queued back to back behind
a sleep kernel, so the host's launch time between them does not count; its
``event_ms``: one call at a time, events around each).
Each kernel's bound counts its instructions (``dpf_tpu_torch/ops/op_count.py``:
LOP3 for AES-MMO, IADD/LOP3/SHF for ChaCha12) over the card's issue rate, and
the build phase prints the built kernels' SASS instruction counts.  Every
check is exact: this is integer cryptography, the tolerance is zero.

Any failed phase raises, so the script exits nonzero.  Without CUDA, or
without the package beside it, it exits nonzero and prints no result.  The
last line of standard output is one JSON object naming the card; the line
before the card's name and power limit lists every kernel with its
measurements.  Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

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
FAST_SOURCE = "dpf_tpu_torch/ops/csrc/chacha_expand.cu"
# The fast profile's kernel checks, (K, W, levels): every W in {1, 3, 128,
# 4096}, L in {0, 1, 5} and K in {1, 9, 1024}, the headline tail (1024 keys,
# 128 entry nodes, 4 levels) and the headline prefix groups (W 1 for 5
# levels, W 32 for 2).
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


def device_breakdown(fn) -> tuple[float, float, dict[str, tuple[float, int]]]:
    """Run ``fn`` once under torch.profiler -> (host wall ms, device span ms
    from the first device event's start to the last one's end, {device event
    name: (total device us, count)}) over kernels, copies and memsets."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy: dict[str, tuple[float, int]] = {}
    starts, ends = [], []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us, count = busy.get(evt.name, (0.0, 0))
        busy[evt.name] = (us + evt.time_range.elapsed_us(), count + 1)
        starts.append(evt.time_range.start)
        ends.append(evt.time_range.end)
    return wall_ms, (max(ends) - min(starts)) / 1e3, busy


def log_breakdown(card: str, entry: str, fn) -> None:
    """Print :func:`device_breakdown` of one run of ``fn``."""
    wall_ms, span_ms, busy = device_breakdown(fn)
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
        "fused_levels_kernel": chacha_cuda.fused_levels,
        "expand_tail_kernel": chacha_cuda.expand_tail,
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
    if launches != {"prg_bm_kernel": 0, "mmo_bm_canon_kernel": 0,
                    "fused_levels_kernel": 4, "expand_tail_kernel": 2}:
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
        log_breakdown(card, entry_name, fn)
    return rows


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
        for B in CHECK_WIDTHS:
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
    if launches != {"prg_bm_kernel": 2 * nu, "mmo_bm_canon_kernel": 2,
                    "fused_levels_kernel": 0, "expand_tail_kernel": 0}:
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
        log_breakdown(card, entry, fn)

    rows_out += fast_phases(dev, card, n_sm * clock_hz)

    print(json.dumps({"kernels": rows_out}), flush=True)
    log(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
