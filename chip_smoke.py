#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dpf_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card, runs the golden vectors, drives
the main path (host ``gen_batch`` -> ``eval_full_batch`` at n=20 with 1024
keys, the BASELINE.json config) with launch counters, checks the kernel path
against the plain path and the chunked split against the unchunked one, and
times the path and each kernel with CUDA events.  Each kernel's bound counts
LOP3 instructions (``dpf_tpu_torch/ops/op_count.py``) over the card's issue
rate, and the build phase prints the built kernels' SASS instruction counts.  Every check is exact: this
is integer cryptography, the tolerance is zero.

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
SOURCE = "dpf_tpu_torch/ops/csrc/aes_mmo.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


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
    build.load()
    log(f"[build] {build.library_path().name} in {time.perf_counter() - t0:.1f} s")
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
    aes_cuda.prg_planes_bm.launches = 0
    aes_cuda.mmo_planes_bm_canon.launches = 0
    ka, kb = P.gen_batch(alphas, LOG_N, rng)
    out_a = P.eval_full_batch(ka)
    out_b = P.eval_full_batch(kb)
    launches = {
        "prg_bm_kernel": aes_cuda.prg_planes_bm.launches,
        "mmo_bm_canon_kernel": aes_cuda.mmo_planes_bm_canon.launches,
    }
    nu = LOG_N - 7
    log(f"[main] n={LOG_N} K={K}: launches over 2 evaluations {launches}")
    if launches != {"prg_bm_kernel": 2 * nu, "mmo_bm_canon_kernel": 2}:
        raise AssertionError(f"expected {nu} PRG + 1 leaf launch per evaluation")
    if out_a.shape != (K, 1 << (LOG_N - 3)) or out_a.dtype != np.uint8:
        raise AssertionError(f"output shape {out_a.shape} {out_a.dtype}")
    rec = out_a ^ out_b
    nz = np.flatnonzero(rec)
    rows, cols = np.divmod(nz, rec.shape[1])
    a = alphas.astype(np.int64)
    if not (
        len(nz) == K
        and np.array_equal(rows, np.arange(K))
        and np.array_equal(cols, a // 8)
        and np.array_equal(rec[rows, cols], (1 << (a % 8)).astype(np.uint8))
    ):
        raise AssertionError("shares do not reconstruct to one bit at each alpha")
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
        k_ms = cuda_ms(lambda: kern["wrapper"](S))
        p_ms = cuda_ms(lambda: kern["plain"](S))
        ops = op_count.lop3_per_column(kern["n_mmo"]) * B
        nbytes = (1 + kern["n_out"]) * 128 * B * 4
        ops_ms, bytes_ms = ops / int_ops_per_s * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        log(f"[time] {card}: {kname} at [128, {B}]: kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.3f} ms, bound {bound_ms:.4f} ms ({ops:.3e} LOP3 -> {ops_ms:.4f} ms, "
            f"{nbytes:.3e} B -> {bytes_ms:.4f} ms)")
        rows_out.append({
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": kern["replaces"], "launches": launches[kname],
            "max_abs_err": kern["err"], "ms": k_ms, "plain_ms": p_ms,
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
        wall_ms, span_ms, busy = device_breakdown(fn)
        total = sum(us for us, _ in busy.values()) / 1e3
        n_events = sum(count for _, count in busy.values())
        log(f"[profile] {card}: {entry} traced: wall {wall_ms:.3f} ms, device span "
            f"{span_ms:.3f} ms, busy {total:.3f} ms in {n_events} device events, idle "
            f"{100 - 100 * total / span_ms:.1f} % of the span, "
            f"{100 - 100 * total / wall_ms:.1f} % of the wall")
        for kname, (us, count) in sorted(busy.items(), key=lambda kv: -kv[1][0])[:15]:
            log(f"[profile]   {us / 1e3:9.3f} ms {count:5d}x  {kname[:110]}")

    print(json.dumps({"kernels": rows_out}), flush=True)
    log(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
