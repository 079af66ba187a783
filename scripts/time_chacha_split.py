#!/usr/bin/env python3
"""Time the fast expansion kernels of the PyTorch/CUDA port at each split.

    python3 scripts/time_chacha_split.py

``dpf_tpu_torch/ops/csrc/chacha_expand.cu`` splits each entry node's subtree
over 2^d threads, d from a fixed rule on the launch's shape
(``split_levels``: M = L - d levels depth first below each thread's path,
M <= 2).  This script shows where that rule and the tail's launch bound come
from.  On one NVIDIA card it builds the kernels three times, each with a C
launcher that takes d as given: as they are; with depth-first walks of up
to 4 levels (d down to L - 4); and with the tail's min-blocks launch bound
removed.  At the shapes the fast routes launch (config 2's tail and two
fused groups, the whole-tree route's deepest tail, the subtree route's tail
at 131,080 keys) it times every d of the first two builds, and the tail at
its rule's d with and without the bound in turns (as built, without,
without, as built).  Each output is held to the rule launch's.  Times: runs
queued back to back behind a sleep kernel, median of 7 trials of 20.
Imports neither JAX nor the JAX package; needs one card and nvcc.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (what, tail?, K, W, levels) of each launch timed.
SHAPES = (
    ("config 2 tail", True, 1024, 128, 4),
    ("config 2 fused group 1", False, 1024, 1, 5),
    ("config 2 fused group 2", False, 1024, 32, 2),
    ("whole-tree tail, n=15", True, 1024, 1, 6),
    ("subtree-route tail, n=15 K=131,073", True, 131080, 1, 5),
)
LAUNCHER = r'''
#include "chacha_expand.cu"

// One launch at split d as given (d < 0: the rule's).
extern "C" int split_launch(int leaf, const void* st, long long st_row, long long st_key,
                            long long K, long long W, int levels, const void* scw,
                            long long scw_key, const void* tcw, long long tcw_key,
                            const void* fcw, long long fcw_key, void* out, long long out_row,
                            long long out_key, int d, void* stream) {
  ExpandArgs a = with_split(
      ExpandArgs{static_cast<const uint32_t*>(st), st_row, st_key, K, W, levels,
                 static_cast<const uint32_t*>(scw), scw_key,
                 static_cast<const uint32_t*>(tcw), tcw_key,
                 static_cast<const uint32_t*>(fcw), fcw_key, static_cast<uint32_t*>(out),
                 out_row, out_key, 0},
      leaf != 0);
  if (d >= 0) a.split = d;
  return launch(leaf != 0, a, stream);
}
'''


def build_variant(name: str, source: str):
    """Compile ``source`` (the kernels' text) with the launcher -> (library,
    ptxas report)."""
    from dpf_tpu_torch.ops import build

    d = build.BUILD_DIR / "split" / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "chacha_expand.cu").write_text(source)
    (d / "launcher.cu").write_text(LAUNCHER)
    so = d / "libsplit.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(d), "-I",
                           str(build.CSRC), "-o", str(so), str(d / "launcher.cu")],
                          capture_output=True, text=True, timeout=600, check=True)
    lib = ctypes.CDLL(str(so))
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.split_launch.argtypes = [i, vp, ll, ll, ll, ll, i, vp, ll, vp, ll, vp, ll, vp, ll,
                                 ll, i, vp]
    lib.split_launch.restype = i
    return lib, build.parse_ptxas(proc.stdout + proc.stderr)


def operands(K: int, W: int, L: int, dev):
    from dpf_tpu_torch.ops.aes_bitslice import to_carrier

    rng = np.random.default_rng(K + W + L)
    words = lambda *s: rng.integers(0, 1 << 32, size=s, dtype=np.uint32)  # noqa: E731
    st = words(5, K, W)
    st[0] &= ~np.uint32(1)
    st[4] &= np.uint32(1)
    scw = words(K, L, 4)
    scw[:, :, 0] &= ~np.uint32(1)
    return tuple(to_carrier(a, dev) for a in (st, scw, words(K, L, 2) & np.uint32(1),
                                              words(K, 16)))


def launch(lib, leaf: bool, st, scw, tcw, fcw, out, d: int) -> None:
    K, W, L = st.shape[1], st.shape[2], scw.shape[1]
    rc = lib.split_launch(int(leaf), st.data_ptr(), st.stride(0), st.stride(1), K, W, L,
                          scw.data_ptr(), scw.stride(0), tcw.data_ptr(), tcw.stride(0),
                          fcw.data_ptr(), fcw.stride(0), out.data_ptr(),
                          0 if leaf else out.stride(0), out.stride(0) if leaf else out.stride(1),
                          d, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"split_launch: CUDA error {rc}")


def kernel_ms(fn, reps: int = 20, trials: int = 7) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("time_chacha_split: CUDA is not available", file=sys.stderr)
        return 1
    from dpf_tpu_torch.ops import build

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    text = (build.CSRC / "chacha_expand.cu").read_text()
    unbounded = text.replace("__launch_bounds__(kChachaThreads, kChachaMinBlocks)",
                             "__launch_bounds__(kChachaThreads)")
    deeper = text.replace("constexpr int kMaxDepthFirst = 2;", "constexpr int kMaxDepthFirst = 4;")
    deeper = deeper.replace("    default: break;", "    case 3: expand_thread<LEAF, 3>(a, i); break;\n"
                            "    case 4: expand_thread<LEAF, 4>(a, i); break;\n    default: break;")
    if unbounded == text or "case 4:" not in deeper or "kMaxDepthFirst = 4" not in deeper:
        raise AssertionError("the kernels' launch bound or depth-first limit was not found")
    libs = {}
    for name, source in (("as built", text), ("depth first to 4 levels", deeper),
                         ("tail without the min-blocks bound", unbounded)):
        libs[name], ptx = build_variant(name.split()[0], source)
        for kern in ("expand_tail_kernel", "fused_levels_kernel"):
            print(f"[build] {name}: {kern} {ptx[kern]}", flush=True)
    split = build.load("chacha_expand").dpf_chacha_split
    lib = libs["as built"]
    for what, leaf, K, W, L in SHAPES:
        st, scw, tcw, fcw = operands(K, W, L, dev)
        shape = (K, W << L, 16) if leaf else (5, K, W << L)
        want = torch.empty(shape, dtype=torch.int32, device=dev)
        launch(lib, leaf, st, scw, tcw, fcw, want, -1)
        rule = split(K * W, L, int(leaf))
        out = torch.empty_like(want)
        times = []
        for name, first in (("depth first to 4 levels", L - 4), ("as built", L - 2)):
            for d in range(max(0, first), L + 1 if name == "as built" else max(0, L - 2)):
                out.zero_()
                launch(libs[name], leaf, st, scw, tcw, fcw, out, d)
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"{what}: {name}, d = {d} != the rule's launch")
                ms = kernel_ms(lambda: launch(libs[name], leaf, st, scw, tcw, fcw, out, d))
                times.append(f"d={d}{' (rule)' if d == rule else ''}"
                             f"{' (' + name + ')' if name != 'as built' else ''} {ms:.4f}")
        print(f"[split] {card}: {what} ([5, {K}, {W}], {L} levels), ms: " + ", ".join(times),
              flush=True)
        if leaf:
            turns = {name: [] for name in ("as built", "tail without the min-blocks bound")}
            for name in ("as built", "tail without the min-blocks bound",
                         "tail without the min-blocks bound", "as built"):
                turns[name].append(kernel_ms(
                    lambda: launch(libs[name], leaf, st, scw, tcw, fcw, out, rule)))
            print(f"[bound] {card}: {what} at d={rule}, ms in turns: " + "; ".join(
                f"{name} {a:.4f} / {b:.4f}" for name, (a, b) in turns.items()), flush=True)
        del st, scw, tcw, fcw, want, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
