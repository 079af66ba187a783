"""Build the port's CUDA kernels at first use and bind them with ctypes.

``nvcc`` compiles each source of :data:`LIBRARIES` (``csrc/aes_mmo.cu``,
``csrc/aes_walk.cu``, ``csrc/chacha_expand.cu``, ``csrc/chacha_walk.cu``;
plain C interfaces, no PyTorch headers) into a
shared library of its own under ``build/`` beside the package, named by a
hash of its source, headers and flags, so an unchanged tree reuses its
build.  :func:`build_all` runs the nvcc processes side by side.
``-Xptxas -v`` output (registers, spills per kernel) is kept beside the
library; :func:`ptxas_report` parses it, and :func:`sass_report` counts the
built kernels' machine instructions.  Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
# Library name -> (its source, the headers it includes).  Each source builds
# into a library of its own, all of them in parallel (one nvcc each).
LIBRARIES = {
    "aes_mmo": (CSRC / "aes_mmo.cu", (CSRC / "aes_bm.cuh", CSRC / "sbox_bp113.cuh")),
    "aes_walk": (CSRC / "aes_walk.cu", (CSRC / "aes_bm.cuh", CSRC / "sbox_bp113.cuh")),
    "chacha_expand": (CSRC / "chacha_expand.cu", (CSRC / "chacha12.cuh",)),
    "chacha_walk": (CSRC / "chacha_walk.cu", (CSRC / "chacha12.cuh",)),
}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dpf_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_BUILD_TIMEOUT_S = 600

_vp, _ll, _int = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# Library name -> {C function: (argtypes, restype)}.
_SIGNATURES = {
    "aes_mmo": {
        "dpf_prg_bm": ([_vp, _vp, _vp, _ll, _vp], _int),
        "dpf_mmo_bm_canon": ([_vp, _vp, _ll, _vp], _int),
        "dpf_error_string": ([_int], ctypes.c_char_p),
    },
    "chacha_expand": {
        # state, its row and key strides, K, W, levels, scw, key stride,
        # tcw, key stride, [fcw, key stride,] out, [row stride,] key stride,
        # stream
        "dpf_chacha_tail": (
            [_vp, _ll, _ll, _ll, _ll, _int, _vp, _ll, _vp, _ll, _vp, _ll,
             _vp, _ll, _vp], _int),
        "dpf_chacha_fused": (
            [_vp, _ll, _ll, _ll, _ll, _int, _vp, _ll, _vp, _ll, _vp, _ll,
             _ll, _vp], _int),
        "dpf_chacha_error_string": ([_int], ctypes.c_char_p),
    },
    "aes_walk": {
        # seeds, t, scw, tl, tr, fcw, pw, sel, out, K, qp, nu, stream
        "dpf_walk_bm": ([_vp] * 9 + [_ll, _ll, _int, _vp], _int),
        "dpf_walk_bm_error_string": ([_int], ctypes.c_char_p),
    },
    "chacha_walk": {
        # meta, seeds, scw, tcw, fcw, xs_lo, xs_hi, out, Q, K, log_n, nu, stream
        "dpf_chacha_walk": ([_vp] * 8 + [_ll, _ll, _int, _int, _vp], _int),
        # meta, seeds, scw, tcw, vcw, fcw, xs_lo, xs_hi, out, Q, K, log_n, nu,
        # stream
        "dpf_chacha_walk_dcf": ([_vp] * 9 + [_ll, _ll, _int, _int, _vp], _int),
        "dpf_chacha_walk_error_string": ([_int], ctypes.c_char_p),
    },
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _stem(name: str) -> str:
    """``name`` plus a hash of its source, headers and the flags."""
    source, headers = LIBRARIES[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (source, *headers):
        h.update(f.read_bytes())
    return f"{name}-{h.hexdigest()[:16]}"


def library_path(name: str) -> Path:
    """Compile library ``name`` unless this tree's build exists; return the
    .so."""
    stem = _stem(name)
    lib = BUILD_DIR / f"{stem}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{stem}.{os.getpid()}.tmp.so"
    source = LIBRARIES[name][0]
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(source)]
    proc = subprocess.run(
        cmd, capture_output=True, text=True, timeout=_BUILD_TIMEOUT_S
    )
    if proc.returncode:
        raise RuntimeError(
            f"nvcc failed on {source.name} ({proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    (BUILD_DIR / f"{stem}.ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def build_all() -> dict[str, Path]:
    """Build every library at once, one nvcc process each."""
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        paths = dict(zip(LIBRARIES, pool.map(library_path, LIBRARIES)))
    return paths


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Library ``name``, built at first use, with its C functions'
    signatures set."""
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, (argtypes, restype) in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def parse_ptxas(text: str) -> dict[str, dict[str, int]]:
    """Per kernel: registers, stack frame and spill bytes from ``-Xptxas -v``
    output."""
    out: dict[str, dict[str, int]] = {}
    kernel = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
            out[kernel] = {}
            continue
        if kernel is None:
            continue
        m = re.search(
            r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
            line,
        )
        if m:
            out[kernel].update(
                stack_bytes=int(m.group(1)),
                spill_store_bytes=int(m.group(2)),
                spill_load_bytes=int(m.group(3)),
            )
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[kernel]["registers"] = int(m.group(1))
    return out


def ptxas_report() -> dict[str, dict[str, int]]:
    """:func:`parse_ptxas` of this tree's build logs, every library."""
    out: dict[str, dict[str, int]] = {}
    for name in LIBRARIES:
        out.update(parse_ptxas((BUILD_DIR / f"{_stem(name)}.ptxas.txt").read_text()))
    return out


def parse_sass(text: str) -> dict[str, Counter]:
    """Per kernel: how often each opcode (``LOP3``, ``LDG``, ...) appears in
    ``cuobjdump -sass`` output.  Static counts: a loop's body counts once."""
    out: dict[str, Counter] = {}
    kernel = None
    for line in text.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            kernel = m.group(1)
            out[kernel] = Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and kernel is not None:
            out[kernel][m.group(1)] += 1
    return out


def sass_report() -> dict[str, Counter]:
    """:func:`parse_sass` of this tree's built libraries."""
    cuobjdump = Path(_nvcc()).with_name("cuobjdump")
    out: dict[str, Counter] = {}
    for name in LIBRARIES:
        proc = subprocess.run(
            [str(cuobjdump), "-sass", str(library_path(name))],
            capture_output=True, text=True, timeout=120, check=True,
        )
        out.update(parse_sass(proc.stdout))
    return out
