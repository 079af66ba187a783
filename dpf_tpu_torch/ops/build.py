"""Build the port's CUDA kernels at first use and bind them with ctypes.

``nvcc`` compiles ``csrc/aes_mmo.cu`` (plain C interface, no PyTorch
headers) into a shared library under ``build/`` beside the package, named by
a hash of the sources and flags, so an unchanged tree reuses its build.
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
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
SOURCE = CSRC / "aes_mmo.cu"
HEADERS = (CSRC / "sbox_bp113.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dpf_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_BUILD_TIMEOUT_S = 600


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _stem() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCE, *HEADERS):
        h.update(f.read_bytes())
    return f"{SOURCE.stem}-{h.hexdigest()[:16]}"


def library_path() -> Path:
    """Compile the kernels unless this tree's build exists; return the .so."""
    stem = _stem()
    lib = BUILD_DIR / f"{stem}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{stem}.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(
        cmd, capture_output=True, text=True, timeout=_BUILD_TIMEOUT_S
    )
    if proc.returncode:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    (BUILD_DIR / f"{stem}.ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """The built kernels' library, with every C function's signature set."""
    lib = ctypes.CDLL(str(library_path()))
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.dpf_prg_bm.argtypes = [vp, vp, vp, ll, vp]
    lib.dpf_prg_bm.restype = ctypes.c_int
    lib.dpf_mmo_bm_canon.argtypes = [vp, vp, ll, vp]
    lib.dpf_mmo_bm_canon.restype = ctypes.c_int
    lib.dpf_error_string.argtypes = [ctypes.c_int]
    lib.dpf_error_string.restype = ctypes.c_char_p
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
    """:func:`parse_ptxas` of this tree's build log."""
    return parse_ptxas((BUILD_DIR / f"{_stem()}.ptxas.txt").read_text())


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
    """:func:`parse_sass` of this tree's built library."""
    cuobjdump = Path(_nvcc()).with_name("cuobjdump")
    proc = subprocess.run(
        [str(cuobjdump), "-sass", str(library_path())],
        capture_output=True, text=True, timeout=120, check=True,
    )
    return parse_sass(proc.stdout)
