"""Generate ``csrc/sbox_bp113.cuh``: the CUDA kernels' S-box and round keys.

The S-box circuit is not copied by hand: :func:`trace_circuit` runs
``sbox_circuit.sbox_bp113`` on a small tracer class that records each
``^ & | ~`` as one C statement.  The header also carries the bit-major
round-key masks of both fixed PRF keys (``aes_cuda._RK_BOTH_BM``) as a
``__constant__`` table.  The generated header is committed;
``tests/port/test_torch_boundary.py`` checks that it is up to date.

Regenerate with ``python -m dpf_tpu_torch.ops.gen_sbox``.
"""

from __future__ import annotations

from pathlib import Path

from .aes_cuda import _RK_BOTH_BM
from .sbox_circuit import sbox_bp113

HEADER_PATH = Path(__file__).parent / "csrc" / "sbox_bp113.cuh"


class _Sym:
    """A named 32-bit value; each operator appends one C statement."""

    def __init__(self, tracer: "_Tracer", name: str):
        self.tracer = tracer
        self.name = name

    def __xor__(self, other: "_Sym") -> "_Sym":
        return self.tracer.emit(f"{self.name} ^ {other.name}")

    def __and__(self, other: "_Sym") -> "_Sym":
        return self.tracer.emit(f"{self.name} & {other.name}")

    def __or__(self, other: "_Sym") -> "_Sym":
        return self.tracer.emit(f"{self.name} | {other.name}")

    def __invert__(self) -> "_Sym":
        return self.tracer.emit(f"~{self.name}")


class _Tracer:
    def __init__(self):
        self.lines: list[str] = []

    def emit(self, expr: str) -> _Sym:
        name = f"v{len(self.lines)}"
        self.lines.append(f"const uint32_t {name} = {expr};")
        return _Sym(self, name)


def trace_circuit() -> tuple[list[str], list[str]]:
    """Run ``sbox_bp113`` on symbols x[0..7] -> (statements, output names).
    Every statement is one 32-bit logical operation."""
    tr = _Tracer()
    outs = sbox_bp113([_Sym(tr, f"x[{i}]") for i in range(8)])
    return tr.lines, [o.name for o in outs]


def generate() -> str:
    """The text of ``csrc/sbox_bp113.cuh``."""
    lines, outs = trace_circuit()
    counts = {op: sum(op in s for s in lines) for op in "&^~"}
    body = "\n".join(f"  {s}" for s in lines)
    assign = "\n".join(f"  y[{i}] = {o};" for i, o in enumerate(outs))
    rk = []
    for key in range(2):
        rows = []
        for rnd in range(11):
            words = [f"0x{int(w):08x}u" for w in _RK_BOTH_BM[key, rnd]]
            chunks = [
                "      " + ", ".join(words[i : i + 8]) for i in range(0, 128, 8)
            ]
            rows.append("    {\n" + ",\n".join(chunks) + "}")
        rk.append("  {\n" + ",\n".join(rows) + "}")
    return f"""\
// Generated by dpf_tpu_torch/ops/gen_sbox.py -- do not edit.
// Regenerate: python -m dpf_tpu_torch.ops.gen_sbox
#pragma once
#include <cstdint>

// Boyar-Peralta AES S-box (sbox_circuit.sbox_bp113), traced to {len(lines)}
// 32-bit logical operations: {counts['&']} AND, {counts['^']} XOR, {counts['~']} NOT (each XNOR is XOR then NOT).
// MSB-first: x[0] is the most significant input bit, y[0] the output's.
__host__ __device__ __forceinline__ void sbox_bp113(const uint32_t x[8],
                                                    uint32_t y[8]) {{
{body}
{assign}
}}

// Round-key masks of the two fixed PRF keys (reference dpf/dpf.go:23-24),
// [key L/R][round][bit-major plane 16*bit + byte], each 0 or ~0.
__constant__ uint32_t RK_BM[2][11][128] = {{
{",\n".join(rk)}}};
"""


def main() -> None:
    HEADER_PATH.write_text(generate())
    print(f"wrote {HEADER_PATH}")


if __name__ == "__main__":
    main()
