"""Generate ``csrc/sbox_bp113.cuh``: the CUDA kernels' S-box and round keys.

The header carries the Boyar-Peralta S-box (``sbox_circuit.sbox_bp113``)
with masked outputs and one column of MixColumns as LOP3 instructions, the
lists of ``op_count.lop3_program`` (:func:`lop3_function`), so the kernels
run the counted cover; nothing is copied by hand.  It carries the round-key
masks of both fixed PRF keys moved to the S-box outputs
(``aes_cuda._RK_SBOX``).  The generated header is committed;
``tests/port/test_torch_boundary.py`` checks that it is up to date.

Regenerate with ``python -m dpf_tpu_torch.ops.gen_sbox``.
"""

from __future__ import annotations

from pathlib import Path

from . import op_count
from .aes_cuda import _RK_SBOX

HEADER_PATH = Path(__file__).parent / "csrc" / "sbox_bp113.cuh"


def lop3_function(name: str, params: str, circuit, inputs: list[str],
                  outputs: list[str]) -> str:
    """A C function that computes ``circuit``'s outputs with the LOP3
    instructions of ``op_count.lop3_program``: input node i is
    ``inputs[i]``, output j is assigned to ``outputs[j]``."""
    dag, outs = circuit()
    program = op_count.lop3_program(dag, outs)
    name_of = {n: inputs[key[1]] for n, key in enumerate(dag.nodes) if key[0] == "in"}
    body = []
    for dst, (a, b, c), imm in program:
        name_of[dst] = f"v{dst}"
        if (a, b, c, imm) == (a, a, a, 0xF0):
            body.append(f"  const uint32_t v{dst} = {name_of[a]};")
        else:
            body.append(f"  const uint32_t v{dst} = lop3<0x{imm:02x}>("
                        f"{name_of[a]}, {name_of[b]}, {name_of[c]});")
    body += [f"  {o} = {name_of[s.n]};" for o, s in zip(outputs, outs)]
    count = op_count.lop3_cover(dag, outs)
    return (f"// {count} LOP3 (ops/op_count.py's cover).\n"
            f"__host__ __device__ __forceinline__ void {name}({params}) {{\n"
            + "\n".join(body) + "\n}\n")


def _mask_table(masks) -> str:
    """uint32[2, 11, 128] masks as a C initializer."""
    keys = []
    for key in range(2):
        rows = []
        for rnd in range(11):
            words = [f"0x{int(w):08x}u" for w in masks[key, rnd]]
            chunks = ["      " + ", ".join(words[i : i + 8]) for i in range(0, 128, 8)]
            rows.append("    {\n" + ",\n".join(chunks) + "}")
        keys.append("  {\n" + ",\n".join(rows) + "}")
    return ",\n".join(keys)


def generate() -> str:
    """The text of ``csrc/sbox_bp113.cuh``."""
    sbox = _mask_table(_RK_SBOX)
    sbox_masked = lop3_function(
        "sbox_bp113_masked", "const uint32_t x[8], const uint32_t m[8], uint32_t y[8]",
        op_count.masked_sbox_circuit,
        [f"x[{i}]" for i in range(8)] + [f"m[{i}]" for i in range(8)],
        [f"y[{i}]" for i in range(8)])
    mix_column = lop3_function(
        "mix_column_lop3", "const uint32_t a[32], uint32_t o[32]", op_count.mix_column_circuit,
        [f"a[{i}]" for i in range(32)], [f"o[{i}]" for i in range(32)])
    return f"""\
// Generated by dpf_tpu_torch/ops/gen_sbox.py -- do not edit.
// Regenerate: python -m dpf_tpu_torch.ops.gen_sbox
#pragma once
#include <cstdint>

// d = f(a, b, c) for the three-input function whose truth table is kLut
// (bit 4 a + 2 b + c): one LOP3.  The host build evaluates the table.
template <int kLut>
__host__ __device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {{
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, %4;" : "=r"(d) : "r"(a), "r"(b), "r"(c), "n"(kLut));
  return d;
#else
  uint32_t d = 0;
  for (int i = 0; i < 8; ++i)
    if ((kLut >> i) & 1) d |= (i & 4 ? a : ~a) & (i & 2 ? b : ~b) & (i & 1 ? c : ~c);
  return d;
#endif
}}

// The Boyar-Peralta S-box (sbox_circuit.sbox_bp113) with y[i] ^= m[i] on
// its outputs.  MSB-first: x[0] is the most significant input bit, y[0]
// the output's.
{sbox_masked}
// MixColumns of one column, a[8 * row + bit] -> o[8 * row + bit]:
// o_r = a_r ^ t ^ xtime(a_r ^ a_(r+1)), t the XOR of the four rows.
{mix_column}
// The round keys of the two fixed PRF keys (reference dpf/dpf.go:23-24)
// moved to the S-box outputs, for aes_bm.cuh's folded cipher: [key L/R]
// [round][canonical plane 8*byte + bit], each 0 or ~0.  Round 0 is the key
// itself, XORed into the input; round r = 1..9 is
// InvShiftRows(InvMixColumns(key r)) and round 10 InvShiftRows(key 10),
// XORed into round r's S-box outputs.
__device__ const uint32_t RK_SBOX[2][11][128] = {{
{sbox}}};
"""


def main() -> None:
    HEADER_PATH.write_text(generate())
    print(f"wrote {HEADER_PATH}")


if __name__ == "__main__":
    main()
