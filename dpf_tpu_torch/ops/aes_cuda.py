"""The compat profile's AES-MMO kernels on bit-major planes, for Hopper.

The port's counterpart of ``dpf_tpu/ops/aes_pallas.py`` (its bit-major
family).  Two wrappers, each beside its plain PyTorch version:

- :func:`prg_planes_bm` (``csrc/aes_mmo.cu::prg_bm_kernel``, replacing
  ``_prg_kernel_bm``): the DPF PRG, both fixed-key MMOs, bit-major planes in
  and out;
- :func:`mmo_planes_bm_canon` (``mmo_bm_canon_kernel``, replacing
  ``_mmo_canon_kernel_bm``): the leaf convert, bit-major in, canonical plane
  order out.

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches the kernel or raises.  Each counts its kernel launches in its
``launches`` attribute, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build
from .aes_bitslice import (
    RK_MASKS_L,
    RK_MASKS_R,
    aes128_mmo_planes,
    permute_planes,
    prg_planes,
)

# Bit-major plane order p' = 16*bit + byte (canonical is p = 8*byte + bit):
# every S-box input/output plane of one byte position is a fixed register in
# the kernel.  Plane 0 (the control-bit plane, byte 0 bit 0) is index 0 in
# both orders, so the evaluator's t-bit handling is order-agnostic.
_TO_BM = [8 * (p % 16) + p // 16 for p in range(128)]  # S_bm = S[_TO_BM]
_FROM_BM = [16 * (p % 8) + p // 8 for p in range(128)]  # S = S_bm[_FROM_BM]
# Both fixed-key round-key mask sets in bit-major order, uint32[2, 11, 128];
# gen_sbox.py writes them into the kernels' __constant__ table.
_RK_BOTH_BM = np.ascontiguousarray(np.stack([RK_MASKS_L, RK_MASKS_R])[:, :, _TO_BM])


def prg_planes_bm_plain(S: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`prg_planes_bm`: canonical PRG between the
    two plane-order permutes."""
    L, R = prg_planes(permute_planes(S, _FROM_BM))
    return permute_planes(L, _TO_BM), permute_planes(R, _TO_BM)


def mmo_planes_bm_canon_plain(S: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`mmo_planes_bm_canon`."""
    return aes128_mmo_planes(permute_planes(S, _FROM_BM), RK_MASKS_L)


def _check_planes(S: torch.Tensor) -> None:
    """Raise on what the kernels do not take."""
    if S.device.type != "cuda":
        raise ValueError(f"expected a CUDA or CPU tensor, got {S.device}")
    if S.dtype != torch.int32:
        raise TypeError(f"expected int32 planes, got {S.dtype}")
    if S.dim() != 2 or S.shape[0] != 128 or S.shape[1] < 1:
        raise ValueError(f"expected planes [128, B >= 1], got {list(S.shape)}")
    if not S.is_contiguous():
        raise ValueError("planes must be contiguous")


def _launch(cfn, kernel: str, S: torch.Tensor, outs) -> None:
    """Launch ``cfn`` on S's device and current stream; raise on its error."""
    with torch.cuda.device(S.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = cfn(S.data_ptr(), *(o.data_ptr() for o in outs), S.shape[1], stream)
    if rc:
        msg = build.load("aes_mmo").dpf_error_string(rc).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} ({msg})")


def prg_planes_bm(S: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """PRG on BIT-MAJOR planes int32[128, B] -> (L, R), also bit-major.
    Contract of ``dpf_tpu.ops.aes_pallas.prg_planes_pallas_bm``."""
    if S.device.type == "cpu":
        return prg_planes_bm_plain(S)
    _check_planes(S)
    L, R = torch.empty_like(S), torch.empty_like(S)
    _launch(build.load("aes_mmo").dpf_prg_bm, "prg_bm_kernel", S, (L, R))
    prg_planes_bm.launches += 1
    return L, R


prg_planes_bm.launches = 0


def mmo_planes_bm_canon(S: torch.Tensor) -> torch.Tensor:
    """Leaf-convert MMO on BIT-MAJOR planes -> CANONICAL-order planes.
    Contract of ``dpf_tpu.ops.aes_pallas.mmo_planes_pallas_bm_canon``."""
    if S.device.type == "cpu":
        return mmo_planes_bm_canon_plain(S)
    _check_planes(S)
    O = torch.empty_like(S)
    _launch(build.load("aes_mmo").dpf_mmo_bm_canon, "mmo_bm_canon_kernel", S, (O,))
    mmo_planes_bm_canon.launches += 1
    return O


mmo_planes_bm_canon.launches = 0
