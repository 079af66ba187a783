"""The compat profile's AES-MMO kernels on bit-major planes, for Hopper.

The port's counterpart of ``dpf_tpu/ops/aes_pallas.py`` (its bit-major
family).  Three wrappers, each beside its plain PyTorch version:

- :func:`prg_planes_bm` (``csrc/aes_mmo.cu::prg_bm_kernel``, replacing
  ``_prg_kernel_bm``): the DPF PRG, both fixed-key MMOs, bit-major planes in
  and out;
- :func:`mmo_planes_bm_canon` (``mmo_bm_canon_kernel``, replacing
  ``_mmo_canon_kernel_bm``): the leaf convert, bit-major in, canonical plane
  order out;
- :func:`eval_points_walk_planes` (``csrc/aes_walk.cu::walk_bm_kernel``,
  replacing ``_walk_kernel_bm``): the whole pointwise walk of 32 queries of
  one key per column word, packed output bits.

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


def _fold(x: torch.Tensor, op) -> torch.Tensor:
    """``op``-reduce ``x`` over its first axis as a tree of ``log2`` steps
    (torch has no bitwise reductions)."""
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        y = op(x[:half], x[half : 2 * half])
        x = torch.cat([y, x[2 * half :]]) if x.shape[0] % 2 else y
    return x[0]


def eval_points_walk_planes_plain(seeds_bm, t_words, scw_bm, tl_w, tr_w,
                                  fcw_canon, pw, sel, nu: int) -> torch.Tensor:
    """Plain version of :func:`eval_points_walk_planes`: the Pallas kernel's
    steps on the whole ``[128, K, qp]`` state, the PRG and leaf MMO by the
    plain bit-major versions above."""
    K, qp = sel.shape[1:]
    S = seeds_bm[:, :, None].expand(128, K, qp)
    T = t_words[:, None].expand(K, qp)
    for i in range(nu):
        L, R = (x.view(128, K, qp) for x in prg_planes_bm_plain(S.reshape(128, -1)))
        tl, tr = L[0].clone(), R[0].clone()
        L[0] = 0
        R[0] = 0
        cwm = scw_bm[i][:, :, None] & T[None]
        L ^= cwm
        R ^= cwm
        tl ^= tl_w[i][:, None] & T
        tr ^= tr_w[i][:, None] & T
        go = pw[i]
        S = (R & go) | (L & ~go)
        T = (tr & go) | (tl & ~go)
    C = mmo_planes_bm_canon_plain(S.reshape(128, -1)).view(128, K, qp)
    C ^= fcw_canon[:, :, None] & T[None]
    return _fold(C & sel, torch.bitwise_or)


def _check_walk_operand(name, x, shape, dev) -> None:
    if x.device != dev:
        raise ValueError(f"{name}: expected a tensor on {dev}, got {x.device}")
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {list(shape)}, got {list(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def eval_points_walk_planes(seeds_bm, t_words, scw_bm, tl_w, tr_w, fcw_canon,
                            pw, sel, nu: int) -> torch.Tensor:
    """Whole-walk pointwise evaluation from prepared operands, all int32
    carriers: seeds_bm [128, K] (bit-major), t_words [K], scw_bm
    [nu, 128, K] (bit-major), tl_w / tr_w [nu, K] (every key word a 0/~0
    lane mask), fcw_canon [128, K] (canonical), pw [nu, K, qp] packed path
    words, sel [128, K, qp] leaf-select one-hot -> [K, qp] packed output
    bits.  Contract of ``dpf_tpu.ops.aes_pallas.eval_points_walk_planes``,
    for any K >= 1 and qp >= 1 (no key padding)."""
    if sel.device.type == "cpu":
        return eval_points_walk_planes_plain(
            seeds_bm, t_words, scw_bm, tl_w, tr_w, fcw_canon, pw, sel, nu
        )
    if sel.device.type != "cuda":
        raise ValueError(f"expected a CUDA or CPU tensor, got {sel.device}")
    if sel.dim() != 3 or sel.shape[0] != 128:
        raise ValueError(f"sel: expected [128, K, qp], got {list(sel.shape)}")
    K, qp = sel.shape[1:]
    if K < 1 or qp < 1 or nu < 0:
        raise ValueError(f"walk: needs K >= 1, qp >= 1, nu >= 0; got {K}, {qp}, {nu}")
    if -(-qp // 32) > 65535:
        raise ValueError(f"walk: qp = {qp} query words per key; the grid takes "
                         f"at most {65535 * 32}")
    dev = sel.device
    for name, x, shape in (
        ("seeds_bm", seeds_bm, (128, K)), ("t_words", t_words, (K,)),
        ("scw_bm", scw_bm, (nu, 128, K)), ("tl_w", tl_w, (nu, K)),
        ("tr_w", tr_w, (nu, K)), ("fcw_canon", fcw_canon, (128, K)),
        ("pw", pw, (nu, K, qp)), ("sel", sel, (128, K, qp)),
    ):
        _check_walk_operand(name, x, shape, dev)
    out = torch.empty((K, qp), dtype=torch.int32, device=dev)
    lib = build.load("aes_walk")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.dpf_walk_bm(
            *(x.data_ptr() for x in (seeds_bm, t_words, scw_bm, tl_w, tr_w,
                                     fcw_canon, pw, sel, out)),
            K, qp, nu, stream,
        )
    if rc:
        msg = lib.dpf_walk_bm_error_string(rc).decode()
        raise RuntimeError(f"walk_bm_kernel launch failed: CUDA error {rc} ({msg})")
    eval_points_walk_planes.launches += 1
    return out


eval_points_walk_planes.launches = 0
