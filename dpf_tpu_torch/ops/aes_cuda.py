"""The compat profile's AES-MMO kernels on bitsliced planes, for Hopper.

The port's counterpart of ``dpf_tpu/ops/aes_pallas.py``.  Seven wrappers,
each beside its plain PyTorch version:

- :func:`prg_planes_bm` (``csrc/aes_mmo.cu::prg_bm_kernel``, replacing
  ``_prg_kernel_bm``): the DPF PRG, both fixed-key MMOs, bit-major planes in
  and out;
- :func:`convert_leaves_bm` (``leaf_words_bm_kernel``, replacing
  ``_mmo_canon_kernel_bm`` and the two steps after it in
  ``dpf_tpu/models/dpf.py::_convert_leaves`` / ``_convert_leaves_fused``):
  the leaf convert from bit-major planes, the final CW under t, and the
  per-key output words;
- :func:`prg_planes_canon` and :func:`convert_leaves_canon`
  (``prg_canon_kernel``, ``leaf_words_canon_kernel``, replacing
  ``_prg_kernel`` and ``_mmo_kernel``): the same PRG and leaf convert from
  canonical planes;
- :func:`prg_planes_bm_il` (``prg_bm_il_kernel``, replacing
  ``_prg_kernel_bm_il``): the bit-major PRG, which the TPU kernel computed
  with both encryptions advancing together; here ``prg_bm_kernel``'s block,
  one warp a key;
- :func:`fused_levels_planes` (``csrc/aes_fused.cu::fused_levels_bm_kernel``,
  replacing ``_fused_levels_kernel_bm``): up to :data:`FUSE_MAX_LEVELS` GGM
  levels in one launch, children stored in ascending node order;
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
    _mix_columns,
    _shift_rows,
    aes128_mmo_planes,
    from_carrier,
    permute_planes,
    prg_planes,
    to_carrier,
    unpack_planes,
)

# Bit-major plane order p' = 16*bit + byte (canonical is p = 8*byte + bit):
# every S-box input/output plane of one byte position is a fixed register in
# the kernel.  Plane 0 (the control-bit plane, byte 0 bit 0) is index 0 in
# both orders, so the evaluator's t-bit handling is order-agnostic.
_TO_BM = [8 * (p % 16) + p // 16 for p in range(128)]  # S_bm = S[_TO_BM]
_FROM_BM = [16 * (p % 8) + p // 8 for p in range(128)]  # S = S_bm[_FROM_BM]


def sbox_output_masks(rk_masks: np.ndarray) -> np.ndarray:
    """Round-key masks uint32[11, 128] (canonical planes) moved to the S-box
    outputs: round 0 as it is (XORed into the input), round r = 1..9 through
    InvMixColumns then InvShiftRows, round 10 through InvShiftRows.  XORing
    mask r into round r's S-box outputs leaves the state after ShiftRows and
    MixColumns as XORing round key r after them does: both are linear, and
    a mask plane is 0 or ~0 in every lane.  MixColumns^4 and ShiftRows^4 are
    the identity, so the inverses are the third powers."""
    out = np.array(rk_masks, dtype=np.uint32)
    for rnd in range(1, 11):
        m = to_carrier(out[rnd][:, None])
        for _ in range(3 if rnd < 10 else 0):
            m = _mix_columns(m)
        for _ in range(3):
            m = _shift_rows(m)
        out[rnd] = from_carrier(m)[:, 0]
    return out


# Both keys' S-box-output masks, uint32[2, 11, 128] canonical; gen_sbox.py
# writes them into the kernels' table RK_SBOX.
_RK_SBOX = np.stack([sbox_output_masks(RK_MASKS_L), sbox_output_masks(RK_MASKS_R)])


def prg_planes_bm_plain(S: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`prg_planes_bm`: canonical PRG between the
    two plane-order permutes."""
    L, R = prg_planes(permute_planes(S, _FROM_BM))
    return permute_planes(L, _TO_BM), permute_planes(R, _TO_BM)


def mmo_planes_bm_canon_plain(S: torch.Tensor) -> torch.Tensor:
    """The leaf MMO (key L) on BIT-MAJOR planes [128, B] -> CANONICAL-order
    planes: the first step of :func:`convert_leaves_bm_plain`."""
    return aes128_mmo_planes(permute_planes(S, _FROM_BM), RK_MASKS_L)


def prg_planes_canon_plain(S: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`prg_planes_canon`."""
    return prg_planes(S)


def mmo_planes_canon_plain(S: torch.Tensor) -> torch.Tensor:
    """The leaf MMO (key L) on CANONICAL-order planes [128, B], canonical
    out: the first step of :func:`convert_leaves_canon_plain`."""
    return aes128_mmo_planes(S, RK_MASKS_L)


# Plain version of :func:`prg_planes_bm_il`: the interleaving changes the
# schedule, not the function.
prg_planes_bm_il_plain = prg_planes_bm_plain


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


def prg_planes_canon(S: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """PRG on CANONICAL-order planes int32[128, B] -> (L, R), canonical.
    Contract of ``dpf_tpu.ops.aes_pallas.prg_planes_pallas``, for any B."""
    if S.device.type == "cpu":
        return prg_planes_canon_plain(S)
    _check_planes(S)
    L, R = torch.empty_like(S), torch.empty_like(S)
    _launch(build.load("aes_mmo").dpf_prg_canon, "prg_canon_kernel", S, (L, R))
    prg_planes_canon.launches += 1
    return L, R


prg_planes_canon.launches = 0


def prg_planes_bm_il(S: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Interleaved PRG on BIT-MAJOR planes: :func:`prg_planes_bm`'s output,
    by the same block of two warps, one a key, from a kernel of its own.
    Contract of ``dpf_tpu.ops.aes_pallas.prg_planes_pallas_bm_il``, for any
    B."""
    if S.device.type == "cpu":
        return prg_planes_bm_il_plain(S)
    _check_planes(S)
    L, R = torch.empty_like(S), torch.empty_like(S)
    _launch(build.load("aes_mmo").dpf_prg_bm_il, "prg_bm_il_kernel", S, (L, R))
    prg_planes_bm_il.launches += 1
    return L, R


prg_planes_bm_il.launches = 0


def _leaf_words_plain(mmo, S, T, fcw_planes, node_minor, out, leaf_offset):
    """The leaf convert as the JAX package runs it: ``mmo`` on the planes,
    the final CW under t, ``unpack_planes``; then, given ``out``, the words
    into its leaves ``leaf_offset ..``."""
    C = mmo(S.reshape(128, -1)).view(S.shape)
    if node_minor:
        C ^= fcw_planes.transpose(1, 2) & T[None]
        C = C.transpose(1, 2)
    else:
        C ^= fcw_planes & T[None]
    words = unpack_planes(C)
    if out is None:
        return words
    out[:, leaf_offset : leaf_offset + words.shape[1]] = words
    return out


def convert_leaves_bm_plain(S, T, fcw_planes, *, node_minor=False, out=None, leaf_offset=0):
    """Plain version of :func:`convert_leaves_bm`."""
    return _leaf_words_plain(mmo_planes_bm_canon_plain, S, T, fcw_planes, node_minor, out,
                             leaf_offset)


def convert_leaves_canon_plain(S, T, fcw_planes, *, node_minor=False, out=None,
                               leaf_offset=0):
    """Plain version of :func:`convert_leaves_canon`."""
    return _leaf_words_plain(mmo_planes_canon_plain, S, T, fcw_planes, node_minor, out,
                             leaf_offset)


def _leaf_words(cfn: str, kernel: str, S, T, fcw_planes, node_minor, out, leaf_offset):
    """Check the leaf convert's operands and launch ``kernel`` -> out."""
    if S.device.type != "cuda":
        raise ValueError(f"expected a CUDA or CPU tensor, got {S.device}")
    if S.dim() != 3 or S.shape[0] != 128:
        raise ValueError(f"S: expected [128, W, Kp] or [128, Kp, W], got {list(S.shape)}")
    kp, W = S.shape[1:] if node_minor else reversed(S.shape[1:])
    if kp < 1 or W < 1:
        raise ValueError(f"leaf convert: needs W, Kp >= 1; got {W}, {kp}")
    dev = S.device
    for name, x, shape in (("S", S, S.shape), ("T", T, S.shape[1:]),
                           ("fcw_planes", fcw_planes, (128, 1, kp))):
        _check_walk_operand(name, x, shape, dev)
    if out is None:
        if leaf_offset:
            raise ValueError("leaf_offset needs out")
        out = torch.empty((32 * kp, W, 4), dtype=torch.int32, device=dev)
    else:
        if out.dim() != 3 or out.shape[0] != 32 * kp or out.shape[2] != 4:
            raise ValueError(f"out: expected [{32 * kp}, leaves, 4], got {list(out.shape)}")
        _check_walk_operand("out", out, out.shape, dev)
        if out.data_ptr() % 16:
            raise ValueError("out: the kernel stores 16 B a key and leaf; needs 16 B alignment")
        if not 0 <= leaf_offset <= out.shape[1] - W:
            raise ValueError(f"out: leaves {leaf_offset} .. {leaf_offset + W} of "
                             f"{out.shape[1]}")
    lib = build.load("aes_mmo")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, cfn)(S.data_ptr(), T.data_ptr(), fcw_planes.data_ptr(),
                               out.data_ptr(), W, kp, int(node_minor), out.shape[1],
                               leaf_offset, stream)
    if rc:
        msg = lib.dpf_error_string(rc).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} ({msg})")
    return out


def convert_leaves_bm(S, T, fcw_planes, *, node_minor=False, out=None, leaf_offset=0):
    """The leaf convert from BIT-MAJOR leaf planes: AES_kL(S) ^ S in
    canonical order, the final CW under t, unpacked to per-key words.
    S int32[128, W, Kp] with T [W, Kp] (the level-major state), or with
    ``node_minor`` S [128, Kp, W] and T [Kp, W] (the fused route's);
    fcw_planes [128, 1, Kp], canonical -> int32[32 Kp, W, 4], or, given
    ``out`` [32 Kp, leaves, 4], the words written into its leaves
    ``leaf_offset .. leaf_offset + W`` and ``out`` returned.  What the
    reference's ``_convert_leaves`` (``_convert_leaves_fused`` for the
    node-minor layout) returns with backend ``pallas_bm``, for any W, Kp
    >= 1."""
    if S.device.type == "cpu":
        return convert_leaves_bm_plain(S, T, fcw_planes, node_minor=node_minor, out=out,
                                       leaf_offset=leaf_offset)
    out = _leaf_words("dpf_leaf_words_bm", "leaf_words_bm_kernel", S, T, fcw_planes,
                      node_minor, out, leaf_offset)
    convert_leaves_bm.launches += 1
    return out


convert_leaves_bm.launches = 0


def convert_leaves_canon(S, T, fcw_planes, *, node_minor=False, out=None, leaf_offset=0):
    """:func:`convert_leaves_bm` from CANONICAL-order leaf planes: the
    reference's ``_convert_leaves`` with backends ``pallas`` and ``xla``."""
    if S.device.type == "cpu":
        return convert_leaves_canon_plain(S, T, fcw_planes, node_minor=node_minor,
                                          out=out, leaf_offset=leaf_offset)
    out = _leaf_words("dpf_leaf_words_canon", "leaf_words_canon_kernel", S, T, fcw_planes,
                      node_minor, out, leaf_offset)
    convert_leaves_canon.launches += 1
    return out


convert_leaves_canon.launches = 0


# Levels one fused launch runs at most (aes_fused.cu's kFusedMaxG): its walk
# recomputes the upper levels of a group per path, 4/3 of the tree's MMOs at
# 4 levels, more above; a longer group splits into launches of at most this.
FUSE_MAX_LEVELS = 4


def fused_levels_planes_plain(S, T, scw_bm, tl_w, tr_w):
    """Plain version of :func:`fused_levels_planes`: the evaluator's level
    step, once a level, on the node-minor layout."""
    for i in range(scw_bm.shape[0]):
        kp, W = T.shape
        L, R = (x.view(128, kp, W) for x in prg_planes_bm_plain(S.reshape(128, -1)))
        tl, tr = L[0].clone(), R[0].clone()
        L[0] = 0
        R[0] = 0
        cw = scw_bm[i][:, :, None] & T[None]  # the CW where the parent t is set
        L ^= cw
        R ^= cw
        tl ^= tl_w[i][:, None] & T
        tr ^= tr_w[i][:, None] & T
        S = torch.stack([L, R], dim=3).reshape(128, kp, 2 * W)
        T = torch.stack([tl, tr], dim=2).reshape(kp, 2 * W)
    return S, T


def fused_levels_planes(S, T, scw_bm, tl_w, tr_w):
    """``g = scw_bm.shape[0]`` consecutive GGM levels from node-minor
    bit-major state: S int32[128, Kp, W], T int32[Kp, W], scw_bm
    int32[g, 128, Kp], tl_w / tr_w int32[g, Kp] -> (S' [128, Kp, W << g],
    T' [Kp, W << g]), children in ascending node order.  What the
    reference's ``fused_levels_planes`` and ``fused_deinterleave`` return
    together, for any Kp, W >= 1; one launch per :data:`FUSE_MAX_LEVELS`
    levels."""
    if S.device.type == "cpu":
        return fused_levels_planes_plain(S, T, scw_bm, tl_w, tr_w)
    if S.device.type != "cuda":
        raise ValueError(f"expected a CUDA or CPU tensor, got {S.device}")
    if S.dim() != 3 or S.shape[0] != 128:
        raise ValueError(f"S: expected [128, Kp, W], got {list(S.shape)}")
    kp, W = S.shape[1:]
    g = scw_bm.shape[0]
    if kp < 1 or W < 1 or g < 1:
        raise ValueError(f"fused levels: needs Kp, W, g >= 1; got {kp}, {W}, {g}")
    dev = S.device
    for name, x, shape in (
        ("S", S, (128, kp, W)), ("T", T, (kp, W)), ("scw_bm", scw_bm, (g, 128, kp)),
        ("tl_w", tl_w, (g, kp)), ("tr_w", tr_w, (g, kp)),
    ):
        _check_walk_operand(name, x, shape, dev)
    lib = build.load("aes_fused")
    for first in range(0, g, FUSE_MAX_LEVELS):
        n = min(FUSE_MAX_LEVELS, g - first)
        w = S.shape[2]
        So = torch.empty((128, kp, w << n), dtype=torch.int32, device=dev)
        To = torch.empty((kp, w << n), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.dpf_fused_bm(
                *(x.data_ptr() for x in (S, T, scw_bm[first : first + n],
                                         tl_w[first : first + n],
                                         tr_w[first : first + n], So, To)),
                kp, w, n, stream,
            )
        if rc:
            msg = lib.dpf_fused_error_string(rc).decode()
            raise RuntimeError(f"fused_levels_bm_kernel launch failed: CUDA error {rc} ({msg})")
        fused_levels_planes.launches += 1
        S, T = So, To
    return S, T


fused_levels_planes.launches = 0


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
