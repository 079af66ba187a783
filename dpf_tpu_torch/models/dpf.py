"""Level-synchronous batched full-domain DPF evaluation on bit-planes.

The port's counterpart of the full-domain path of ``dpf_tpu/models/dpf.py``.
Where the reference walks the GGM tree depth-first (dpf/dpf.go:213-262), the
evaluator expands it breadth-first: level ``i`` holds all ``2^i`` nodes of all
``K`` keys as one bitsliced tensor ``int32[128, W, K/32]`` (128 bit-planes,
W nodes, keys packed 32 per word), and one step per level does

    PRG doubling (2 fixed-key bitsliced AES-MMO)     reference dpf.go:229
    control-bit extraction + clearing (plane 0)      reference dpf.go:62-67
    correction-word XOR masked by parent t-bits      reference dpf.go:230-238

The level state is held in bit-major plane order (``aes_cuda._TO_BM``) for
the whole expansion; the leaf convert emits canonical order.  The PRG and the
leaf MMO are the CUDA kernels of ``ops/aes_cuda.py`` on the card and their
plain versions on the CPU; the glue around them is plain PyTorch, as it is
XLA outside Pallas in the JAX package.

Outputs are byte-identical to the reference: leaves emit in ascending index
order (children interleave L,R like the DFS emit order), and each leaf is the
MMO-converted seed XOR the final CW when the control bit is set.  Domains
whose leaf level exceeds ``max_plane_words`` split into independent subtree
chunks, finished one after another.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.keys import KeyBatch
from ..ops.aes_bitslice import (
    from_carrier,
    pack_padded_keys,
    to_carrier,
    unpack_planes,
)
from ..ops.aes_cuda import (
    _TO_BM,
    mmo_planes_bm_canon,
    mmo_planes_bm_canon_plain,
    prg_planes_bm,
    prg_planes_bm_plain,
)

# Soft cap on W * Kp (words per plane) for a single expansion; above this
# the tree is split into independent subtree chunks.  2^19 words/plane ->
# the [128, W, Kp] tensor is 256 MB; a few live at once during a step.
MAX_PLANE_WORDS = 1 << 19

# impl -> (PRG, leaf MMO).  None: the wrappers, which launch the kernels on
# CUDA tensors and run the plain versions on CPU tensors.  "plain": the
# plain versions on any device (chip_smoke.py holds the kernels against it).
_IMPLS = {
    None: (prg_planes_bm, mmo_planes_bm_canon),
    "plain": (prg_planes_bm_plain, mmo_planes_bm_canon_plain),
}


def _resolve_device(device) -> torch.device:
    """``None`` means the card.  Without CUDA, raise unless the caller asked
    for the CPU: the evaluator never moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            'CUDA is not available; pass device="cpu" to evaluate on the CPU'
        )
    return dev


# ---------------------------------------------------------------------------
# Packing of key material into plane/mask form
# ---------------------------------------------------------------------------


def _pack_bits_over_keys(bits: np.ndarray) -> np.ndarray:
    """uint8[..., K] 0/1 -> uint32[..., K//32] packed words."""
    K = bits.shape[-1]
    b = bits.reshape(bits.shape[:-1] + (K // 32, 32)).astype(np.uint32)
    return (b << np.arange(32, dtype=np.uint32)).sum(-1, dtype=np.uint32)


class DeviceKeys:
    """Key material packed for the evaluator, on ``device`` (None: the card).

    K is zero-padded to a multiple of 32, the lane-packing quantum."""

    def __init__(self, kb: KeyBatch, device=None):
        dev = self.device = _resolve_device(device)
        self.nu = kb.nu
        self.k = kb.k
        pad = (-kb.k) % 32
        self.k_padded = kb.k + pad
        kp = self.k_padded // 32

        def padk(a):  # zero-pad the key axis
            return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])

        def pack_words(words):  # uint32[K, N, 4] -> int32[128, N, Kp]
            return pack_padded_keys(to_carrier(words, dev))

        self.seed_planes = pack_words(padk(kb.seeds)[:, None, :])  # [128, 1, Kp]
        self.t_words = to_carrier(_pack_bits_over_keys(padk(kb.ts) & 1)[None, :], dev)
        if self.nu:
            tcw = padk(kb.tcw)
            # scw [K, nu, 4] packs with levels as the "node" axis, then moves
            # levels to the front: [nu, 128, Kp] so scw_planes[i] is level i.
            scw = pack_words(padk(kb.scw)).movedim(1, 0).contiguous()
            scw[:, 0] = 0  # plane 0 (the t bit) of every sCW is 0 by Gen
            self.scw_planes = scw
            self.tl_words = to_carrier(
                _pack_bits_over_keys(np.moveaxis(tcw[:, :, 0] & 1, 0, 1)), dev
            )  # [nu, Kp]
            self.tr_words = to_carrier(
                _pack_bits_over_keys(np.moveaxis(tcw[:, :, 1] & 1, 0, 1)), dev
            )
        else:
            self.scw_planes = torch.zeros((0, 128, kp), dtype=torch.int32, device=dev)
            self.tl_words = torch.zeros((0, kp), dtype=torch.int32, device=dev)
            self.tr_words = torch.zeros((0, kp), dtype=torch.int32, device=dev)
        self.fcw_planes = pack_words(padk(kb.fcw)[:, None, :])  # [128, 1, Kp]


# ---------------------------------------------------------------------------
# Expansion steps
# ---------------------------------------------------------------------------


def _level_step(S, T, cw_plane, tl_w, tr_w, prg):
    """One level of the expansion: [128, W, Kp] -> [128, 2W, Kp].  L and R
    are fresh PRG outputs, so they are updated in place."""
    W = S.shape[1]
    L, R = prg(S.reshape(128, -1))
    L = L.view(128, W, -1)
    R = R.view(128, W, -1)
    tl, tr = L[0].clone(), R[0].clone()
    L[0] = 0
    R[0] = 0
    cw = cw_plane[:, None, :] & T[None, :, :]  # CW where the parent t is set
    L ^= cw
    R ^= cw
    tl ^= tl_w[None, :] & T
    tr ^= tr_w[None, :] & T
    S = torch.stack([L, R], dim=2).reshape(128, 2 * W, -1)
    T = torch.stack([tl, tr], dim=1).reshape(2 * W, -1)
    return S, T


def _convert_leaves(S, T, fcw_planes, mmo):
    """Leaf conversion + final CW: -> per-key output words int32[K, W, 4]."""
    C = mmo(S.reshape(128, -1)).view(S.shape)
    C ^= fcw_planes & T[None, :, :]
    return unpack_planes(C)


def _to_bm(seed_planes, scw_planes):
    """Canonical -> bit-major plane order for the level-state inputs: the
    [128, 1, Kp] seeds and the [nu, 128, Kp] CWs (the leaf convert emits
    canonical order, so the big leaf-level tensors are never permuted)."""
    idx = torch.as_tensor(_TO_BM, dtype=torch.long, device=scw_planes.device)
    return seed_planes.index_select(0, idx), scw_planes.index_select(1, idx)


def _expand(n_levels, first, S, T, scw_planes, tl_w, tr_w, prg):
    """Levels ``first .. first + n_levels - 1``; S and scw_planes bit-major."""
    for i in range(first, first + n_levels):
        S, T = _level_step(S, T, scw_planes[i], tl_w[i], tr_w[i], prg)
    return S, T


def eval_full_device(
    dk: DeviceKeys, max_plane_words: int = MAX_PLANE_WORDS, impl: str | None = None
) -> torch.Tensor:
    """Full-domain evaluation on ``dk.device`` -> int32[K_padded, n_leaves, 4].

    The returned words ARE the bit-packed output: word q of leaf w holds
    domain bits [128*w + 32*q, 128*w + 32*q + 32), LSB-first.

    ``impl=None`` runs the kernels on CUDA and their plain versions on the
    CPU; ``impl="plain"`` runs the plain versions on either."""
    if impl not in _IMPLS:
        raise ValueError(f"impl must be one of {list(_IMPLS)}, got {impl!r}")
    prg, mmo = _IMPLS[impl]
    nu = dk.nu
    kp = dk.k_padded // 32
    total = (1 << nu) * kp
    seeds, scw = _to_bm(dk.seed_planes, dk.scw_planes)
    tl, tr = dk.tl_words, dk.tr_words
    if total <= max_plane_words:
        S, T = _expand(nu, 0, seeds, dk.t_words, scw, tl, tr, prg)
        return _convert_leaves(S, T, dk.fcw_planes, mmo)
    # Chunked: expand a prefix of c levels, then finish each of the 2^c
    # independent subtrees.  Minimal split: c = ceil(log2(ceil(total / max))).
    n_chunks = -(-total // max_plane_words)
    c = min((n_chunks - 1).bit_length(), nu)
    S, T = _expand(c, 0, seeds, dk.t_words, scw, tl, tr, prg)
    wc = 1 << (nu - c)
    out = torch.empty(
        (dk.k_padded, (1 << c) * wc, 4), dtype=torch.int32, device=dk.device
    )
    for j in range(1 << c):
        Sj, Tj = _expand(
            nu - c, c, S[:, j : j + 1].contiguous(), T[j : j + 1], scw, tl, tr, prg
        )
        out[:, j * wc : (j + 1) * wc] = _convert_leaves(Sj, Tj, dk.fcw_planes, mmo)
    return out


def eval_full(
    kb: KeyBatch, max_plane_words: int = MAX_PLANE_WORDS, device=None
) -> np.ndarray:
    """Full-domain evaluation of a key batch -> uint8[K, out_bytes], where
    out_bytes = 2^(log_n-3) (16 when log_n < 7), byte-identical to
    ``spec.eval_full`` / the reference's EvalFull per key.  ``device=None``
    is the card."""
    dk = DeviceKeys(kb, device)
    words = eval_full_device(dk, max_plane_words)  # [Kpad, W, 4]
    return from_carrier(words[: kb.k]).view("<u1").reshape(kb.k, -1)
