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

Pointwise evaluation (:func:`eval_points`, :func:`eval_points_level_grouped`)
walks root to leaf instead: the operand prep (plain PyTorch, as it is XLA in
the JAX package) packs each level's path bits and the leaf-select one-hot
over 32 queries per word, and one ``eval_points_walk_planes`` launch
(``ops/aes_cuda.py``) runs the whole walk.  The JAX package pads keys to 8
for its kernel; the port's kernel takes any K, and the rows are the same.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import bitpack
from ..core.keys import KeyBatch
from ..ops.aes_bitslice import (
    from_carrier,
    pack_padded_keys,
    to_carrier,
    unpack_planes,
)
from ..ops.aes_cuda import (
    _TO_BM,
    _fold,
    eval_points_walk_planes,
    eval_points_walk_planes_plain,
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


# ---------------------------------------------------------------------------
# Pointwise evaluation
# ---------------------------------------------------------------------------

# impl -> walk.  None: the wrapper (the kernel on CUDA tensors, the plain
# version on CPU tensors); "plain": the plain version on any device.
_WALK_IMPLS = {None: eval_points_walk_planes, "plain": eval_points_walk_planes_plain}


def _point_masks(kb: KeyBatch, device):
    """Per-key lane masks (0 / ~0) for the walk on ``device``, int32:
    seed [128, K], t [K], scw [nu, 128, K], tl and tr [nu, K], fcw [128, K],
    planes in canonical order.  Built once per key batch and device and
    cached on the batch: key material is immutable once evaluated."""
    dev = torch.device(device)
    if dev in kb._point_masks:
        return kb._point_masks[dev]
    K, nu = kb.k, kb.nu
    m = np.uint32(0xFFFFFFFF)

    def bits_of_words(words):  # uint32[..., 4] -> 0/1 uint32[..., 128]
        b = (words[..., None] >> np.arange(32, dtype=np.uint32)) & 1
        return b.reshape(words.shape[:-1] + (128,))

    masks = (
        bits_of_words(kb.seeds).T * m,
        (kb.ts & 1).astype(np.uint32) * m,
        np.moveaxis(bits_of_words(kb.scw.reshape(K, nu, 4)), 0, 2) * m,
        np.moveaxis(kb.tcw[:, :, 0] & 1, 0, 1).astype(np.uint32) * m,
        np.moveaxis(kb.tcw[:, :, 1] & 1, 0, 1).astype(np.uint32) * m,
        bits_of_words(kb.fcw).T * m,
    )
    kb._point_masks[dev] = tuple(to_carrier(a, dev) for a in masks)
    return kb._point_masks[dev]


def _split_words(xs: np.ndarray, log_n: int, device):
    """uint64[A, B] -> (xs_hi, xs_lo) int32 carriers [A, B] on ``device``;
    xs_hi is None when log_n <= 32.  The halves are the little-endian
    uint32 view of the indices, split on the host."""
    halves = np.ascontiguousarray(xs, dtype="<u8").view("<u4").reshape(xs.shape + (2,))
    xs_lo = to_carrier(halves[..., 0], device)
    if log_n <= 32:
        return None, xs_lo
    return to_carrier(halves[..., 1], device), xs_lo


def _path_bits(xs_hi, xs_lo, log_n: int, nu: int) -> torch.Tensor:
    """0/1 int32[nu, A, B]: level i's descent bit, bit log_n - 1 - i of each
    query (an arithmetic shift then ``& 1`` reads any bit).  The levels
    whose bit is 32 or more read the high words."""
    dev = xs_lo.device
    n_hi = max(0, min(nu, log_n - 32))
    parts = []
    if n_hi:
        sh = torch.arange(log_n - 33, log_n - 33 - n_hi, -1, dtype=torch.int32, device=dev)
        parts.append((xs_hi[None] >> sh[:, None, None]) & 1)
    if nu > n_hi:
        sh = torch.arange(log_n - 1 - n_hi, log_n - 1 - nu, -1, dtype=torch.int32, device=dev)
        parts.append((xs_lo[None] >> sh[:, None, None]) & 1)
    if not parts:
        return torch.zeros((0,) + tuple(xs_lo.shape), dtype=torch.int32, device=dev)
    return torch.cat(parts)


def _leaf_select(low: torch.Tensor) -> torch.Tensor:
    """Leaf-select one-hot: low int32[K, Q] (Q % 32 == 0, values 0..127) ->
    [128, K, Q/32], bit l of word (p, k, j) set where query 32 j + l of key
    k reads canonical plane p.  The lanes' bits are distinct, so the
    scatter's sums are ORs."""
    K, Q = low.shape
    qp = Q // 32
    idx = low.reshape(K * qp, 32).T.long()  # [32 lanes, K * qp columns]
    src = bitpack._lane_bits(low.device)[:, None].expand(32, K * qp)
    sel = torch.zeros((128, K * qp), dtype=torch.int32, device=low.device)
    return sel.scatter_add_(0, idx, src).view(128, K, qp)


def _to_bm_masks(seed_masks, scw_masks):
    """The walk's level-state inputs in bit-major plane order."""
    idx = torch.as_tensor(_TO_BM, dtype=torch.long, device=seed_masks.device)
    return seed_masks.index_select(0, idx), scw_masks.index_select(1, idx)


def _eval_points_walk_body(nu, log_n, seed_masks, t_masks, scw_masks, tl_masks,
                           tr_masks, fcw_masks, xs_hi, xs_lo, walk):
    """Operand prep for the walk (``dpf_tpu``'s ``_eval_points_walk_body``):
    xs_lo / xs_hi int32[K, Q] (Q % 32 == 0) -> the per-level packed path
    words pw [nu, K, Q/32] and the leaf-select one-hot sel [128, K, Q/32],
    then one ``walk`` -> packed output words int32[K, Q/32]."""
    pw = bitpack.pack_bits_torch(_path_bits(xs_hi, xs_lo, log_n, nu))
    sel = _leaf_select(xs_lo & 127)
    seeds_bm, scw_bm = _to_bm_masks(seed_masks, scw_masks)
    return walk(seeds_bm, t_masks, scw_bm, tl_masks, tr_masks, fcw_masks, pw, sel, nu)


def _pad_queries(xs: np.ndarray) -> np.ndarray:
    """Zero-pad the query axis to whole 32-query words."""
    pad = (-xs.shape[1]) % 32
    return np.pad(xs, ((0, 0), (0, pad))) if pad else xs


def _walk_fn(impl):
    if impl not in _WALK_IMPLS:
        raise ValueError(f"impl must be one of {list(_WALK_IMPLS)}, got {impl!r}")
    return _WALK_IMPLS[impl]


def _finish_words(words: torch.Tensor, Q: int, packed: bool) -> np.ndarray:
    """Walk words -> uint32[., ceil(Q/32)] with the tail masked, or
    uint8[., Q] bits."""
    w = from_carrier(words)
    return bitpack.mask_tail(w, Q) if packed else bitpack.unpack_bits(w, Q)


def eval_points(kb: KeyBatch, xs: np.ndarray, packed: bool = False, device=None,
                impl: str | None = None) -> np.ndarray:
    """Batched pointwise evaluation: xs uint64[K, Q] -> bits uint8[K, Q],
    one walk launch on ``device`` (None: the card).

    ``packed=True`` returns the walk's native bit-packed form instead:
    uint32[K, ceil(Q/32)] words, query q at word q//32 bit q%32 (LSB-first;
    bits >= Q zero; core/bitpack.py).  One root-to-leaf path walk per (key,
    query) lane, 32 queries of one key bitsliced per word (reference Eval,
    dpf/dpf.go:171-211, vectorized).  ``impl="plain"`` runs the walk's plain
    version on either device."""
    xs = np.asarray(xs, dtype=np.uint64)
    if xs.ndim != 2 or xs.shape[0] != kb.k:
        raise ValueError("xs first axis must match key batch")
    if (xs >> np.uint64(kb.log_n)).any():
        raise ValueError("dpf: query index out of domain")
    walk = _walk_fn(impl)
    dev = _resolve_device(device)
    if not xs.size:  # no keys or no queries: nothing to launch
        return bitpack.empty_rows(kb.k, xs.shape[1], packed)
    xs_hi, xs_lo = _split_words(_pad_queries(xs), kb.log_n, dev)
    words = _eval_points_walk_body(
        kb.nu, kb.log_n, *_point_masks(kb, dev), xs_hi, xs_lo, walk
    )
    return _finish_words(words, xs.shape[1], packed)


def _masked_level_queries(
    xs: np.ndarray, log_n: int, levels, groups: int
) -> np.ndarray:
    """uint64[G, Q] raw queries -> uint64[groups * len(levels) * G, Q]:
    per selected level i, x with its low ``log_n - 1 - i`` bits zeroed
    (the dyadic-prefix query), level-major; shared by both profiles'
    ``levels=`` grouped paths."""
    lv = np.asarray(levels, dtype=np.uint64)
    shifts = (np.uint64(log_n) - np.uint64(1) - lv)[:, None, None]
    qexp = ((xs[None] >> shifts) << shifts).reshape(
        lv.shape[0] * xs.shape[0], -1
    )
    if groups > 1:
        qexp = np.concatenate([qexp] * groups)
    return qexp


def _grouped_walk_body(nu, log_n, groups, G, seed_masks, t_masks, scw_masks,
                       tl_masks, tr_masks, fcw_masks, xs_hi, xs_lo, reduce, walk):
    """Walk prep for level-grouped gates (``dpf_tpu``'s
    ``_grouped_walk_body``): each block's path words are the gates' raw path
    words ANDed with the ``walk level <= block level`` keep matrix, and its
    leaf select uses the gates' low bits under the block's ``lowmask``, so
    the level-replicated queries never exist.  xs_lo / xs_hi int32[G, Q]
    -> packed words int32[K, Q/32], or [G, Q/32] XOR-folded with
    ``reduce``."""
    n, dev = log_n, xs_lo.device
    B = groups * n
    K = B * G
    pw_raw = bitpack.pack_bits_torch(_path_bits(xs_hi, xs_lo, n, nu))  # [nu, G, qp]
    qp = pw_raw.shape[-1]
    keep = torch.tensor([[int(j <= bi % n) for bi in range(B)] for j in range(nu)],
                        dtype=torch.int32, device=dev).view(nu, B, 1, 1)
    pw = (pw_raw[:, None] * keep).reshape(nu, K, qp)
    lowmask = torch.tensor(
        [(~((1 << max(0, n - 1 - (bi % n))) - 1)) & 127 for bi in range(B)],
        dtype=torch.int32, device=dev,
    )
    low = ((xs_lo & 127)[None] & lowmask[:, None, None]).reshape(K, -1)
    seeds_bm, scw_bm = _to_bm_masks(seed_masks, scw_masks)
    words = walk(seeds_bm, t_masks, scw_bm, tl_masks, tr_masks, fcw_masks, pw,
                 _leaf_select(low), nu)
    if reduce:
        words = _fold(words.view(B, G, qp), torch.bitwise_xor)
    return words


def eval_points_level_grouped(
    kb: KeyBatch, xs: np.ndarray, groups: int, reduce: bool = False,
    packed: bool = False, levels=None, device=None, impl: str | None = None,
) -> np.ndarray:
    """FSS-support pointwise evaluation over level-major key groups
    (compat profile; mirror of ``dpf_chacha.eval_points_level_grouped``).

    ``kb`` holds ``groups * log_n * G`` keys arranged as ``groups`` repeats
    of ``log_n`` level-major blocks of ``G`` gates (models/fss.py layout);
    ``xs`` is the RAW gate queries uint64[G, Q].  Key ``i*G + g`` of each
    group is evaluated at xs[g] with its low ``log_n - 1 - i`` bits zeroed
    (the dyadic-prefix query); the masking folds into the walk's operand
    prep on the device.  -> uint8[groups * log_n * G, Q], or uint8[G, Q]
    with ``reduce`` (the XOR-fold runs on the device).  ``packed`` returns
    the same rows as uint32[., ceil(Q/32)] words.

    ``levels`` (a tuple of level indices in [0, log_n)) selects a subset of
    level blocks: ``kb`` then holds ``groups * len(levels) * G`` keys whose
    block ``j`` is level ``levels[j]``; the queries are masked on the host
    and walked by :func:`eval_points`."""
    xs = np.asarray(xs, dtype=np.uint64)
    if xs.ndim != 2:
        raise ValueError("dpf: xs must be [G, Q]")
    G, Q = xs.shape
    n = kb.log_n
    if levels is not None:
        lv = tuple(int(i) for i in levels)
        if not lv or any(i < 0 or i >= n for i in lv):
            raise ValueError("dpf: levels must be non-empty, in [0, log_n)")
        if kb.k != groups * len(lv) * G:
            raise ValueError("dpf: key count != groups * len(levels) * G")
        if (xs >> np.uint64(n)).any():
            raise ValueError("dpf: query index out of domain")
        out = eval_points(kb, _masked_level_queries(xs, n, lv, groups),
                          packed=packed, device=device, impl=impl)
        if reduce:
            out = np.bitwise_xor.reduce(
                out.reshape(groups * len(lv), G, out.shape[1]), axis=0)
        return out
    if groups < 1 or kb.k != groups * n * G:
        raise ValueError("dpf: key count != groups * log_n * G")
    if (xs >> np.uint64(n)).any():
        raise ValueError("dpf: query index out of domain")
    walk = _walk_fn(impl)
    dev = _resolve_device(device)
    if not xs.size:  # no gates or no queries: nothing to launch
        return bitpack.empty_rows(G if reduce else kb.k, Q, packed)
    xs_hi, xs_lo = _split_words(_pad_queries(xs), n, dev)
    words = _grouped_walk_body(kb.nu, n, groups, G, *_point_masks(kb, dev), xs_hi,
                               xs_lo, reduce, walk)
    return _finish_words(words, Q, packed)
