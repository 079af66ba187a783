"""Level-synchronous batched full-domain DPF evaluation on bit-planes.

The port's counterpart of the full-domain path of ``dpf_tpu/models/dpf.py``.
Where the reference walks the GGM tree depth-first (dpf/dpf.go:213-262), the
evaluator expands it breadth-first: level ``i`` holds all ``2^i`` nodes of all
``K`` keys as one bitsliced tensor ``int32[128, W, K/32]`` (128 bit-planes,
W nodes, keys packed 32 per word), and one step per level does

    PRG doubling (2 fixed-key bitsliced AES-MMO)     reference dpf.go:229
    control-bit extraction + clearing (plane 0)      reference dpf.go:62-67
    correction-word XOR masked by parent t-bits      reference dpf.go:230-238

``backend`` picks the kernels, as in the JAX package: ``"pallas_bm"`` (the
default) and ``"pallas_bm_il"`` hold the level state in bit-major plane order
(``aes_cuda._TO_BM``) for the whole expansion and the leaf convert emits
canonical order; ``"pallas"`` and ``"xla"`` keep it canonical throughout.
``fuse=g`` on a bit-major backend runs the levels from ``_FUSE_FLOOR`` down
as groups of at most g levels, each one ``fused_levels_planes`` launch.
``backend=None`` and ``fuse=None`` read the knobs ``DPF_CUDA_PRG`` (unset:
``"pallas_bm"``) and ``DPF_CUDA_FUSE`` (unset: ``"off"``; ``core/knobs.py``),
as the JAX package's read ``DPF_TPU_PRG`` and ``DPF_TPU_FUSE``.  The
PRG, the leaf convert (the leaf MMO, the final CW and the unpack to per-key
words, one launch) and the fused levels are the CUDA kernels of
``ops/aes_cuda.py`` on the card and their plain versions on the CPU; the glue
around them is plain PyTorch, as it is XLA outside Pallas in the JAX package.

Outputs are byte-identical to the reference: leaves emit in ascending index
order (children interleave L,R like the DFS emit order), and each leaf is the
MMO-converted seed XOR the final CW when the control bit is set.  Domains
whose leaf level exceeds ``max_plane_words`` split into independent subtree
chunks, finished one after another.  :func:`eval_full_stream` yields those
chunks as blocks, each block's copy to the host overlapping the next
block's compute (``core/stream.py``).  A key batch keeps its packed
``DeviceKeys`` per device (``_device_keys``), built at first use.

Pointwise evaluation (:func:`eval_points`, :func:`eval_points_level_grouped`)
walks root to leaf instead: the operand prep (plain PyTorch, as it is XLA in
the JAX package) packs each level's path bits and the leaf-select one-hot
over 32 queries per word, and one ``eval_points_walk_planes`` launch
(``ops/aes_cuda.py``) runs the whole walk.  The JAX package pads keys to 8
for its kernel; the port's kernel takes any K, and the rows are the same.
"""

from __future__ import annotations

import copy
import functools

import numpy as np
import torch

from ..core import bitpack, knobs
from ..core.device import resolve_device
from ..core.keys import KeyBatch
from ..core.stream import chunk_levels, stream_chunks
from ..ops.aes_bitslice import (
    from_carrier,
    pack_padded_keys,
    to_carrier,
)
from ..ops.aes_cuda import (
    _TO_BM,
    FUSE_MAX_LEVELS,
    _fold,
    convert_leaves_bm,
    convert_leaves_bm_plain,
    convert_leaves_canon,
    convert_leaves_canon_plain,
    eval_points_walk_planes,
    eval_points_walk_planes_plain,
    fused_levels_planes,
    fused_levels_planes_plain,
    prg_planes_bm,
    prg_planes_bm_il,
    prg_planes_bm_il_plain,
    prg_planes_bm_plain,
    prg_planes_canon,
    prg_planes_canon_plain,
)

# Soft cap on W * Kp (words per plane) for a single expansion; above this
# the tree is split into independent subtree chunks.  2^19 words/plane ->
# the [128, W, Kp] tensor is 256 MB; a few live at once during a step.
MAX_PLANE_WORDS = 1 << 19

# backend -> impl -> (PRG, leaf convert).  impl None: the wrappers, which launch
# the kernels on CUDA tensors and run the plain versions on CPU tensors.
# "plain": the plain versions on any device (chip_smoke.py holds the kernels
# against them).  "xla" is the JAX package's canonical-order XLA expression
# of the same function, so it runs the canonical kernels here.
_CANON = {
    None: (prg_planes_canon, convert_leaves_canon),
    "plain": (prg_planes_canon_plain, convert_leaves_canon_plain),
}
_IMPLS = {
    "pallas_bm": {
        None: (prg_planes_bm, convert_leaves_bm),
        "plain": (prg_planes_bm_plain, convert_leaves_bm_plain),
    },
    "pallas_bm_il": {
        None: (prg_planes_bm_il, convert_leaves_bm),
        "plain": (prg_planes_bm_il_plain, convert_leaves_bm_plain),
    },
    "pallas": _CANON,
    "xla": _CANON,
}
# Backends whose level state lives in bit-major plane order.
_BM_BACKENDS = frozenset({"pallas_bm", "pallas_bm_il"})
# impl -> the fused levels (bit-major backends' fuse= route).
_FUSED_IMPLS = {None: fused_levels_planes, "plain": fused_levels_planes_plain}


def _resolve_backend(backend: str | None) -> str:
    """``None`` means the knob ``DPF_CUDA_PRG``, and ``"pallas_bm"`` where it
    is unset (``dpf_tpu.models.dpf.default_backend``); any name must be one
    of the JAX package's (``dpf_tpu.models.dpf._PRG_IMPLS``)."""
    if backend is None:
        backend = knobs.get_raw("DPF_CUDA_PRG") or "pallas_bm"
    if backend not in _IMPLS:
        raise ValueError(f"backend {backend!r} unknown; choose from {sorted(_IMPLS)}")
    return backend


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
        dev = self.device = resolve_device(device)
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

    # The tensors of the key material, in the order of :meth:`tensors`.
    FIELDS = ("seed_planes", "t_words", "scw_planes", "tl_words", "tr_words",
              "fcw_planes")

    def tensors(self) -> tuple:
        return tuple(getattr(self, f) for f in self.FIELDS)

    def with_tensors(self, tensors) -> "DeviceKeys":
        """A copy of these keys whose tensors are ``tensors`` (same shapes:
        a dispatch plan's static inputs)."""
        dk = copy.copy(self)
        for f, t in zip(self.FIELDS, tensors, strict=True):
            setattr(dk, f, t)
        return dk


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


@functools.cache
def _bm_index(device: torch.device) -> torch.Tensor:
    """int64[128]: ``_TO_BM`` on ``device``, made once per device (so that
    no call of a captured body copies it from the host)."""
    return torch.as_tensor(_TO_BM, dtype=torch.long, device=device)


def _to_bm(seed_planes, scw_planes):
    """Canonical -> bit-major plane order for the level-state inputs: the
    [128, 1, Kp] seeds and the [nu, 128, Kp] CWs (the leaf convert emits
    canonical order, so the big leaf-level tensors are never permuted)."""
    idx = _bm_index(scw_planes.device)
    return seed_planes.index_select(0, idx), scw_planes.index_select(1, idx)


def _expand(n_levels, first, S, T, scw_planes, tl_w, tr_w, prg):
    """Levels ``first .. first + n_levels - 1``; S and scw_planes in the
    backend's plane order."""
    for i in range(first, first + n_levels):
        S, T = _level_step(S, T, scw_planes[i], tl_w[i], tr_w[i], prg)
    return S, T


# ---------------------------------------------------------------------------
# Level-fused expansion (fuse=; ops/aes_cuda.fused_levels_planes)
# ---------------------------------------------------------------------------

# Entry level of the fused groups, as in the JAX package: the levels above
# run per level (a vanishing fraction of the work).
_FUSE_FLOOR = 7


def _fuse_schedule(n_levels, g, floor=_FUSE_FLOOR):
    """(first_fused_level, group sizes) tiling levels floor..n_levels-1
    into fused groups of <= g levels, or None when nothing can fuse.
    ``floor`` is a parameter for tests."""
    mid = n_levels - floor
    if g <= 0 or mid <= 0:
        return None
    groups = []
    while mid > 0:
        t = min(g, mid)
        groups.append(t)
        mid -= t
    return floor, tuple(groups)


def _fuse_request() -> int:
    """The knob ``DPF_CUDA_FUSE`` as a group size (``dpf_tpu.ops.
    fuse_request``): ``off`` 0, ``auto`` ``FUSE_MAX_LEVELS`` (the most levels
    one ``fused_levels_bm_kernel`` launch runs), or the number given."""
    env = knobs.get_str("DPF_CUDA_FUSE")
    if env == "off":
        return 0
    if env == "auto":
        return FUSE_MAX_LEVELS
    try:
        g = int(env)
    except ValueError:
        raise ValueError(f"DPF_CUDA_FUSE={env!r} invalid; use off|auto|<levels>") from None
    if g < 0:
        raise ValueError("DPF_CUDA_FUSE must be >= 0")
    return g


def _fuse_plan(nu: int, backend: str, fuse: int | None):
    """The fused route's schedule, or None for the per-level pipeline.
    ``fuse``: None = the knob (:func:`_fuse_request`; off by default, as in
    the JAX package), 0 = off, g >= 1 = groups of <= g levels.  The fused
    state is bit-major: the canonical backends keep the per-level path."""
    if backend not in _BM_BACKENDS:
        return None
    return _fuse_schedule(nu, _fuse_request() if fuse is None else fuse)


def _fused_groups(S, T, scw_planes, tl_w, tr_w, first, groups, fused):
    """Run the fused groups from per-level bit-major state at level
    ``first`` (S [128, W, Kp], T [W, Kp]) -> node-minor leaf-level state
    (S_f [128, Kp, W'], T_f [Kp, W']), ascending node order."""
    Sf = S.transpose(1, 2).contiguous()
    Tf = T.transpose(0, 1).contiguous()
    lvl = first
    for g in groups:
        Sf, Tf = fused(Sf, Tf, scw_planes[lvl : lvl + g], tl_w[lvl : lvl + g],
                       tr_w[lvl : lvl + g])
        lvl += g
    return Sf, Tf


def eval_full_device(
    dk: DeviceKeys,
    max_plane_words: int = MAX_PLANE_WORDS,
    backend: str | None = None,
    fuse: int | None = None,
    *,
    impl: str | None = None,
) -> torch.Tensor:
    """Full-domain evaluation on ``dk.device`` -> int32[K_padded, n_leaves, 4].

    The returned words ARE the bit-packed output: word q of leaf w holds
    domain bits [128*w + 32*q, 128*w + 32*q + 32), LSB-first.

    ``backend``: ``"pallas_bm"``, ``"pallas_bm_il"``, ``"pallas"`` or
    ``"xla"``, None the knob (module docstring); every one gives the same
    words.  ``fuse``: level-fused group size for the bit-major backends
    (None = the knob ``DPF_CUDA_FUSE``, 0 = off, g >= 1 = groups of <= g
    levels from level ``_FUSE_FLOOR``).  As
    in the JAX package, the fused route covers the unchunked path; domains
    split into subtree chunks run per level with the chosen backend.

    ``impl=None`` runs the kernels on CUDA and their plain versions on the
    CPU; ``impl="plain"`` runs the plain versions on either."""
    backend = _resolve_backend(backend)
    if impl not in _IMPLS[backend]:
        raise ValueError(f"impl must be one of {list(_IMPLS[backend])}, got {impl!r}")
    prg, convert = _IMPLS[backend][impl]
    nu = dk.nu
    kp = dk.k_padded // 32
    total = (1 << nu) * kp
    seeds, scw = dk.seed_planes, dk.scw_planes
    if backend in _BM_BACKENDS:
        seeds, scw = _to_bm(seeds, scw)
    tl, tr = dk.tl_words, dk.tr_words
    if total <= max_plane_words:
        sched = _fuse_plan(nu, backend, fuse)
        if sched is not None:
            first, groups = sched
            S, T = _expand(first, 0, seeds, dk.t_words, scw, tl, tr, prg)
            Sf, Tf = _fused_groups(S, T, scw, tl, tr, first, groups, _FUSED_IMPLS[impl])
            return convert(Sf, Tf, dk.fcw_planes, node_minor=True)
        S, T = _expand(nu, 0, seeds, dk.t_words, scw, tl, tr, prg)
        return convert(S, T, dk.fcw_planes)
    # Chunked: expand a prefix of c levels, then finish each of the 2^c
    # independent subtrees, each leaf convert writing straight into its
    # columns of the output.  Minimal split: c = ceil(log2(ceil(total / max))).
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
        convert(Sj, Tj, dk.fcw_planes, out=out, leaf_offset=j * wc)
    return out


def eval_full(
    kb: KeyBatch,
    max_plane_words: int = MAX_PLANE_WORDS,
    backend: str | None = None,
    fuse: int | None = None,
    *,
    device=None,
) -> np.ndarray:
    """Full-domain evaluation of a key batch -> uint8[K, out_bytes], where
    out_bytes = 2^(log_n-3) (16 when log_n < 7), byte-identical to
    ``spec.eval_full`` / the reference's EvalFull per key.  ``backend`` and
    ``fuse`` as in :func:`eval_full_device`.  ``device=None`` is the
    card."""
    backend = _resolve_backend(backend)
    dk = _cached_device_keys(kb, device)
    words = eval_full_device(dk, max_plane_words, backend, fuse)  # [Kpad, W, 4]
    return _words_to_rows(from_carrier(words[: kb.k]), kb.k)


def _words_to_rows(words: np.ndarray, k: int) -> np.ndarray:
    """[>= k, W, 4] words -> uint8[k, W*16] output-byte rows."""
    return np.ascontiguousarray(words[:k]).view("<u1").reshape(k, -1)


def _cached_device_keys(kb, device=None, build=None):
    """The batch's key material on ``device`` (None: the card), built by
    ``build(kb, device)`` (None: :class:`DeviceKeys`) at its first use on
    that device and kept on the batch (its ``_device_keys``): key material
    is immutable once evaluated, and a batch evaluated again, or streamed
    chunk by chunk, must not repack and re-upload it on every call."""
    dev = resolve_device(device)
    dk = kb._device_keys.get(dev)
    if dk is None:
        dk = kb._device_keys[dev] = (build or DeviceKeys)(kb, dev)
    return dk


def eval_full_stream(
    kb: KeyBatch,
    max_plane_words: int = MAX_PLANE_WORDS,
    backend: str | None = None,
    min_chunks: int = 2,
    events: list | None = None,
    timer=None,
    *,
    device=None,
    impl: str | None = None,
):
    """Double-buffered streaming full-domain evaluation on ``device``
    (None: the card).

    Yields uint8[K, chunk_bytes] blocks whose axis-1 concatenation is
    byte-identical to :func:`eval_full`.  A prefix of ``c`` levels runs
    once; then each of the ``2^c`` subtrees is one dispatch (its levels
    and the leaf convert into a fresh block), and chunk ``j+1``'s compute
    is dispatched before chunk ``j``'s copy to the host is waited on
    (``core/stream.stream_chunks``), so a consumer gets its first bytes
    after about one chunk instead of the whole tree.  ``c`` is the least
    split that fits ``max_plane_words`` words a plane and makes at least
    ``min_chunks`` chunks, nu permitting; with ``c = 0`` the one block is
    :func:`eval_full_device`'s.

    ``backend`` as in :func:`eval_full_device` (None: ``"pallas_bm"``);
    ``events`` and ``timer`` follow the driver's protocol; ``impl`` as in
    :func:`eval_full_device`.  A generator: nothing runs, and nothing
    raises, before the first ``next``."""
    backend = _resolve_backend(backend)
    if impl not in _IMPLS[backend]:
        raise ValueError(f"impl must be one of {list(_IMPLS[backend])}, got {impl!r}")
    prg, convert = _IMPLS[backend][impl]
    dk = _cached_device_keys(kb, device)
    nu = dk.nu
    c = chunk_levels((1 << nu) * (dk.k_padded // 32), max_plane_words, min_chunks, nu)

    def to_rows(words):
        return _words_to_rows(words, kb.k)

    if c == 0:
        yield from stream_chunks(
            0, lambda j: eval_full_device(dk, max_plane_words, backend, impl=impl)[: kb.k],
            to_rows, events, timer, device=dk.device,
        )
        return
    seeds, scw = dk.seed_planes, dk.scw_planes
    if backend in _BM_BACKENDS:
        seeds, scw = _to_bm(seeds, scw)
    tl, tr = dk.tl_words, dk.tr_words
    S, T = _expand(c, 0, seeds, dk.t_words, scw, tl, tr, prg)

    def dispatch(j):
        Sj, Tj = _expand(
            nu - c, c, S[:, j : j + 1].contiguous(), T[j : j + 1], scw, tl, tr, prg
        )
        return convert(Sj, Tj, dk.fcw_planes)[: kb.k]

    yield from stream_chunks(c, dispatch, to_rows, events, timer, device=dk.device)


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
    idx = _bm_index(seed_masks.device)
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


def eval_points(kb: KeyBatch, xs: np.ndarray, backend: str | None = None,
                packed: bool = False, *, device=None,
                impl: str | None = None) -> np.ndarray:
    """Batched pointwise evaluation: xs uint64[K, Q] -> bits uint8[K, Q],
    one walk launch on ``device`` (None: the card).  ``backend`` takes the
    JAX package's names (``_IMPLS``; None as well) and picks nothing: every
    backend runs the one walk kernel, whose bits are the same.

    ``packed=True`` returns the walk's native bit-packed form instead:
    uint32[K, ceil(Q/32)] words, query q at word q//32 bit q%32 (LSB-first;
    bits >= Q zero; core/bitpack.py).  One root-to-leaf path walk per (key,
    query) lane, 32 queries of one key bitsliced per word (reference Eval,
    dpf/dpf.go:171-211, vectorized).  ``impl="plain"`` runs the walk's plain
    version on either device."""
    _resolve_backend(backend)
    xs = np.asarray(xs, dtype=np.uint64)
    if xs.ndim != 2 or xs.shape[0] != kb.k:
        raise ValueError("xs first axis must match key batch")
    if (xs >> np.uint64(kb.log_n)).any():
        raise ValueError("dpf: query index out of domain")
    walk = _walk_fn(impl)
    dev = resolve_device(device)
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
    backend: str | None = None, packed: bool = False, levels=None, *,
    device=None, impl: str | None = None,
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
    and walked by :func:`eval_points`.  ``backend`` as in
    :func:`eval_points`."""
    _resolve_backend(backend)
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
    dev = resolve_device(device)
    if not xs.size:  # no gates or no queries: nothing to launch
        return bitpack.empty_rows(G if reduce else kb.k, Q, packed)
    xs_hi, xs_lo = _split_words(_pad_queries(xs), n, dev)
    words = _grouped_walk_body(kb.nu, n, groups, G, *_point_masks(kb, dev), xs_hi,
                               xs_lo, reduce, walk)
    return _finish_words(words, Q, packed)


# ---------------------------------------------------------------------------
# Incremental heavy-hitter frontier extension (apps/hh_state.py): the
# compat twin of models/dpf_chacha.py's hh bodies (see there for the
# control-bit invariant).  State stays in the bitsliced plane layout
# ([128, F, Kp] seeds, [F, Kp] key-packed control words); the emitted rows
# go to the client-major packed layout on the device.
# ---------------------------------------------------------------------------


def _keywords_to_rows(Tq: torch.Tensor) -> torch.Tensor:
    """Key-packed bit words int32[Q, Kp] (key k at word k // 32, bit k % 32)
    -> client-major packed rows int32[Kp * 32, ceil(Q/32)] (the core/bitpack
    output contract)."""
    bits = bitpack.unpack_bits_torch(Tq, Tq.shape[1] * 32).to(torch.int32)  # [Q, K]
    return bitpack.pack_bits_qmajor_torch(bits)


def hh_leaf_fold_planes(C: torch.Tensor, m: int, ibits: int) -> torch.Tensor:
    """Fold converted leaf planes to depth-``m`` intra-leaf predicate bits.
    C int32[128, A, Kp] (plane x = leaf value bit x, key-packed); only
    planes < 2**ibits are populated (ibits = log_n - nu <= 7).  Returns
    int32[2**m, A, Kp]: entry v = XOR of planes [v * s, (v + 1) * s),
    s = 2**(ibits - m)."""
    s = (1 << ibits) >> m
    w = C[: 1 << ibits].reshape(1 << m, s, C.shape[1], C.shape[2])
    return _fold(w.movedim(1, 0), torch.bitwise_xor)


def _hh_extend_body(S, T, sel, cw_plane, tl_w, tr_w):
    """One incremental frontier level: gather the surviving parent columns
    (public ``sel`` int64[F]) from the carried [128, ., Kp] / [., Kp] state
    and expand one level through the canonical PRG kernel -> new state
    ([128, 2F, Kp], [2F, Kp]) + client-major packed rows int32[Kp * 32,
    2F / 32]."""
    Sg = S.index_select(1, sel)
    Tg = T.index_select(0, sel)
    S2, T2 = _level_step(Sg, Tg, cw_plane, tl_w, tr_w, prg_planes_canon)
    return S2, T2, _keywords_to_rows(T2)


def _hh_leaf_first_body(ibits, S, T, sel, fcw_planes):
    """Frontier crossing into the leaf: convert the surviving depth-nu
    columns once (the leaf MMO is the canonical PRG kernel's L half) ->
    resident plane state int32[128, F, Kp] + the m=1 split rows
    int32[Kp * 32, 2F / 32], in (parent, bit) order."""
    Sg = S.index_select(1, sel)
    Tg = T.index_select(0, sel)
    C = prg_planes_canon(Sg.reshape(128, -1))[0].view(Sg.shape)
    C = C ^ (fcw_planes & Tg[None])
    B = hh_leaf_fold_planes(C, 1, ibits)  # [2, F, Kp]
    return C, _keywords_to_rows(B.movedim(0, 1).reshape(-1, B.shape[2]))


def _hh_leaf_fold_body(m, ibits, C, idx):
    """Intra-leaf frontier level m >= 2: fold the resident plane state
    (reused by deeper rounds) and gather the requested children (public
    ``idx`` int64[Q] = anc * 2**m + v) -> packed rows int32[Kp * 32,
    Q / 32]."""
    B = hh_leaf_fold_planes(C, m, ibits)
    flat = B.movedim(0, 1).reshape(-1, B.shape[2])
    return _keywords_to_rows(flat.index_select(0, idx))
