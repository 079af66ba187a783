"""The fast profile's kernels for Hopper, and their routing plan.

The port's counterpart of ``dpf_tpu/ops/chacha_pallas.py``.  Five
wrappers, each beside its plain PyTorch version:

- :func:`expand_tail` (``csrc/chacha_expand.cu::expand_tail_kernel``,
  replacing ``_expand_kernel``): the last L GGM levels plus the 512-bit leaf
  convert and final CW, state ``[5, K, W]`` in, leaf words
  ``[K, W << L, 16]`` out in ascending leaf order;
- :func:`fused_levels` (``fused_levels_kernel``, replacing
  ``_fused_levels_kernel``): G GGM levels, state ``[5, K, W]`` in,
  ``[5, K, W << G]`` out in ascending node order;
- :func:`walk` (``csrc/chacha_walk.cu::walk_kernel``, replacing
  ``_walk_kernel`` with ``dcf=False``): the pointwise root-to-leaf walk of
  every (query, key) pair, the key-minor operands of :func:`walk_operands`
  and ``xs_lo[Q, K]`` in, ``[Q, K]`` bits out;
- :func:`walk_dcf` (``walk_dcf_kernel``, replacing ``_walk_kernel`` with
  ``dcf=True``): the same walk with the DCF value accumulator, the
  operands of :func:`dcf_walk_operands` in, ``[Q, K]`` share bits out;
- :func:`gen_tower` (``csrc/chacha_gen.cu::gen_tower_cc_kernel``, replacing
  no Pallas kernel but the JAX package's XLA body ``models/keys_gen.py::
  _gen_cc_body``): the fast or DCF dealer's whole correction-word tower,
  one key a thread.

State rows 0..3 are the four seed words, row 4 the control bit (0/1); the
CWs are the compact per-key ``scw[K, L, 4]``, ``tcw[K, L, 2]`` and
``fcw[K, 16]`` of the levels the call runs (views of the key arrays are
taken as they are, through their strides).  All tensors are int32 carriers
of the uint32 words.  The Pallas kernels emit block order and need
``deinterleave_nodes`` afterwards; these write ascending order directly.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  Each counts its kernel launches in its
``launches`` attribute.

The plan functions below are copies of ``chacha_pallas``'s, as pure
functions, as they decide on the TPU with ``DPF_TPU_EXPAND_ENTRY`` unset:
the port's routes take the card's schedule on either device.  The TPU-only
parts (failure latches, env knobs, the 128-lane CW padding) are not ported.
:func:`expand_plan_subtrees` is the counterpart of the JAX package's XLA
chunk route, for the configurations neither kernel plan takes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import bitpack
from ..core import chacha_np as cc
from ..core.device import resolve_device
from . import build
from .aes_bitslice import from_carrier, to_carrier

_EKT = 8  # key tile of the Pallas kernel: the plan's key padding quantum
_EWT = 128  # node tile of the Pallas kernel at its entry
_EXP_LEVELS = 5  # levels the tail runs at most (entry_level)
# The most levels one launch runs (csrc/chacha_expand.cu::kMaxLevels): the
# whole-tree route's deepest tail (nu = 6); every other route's tail and
# every fused group runs at most _EXP_LEVELS.
_MAX_LAUNCH_LEVELS = 6
# Cap on padded-key lanes at the chunked route's entry level.
_MAX_PREFIX_LANES = 1 << 24


def fuse_auto_levels() -> int:
    """Group size of a fused-levels launch: the tail's depth, as in
    ``chacha_pallas.fuse_auto_levels``."""
    return _EXP_LEVELS


def level_groups(n_levels: int) -> list[int]:
    """``n_levels`` split into fused-launch groups of at most
    :func:`fuse_auto_levels` levels, largest first."""
    g = fuse_auto_levels()
    return [min(g, n_levels - i) for i in range(0, n_levels, g)]


def small_tree_entry(nu: int):
    """Entry level of the whole-tree route (0) where the classic route
    cannot run (1 <= nu < 7), else None."""
    return 0 if 1 <= nu < 7 else None


def expand_plan(nu: int, k: int, max_leaf_nodes: int):
    """(eligible, entry_level, padded_k) of the one-shot kernel route.  The
    padded key count's leaves must fit under the cap."""
    kp = k + (-k) % _EKT
    fits = (kp << nu) <= max_leaf_nodes
    small = small_tree_entry(nu)
    if small is not None and fits:
        return True, small, kp
    eligible = kernel_usable(nu, kp) and fits
    return eligible, entry_level(nu), kp


def kernel_usable(nu: int, k: int) -> bool:
    """The classic route's entry must be >= 128 nodes wide, and the key
    count a multiple of the 8-key quantum."""
    return nu >= 7 and k % _EKT == 0


def entry_level(nu: int, floor: int = 7) -> int:
    """The tail's entry level: at most _EXP_LEVELS levels below it, never
    narrower than 2^floor nodes."""
    return max(floor, nu - _EXP_LEVELS)


def expand_plan_chunked(nu: int, k: int, max_leaf_nodes: int):
    """(eligible, entry_level, padded_k, n_chunks) of the chunked route:
    the tail runs over ``n_chunks`` node ranges of the entry state (each
    an independent set of subtrees)."""
    kp = k + (-k) % _EKT
    total = kp << nu
    n_chunks = -(-total // max_leaf_nodes)
    chunk_bits = max(0, (n_chunks - 1).bit_length())
    s = entry_level(nu, 7 + chunk_bits)
    if not kernel_usable(nu, kp) or s > nu or (kp << s) > _MAX_PREFIX_LANES:
        return False, s, kp, 0
    return True, s, kp, 1 << chunk_bits


class SubtreePlan(NamedTuple):
    """The subtree route's launches (:func:`expand_plan_subtrees`): the
    fused groups ``prefix`` of levels 0..c-1 from the root, then for each
    of the ``2^c`` subtrees at level ``c`` the fused groups ``groups`` of
    levels c..entry-1 and one tail of ``tail`` levels."""

    n_chunks: int
    c: int
    prefix: list[int]
    groups: list[int]
    tail: int

    @property
    def entry(self) -> int:
        """The tail's entry level."""
        return self.c + sum(self.groups)


def expand_plan_subtrees(nu: int, k: int, max_leaf_nodes: int) -> SubtreePlan:
    """The subtree route, for any (nu, k, cap): the counterpart of the JAX
    package's XLA chunk route (``dpf_tpu/models/dpf_chacha.py``'s
    ``eval_full_device`` past both kernel plans).  The padded batch's
    leaves make ``n_chunks = ceil(kp 2^nu / max_leaf_nodes)`` chunks, which
    become the ``2^c`` subtrees of level ``c = min(bit_length(n_chunks - 1),
    nu)``, as there.  A subtree finishes with fused groups of at most
    ``fuse_auto_levels()`` levels down to ``entry = max(c, nu - 5)``, then
    a tail of the last ``nu - entry <= 5`` levels, so no launch runs more
    than five.  With ``c = nu`` a subtree is one node a key, whose kp
    leaves may exceed the cap, as in the JAX route."""
    kp = k + (-k) % _EKT
    n_chunks = -(-(kp << nu) // max_leaf_nodes)
    c = min((n_chunks - 1).bit_length(), nu)
    return subtree_plan(nu, c)._replace(n_chunks=n_chunks)


def subtree_plan(nu: int, c: int) -> SubtreePlan:
    """The subtree route's launches at a given split ``0 <= c <= nu`` (its
    ``n_chunks`` is ``2^c``): the prefix groups of levels 0..c-1, then a
    subtree's fused groups down to ``entry = max(c, nu - 5)`` and a tail of
    the last ``nu - entry`` levels.  :func:`expand_plan_subtrees` picks
    ``c`` from the leaf cap; the fast ``eval_full_stream`` from its
    chunking."""
    entry = max(c, nu - _EXP_LEVELS)
    return SubtreePlan(1 << c, c, level_groups(c), level_groups(entry - c), nu - entry)


# ---------------------------------------------------------------------------
# Plain versions (the torch level body of models/dpf_chacha.py)
# ---------------------------------------------------------------------------


def fused_levels_plain(state: torch.Tensor, scw: torch.Tensor,
                       tcw: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`fused_levels`: the ``_level_step_cc`` loop."""
    from ..models import dpf_chacha as m

    S, T = m._expand_levels_cc(list(state[:4]), state[4], scw, tcw)
    return torch.stack(S + [T])


def expand_tail_plain(state: torch.Tensor, scw: torch.Tensor, tcw: torch.Tensor,
                      fcw: torch.Tensor, out: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Plain version of :func:`expand_tail`: the ``_level_step_cc`` loop,
    then ``_convert_leaves_cc``."""
    from ..models import dpf_chacha as m

    S, T = m._expand_levels_cc(list(state[:4]), state[4], scw, tcw)
    leaves = m._convert_leaves_cc(S, T, [fcw[:, j] for j in range(16)])
    if out is None:
        return leaves
    out.copy_(leaves)
    return out


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(name: str, x: torch.Tensor, shape, inner: tuple[int, ...], dev) -> None:
    """Raise unless ``x`` is int32 on ``dev`` with ``shape`` (None: any) and
    its trailing strides equal ``inner`` (where a dimension has more than
    one element, of a tensor that has any: the kernels never step along the
    others)."""
    if x.device != dev:
        raise ValueError(f"{name}: expected a tensor on {dev}, got {x.device}")
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {x.dtype}")
    if x.dim() != len(shape) or any(
        want is not None and got != want for got, want in zip(x.shape, shape)
    ):
        raise ValueError(f"{name}: expected shape {list(shape)}, got {list(x.shape)}")
    tail = range(len(shape) - len(inner), len(shape))
    if x.numel() and any(
        x.shape[d] > 1 and x.stride(d) != want for d, want in zip(tail, inner)
    ):
        raise ValueError(f"{name}: strides {x.stride()} need trailing {inner}")


def _operands(state, scw, tcw):
    """Check the state and level CWs for a launch -> (K, W, levels)."""
    if state.device.type != "cuda":
        raise ValueError(f"expected a CUDA or CPU tensor, got {state.device}")
    dev = state.device
    _check("state", state, (5, None, None), (1,), dev)
    K, W = state.shape[1:]
    if K < 1 or W < 1:
        raise ValueError(f"state: expected [5, K >= 1, W >= 1], got {list(state.shape)}")
    levels = scw.shape[1] if scw.dim() == 3 else -1
    _check("scw", scw, (K, levels, 4), (4, 1), dev)
    _check("tcw", tcw, (K, levels, 2), (2, 1), dev)
    if levels > _MAX_LAUNCH_LEVELS:
        raise ValueError(f"{levels} levels in one launch; the kernels take "
                         f"at most {_MAX_LAUNCH_LEVELS}")
    return K, W, levels


def _launch(kernel: str, cfn, dev, *args) -> None:
    """Launch ``cfn`` on ``dev``'s current stream; raise on its error."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = cfn(*args, stream)
    if rc:
        msg = build.load("chacha_expand").dpf_chacha_error_string(rc).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} ({msg})")


def fused_levels(state: torch.Tensor, scw: torch.Tensor,
                 tcw: torch.Tensor) -> torch.Tensor:
    """G = ``scw.shape[1]`` GGM levels: state int32[5, K, W] ->
    int32[5, K, W << G], ascending node order.  Contract of
    ``deinterleave(dpf_tpu.ops.chacha_pallas.fused_levels_raw(...))``."""
    if state.device.type == "cpu":
        return fused_levels_plain(state, scw, tcw)
    K, W, levels = _operands(state, scw, tcw)
    out = torch.empty((5, K, W << levels), dtype=torch.int32, device=state.device)
    _launch(
        "fused_levels_kernel", build.load("chacha_expand").dpf_chacha_fused,
        state.device, state.data_ptr(), state.stride(0), state.stride(1), K, W,
        levels, scw.data_ptr(), scw.stride(0), tcw.data_ptr(), tcw.stride(0),
        out.data_ptr(), out.stride(0), out.stride(1),
    )
    fused_levels.launches += 1
    return out


fused_levels.launches = 0


def expand_tail(state: torch.Tensor, scw: torch.Tensor, tcw: torch.Tensor,
                fcw: torch.Tensor, out: torch.Tensor | None = None
                ) -> torch.Tensor:
    """L = ``scw.shape[1]`` GGM levels, then the leaf convert and final CW:
    state int32[5, K, W] -> leaf words int32[K, W << L, 16], ascending leaf
    order (written into ``out``, which may be a node-range view of a larger
    output, when given).  Contract of ``dpf_tpu.models.dpf_chacha._finish_pk``
    (``_expand_raw`` and its deinterleave)."""
    if state.device.type == "cpu":
        return expand_tail_plain(state, scw, tcw, fcw, out)
    K, W, levels = _operands(state, scw, tcw)
    _check("fcw", fcw, (K, 16), (1,), state.device)
    if out is None:
        out = torch.empty((K, W << levels, 16), dtype=torch.int32, device=state.device)
    _check("out", out, (K, W << levels, 16), (16, 1), state.device)
    if out.data_ptr() % 16 or out.stride(0) % 4:
        raise ValueError("out: leaf rows must be 16-byte aligned (whole 16-word rows)")
    _launch(
        "expand_tail_kernel", build.load("chacha_expand").dpf_chacha_tail,
        state.device, state.data_ptr(), state.stride(0), state.stride(1), K, W,
        levels, scw.data_ptr(), scw.stride(0), tcw.data_ptr(), tcw.stride(0),
        fcw.data_ptr(), fcw.stride(0), out.data_ptr(), out.stride(0),
    )
    expand_tail.launches += 1
    return out


expand_tail.launches = 0


# ---------------------------------------------------------------------------
# Pointwise walk
# ---------------------------------------------------------------------------


def _walk_common_operands(kb, key_level, lowmask, dev):
    """(meta, seeds_t, scw_t, tcw_t) in the kernel's key-minor layout, int32
    on ``dev``: meta [3, K] (ts, key_level, lowmask), seeds_t [4, K],
    scw_t [4 nu, K], tcw_t [2 nu, K] (``chacha_pallas._walk_common_operands``;
    with nu = 0 the CW rows are empty)."""
    k, nu = kb.k, kb.nu
    meta = np.stack([kb.ts.astype(np.uint32), key_level, lowmask])
    scw_t = np.moveaxis(kb.scw.reshape(k, nu, 4), 0, 2).reshape(4 * nu, k)
    tcw_t = np.moveaxis(kb.tcw.astype(np.uint32).reshape(k, nu, 2), 0, 2).reshape(2 * nu, k)
    return tuple(to_carrier(a, dev) for a in (meta, kb.seeds.T, scw_t, tcw_t))


def walk_operands(kb, groups: int = 0, device=None):
    """(meta, seeds_t, scw_t, tcw_t, fcw_t) for the walk on ``device``
    (None: the card), memoized per key batch, ``groups`` and device (key
    material is immutable once evaluated).  ``groups`` > 0: a level-grouped
    FSS batch, whose key_level and lowmask come from
    ``chacha_np.grouped_masks``."""
    dev = resolve_device(device)
    cache = kb._walk_ops
    if (groups, dev) in cache:
        return cache[(groups, dev)]
    k = kb.k
    if groups:
        key_level, lowmask = cc.grouped_masks(k, k // (groups * kb.log_n), kb.log_n)
    else:
        key_level = np.full(k, kb.log_n, np.uint32)
        lowmask = np.full(k, cc.LEAF_BITS - 1, np.uint32)
    ops = _walk_common_operands(kb, key_level, lowmask, dev) + (
        to_carrier(kb.fcw.T, dev),
    )
    cache[(groups, dev)] = ops
    return ops


def _walk_plain(meta, seeds_t, scw_t, tcw_t, fcw_t, xs_lo, xs_hi, log_n: int,
                nu: int, vcw_t=None) -> torch.Tensor:
    """The Pallas kernel's steps on whole ``[Q, K]`` word tensors, the
    ChaCha12 core of ``models/dpf_chacha.py``; with ``vcw_t`` the DCF
    accumulator (``_walk_kernel(dcf=True)``)."""
    from ..models import dpf_chacha as m

    Q, K = xs_lo.shape
    ts, key_level, lowmask = meta
    S = [seeds_t[w][None].expand(Q, K).contiguous() for w in range(4)]
    T = ts[None].expand(Q, K)
    acc = torch.zeros((Q, K), dtype=torch.int32, device=xs_lo.device)
    for i in range(nu):
        out = m._chacha_core(S, m._DSX, 8 if vcw_t is None else 9)
        L, R = out[0:4], out[4:8]
        tl, tr = L[0] & 1, R[0] & 1
        L[0] = L[0] & ~1
        R[0] = R[0] & ~1
        msk = -T
        L = [L[w] ^ (scw_t[4 * i + w][None] & msk) for w in range(4)]
        R = [R[w] ^ (scw_t[4 * i + w][None] & msk) for w in range(4)]
        tl = tl ^ (tcw_t[2 * i][None] & T)
        tr = tr ^ (tcw_t[2 * i + 1][None] & T)
        b = log_n - 1 - i  # the descent bit, MSB first
        src, sh = (xs_hi, b - 32) if b >= 32 else (xs_lo, b)
        pbit = ((src >> sh) & 1) & (key_level >= i).to(torch.int32)[None]
        if vcw_t is not None:  # the value word, under the parent's t
            acc = acc ^ ((out[8] ^ (vcw_t[i][None] & T)) & 1 & (1 - pbit))
        bm = -pbit
        S = [(R[w] & bm) | (L[w] & ~bm) for w in range(4)]
        T = (tr & bm) | (tl & ~bm)
    out = m._convert(S)
    msk = -T
    low = xs_lo & (cc.LEAF_BITS - 1) & lowmask[None]
    words = torch.stack([out[j] ^ (fcw_t[j][None] & msk) for j in range(16)], dim=2)
    sel = words.gather(2, ((low >> 5) & 15).long()[:, :, None])[:, :, 0]
    return acc ^ ((sel >> (low & 31)) & 1)


def walk_plain(meta, seeds_t, scw_t, tcw_t, fcw_t, xs_lo, xs_hi, log_n: int,
               nu: int) -> torch.Tensor:
    """Plain version of :func:`walk`: the Pallas kernel's steps on whole
    ``[Q, K]`` word tensors, the ChaCha12 core of ``models/dpf_chacha.py``."""
    return _walk_plain(meta, seeds_t, scw_t, tcw_t, fcw_t, xs_lo, xs_hi, log_n, nu)


def walk_dcf_plain(meta, seeds_t, scw_t, tcw_t, vcw_t, fcw_t, xs_lo, xs_hi,
                   log_n: int, nu: int) -> torch.Tensor:
    """Plain version of :func:`walk_dcf`: the steps of :func:`walk_plain`
    with 9-word expansions and the DCF accumulator."""
    return _walk_plain(meta, seeds_t, scw_t, tcw_t, fcw_t, xs_lo, xs_hi, log_n, nu,
                       vcw_t)


def _walk_launch(kernel: str, meta, seeds_t, scw_t, tcw_t, vcw_t, fcw_t, xs_lo,
                 xs_hi, log_n: int, nu: int) -> torch.Tensor:
    """Check the walk's operands on the card and launch ``kernel``
    (``walk_kernel``, or ``walk_dcf_kernel`` with ``vcw_t``) -> int32[Q, K]."""
    if xs_lo.device.type != "cuda":
        raise ValueError(f"expected a CUDA or CPU tensor, got {xs_lo.device}")
    dev = xs_lo.device
    if xs_lo.dim() != 2 or min(xs_lo.shape) < 1:
        raise ValueError(f"xs_lo: expected [Q >= 1, K >= 1], got {list(xs_lo.shape)}")
    Q, K = xs_lo.shape
    if not 1 <= log_n <= 64 or nu < 0:
        raise ValueError(f"walk: log_n = {log_n}, nu = {nu} out of range")
    if -(-Q * K // 128) > 0x7FFFFFFF:
        raise ValueError(f"walk: Q * K = {Q * K} lanes; the grid takes at most "
                         f"{0x7FFFFFFF * 128}")
    operands = [("meta", meta, (3, K)), ("seeds_t", seeds_t, (4, K)),
                ("scw_t", scw_t, (4 * nu, K)), ("tcw_t", tcw_t, (2 * nu, K)),
                ("fcw_t", fcw_t, (16, K)), ("xs_lo", xs_lo, (Q, K))]
    if vcw_t is not None:
        operands.append(("vcw_t", vcw_t, (max(nu, 1), K)))
    if log_n > 32:
        operands.append(("xs_hi", xs_hi, (Q, K)))
    for name, x, shape in operands:  # each contiguous
        _check(name, x, shape, (K, 1), dev)
    out = torch.empty((Q, K), dtype=torch.int32, device=dev)
    hi = xs_hi if log_n > 32 else xs_lo  # never read when log_n <= 32
    lib = build.load("chacha_walk")
    keys = (meta, seeds_t, scw_t, tcw_t) + (() if vcw_t is None else (vcw_t,))
    cfn = lib.dpf_chacha_walk if vcw_t is None else lib.dpf_chacha_walk_dcf
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = cfn(*(x.data_ptr() for x in keys + (fcw_t, xs_lo, hi, out)),
                 Q, K, log_n, nu, stream)
    if rc:
        msg = lib.dpf_chacha_walk_error_string(rc).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} ({msg})")
    return out


def walk(meta, seeds_t, scw_t, tcw_t, fcw_t, xs_lo, xs_hi, log_n: int,
         nu: int) -> torch.Tensor:
    """The pointwise walk: operands of :func:`walk_operands`, query words
    ``xs_lo`` int32[Q, K] and ``xs_hi`` ([Q, K]; read only when log_n > 32)
    -> int32[Q, K] bits 0/1.  Contract of ``dpf_tpu.ops.chacha_pallas.
    _walk_raw`` with ``dcf=False``, for any Q >= 1 and K >= 1 (no query tile,
    no 128-key quantum)."""
    if xs_lo.device.type == "cpu":
        return walk_plain(meta, seeds_t, scw_t, tcw_t, fcw_t, xs_lo, xs_hi, log_n, nu)
    out = _walk_launch("walk_kernel", meta, seeds_t, scw_t, tcw_t, None, fcw_t, xs_lo,
                       xs_hi, log_n, nu)
    walk.launches += 1
    return out


walk.launches = 0


def walk_args(kb, xs: np.ndarray, groups: int = 0, device=None) -> tuple:
    """The arguments of :func:`walk` for ``xs`` on ``device`` (None: the
    card): the key
    operands, the queries split into int32 halves and transposed to
    ``[Q, K]`` (repeated across the level blocks of a grouped batch, whose
    ``xs`` is the raw gate queries ``[G, Q]``), log_n and nu."""
    from ..models.dpf_chacha import _split_queries

    dev = resolve_device(device)
    xs_hi, xs_lo = _split_queries(xs, kb.log_n, dev)  # [Q, G or K]
    rep = kb.k // xs.shape[0]
    if rep > 1:  # level-grouped: the queries repeat across level blocks
        xs_lo = xs_lo.repeat(1, rep)
        xs_hi = xs_hi.repeat(1, rep) if xs_hi is not None else None
    return (*walk_operands(kb, groups, dev), xs_lo, xs_hi, kb.log_n, kb.nu)


def eval_points_walk(kb, xs: np.ndarray, groups: int = 0, reduce: bool = False,
                     packed: bool = False, device=None, walk_fn=walk) -> np.ndarray:
    """Pointwise evaluation through one ``walk_fn`` launch on ``device``
    (None: the card; ``chacha_pallas.eval_points_walk``).  ``xs`` is uint64[K, Q], or the raw
    gate queries uint64[G, Q] of a level-grouped batch (``groups`` > 0),
    checked by the caller.  -> uint8[K, Q]; with ``reduce`` the level and
    group blocks XOR-fold on the device -> uint8[G, Q]; ``packed`` returns
    the rows as uint32[., ceil(Q/32)] words packed on the device, tail bits
    zero."""
    if reduce and not groups:
        raise ValueError("reduce requires a level-grouped batch")
    device = resolve_device(device)
    k, q = kb.k, xs.shape[1]
    if not xs.size:  # no keys or no queries: nothing to launch
        return bitpack.empty_rows(xs.shape[0] if reduce else k, q, packed)
    bits = walk_fn(*walk_args(kb, xs, groups, device))
    if reduce:  # XOR of 0/1 bits over the level and group blocks: the sum's parity
        g = k // (groups * kb.log_n)
        bits = bits.view(q, k // g, g).sum(1, dtype=torch.int32) & 1
    if packed:
        return bitpack.mask_tail(from_carrier(bitpack.pack_bits_qmajor_torch(bits)), q)
    return bits.T.to(torch.uint8).contiguous().cpu().numpy()


# ---------------------------------------------------------------------------
# DCF walk (models/dcf.py)
# ---------------------------------------------------------------------------


def walk_dcf(meta, seeds_t, scw_t, tcw_t, vcw_t, fcw_t, xs_lo, xs_hi, log_n: int,
             nu: int) -> torch.Tensor:
    """The DCF comparison-share walk: operands of :func:`dcf_walk_operands`
    (``fcw_t`` is the FVCW), query words ``xs_lo`` int32[Q, K] and ``xs_hi``
    (read only when log_n > 32) -> int32[Q, K] share bits 0/1.  Contract of
    ``dpf_tpu.ops.chacha_pallas._walk_call_dcf``'s ``_walk_raw(dcf=True)``,
    for any Q >= 1 and K >= 1."""
    if xs_lo.device.type == "cpu":
        return walk_dcf_plain(meta, seeds_t, scw_t, tcw_t, vcw_t, fcw_t, xs_lo, xs_hi,
                              log_n, nu)
    out = _walk_launch("walk_dcf_kernel", meta, seeds_t, scw_t, tcw_t, vcw_t, fcw_t,
                       xs_lo, xs_hi, log_n, nu)
    walk_dcf.launches += 1
    return out


walk_dcf.launches = 0


def dcf_walk_operands(kb, device=None):
    """(meta, seeds_t, scw_t, tcw_t, vcw_t, fvcw_t) for the DCF walk on
    ``device`` (None: the card), memoized per key batch and device
    (``chacha_pallas.dcf_walk_operands``): key_level = log_n and lowmask =
    511 for every key (no level grouping); vcw_t [max(nu, 1), K] (zero when
    nu = 0) and fvcw_t [16, K], key-minor."""
    dev = resolve_device(device)
    if dev in kb._walk_ops:
        return kb._walk_ops[dev]
    k, nu = kb.k, kb.nu
    common = _walk_common_operands(kb, np.full(k, kb.log_n, np.uint32),
                                   np.full(k, cc.LEAF_BITS - 1, np.uint32), dev)
    vcw_t = kb.vcw.astype(np.uint32).T if nu else np.zeros((1, k), np.uint32)
    ops = common + (to_carrier(vcw_t, dev), to_carrier(kb.fvcw.T, dev))
    kb._walk_ops[dev] = ops
    return ops


def dcf_walk_args(kb, xs: np.ndarray, device=None) -> tuple:
    """The arguments of :func:`walk_dcf` for xs uint64[K, Q] on ``device``
    (None: the card): the key operands, the queries split into int32 halves
    and transposed to ``[Q, K]``, log_n and nu."""
    from ..models.dpf_chacha import _split_queries

    dev = resolve_device(device)
    xs_hi, xs_lo = _split_queries(xs, kb.log_n, dev)
    return (*dcf_walk_operands(kb, dev), xs_lo, xs_hi, kb.log_n, kb.nu)


def eval_points_walk_dcf(kb, xs: np.ndarray, packed: bool = False, device=None,
                         walk_fn=walk_dcf) -> np.ndarray:
    """DCF comparison shares through one ``walk_fn`` launch on ``device``
    (None: the card; ``chacha_pallas.eval_points_walk_dcf``): xs
    uint64[K, Q], checked by the caller -> uint8[K, Q]; ``packed`` returns
    uint32[K, ceil(Q/32)] words packed on the device, tail bits zero."""
    device = resolve_device(device)
    k, q = xs.shape
    if not xs.size:  # no keys or no queries: nothing to launch
        return bitpack.empty_rows(k, q, packed)
    bits = walk_fn(*dcf_walk_args(kb, xs, device))
    if packed:
        return bitpack.mask_tail(from_carrier(bitpack.pack_bits_qmajor_torch(bits)), q)
    return bits.T.to(torch.uint8).contiguous().cpu().numpy()


# ---------------------------------------------------------------------------
# The dealer's tower (models/keys_gen.py)
# ---------------------------------------------------------------------------


def gen_tower_plain(s0, s1, t0, t1, bits, dcf: bool) -> tuple:
    """Plain version of :func:`gen_tower`: the ``_level_gen_cc`` loop of
    ``models/keys_gen.py`` on whole ``[K]`` word tensors."""
    from ..models import keys_gen

    return keys_gen._gen_cc_body(bits.shape[0], dcf, s0, s1, t0, t1, bits)


def gen_tower(s0: torch.Tensor, s1: torch.Tensor, t0: torch.Tensor, t1: torch.Tensor,
              bits: torch.Tensor, dcf: bool) -> tuple:
    """The fast or DCF dealer's correction-word tower of K keys: root seeds
    ``s0``, ``s1`` int32[K, 4] (bit 0 of word 0 cleared), root control bits
    ``t0``, ``t1`` int32[K] and alpha's path bits ``bits`` int32[nu, K]
    (0/1) -> (scw [nu, K, 4], tl [nu, K], tr [nu, K], fcw [K, 16]) and, with
    ``dcf``, vcw [nu, K], all int32.  Contract of ``dpf_tpu.models.keys_gen.
    _gen_cc_body`` (``fcw`` is the parties' leaf XOR, before alpha's bit)."""
    if bits.device.type == "cpu":
        return gen_tower_plain(s0, s1, t0, t1, bits, dcf)
    if bits.device.type != "cuda":
        raise ValueError(f"expected a CUDA or CPU tensor, got {bits.device}")
    dev = bits.device
    if bits.dim() != 2:
        raise ValueError(f"bits: expected [nu, K], got {list(bits.shape)}")
    nu, K = bits.shape
    for name, x, shape in (("s0", s0, (K, 4)), ("s1", s1, (K, 4)), ("t0", t0, (K,)),
                           ("t1", t1, (K,)), ("bits", bits, (nu, K))):
        _check(name, x, shape, (), dev)
        if not x.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    outs = [torch.empty((nu, K, 4), dtype=torch.int32, device=dev)]
    outs += [torch.empty((nu, K), dtype=torch.int32, device=dev) for _ in range(2)]
    outs.append(torch.empty((K, 16), dtype=torch.int32, device=dev))
    if dcf:
        outs.append(torch.empty((nu, K), dtype=torch.int32, device=dev))
    if K == 0:  # no keys: nothing to launch
        return tuple(outs)
    lib = build.load("chacha_gen")
    vcw = outs[4].data_ptr() if dcf else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.dpf_chacha_gen(*(x.data_ptr() for x in (s0, s1, t0, t1, bits, *outs[:4])),
                                vcw, K, nu, int(dcf), stream)
    if rc:
        msg = lib.dpf_chacha_gen_error_string(rc).decode()
        raise RuntimeError(f"gen_tower_cc_kernel launch failed: CUDA error {rc} ({msg})")
    gen_tower.launches += 1
    return tuple(outs)


gen_tower.launches = 0
