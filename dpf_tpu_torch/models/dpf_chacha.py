"""Full-domain evaluation for the ChaCha fast profile, on seed words.

The port's counterpart of the EvalFull path of
``dpf_tpu/models/dpf_chacha.py``.  The ChaCha PRG is native 32-bit
add/rotate/xor, so the expansion works on seed WORDS: the state of level i
is ``int32[5, K, 2^i]`` (rows 0..3 the seed words, row 4 the control bit),
and one GGM level step (reference dpf/dpf.go:229-238) expands, extracts and
clears the control bits, and XORs the CWs in under the parent's t.  Leaves
convert through one ChaCha block each, 512 output bits in the bit-packed
output layout (word j of leaf w holds domain bits [512w + 32j, +32)).

Words travel as int32 carriers (``ops/aes_bitslice.to_carrier``): int32
addition wraps as uint32 does, and the rotate is ``(x << r) | lshr(x,
32 - r)`` because torch's ``>>`` on int32 is arithmetic.

Routes on the card, the kernels of ``ops/chacha_cuda.py``:

- the tail (levels ``entry..nu-1`` plus the leaf convert) is one
  ``expand_tail`` launch, at the entry level the JAX plan gives
  (``chacha_cuda.expand_plan``), or one per node-range chunk
  (``expand_plan_chunked``) when the leaves exceed ``max_leaf_nodes``;
- small trees (nu < 7) take the whole-tree route: the tail from the root.

One deviation from the JAX routes, which adds no feature: on the TPU the
levels above the entry run as XLA level steps, because a Pallas program
wants a >= 128-node tile.  Run eagerly in torch, each such level would be
some 1,200 small launches (12 rounds of quarter-round adds, xors and
shifts on [K, W] tensors).  The port covers those levels with
``fused_levels`` launches from the root (W = 1), in groups of at most
``fuse_auto_levels()`` levels: at n=20 (nu=11, entry 7) that is 5 + 2
levels, then the tail of 4.  The output is the same bytes by construction
(each kernel runs ``_level_step_cc`` level after level).  These launches
also cover the levels that the JAX fused schedule (``_fuse_schedule_cc``,
nu > 12) runs as mid groups between its XLA prefix and the tail, so that
schedule has no counterpart here.  A log_n <= 9
domain (nu = 0) has no levels and takes the whole-tree route as one leaf
convert.

Pointwise evaluation (:func:`eval_points`, :func:`eval_points_level_grouped`)
is one ``walk`` launch per call (``ops/chacha_cuda.py``): every (query, key)
pair walks root to leaf in one thread, for any K and Q.  The JAX package
takes its walk kernel only for K % 128 == 0 on the TPU and its XLA body
otherwise; the port's one route gives the same bytes.

On the CPU the same routes run the wrappers' plain versions, so the CPU
tests walk the card's schedule.  ``impl="plain"`` runs the plain versions
on either device.  There is no fallback: a configuration no kernel route
takes raises, naming its limit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import chacha_np as cc
from ..core.keys_chacha import KeyBatchFast, _pad_fast_batch
from ..ops import chacha_cuda as cp
from ..ops.aes_bitslice import from_carrier, lshr, to_carrier
from .dpf import _resolve_device, _split_words


def _s32(v: int) -> int:
    """A uint32 constant as the int32 carrier with the same bits."""
    v = int(v)
    return v - (1 << 32) if v >= 1 << 31 else v


_C = [_s32(v) for v in cc._CONSTANTS]
_DSX = [_s32(v) for v in cc.DS_EXPAND]
_DSL = [_s32(v) for v in cc.DS_LEAF]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate int32 carriers left by ``0 < r < 32``."""
    return (x << r) | lshr(x, 32 - r)


def _quarter(s, a, b, c, d):
    s[a] = s[a] + s[b]
    s[d] = _rotl(s[d] ^ s[a], 16)
    s[c] = s[c] + s[d]
    s[b] = _rotl(s[b] ^ s[c], 12)
    s[a] = s[a] + s[b]
    s[d] = _rotl(s[d] ^ s[a], 8)
    s[c] = s[c] + s[d]
    s[b] = _rotl(s[b] ^ s[c], 7)


def _double_round(s):
    """``chacha_np.double_round`` on int32 carriers, in place."""
    _quarter(s, 0, 4, 8, 12)
    _quarter(s, 1, 5, 9, 13)
    _quarter(s, 2, 6, 10, 14)
    _quarter(s, 3, 7, 11, 15)
    _quarter(s, 0, 5, 10, 15)
    _quarter(s, 1, 6, 11, 12)
    _quarter(s, 2, 7, 8, 13)
    _quarter(s, 3, 4, 9, 14)


def _chacha_core(seed, ds, n_out):
    """seed: 4 int32 tensors; ds: 4 int32 constants.  ChaCha12 with the
    fast-profile state layout -> the first ``n_out`` output words
    (permuted state + initial state, RFC 8439 feed-forward)."""
    z = torch.zeros_like(seed[0])
    init = (
        [torch.full_like(z, v) for v in _C]
        + list(seed)
        + [torch.full_like(z, v) for v in ds]
        + [z, z, z, z]
    )
    s = list(init)
    for _ in range(cc.ROUNDS // 2):
        _double_round(s)
    return [s[i] + init[i] for i in range(n_out)]


def _prg_expand(seed):
    """4x[K, W] -> (left 4x, right 4x) child seed words."""
    out = _chacha_core(seed, _DSX, 8)
    return out[0:4], out[4:8]


def _convert(seed):
    """4x[K, W] -> 16 output words (the leaf's 512 bits)."""
    return _chacha_core(seed, _DSL, 16)


def _interleave(l, r):
    """[K, W] pairs -> [K, 2W] with children in L,R order per parent."""
    return torch.stack([l, r], dim=2).reshape(l.shape[0], -1)


def _level_step_cc(S, T, scw_w, tlcw, trcw):
    """One expansion level.

    S: 4x int32[K, W]; T: int32[K, W] control bits (0/1);
    scw_w: 4x int32[K]; tlcw/trcw: int32[K]."""
    L, R = _prg_expand(S)
    tl = L[0] & 1
    tr = R[0] & 1
    L[0] = L[0] & ~1
    R[0] = R[0] & ~1
    msk = -T  # 0 / 0xFFFFFFFF
    L = [L[i] ^ (scw_w[i][:, None] & msk) for i in range(4)]
    R = [R[i] ^ (scw_w[i][:, None] & msk) for i in range(4)]
    tl = tl ^ (tlcw[:, None] & T)
    tr = tr ^ (trcw[:, None] & T)
    S2 = [_interleave(L[i], R[i]) for i in range(4)]
    T2 = _interleave(tl, tr)
    return S2, T2


def _convert_leaves_cc(S, T, fcw_w):
    """Leaf conversion + final CW -> int32[K, W, 16] output words."""
    out = _convert(S)
    msk = -T
    out = [out[j] ^ (fcw_w[j][:, None] & msk) for j in range(16)]
    return torch.stack(out, dim=2)


def _expand_levels_cc(S, T, scw, tcw):
    """``scw.shape[1]`` level steps with the CWs scw[K, L, 4], tcw[K, L, 2]."""
    for i in range(scw.shape[1]):
        S, T = _level_step_cc(
            S, T, [scw[:, i, w] for w in range(4)], tcw[:, i, 0], tcw[:, i, 1]
        )
    return S, T


def _expand_prefix_cc(n_levels, seeds, ts, scw, tcw):
    """Levels 0..n_levels-1 from the roots, plain (``_expand_prefix_cc_jit``)
    -> (4x int32[K, 2^n], int32[K, 2^n])."""
    S = [seeds[:, i : i + 1] for i in range(4)]
    return _expand_levels_cc(S, ts[:, None], scw[:, :n_levels], tcw[:, :n_levels])


def _eval_full_cc(nu, seeds, ts, scw, tcw, fcw):
    """The whole tree plain, level by level (``_eval_full_cc_jit``):
    seeds int32[K,4], ts int32[K], scw int32[K,nu,4], tcw int32[K,nu,2],
    fcw int32[K,16] -> int32[K, 2^nu, 16]."""
    S, T = _expand_prefix_cc(nu, seeds, ts, scw, tcw)
    return _convert_leaves_cc(S, T, [fcw[:, j] for j in range(16)])


class DeviceKeysFast:
    """A fast-profile key batch's operands on ``device`` (None: the card):
    seeds int32[K, 4], ts int32[K], scw int32[K, nu, 4], tcw int32[K, nu, 2]
    (0/1) and fcw int32[K, 16].  The counterpart of
    ``KeyBatchFast.device_args``."""

    def __init__(self, kb: KeyBatchFast, device=None):
        dev = self.device = _resolve_device(device)
        self.log_n, self.nu, self.k = kb.log_n, kb.nu, kb.k
        self.seeds = to_carrier(kb.seeds, dev)
        self.ts = to_carrier(kb.ts.astype(np.uint32), dev)
        self.scw = to_carrier(kb.scw.reshape(kb.k, kb.nu, 4), dev)
        self.tcw = to_carrier(kb.tcw.astype(np.uint32).reshape(kb.k, kb.nu, 2), dev)
        self.fcw = to_carrier(kb.fcw, dev)

    def root_state(self) -> torch.Tensor:
        """Level-0 state int32[5, K, 1]."""
        return torch.cat([self.seeds.T, self.ts[None]])[:, :, None].contiguous()


# ---------------------------------------------------------------------------
# Kernel routes
# ---------------------------------------------------------------------------

# Soft cap on K * 2^nu leaf nodes per one-shot expansion (64 B each); above
# it the tail runs over node-range chunks of its entry state.
MAX_LEAF_NODES = 1 << 23

# impl -> (fused levels, tail).  None: the wrappers, which launch the
# kernels on CUDA tensors and run the plain versions on CPU tensors.
# "plain": the plain versions on any device.
_IMPLS = {
    None: (cp.fused_levels, cp.expand_tail),
    "plain": (cp.fused_levels_plain, cp.expand_tail_plain),
}


def _groups(n_levels: int, g: int) -> list[int]:
    """``n_levels`` split into groups of at most ``g``, largest first."""
    return [min(g, n_levels - i) for i in range(0, n_levels, g)]


def _prefix(fused, dk, n_levels, root=None):
    """Levels 0..n_levels-1 from the roots (``root``: ``dk.root_state()``)
    as one ``fused`` launch per group of at most ``fuse_auto_levels()``
    levels (the card's stand-in for the JAX XLA prefix) -> int32[5, K,
    2^n_levels]."""
    state = dk.root_state() if root is None else root
    first = 0
    for g in _groups(n_levels, cp.fuse_auto_levels()):
        state = fused(state, dk.scw[:, first : first + g], dk.tcw[:, first : first + g])
        first += g
    return state


def _finish_pk(tail, dk, first, state, out=None):
    """The tail: levels first..nu-1 plus the leaf convert, ascending
    ``[K, W << L, 16]`` (``dpf_tpu``'s ``_finish_pk``)."""
    return tail(state, dk.scw[:, first:], dk.tcw[:, first:], dk.fcw, out=out)


def _eval_full_kernel_device(fns, dk, entry):
    """Classic route (entry >= 7) or whole-tree route (entry 0): the prefix
    to ``entry``, then one tail launch (``dpf_tpu``'s
    ``_eval_full_pallas_device`` and ``_eval_full_pk_jit``)."""
    fused, tail = fns
    return _finish_pk(tail, dk, entry, _prefix(fused, dk, entry))


def _eval_full_kernel_chunked(fns, dk, entry, n_chunks):
    """Chunked route: the prefix to ``entry``, then one tail launch per
    node-range chunk of the entry state, each writing its leaves into one
    output (``_eval_full_pallas_chunked``)."""
    fused, tail = fns
    state = _prefix(fused, dk, entry)
    levels = dk.nu - entry
    wc = (1 << entry) // n_chunks
    out = torch.empty((dk.k, 1 << dk.nu, 16), dtype=torch.int32, device=dk.device)
    for a in range(0, 1 << entry, wc):
        _finish_pk(tail, dk, entry, state[:, :, a : a + wc],
                   out=out[:, a << levels : (a + wc) << levels])
    return out


def eval_full_device(
    dk: DeviceKeysFast,
    max_leaf_nodes: int = MAX_LEAF_NODES,
    impl: str | None = None,
) -> torch.Tensor:
    """Full-domain evaluation on ``dk.device`` -> int32[K, 2^nu, 16] leaf
    words (word j of leaf w holds domain bits [512w + 32j, +32),
    LSB-first).

    ``impl=None`` runs the kernels on CUDA and their plain versions on the
    CPU; ``impl="plain"`` the plain versions on either."""
    if impl not in _IMPLS:
        raise ValueError(f"impl must be one of {list(_IMPLS)}, got {impl!r}")
    fns = _IMPLS[impl]
    nu, k = dk.nu, dk.k
    eligible, entry, kp = cp.expand_plan(nu, k, max_leaf_nodes)
    if eligible:
        return _eval_full_kernel_device(fns, dk, entry)
    if nu == 0 and kp <= max_leaf_nodes:
        return _eval_full_kernel_device(fns, dk, 0)
    ok, entry, _, n_chunks = cp.expand_plan_chunked(nu, k, max_leaf_nodes)
    if ok:
        return _eval_full_kernel_chunked(fns, dk, entry, n_chunks)
    raise RuntimeError(
        f"dpf-fast: no kernel route for nu={nu}, K={k} under max_leaf_nodes="
        f"{max_leaf_nodes}: the padded batch's {kp << nu} leaves exceed it, and "
        f"the chunked route needs nu >= 7, a chunked entry level ({entry}) of "
        f"at most nu, and at most {cp._MAX_PREFIX_LANES} padded-key lanes there"
    )


def eval_full(
    kb: KeyBatchFast,
    max_leaf_nodes: int = MAX_LEAF_NODES,
    device=None,
    impl: str | None = None,
) -> np.ndarray:
    """Full-domain evaluation -> uint8[K, out_bytes] bit-packed
    (out_bytes = 2^(log_n-3), at least 64), byte-identical to
    ``chacha_np.eval_full`` per key.  The key axis is zero-padded to the
    plan's 8-key quantum, as in the JAX routes.  ``device=None`` is the
    card."""
    pk = _pad_fast_batch(kb, (-kb.k) % cp._EKT)
    dk = DeviceKeysFast(pk, device)
    words = eval_full_device(dk, max_leaf_nodes, impl)
    return from_carrier(words[: kb.k]).view("<u1").reshape(kb.k, -1)


# ---------------------------------------------------------------------------
# Pointwise evaluation
# ---------------------------------------------------------------------------

# impl -> walk.  None: the wrapper (the kernel on CUDA tensors, the plain
# version on CPU tensors); "plain": the plain version on any device.
_WALK_IMPLS = {None: cp.walk, "plain": cp.walk_plain}


def _split_queries(xs: np.ndarray, log_n: int, device):
    """uint64[A, B] -> (xs_hi, xs_lo) int32 carriers of the transposed
    queries on ``device``, [B, A] each (split on the host, transposed on
    the device); xs_hi is None when log_n <= 32."""
    hi, lo = _split_words(xs, log_n, device)
    return (None if hi is None else hi.T.contiguous()), lo.T.contiguous()


def _walk_fn(impl):
    if impl not in _WALK_IMPLS:
        raise ValueError(f"impl must be one of {list(_WALK_IMPLS)}, got {impl!r}")
    return _WALK_IMPLS[impl]


def eval_points(
    kb: KeyBatchFast, xs: np.ndarray, packed: bool = False, device=None,
    impl: str | None = None,
) -> np.ndarray:
    """Batched pointwise evaluation: xs uint64[K, Q] -> uint8[K, Q], one
    walk launch.  ``packed=True`` returns bit-packed words
    uint32[K, ceil(Q/32)] instead (query q at word q//32, bit q%32,
    LSB-first, tail bits zero: core/bitpack.py), packed on the device.
    ``device=None`` is the card; ``impl="plain"`` runs the walk's plain
    version on either device."""
    xs = np.asarray(xs, dtype=np.uint64)
    if xs.ndim != 2 or xs.shape[0] != kb.k:
        raise ValueError("dpf-fast: xs must be [K, Q]")
    if (xs >> np.uint64(kb.log_n)).any():
        raise ValueError("dpf-fast: query index out of domain")
    walk = _walk_fn(impl)
    dev = _resolve_device(device)
    return cp.eval_points_walk(kb, xs, packed=packed, device=dev, walk_fn=walk)


def eval_points_level_grouped(
    kb: KeyBatchFast, xs: np.ndarray, groups: int, reduce: bool = False,
    packed: bool = False, levels=None, device=None, impl: str | None = None,
) -> np.ndarray:
    """FSS-support pointwise evaluation over level-major key groups.

    ``kb`` holds ``groups * log_n * G`` keys, ``groups`` repeats of
    ``log_n`` level-major blocks of ``G`` gates (models/fss.py layout); ``xs``
    is the RAW gate queries uint64[G, Q].  Key ``i*G + g`` of each group is
    evaluated at xs[g] with its low ``log_n - 1 - i`` bits zeroed (the
    dyadic-prefix query); the masking happens in the walk, against the
    per-key key_level / lowmask operands.  -> uint8[groups * log_n * G, Q];
    with ``reduce`` the blocks XOR-fold on the device into gate shares
    uint8[G, Q].  ``packed`` returns the same rows as uint32[., ceil(Q/32)]
    words.

    ``levels`` (a tuple of level indices) selects a subset of level blocks:
    ``kb`` holds ``groups * len(levels) * G`` keys, block ``j`` masks its
    queries to level ``levels[j]`` on the host, and the rows go through
    :func:`eval_points`."""
    xs = np.asarray(xs, dtype=np.uint64)
    if xs.ndim != 2:
        raise ValueError("dpf-fast: xs must be [G, Q]")
    G = xs.shape[0]
    if levels is not None:
        from .dpf import _masked_level_queries

        lv = tuple(int(i) for i in levels)
        if not lv or any(i < 0 or i >= kb.log_n for i in lv):
            raise ValueError("dpf-fast: levels must be non-empty, in [0, log_n)")
        if kb.k != groups * len(lv) * G:
            raise ValueError("dpf-fast: key count != groups * len(levels) * G")
        if (xs >> np.uint64(kb.log_n)).any():
            raise ValueError("dpf-fast: query index out of domain")
        out = eval_points(kb, _masked_level_queries(xs, kb.log_n, lv, groups),
                          packed=packed, device=device, impl=impl)
        if reduce:
            out = np.bitwise_xor.reduce(
                out.reshape(groups * len(lv), G, out.shape[1]), axis=0)
        return out
    if groups < 1 or kb.k != groups * kb.log_n * G:
        raise ValueError("dpf-fast: key count != groups * log_n * G")
    if (xs >> np.uint64(kb.log_n)).any():
        raise ValueError("dpf-fast: query index out of domain")
    walk = _walk_fn(impl)
    dev = _resolve_device(device)
    return cp.eval_points_walk(kb, xs, groups=groups, reduce=reduce, packed=packed,
                               device=dev, walk_fn=walk)
