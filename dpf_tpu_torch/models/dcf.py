"""Distributed Comparison Function (DCF): one key per comparison gate.

The port's counterpart of ``dpf_tpu/models/dcf.py``.  A DCF key shares the
whole comparison ``1{x < alpha}`` in ONE fast-profile GGM tree (Boyle,
Gilboa, Ishai, "Function Secret Sharing: Improvements and Extensions", CCS
2016, sec. 3.2): a DPF key plus one value correction bit per level and a
512-bit leaf correction.

  - The node PRG emits (left child, right child, v), v the 9th word of the
    same ChaCha block (core/chacha_np.prg_expand_v).
  - Gen walks alpha's path like DPF Gen (the same seed and control-bit CWs)
    and publishes per level i ``VCW_i = v(s0_i) ^ v(s1_i) ^ alpha_i``
    (LSBs), s0_i and s1_i the parties' on-path seeds.
  - Eval(x) walks x's path; at level i, while x descends left, each party
    accumulates ``v ^ t * VCW_i`` (t the parent's control bit).  On-path
    nodes contribute alpha_i, off-path nodes cancel, so the parties'
    accumulators XOR to 1 exactly when the first differing bit has x_j = 0
    and alpha_j = 1.
  - The low LEAF_LOG bits resolve in the leaf block: FVCW =
    convert(s0) ^ convert(s1) ^ LT(alpha_low) (bits j < alpha_low set), and
    each party XORs in bit x_low of ``convert(s) ^ t * FVCW``.

Key layout (to_bytes, per key): seed(16) | t(1) | nu * (sCW(16) | tL(1) |
tR(1) | VCW(1)) | FVCW(64) -> 81 + 19 nu bytes.

Gen runs on the host: the roots are drawn (``core/keys_chacha._draw_roots``)
and the tower runs as a numpy loop batched over the gates, the JAX
package's host route, so the same ``rng`` gives the same key bytes.  The
JAX package's device dealer (``keys_gen``) waits for its own slice.
Evaluation is one ``walk_dcf`` launch per call (``ops/chacha_cuda.py``,
kernel ``csrc/chacha_walk.cu::walk_dcf_kernel``) for any K and Q; the JAX
package takes its kernel only for K % 128 == 0 on the TPU and its XLA body
otherwise, with the same bytes.  The interval gate's two comparisons run as
one fused launch over both key sets.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field

import numpy as np

from ..core import bitpack
from ..core import chacha_np as cc
from ..core.keys_chacha import _draw_roots
from ..ops import chacha_cuda as cp
from .dpf import _resolve_device


@dataclass
class DcfKeyBatch:
    """One party's share of K comparison gates ``1{x < alpha}``."""

    log_n: int
    seeds: np.ndarray  # uint32 [K, 4]
    ts: np.ndarray  # uint8  [K]
    scw: np.ndarray  # uint32 [K, nu, 4]
    tcw: np.ndarray  # uint8  [K, nu, 2]
    vcw: np.ndarray  # uint8  [K, nu]   (LSB per level)
    fvcw: np.ndarray  # uint32 [K, 16]
    # The walk's operands per device (ops/chacha_cuda.dcf_walk_operands),
    # built at first use: key material is immutable once evaluated.
    _walk_ops: dict = field(default_factory=dict, repr=False, compare=False)
    # eval_interval_points' fused batch (see fused_pair), when this batch
    # is an interval's upper half.
    _both: object = field(default=None, repr=False, compare=False)

    @property
    def k(self) -> int:
        return self.seeds.shape[0]

    @property
    def nu(self) -> int:
        return cc.nu_of(self.log_n)

    def to_bytes(self) -> list[bytes]:
        k, nu = self.k, self.nu
        cws = np.concatenate(
            [
                self.scw.view(np.uint8).reshape(k, nu, 16),
                self.tcw,
                self.vcw[:, :, None],
            ],
            axis=2,
        )
        out = np.concatenate(
            [
                self.seeds.view(np.uint8).reshape(k, 16),
                self.ts[:, None],
                cws.reshape(k, 19 * nu),
                self.fvcw.view(np.uint8).reshape(k, 64),
            ],
            axis=1,
        )
        return [bytes(row) for row in out]

    @classmethod
    def from_bytes(cls, keys: list[bytes], log_n: int) -> "DcfKeyBatch":
        nu = cc.nu_of(log_n)
        want = key_len(log_n)
        arr = np.empty((len(keys), want), dtype=np.uint8)
        for i, b in enumerate(keys):
            if len(b) != want:
                raise ValueError(f"dcf: key {i} length {len(b)} != {want}")
            arr[i] = np.frombuffer(b, dtype=np.uint8)
        seeds = arr[:, :16].copy().view("<u4")
        ts = arr[:, 16].copy()
        cws = arr[:, 17 : 17 + 19 * nu].reshape(len(keys), nu, 19)
        scw = np.ascontiguousarray(cws[:, :, :16]).view("<u4")
        tcw = cws[:, :, 16:18].copy()
        vcw = cws[:, :, 18].copy()
        fvcw = arr[:, -64:].copy().view("<u4")
        if (
            (ts > 1).any()
            or (tcw > 1).any()
            or (vcw > 1).any()
            or (seeds[:, 0] & 1).any()
            or (scw[:, :, 0] & 1).any()
        ):
            raise ValueError("dcf: non-canonical key")
        return cls(log_n, seeds, ts, scw, tcw, vcw, fvcw)


def key_len(log_n: int) -> int:
    """Serialized DCF key size: 17 + 19*nu + 64 bytes."""
    return 17 + 19 * cc.nu_of(log_n) + 64


def _lt_leaf_mask(low: np.ndarray) -> np.ndarray:
    """uint64[K] in-leaf thresholds -> uint32[K, 16] blocks with bits
    j < low set (LSB-first within words, ascending words)."""
    j = np.arange(cc.LEAF_BITS, dtype=np.uint64)
    bits = (j[None, :] < low[:, None]).astype(np.uint8)
    w = bits.reshape(-1, 16, 32).astype(np.uint32)
    return (w << np.arange(32, dtype=np.uint32)).sum(-1, dtype=np.uint32)


def gen_lt_batch(
    alphas: np.ndarray | list[int],
    log_n: int,
    rng: np.random.Generator | None = None,
) -> tuple[DcfKeyBatch, DcfKeyBatch]:
    """Vectorized DCF Gen for K gates ``1{x < alpha}`` -> (key_a, key_b), on
    the host: both parties' roots drawn (one 2K draw, party A first), then
    the tower of :func:`_gen_lt_from_roots`."""
    alphas = np.asarray(alphas, dtype=np.uint64)
    K = alphas.shape[0]
    if log_n > 63 or log_n < 1 or (alphas >> np.uint64(log_n)).any():
        raise ValueError("dcf: invalid parameters")
    s0, t0, s1, t1 = _draw_roots(K, rng)
    return _gen_lt_from_roots(alphas, log_n, s0, t0, s1, t1)


def _gen_lt_from_roots(
    alphas: np.ndarray,
    log_n: int,
    s0: np.ndarray,
    t0: np.ndarray,
    s1: np.ndarray,
    t1: np.ndarray,
) -> tuple[DcfKeyBatch, DcfKeyBatch]:
    """The host DCF tower: the fast-profile Gen level loop plus the value
    CWs and the in-leaf comparison correction."""
    K = alphas.shape[0]
    nu = cc.nu_of(log_n)
    root0, rt0 = s0.copy(), t0.copy()
    root1, rt1 = s1.copy(), t1.copy()

    scw_all = np.zeros((K, nu, 4), dtype=np.uint32)
    tcw_all = np.zeros((K, nu, 2), dtype=np.uint8)
    vcw_all = np.zeros((K, nu), dtype=np.uint8)

    for i in range(nu):
        l0, r0, v0 = cc.prg_expand_v(s0)
        l1, r1, v1 = cc.prg_expand_v(s1)
        t0l, t0r = (l0[:, 0] & 1).astype(np.uint8), (r0[:, 0] & 1).astype(np.uint8)
        t1l, t1r = (l1[:, 0] & 1).astype(np.uint8), (r1[:, 0] & 1).astype(np.uint8)
        for a in (l0, r0, l1, r1):
            a[:, 0] &= ~np.uint32(1)

        bit = ((alphas >> np.uint64(log_n - 1 - i)) & np.uint64(1)).astype(np.uint8)
        vcw_all[:, i] = (v0 ^ v1 ^ bit.astype(np.uint32)) & 1
        b = bit[:, None].astype(bool)
        scw = np.where(b, l0 ^ l1, r0 ^ r1)  # LOSE side
        tlcw = (t0l ^ t1l ^ bit ^ 1).astype(np.uint8)
        trcw = (t0r ^ t1r ^ bit).astype(np.uint8)
        scw_all[:, i] = scw
        tcw_all[:, i, 0] = tlcw
        tcw_all[:, i, 1] = trcw

        keep_s0 = np.where(b, r0, l0)
        keep_s1 = np.where(b, r1, l1)
        keep_t0 = np.where(bit, t0r, t0l).astype(np.uint8)
        keep_t1 = np.where(bit, t1r, t1l).astype(np.uint8)
        keep_tcw = np.where(bit, trcw, tlcw).astype(np.uint8)

        s0 = keep_s0 ^ (t0[:, None].astype(np.uint32) * scw)
        s1 = keep_s1 ^ (t1[:, None].astype(np.uint32) * scw)
        t0 = keep_t0 ^ (t0 * keep_tcw)
        t1 = keep_t1 ^ (t1 * keep_tcw)

    conv0 = cc.convert_leaf(s0)
    conv1 = cc.convert_leaf(s1)
    low = alphas & np.uint64(cc.LEAF_BITS - 1) if log_n >= cc.LEAF_LOG else alphas
    fvcw = conv0 ^ conv1 ^ _lt_leaf_mask(low)

    def mk(root, rt):
        return DcfKeyBatch(
            log_n, root, rt, scw_all.copy(), tcw_all.copy(), vcw_all.copy(), fvcw,
        )

    return mk(root0, rt0), mk(root1, rt1)


def eval_points_np(kb: DcfKeyBatch, xs: np.ndarray) -> np.ndarray:
    """Pure-NumPy spec evaluation: xs uint64[K, Q] -> uint8[K, Q].  Slow;
    the oracle the walk is held against."""
    xs = np.asarray(xs, dtype=np.uint64)
    K, Q = xs.shape
    if K != kb.k:
        raise ValueError("dcf: xs first axis must match key batch")
    if (xs >> np.uint64(kb.log_n)).any():
        raise ValueError("dcf: query index out of domain")
    n, nu = kb.log_n, kb.nu
    s = np.repeat(kb.seeds[:, None, :], Q, axis=1).reshape(K * Q, 4)
    t = np.repeat(kb.ts.astype(np.uint32)[:, None], Q, axis=1).reshape(-1)
    acc = np.zeros(K * Q, np.uint32)
    xf = xs.reshape(-1)
    kidx = np.repeat(np.arange(K), Q)
    for i in range(nu):
        l, r, v = cc.prg_expand_v(s)
        tl = l[:, 0] & 1
        tr = r[:, 0] & 1
        l[:, 0] &= ~np.uint32(1)
        r[:, 0] &= ~np.uint32(1)
        vcw = kb.vcw[kidx, i].astype(np.uint32)
        xbit = ((xf >> np.uint64(n - 1 - i)) & np.uint64(1)).astype(np.uint32)
        acc ^= (v ^ (t * vcw)) & np.uint32(1) & (1 - xbit)
        scw = kb.scw[kidx, i]
        tcw = kb.tcw[kidx, i].astype(np.uint32)
        go_r = xbit[:, None].astype(bool)
        s = np.where(go_r, r, l) ^ (t[:, None] * scw)
        t = np.where(xbit.astype(bool), tr, tl) ^ (t * np.where(
            xbit.astype(bool), tcw[:, 1], tcw[:, 0]
        ))
    block = cc.convert_leaf(s) ^ (t[:, None] * kb.fvcw[kidx])
    low = (xf & np.uint64(cc.LEAF_BITS - 1)).astype(np.int64)
    if n < cc.LEAF_LOG:
        low = xf.astype(np.int64)
    sel = block[np.arange(K * Q), low >> 5]
    acc ^= (sel >> (low & 31).astype(np.uint32)) & 1
    return acc.astype(np.uint8).reshape(K, Q)


def eval_lt_points(
    kb: DcfKeyBatch, xs: np.ndarray, packed: bool = False, device=None
) -> np.ndarray:
    """Batched comparison shares: xs uint64[K, Q] -> uint8[K, Q] with
    ``eval(ka) ^ eval(kb) == 1{x < alpha}`` per gate, one walk launch on
    ``device`` (None: the card).  ``packed`` returns uint32[K, ceil(Q/32)]
    words packed on the device (core/bitpack contract; XOR reconstruction
    works on the words)."""
    xs = np.asarray(xs, dtype=np.uint64)
    if xs.ndim != 2 or xs.shape[0] != kb.k:
        raise ValueError("dcf: xs must be [K, Q]")
    if (xs >> np.uint64(kb.log_n)).any():
        raise ValueError("dcf: query index out of domain")
    return cp.eval_points_walk_dcf(kb, xs, packed=packed, device=_resolve_device(device))


def interval_alphas(lo, hi, log_n: int, tag: str):
    """Checked bounds of interval gates ``1{lo <= x <= hi}`` -> (upper
    alphas, lower alphas, party A's constants, party B's constants).  The
    gate is ``1{x < hi+1} ^ 1{x < lo}``; where ``hi = 2^n - 1`` (hi + 1
    leaves the domain) the upper gate takes alpha 0, which is always 0, and
    party A a public constant 1.  ``tag`` prefixes the errors ("dcf",
    "fss")."""
    lo = np.asarray(lo, dtype=np.uint64)
    hi = np.asarray(hi, dtype=np.uint64)
    if lo.shape != hi.shape or lo.ndim != 1:
        raise ValueError(f"{tag}: lo/hi must be 1-D and equal length")
    if (lo > hi).any():
        raise ValueError(f"{tag}: lo > hi")
    top = (np.uint64(1) << np.uint64(log_n)) - np.uint64(1)
    if (hi > top).any():
        raise ValueError(f"{tag}: hi out of domain")
    wrap = hi == top
    const_a = wrap.astype(np.uint8)
    upper = np.where(wrap, np.uint64(0), hi + np.uint64(1))
    return upper, lo, const_a, np.zeros_like(const_a)


def fold_const(out: np.ndarray, const: np.ndarray, q: int, packed: bool) -> np.ndarray:
    """XOR the interval gates' public constants (0 or 1 a gate) into their
    shares: uint8[G, Q] bits, or uint32[G, ceil(Q/32)] words, whose tail
    bits the complement sets and the mask clears again."""
    if packed:
        cmask = (np.uint32(0) - const.astype(np.uint32))[:, None]
        return bitpack.mask_tail(out ^ cmask, q)
    return out ^ const[:, None]


def concat_batches(a, b):
    """One key batch of ``a``'s keys then ``b``'s, for the key batches of
    either profile and the DCF (their array fields, caches left empty)."""
    names = [f.name for f in dataclasses.fields(a)
             if not f.name.startswith("_") and f.name != "log_n"]
    return type(a)(log_n=a.log_n,
                   **{n: np.concatenate([getattr(a, n), getattr(b, n)]) for n in names})


def fused_pair(holder, upper, lower):
    """The interval's fused ``upper || lower`` batch, built once and memoized
    in ``holder._both`` with its device operands.  The memo is keyed on the
    *pair*: a fused batch built against another half would return wrong
    interval shares."""
    memo = holder._both
    if memo is None or memo[0] is not upper or memo[1] is not lower:
        memo = holder._both = (upper, lower, concat_batches(upper, lower))
    return memo[2]


def gen_interval_batch(
    lo: np.ndarray | list[int],
    hi: np.ndarray | list[int],
    log_n: int,
    rng: np.random.Generator | None = None,
):
    """K interval gates ``1{lo <= x <= hi}`` from TWO DCFs per gate
    (``lt_{hi+1} ^ lt_{lo}``; the ``hi = 2^n - 1`` wrap edge becomes an
    always-0 upper gate plus a public constant on party A).  Returns two
    (upper, lower, const) triples, upper drawn first; evaluate with
    :func:`eval_interval_points`."""
    upper_alpha, lo, const_a, const_b = interval_alphas(lo, hi, log_n, "dcf")
    ua, ub = gen_lt_batch(upper_alpha, log_n, rng=rng)
    la, lb = gen_lt_batch(lo, log_n, rng=rng)
    return (ua, la, const_a), (ub, lb, const_b)


def eval_interval_points(
    ik, xs: np.ndarray, packed: bool = False, lt_eval=None, device=None
) -> np.ndarray:
    """Interval shares at xs uint64[K, Q] -> uint8[K, Q]; ``ik`` is one
    party's (upper, lower, const) triple from :func:`gen_interval_batch`.
    Both gate sets evaluate in ONE launch over a fused 2K-key batch, built
    once per (upper, lower) pair and reused with its device operands.
    ``packed`` returns uint32[K, ceil(Q/32)] words; the upper ^ lower fold
    and the public wrap constant apply on the words.  ``lt_eval`` replaces
    the comparison evaluator (the signature of :func:`eval_lt_points`
    without ``device``); by default it is :func:`eval_lt_points` on
    ``device``."""
    upper, lower, const = ik[0], ik[1], ik[2]
    if lt_eval is None:
        lt_eval = functools.partial(eval_lt_points, device=device)
    xs = np.asarray(xs, dtype=np.uint64)
    if xs.ndim != 2 or xs.shape[0] != upper.k:
        raise ValueError("dcf: xs must be [K, Q]")
    both = fused_pair(upper, upper, lower)
    k = upper.k
    out = lt_eval(both, np.concatenate([xs, xs]), packed=packed)
    return fold_const(out[:k] ^ out[k:], const, xs.shape[1], packed)
