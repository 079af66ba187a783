"""FSS comparison and interval gates built from batched DPFs.

The port's counterpart of ``dpf_tpu/models/fss.py``.  The reference library
stops at point functions (dpf/dpf.go: Gen/Eval/EvalFull); comparison and
interval gates are the FSS application layered on top (BGI 2016, sec.
3.2.2: an interval is a union of at most ``log N`` dyadic intervals, each a
point function on a prefix domain).

Comparison, ``1{x < alpha}`` over ``[0, 2^n)``: x < alpha exactly when, at a
unique level i, x and alpha agree on their top i bits, bit i of alpha
(MSB-first) is 1 and bit i of x is 0.  Level i's condition is the point
function "top i+1 bits of x equal (alpha's top i bits || 0)", embedded in
the full n-bit domain (the prefix shifted back up, low bits zero), so the n
levels of G gates form one key batch of ``n * G`` keys, level-major.  A
level whose alpha bit is 0 contributes 0: both parties get the same key for
a random point, whose evaluations cancel under XOR.  Since the matching
level is unique, the XOR over levels is the predicate:

    eval_lt_points(ck_a, xs) ^ eval_lt_points(ck_b, xs) == (xs < alpha)

An interval gate ``1{lo <= x <= hi}`` is ``lt_{hi+1} ^ lt_{lo}``, evaluated
as one fused batch over both gate sets; the ``hi == 2^n - 1`` edge folds
into a public constant on party A.

Both profiles run each gate call as ONE walk launch of their
``eval_points_level_grouped`` with ``reduce``: the dyadic-prefix masking and
the level XOR-fold happen on the device, and only the raw ``[G, Q]``
queries go in and the ``[G, Q]`` shares come out.  (The JAX package expands
the compat queries on the host off the TPU; the port's compat walk takes
the grouped form on either device, with the same bytes.)

``ge_full_from_dpf``: full-domain comparison shares from ONE ordinary DPF
key, by a carry-less prefix XOR over its bit-packed EvalFull output
(XOR_{y <= x} DPF_alpha(y) = 1{x >= alpha}).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.keys import KeyBatch, gen_batch
from ..core.keys_chacha import KeyBatchFast
from ..ops.aes_bitslice import from_carrier
from . import dpf, dpf_chacha
from .dcf import fold_const, fused_pair, interval_alphas

__all__ = [
    "CmpKeyBatch",
    "IntervalKeyBatch",
    "gen_lt_batch",
    "eval_lt_points",
    "gen_interval_batch",
    "eval_interval_points",
    "ge_full_from_dpf",
]


def _profile_funcs(profile: str):
    """(gen_batch, key-batch class, key_len, grouped_eval) per profile;
    ``grouped_eval`` is the profile's ``eval_points_level_grouped``."""
    if profile == "fast":
        from ..core.chacha_np import key_len as kl
        from ..core.keys_chacha import gen_batch as gb

        return gb, KeyBatchFast, kl, dpf_chacha.eval_points_level_grouped
    if profile == "compat":
        from ..core.spec import key_len as kl

        return gen_batch, KeyBatch, kl, dpf.eval_points_level_grouped
    raise ValueError(f"fss: unknown profile {profile!r}")


@dataclass
class CmpKeyBatch:
    """One party's share of G comparison gates ``1{x < alpha_g}``.

    ``levels`` holds ``n * G`` full-domain DPF keys, level-major: key
    ``i * G + g`` is gate g's level-i DPF.  Serializes per gate as the
    concatenation of its n per-profile-layout DPF keys."""

    log_n: int
    levels: KeyBatch | KeyBatchFast  # K = log_n * G keys on the n-bit domain
    profile: str = "compat"

    @property
    def g(self) -> int:
        return self.levels.k // self.log_n

    def to_bytes(self) -> list[bytes]:
        """-> G blobs, each ``log_n * key_len(log_n)`` bytes."""
        lv = self.levels.to_bytes()
        G = self.g
        return [b"".join(lv[i * G + g] for i in range(self.log_n)) for g in range(G)]

    @classmethod
    def from_bytes(
        cls, blobs: list[bytes], log_n: int, profile: str = "compat"
    ) -> "CmpKeyBatch":
        _, batch_cls, key_len, _ = _profile_funcs(profile)

        kl = key_len(log_n)
        keys: list[bytes] = []
        for i in range(log_n):
            for g, blob in enumerate(blobs):
                if len(blob) != log_n * kl:
                    raise ValueError(f"fss: gate {g} blob length != {log_n * kl}")
                keys.append(blob[i * kl : (i + 1) * kl])
        return cls(log_n, batch_cls.from_bytes(keys, log_n), profile)


@dataclass
class IntervalKeyBatch:
    """One party's share of G interval gates ``1{lo_g <= x <= hi_g}``:
    two comparison gate sets plus a public per-gate constant (non-zero only
    on party A, only for the ``hi == 2^n - 1`` edge)."""

    upper: CmpKeyBatch  # lt_{hi+1}
    lower: CmpKeyBatch  # lt_{lo}
    const: np.ndarray  # uint8 [G]
    # eval_interval_points' fused upper||lower level batch (dcf.fused_pair).
    _both: object = field(default=None, repr=False, compare=False)


def _rand_points(rng: np.random.Generator, shape, log_n: int) -> np.ndarray:
    raw = rng.integers(0, 1 << 32, size=shape + (2,), dtype=np.uint64)
    v = (raw[..., 0] << np.uint64(32)) | raw[..., 1]
    return v & ((np.uint64(1) << np.uint64(log_n)) - np.uint64(1))


def gen_lt_batch(
    alphas: np.ndarray | list[int],
    log_n: int,
    rng: np.random.Generator | None = None,
    profile: str = "compat",
) -> tuple[CmpKeyBatch, CmpKeyBatch]:
    """Generate G comparison gate pairs for ``1{x < alpha}`` on the host:
    the inactive levels' random points are drawn first, then one
    ``gen_batch`` over all ``log_n * G`` level DPFs draws its roots from the
    same ``rng`` (the JAX package's order).  ``profile="fast"`` builds the
    gates from ChaCha-profile DPFs."""
    gen, _, _, _ = _profile_funcs(profile)
    alphas = np.asarray(alphas, dtype=np.uint64)
    if log_n < 1 or log_n > 63:
        raise ValueError("fss: log_n out of range")
    if (alphas >> np.uint64(log_n)).any():
        raise ValueError("fss: alpha out of domain")
    G = alphas.shape[0]
    n = log_n
    point_rng = rng if rng is not None else np.random.default_rng()

    shifts = (n - 1 - np.arange(n, dtype=np.uint64))[:, None]  # [n, 1]
    pref = alphas[None, :] >> shifts  # top i+1 bits of alpha
    active = (pref & np.uint64(1)).astype(bool)  # bit i of alpha
    points = (pref & ~np.uint64(1)) << shifts  # (top-i bits || 0) << shift
    points = np.where(active, points, _rand_points(point_rng, (n, G), n))

    ka, kb = gen(points.reshape(n * G), n, rng=rng)
    # Zero-share inactive levels: party B gets party A's key verbatim.
    idx = np.flatnonzero(~active.reshape(n * G))
    for f in ("seeds", "ts", "scw", "tcw", "fcw"):
        getattr(kb, f)[idx] = getattr(ka, f)[idx]
    return CmpKeyBatch(n, ka, profile), CmpKeyBatch(n, kb, profile)


def _masked_prefix_queries(xs: np.ndarray, log_n: int) -> np.ndarray:
    """uint64[G, Q] -> uint64[n * G, Q]: per level, x with its low
    ``n - 1 - i`` bits zeroed (the level-i prefix, shifted back up): the
    queries each level's keys see, which the grouped walk masks on the
    device."""
    n = log_n
    shifts = (n - 1 - np.arange(n, dtype=np.uint64))[:, None, None]
    return ((xs[None, :, :] >> shifts) << shifts).reshape(n * xs.shape[0], -1)


def eval_lt_points(
    ck: CmpKeyBatch, xs: np.ndarray, packed: bool = False, device=None
) -> np.ndarray:
    """Comparison shares at xs uint64[G, Q] -> uint8[G, Q]: one walk launch
    over all ``n * G`` level DPFs on ``device`` (None: the card), the level
    XOR-fold on the device.  ``packed`` returns uint32[G, ceil(Q/32)]
    words (core/bitpack contract)."""
    xs = np.asarray(xs, dtype=np.uint64)
    if xs.ndim != 2 or xs.shape[0] != ck.g:
        raise ValueError("fss: xs must be [G, Q]")
    grouped = _profile_funcs(ck.profile)[3]
    return grouped(ck.levels, xs, groups=1, reduce=True, packed=packed, device=device)


def gen_interval_batch(
    lo: np.ndarray | list[int],
    hi: np.ndarray | list[int],
    log_n: int,
    rng: np.random.Generator | None = None,
    profile: str = "compat",
) -> tuple[IntervalKeyBatch, IntervalKeyBatch]:
    """Generate G interval gate pairs for ``1{lo <= x <= hi}`` (inclusive):
    ``1{x < hi+1} ^ 1{x < lo}``, the upper gates drawn first; the
    ``hi = 2^n - 1`` edge (hi+1 leaves the domain) becomes an always-0 gate
    plus a public constant 1 on party A."""
    # alpha = 0 has no set bits -> every level inactive -> lt_0 == 0 shares.
    upper_alpha, lo, const_a, const_b = interval_alphas(lo, hi, log_n, "fss")
    ua, ub = gen_lt_batch(upper_alpha, log_n, rng=rng, profile=profile)
    la, lb = gen_lt_batch(lo, log_n, rng=rng, profile=profile)
    return IntervalKeyBatch(ua, la, const_a), IntervalKeyBatch(ub, lb, const_b)


def eval_interval_points(
    ik: IntervalKeyBatch, xs: np.ndarray, packed: bool = False, device=None
) -> np.ndarray:
    """Interval shares at xs uint64[G, Q] -> uint8[G, Q]: both comparison
    gate sets in ONE walk launch (a fused batch of ``2 * n * G`` keys,
    ``groups=2``) on ``device``.  ``packed`` returns uint32[G, ceil(Q/32)]
    words; the public wrap constant complements rows on the words."""
    grouped = _profile_funcs(ik.upper.profile)[3]
    xs = np.asarray(xs, dtype=np.uint64)
    if xs.ndim != 2 or xs.shape[0] != ik.upper.g:
        raise ValueError("fss: xs must be [G, Q]")
    both = fused_pair(ik, ik.upper.levels, ik.lower.levels)
    out = grouped(both, xs, groups=2, reduce=True, packed=packed, device=device)
    return fold_const(out, ik.const, xs.shape[1], packed)


# ---------------------------------------------------------------------------
# Full-domain comparison from a single ordinary DPF
# ---------------------------------------------------------------------------


def _prefix_xor_words(w: torch.Tensor) -> torch.Tensor:
    """Bitwise prefix XOR over int32 carriers of uint32[K, M] in ascending
    LSB-first bit order: output bit j = XOR of input bits 0..j (per key).
    In-word prefixes by shifted XORs (int32 ``<<`` keeps bit 31), then each
    word is complemented where the words below it hold odd parity: the
    exclusive prefix parity, a ``cumsum`` of the word parities, stands in
    for the JAX package's associative scan."""
    for sh in (1, 2, 4, 8, 16):
        w = w ^ (w << sh)
    par = (w >> 31) & 1  # bit 31 of the in-word prefix: the word's parity
    carry = (torch.cumsum(par, dim=1, dtype=torch.int32) & 1) ^ par
    return w ^ -carry  # complement the words with odd carry-in


def ge_full_from_dpf(kb: KeyBatch | KeyBatchFast, device=None) -> np.ndarray:
    """Full-domain comparison table from plain DPF keys: for a key pair on
    alpha, the parties' outputs XOR to the bit-packed ``1{x >= alpha}`` over
    the whole domain (``1{x < alpha}`` is its public complement).  Expands
    each key with its profile's ``eval_full_device`` on ``device`` (None:
    the card), then one prefix-XOR pass there.  -> uint8[K, out_bytes],
    packed as ``eval_full`` (bit x at byte x//8, bit x%8)."""
    if isinstance(kb, KeyBatchFast):
        words = dpf_chacha.eval_full_device(dpf_chacha.DeviceKeysFast(kb, device))
    else:
        words = dpf.eval_full_device(dpf.DeviceKeys(kb, device))  # [K_padded, W, 4]
    scanned = _prefix_xor_words(words[: kb.k].reshape(kb.k, -1))
    return from_carrier(scanned).view("<u1").reshape(kb.k, -1)
