"""Batched key handling for the ChaCha fast profile.

The port's counterpart of ``dpf_tpu/models/keys_chacha.py``.
Struct-of-arrays form of the fast-profile key layout (core/chacha_np.py):
128-bit seeds, 18-byte per-level CWs (the reference's CW shape,
dpf/dpf.go:111-112), a 64-byte final CW for the 512-bit leaf:

    seeds  uint32[K, 4]       root seeds
    ts     uint8[K]           root control bits
    scw    uint32[K, nu, 4]   per-level seed correction words
    tcw    uint8[K, nu, 2]    per-level (tLCW, tRCW)
    fcw    uint32[K, 16]      final output correction word

Gen draws its root seeds on the host and runs the correction-word tower on
the card by default (one ``gen_tower`` launch, ``models/keys_gen.py``), or,
with ``device="cpu"``, as a host loop vectorized across the key batch.  The
draw order is the JAX package's, so the same ``rng`` gives the same key
bytes in both packages and on both devices.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import chacha_np as cc
from .device import resolve_device


@dataclass
class KeyBatchFast:
    """K same-domain fast-profile DPF keys in struct-of-arrays form."""

    log_n: int
    seeds: np.ndarray  # uint32 [K, 4]
    ts: np.ndarray  # uint8  [K]
    scw: np.ndarray  # uint32 [K, nu, 4]
    tcw: np.ndarray  # uint8  [K, nu, 2]
    fcw: np.ndarray  # uint32 [K, 16]
    # The pointwise walk's operands per (groups, device)
    # (ops/chacha_cuda.walk_operands), built at first use.
    _walk_ops: dict = field(default_factory=dict, repr=False, compare=False)
    # Full-domain evaluation's DeviceKeysFast of the batch padded to the
    # plan's 8-key quantum, per device (models/dpf._cached_device_keys).
    _device_keys: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def k(self) -> int:
        return self.seeds.shape[0]

    @property
    def nu(self) -> int:
        return cc.nu_of(self.log_n)

    @classmethod
    def from_bytes(cls, keys: list[bytes], log_n: int) -> "KeyBatchFast":
        nu = cc.nu_of(log_n)
        want = cc.key_len(log_n)
        arr = np.empty((len(keys), want), dtype=np.uint8)
        for i, k in enumerate(keys):
            if len(k) != want:
                raise ValueError(f"dpf-fast: key {i} length {len(k)} != {want}")
            arr[i] = np.frombuffer(k, dtype=np.uint8)
        seeds = arr[:, :16].copy().view("<u4")
        ts = arr[:, 16].copy()
        cws = arr[:, 17 : 17 + 18 * nu].reshape(len(keys), nu, 18)
        scw = np.ascontiguousarray(cws[:, :, :16]).view("<u4")
        tcw = cws[:, :, 16:].copy()
        fcw = arr[:, -64:].copy().view("<u4")
        if (
            (ts > 1).any()
            or (tcw > 1).any()
            or (seeds[:, 0] & 1).any()
            or (scw[:, :, 0] & 1).any()
        ):
            raise ValueError("dpf-fast: non-canonical key")
        return cls(log_n, seeds, ts, scw, tcw, fcw)

    def to_bytes(self) -> list[bytes]:
        k, nu = self.k, self.nu
        cws = np.concatenate(
            [self.scw.view(np.uint8).reshape(k, nu, 16), self.tcw], axis=2
        )
        out = np.concatenate(
            [
                self.seeds.view(np.uint8).reshape(k, 16),
                self.ts[:, None],
                cws.reshape(k, 18 * nu),
                self.fcw.view(np.uint8).reshape(k, 64),
            ],
            axis=1,
        )
        return [bytes(row) for row in out]


def _pad_fast_batch(kb: KeyBatchFast, pad: int) -> KeyBatchFast:
    """Zero-pad the key axis by ``pad`` keys (``dpf_tpu``'s
    ``parallel/sharding._pad_fast_batch``, without its memo)."""
    if not pad:
        return kb

    def padk(a):
        return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])

    return KeyBatchFast(
        kb.log_n, padk(kb.seeds), padk(kb.ts), padk(kb.scw),
        padk(kb.tcw), padk(kb.fcw),
    )


def _draw_roots(
    K: int, rng: np.random.Generator | None
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Draw + canonicalize both parties' root seeds (the CSPRNG boundary;
    one 2K draw, party A first -- the draw order is part of the
    byte-identity contract with the JAX package)."""
    raw = cc.gen_root_seeds(2 * K, rng)
    s0 = np.ascontiguousarray(raw[:K]).view("<u4")
    s1 = np.ascontiguousarray(raw[K:]).view("<u4")
    t0 = (s0[:, 0] & 1).astype(np.uint8)
    t1 = t0 ^ 1
    s0[:, 0] &= ~np.uint32(1)
    s1[:, 0] &= ~np.uint32(1)
    return s0, t0, s1, t1


def gen_batch(
    alphas: np.ndarray | list[int],
    log_n: int,
    rng: np.random.Generator | None = None,
    *,
    device=None,
) -> tuple[KeyBatchFast, KeyBatchFast]:
    """Fast-profile Gen: root seeds drawn on the host, then the
    correction-word tower on ``device``: None is the card (one
    ``gen_tower`` launch, through ``plans.run_gen``), ``"cpu"`` the host
    tower of
    :func:`_gen_from_roots`; the bytes are the same."""
    alphas = np.asarray(alphas, dtype=np.uint64)
    K = alphas.shape[0]
    if log_n > 63 or (alphas >> np.uint64(log_n)).any():
        raise ValueError("dpf-fast: invalid parameters")
    dev = resolve_device(device)
    s0, t0, s1, t1 = _draw_roots(K, rng)
    if dev.type == "cpu":
        return _gen_from_roots(alphas, log_n, s0, t0, s1, t1)
    from . import plans

    return plans.run_gen("fast", alphas, log_n, s0, t0, s1, t1, device=dev)


def _gen_from_roots(
    alphas: np.ndarray,
    log_n: int,
    s0: np.ndarray,
    t0: np.ndarray,
    s1: np.ndarray,
    t1: np.ndarray,
) -> tuple[KeyBatchFast, KeyBatchFast]:
    """The host tower: the reference Gen level loop (dpf/dpf.go:94-158)
    with the ChaCha node PRG, stopping 9 levels early (512-bit leaves),
    every step batched over all K keys."""
    K = alphas.shape[0]
    nu = cc.nu_of(log_n)
    root0, rt0 = s0.copy(), t0.copy()
    root1, rt1 = s1.copy(), t1.copy()

    scw_all = np.zeros((K, nu, 4), dtype=np.uint32)
    tcw_all = np.zeros((K, nu, 2), dtype=np.uint8)

    for i in range(nu):
        l0, r0 = cc.prg_expand(s0)
        l1, r1 = cc.prg_expand(s1)
        t0l, t0r = (l0[:, 0] & 1).astype(np.uint8), (r0[:, 0] & 1).astype(np.uint8)
        t1l, t1r = (l1[:, 0] & 1).astype(np.uint8), (r1[:, 0] & 1).astype(np.uint8)
        for a in (l0, r0, l1, r1):
            a[:, 0] &= ~np.uint32(1)

        bit = ((alphas >> np.uint64(log_n - 1 - i)) & np.uint64(1)).astype(np.uint8)
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
    fcw = conv0 ^ conv1
    low = (
        (alphas & np.uint64(cc.LEAF_BITS - 1)).astype(np.int64)
        if log_n >= cc.LEAF_LOG
        else alphas.astype(np.int64)
    )
    fcw[np.arange(K), low >> 5] ^= (np.uint32(1) << (low & 31).astype(np.uint32))

    def mk(root, rt):
        return KeyBatchFast(log_n, root, rt, scw_all.copy(), tcw_all.copy(), fcw)

    return mk(root0, rt0), mk(root1, rt1)
