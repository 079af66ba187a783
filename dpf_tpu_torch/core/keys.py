"""Batched DPF key handling: vectorized host-side Gen and the struct-of-arrays
form of serialized keys that the evaluator packs onto the device.

The port's counterpart of ``dpf_tpu/core/keys.py``.  Keys-as-bytes is the
wire/storage format (reference dpf/dpf.go:7: ``type DPFkey []byte``); this
module converts between that format and

    seeds  uint32[K, 4]       root seeds (16 B as little-endian words)
    ts     uint8[K]           root control bits
    scw    uint32[K, nu, 4]   per-level seed correction words
    tcw    uint8[K, nu, 2]    per-level (tLCW, tRCW) control-bit CWs
    fcw    uint32[K, 4]       final output correction word

Gen draws its root seeds on the host (the CSPRNG boundary, reference
dpf/dpf.go:80-81) and runs the correction-word tower on the card by default
(``models/keys_gen.gen_device_compat``), or, with ``device="cpu"``, as a
host loop vectorized across the key batch (:func:`_gen_from_roots`).  The
draw order is the JAX package's, so the same ``rng`` gives the same key
bytes in both packages and on both devices.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from . import aes_np, spec
from .device import resolve_device


@dataclass
class KeyBatch:
    """A batch of K same-domain DPF keys in struct-of-arrays form."""

    log_n: int
    seeds: np.ndarray  # uint32 [K, 4]
    ts: np.ndarray  # uint8  [K]
    scw: np.ndarray  # uint32 [K, nu, 4]
    tcw: np.ndarray  # uint8  [K, nu, 2]
    fcw: np.ndarray  # uint32 [K, 4]
    # Pointwise evaluation's lane masks per device (models/dpf._point_masks),
    # built at first use: key material is immutable once evaluated.
    _point_masks: dict = field(default_factory=dict, repr=False, compare=False)
    # Full-domain evaluation's packed key material per device
    # (models/dpf._cached_device_keys), built at first use.
    _device_keys: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def k(self) -> int:
        return self.seeds.shape[0]

    @property
    def nu(self) -> int:
        return max(self.log_n - 7, 0)

    @classmethod
    def from_bytes(cls, keys: list[bytes], log_n: int) -> "KeyBatch":
        """Parse serialized keys (reference byte layout, see spec.parse_key)."""
        nu = max(log_n - 7, 0)
        want = spec.key_len(log_n)
        arr = np.empty((len(keys), want), dtype=np.uint8)
        for i, k in enumerate(keys):
            if len(k) != want:
                raise ValueError(f"dpf: key {i} length {len(k)} != {want}")
            arr[i] = np.frombuffer(k, dtype=np.uint8)
        seeds = arr[:, :16].copy().view("<u4")
        ts = arr[:, 16].copy()
        cws = arr[:, 17 : 17 + 18 * nu].reshape(len(keys), nu, 18)
        scw = np.ascontiguousarray(cws[:, :, :16]).view("<u4")
        tcw = cws[:, :, 16:].copy()
        fcw = arr[:, -16:].copy().view("<u4")
        # Canonical-form check (same contract as spec.parse_key): keeps the
        # kernel path and the plain path bit-identical on every accepted key.
        if (
            (ts > 1).any()
            or (tcw > 1).any()
            or (arr[:, 0] & 1).any()
            or (cws[:, :, 0] & 1).any()
        ):
            raise ValueError("dpf: non-canonical key (control bytes/LSBs)")
        return cls(log_n, seeds, ts, scw, tcw, fcw)

    def to_bytes(self) -> list[bytes]:
        """Serialize back to the reference byte layout."""
        k, nu = self.k, self.nu
        cws = np.concatenate(
            [self.scw.view(np.uint8).reshape(k, nu, 16), self.tcw], axis=2
        )
        out = np.concatenate(
            [
                self.seeds.view(np.uint8).reshape(k, 16),
                self.ts[:, None],
                cws.reshape(k, 18 * nu),
                self.fcw.view(np.uint8).reshape(k, 16),
            ],
            axis=1,
        )
        return [bytes(row) for row in out]


def _draw_roots(
    K: int, rng: np.random.Generator | None
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Draw + canonicalize both parties' root seeds: (s0, t0, s1, t1)
    with control bits extracted and seed LSBs cleared.  This is the
    CSPRNG boundary — the draw order is part of the byte-identity
    contract with ``dpf_tpu.core.keys.gen_batch``."""
    if rng is None:
        raw = np.frombuffer(os.urandom(32 * K), dtype=np.uint8).reshape(K, 32)
        s0, s1 = raw[:, :16].copy(), raw[:, 16:].copy()
    else:
        s0 = rng.integers(0, 256, size=(K, 16), dtype=np.uint8)
        s1 = rng.integers(0, 256, size=(K, 16), dtype=np.uint8)
    t0 = (s0[:, 0] & 1).astype(np.uint8)
    t1 = t0 ^ 1
    s0[:, 0] &= 0xFE
    s1[:, 0] &= 0xFE
    return s0, t0, s1, t1


def gen_batch(
    alphas: np.ndarray | list[int],
    log_n: int,
    rng: np.random.Generator | None = None,
    *,
    device=None,
) -> tuple[KeyBatch, KeyBatch]:
    """Generate key pairs for a whole batch of points at once.

    Mirror of the reference Gen (dpf/dpf.go:71-169).  ``rng=None`` draws the
    root seeds from OS entropy; a seeded ``np.random.Generator`` gives the
    same key bytes as ``dpf_tpu.gen_batch`` with an equal generator.  The
    tower runs on ``device``: None is the card (through the plan cache,
    ``plans.run_gen``, onto ``keys_gen.gen_device_compat``), ``"cpu"`` the
    host tower; the bytes are the same."""
    alphas = np.asarray(alphas, dtype=np.uint64)
    K = alphas.shape[0]
    if log_n > 63 or (alphas >= (np.uint64(1) << np.uint64(log_n))).any():
        raise ValueError("dpf: invalid parameters")
    dev = resolve_device(device)
    s0, t0, s1, t1 = _draw_roots(K, rng)
    if dev.type == "cpu":
        return _gen_from_roots(alphas, log_n, s0, t0, s1, t1)
    from . import plans

    return plans.run_gen("compat", alphas, log_n, s0, t0, s1, t1, device=dev)


def _gen_from_roots(
    alphas: np.ndarray,
    log_n: int,
    s0: np.ndarray,
    t0: np.ndarray,
    s1: np.ndarray,
    t1: np.ndarray,
) -> tuple[KeyBatch, KeyBatch]:
    """The host correction-word tower: the level loop is sequential
    (inherent data dependence) but every AES call runs across all K keys
    as one numpy batch."""
    K = alphas.shape[0]
    nu = max(log_n - 7, 0)
    root0, root_t0 = s0.copy(), t0.copy()
    root1, root_t1 = s1.copy(), t1.copy()

    scw_all = np.zeros((K, nu, 16), dtype=np.uint8)
    tcw_all = np.zeros((K, nu, 2), dtype=np.uint8)

    for i in range(nu):
        s0l = aes_np.mmo_l(s0)
        s0r = aes_np.mmo_r(s0)
        s1l = aes_np.mmo_l(s1)
        s1r = aes_np.mmo_r(s1)
        t0l, t0r = s0l[:, 0] & 1, s0r[:, 0] & 1
        t1l, t1r = s1l[:, 0] & 1, s1r[:, 0] & 1
        for a in (s0l, s0r, s1l, s1r):
            a[:, 0] &= 0xFE

        bit = ((alphas >> np.uint64(log_n - 1 - i)) & np.uint64(1)).astype(np.uint8)
        b = bit[:, None].astype(bool)
        # LOSE child = the one alpha does NOT descend into.
        scw = np.where(b, s0l ^ s1l, s0r ^ s1r)
        tlcw = (t0l ^ t1l ^ bit ^ 1).astype(np.uint8)
        trcw = (t0r ^ t1r ^ bit).astype(np.uint8)
        scw_all[:, i] = scw
        tcw_all[:, i, 0] = tlcw
        tcw_all[:, i, 1] = trcw

        keep_s0 = np.where(b, s0r, s0l)
        keep_s1 = np.where(b, s1r, s1l)
        keep_t0 = np.where(bit, t0r, t0l).astype(np.uint8)
        keep_t1 = np.where(bit, t1r, t1l).astype(np.uint8)
        keep_tcw = np.where(bit, trcw, tlcw).astype(np.uint8)

        s0 = keep_s0 ^ (t0[:, None] * scw)
        s1 = keep_s1 ^ (t1[:, None] * scw)
        t0 = keep_t0 ^ (t0 * keep_tcw)
        t1 = keep_t1 ^ (t1 * keep_tcw)

    conv0 = aes_np.mmo_l(s0)
    conv1 = aes_np.mmo_l(s1)
    fcw = conv0 ^ conv1
    low = (alphas & np.uint64(127)).astype(np.int64)
    fcw[np.arange(K), low // 8] ^= (1 << (low % 8)).astype(np.uint8)

    def mk(root, root_t):
        return KeyBatch(
            log_n,
            root.view("<u4"),
            root_t,
            np.ascontiguousarray(scw_all).view("<u4").reshape(K, nu, 4),
            tcw_all,
            fcw.view("<u4").reshape(K, 4),
        )

    return mk(root0, root_t0), mk(root1, root_t1)
