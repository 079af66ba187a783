"""Pure-NumPy DPF executable spec — the port's host golden model.

The port's own copy of ``dpf_tpu/core/spec.py`` (the port imports nothing of
``dpf_tpu``); the port's tests hold the two byte-identical.

2-party Distributed Point Function per Boyle-Gilboa-Ishai with the
early-termination optimization: the GGM tree stops 7 levels early and each
leaf covers 128 output bits (one AES block).  Semantics and *byte layout* are
identical to the reference implementation (dpf/dpf.go) so that keys are
interchangeable between backends:

key layout for logN >= 7, nu = logN - 7  (reference dpf/dpf.go:89-92,111-112,165):

    offset 0..15      root seed s (16 B, LSB of byte 0 cleared)
    offset 16         root control bit t in {0, 1}
    offset 17+18*i    level-i correction word: sCW (16 B) || tLCW (1 B) || tRCW (1 B)
    offset 17+18*nu   final output correction word (16 B)
    total             33 + 18*nu bytes

Bit conventions (reference dpf/dpf.go:46-52, 207):
  - control bit t of a seed = LSB of byte 0, then cleared;
  - output bit for index x = bit (x & 127) of the leaf block, addressed as
    byte ((x & 127) // 8), bit ((x & 127) % 8)  — LSB-first within a byte.

``eval_full`` here is written *level-synchronously* (breadth-first, whole
level as one vectorized batch) — the same dataflow the TPU backend uses —
rather than the reference's sequential DFS (dpf/dpf.go:213-241).  Both orders
emit leaves ascending, so outputs are byte-identical.
"""

from __future__ import annotations

import os

import numpy as np

from . import aes_np

DPFKey = bytes


def key_len(log_n: int) -> int:
    """Serialized key size in bytes: 33 + 18 * max(log_n - 7, 0)."""
    nu = max(log_n - 7, 0)
    return 33 + 18 * nu


def _check_params(alpha: int, log_n: int) -> None:
    if log_n > 63 or alpha >= (1 << log_n) or alpha < 0:
        raise ValueError("dpf: invalid parameters")


def _prg(seed: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Length-doubling PRG on a batch of seeds [N, 16].

    Returns (s_left, t_left, s_right, t_right): each child is the fixed-key
    MMO of the seed with the child's control bit extracted from and cleared
    out of byte 0's LSB (reference dpf/dpf.go:59-69).
    """
    s_l = aes_np.mmo_l(seed)
    s_r = aes_np.mmo_r(seed)
    t_l = s_l[:, 0] & 1
    t_r = s_r[:, 0] & 1
    s_l[:, 0] &= 0xFE
    s_r[:, 0] &= 0xFE
    return s_l, t_l, s_r, t_r


def _convert(seed: np.ndarray) -> np.ndarray:
    """Leaf conversion: map a seed to its 128-bit output block
    (reference dpf/dpf.go:54-57; control bit is *not* cleared here)."""
    return aes_np.mmo_l(seed)


def gen(
    alpha: int, log_n: int, rng: np.random.Generator | None = None
) -> tuple[DPFKey, DPFKey]:
    """Generate a DPF key pair for point ``alpha`` in domain [0, 2^log_n).

    ``rng`` defaults to OS entropy (like the reference's crypto/rand,
    dpf/dpf.go:80-81); pass a seeded ``np.random.Generator`` for reproducible
    test vectors — the gap the reference leaves open (no deterministic mode).
    """
    _check_params(alpha, log_n)
    if rng is None:
        s0 = np.frombuffer(os.urandom(16), dtype=np.uint8).copy()
        s1 = np.frombuffer(os.urandom(16), dtype=np.uint8).copy()
    else:
        s0 = rng.integers(0, 256, size=16, dtype=np.uint8)
        s1 = rng.integers(0, 256, size=16, dtype=np.uint8)

    t0 = int(s0[0] & 1)
    t1 = t0 ^ 1
    s0[0] &= 0xFE
    s1[0] &= 0xFE

    ka = bytearray(s0.tobytes())
    ka.append(t0)
    kb = bytearray(s1.tobytes())
    kb.append(t1)

    cw_all = bytearray()
    stop = max(log_n - 7, 0)
    s0 = s0[None, :]
    s1 = s1[None, :]
    for i in range(stop):
        s0l, t0l, s0r, t0r = _prg(s0)
        s1l, t1l, s1r, t1r = _prg(s1)
        t0l, t0r = int(t0l[0]), int(t0r[0])
        t1l, t1r = int(t1l[0]), int(t1r[0])
        bit = (alpha >> (log_n - 1 - i)) & 1
        if bit:  # KEEP = right child, LOSE = left
            scw = s0l ^ s1l
            tlcw = t0l ^ t1l
            trcw = t0r ^ t1r ^ 1
            s0 = s0r ^ (scw if t0 else 0)
            s1 = s1r ^ (scw if t1 else 0)
            t0 = t0r ^ (trcw if t0 else 0)
            t1 = t1r ^ (trcw if t1 else 0)
        else:  # KEEP = left child, LOSE = right
            scw = s0r ^ s1r
            tlcw = t0l ^ t1l ^ 1
            trcw = t0r ^ t1r
            s0 = s0l ^ (scw if t0 else 0)
            s1 = s1l ^ (scw if t1 else 0)
            t0 = t0l ^ (tlcw if t0 else 0)
            t1 = t1l ^ (tlcw if t1 else 0)
        cw_all += scw.tobytes() + bytes([tlcw, trcw])

    conv0 = _convert(s0)
    conv1 = _convert(s1)
    fcw = (conv0 ^ conv1)[0].copy()
    low = alpha & 127
    fcw[low // 8] ^= np.uint8(1 << (low % 8))
    cw_all += fcw.tobytes()

    return bytes(ka) + bytes(cw_all), bytes(kb) + bytes(cw_all)


def parse_key(k: DPFKey, log_n: int):
    """Split a serialized key into (seed[16], t, scw[nu,16], tcw[nu,2], fcw[16]).

    Enforces the canonical form that Gen always produces (and that every
    backend relies on): control-bit bytes are in {0, 1} and the LSB of each
    seed/sCW block is clear (reference Gen clears them: dpf/dpf.go:86-87 and
    via prg at dpf/dpf.go:62-67).  Rejecting non-canonical bytes here keeps
    all backends bit-identical on every accepted key."""
    nu = max(log_n - 7, 0)
    if len(k) != key_len(log_n):
        raise ValueError(f"dpf: key length {len(k)} != {key_len(log_n)} for n={log_n}")
    buf = np.frombuffer(bytes(k), dtype=np.uint8)
    seed = buf[:16].copy()
    t = int(buf[16])
    cws = buf[17 : 17 + 18 * nu].reshape(nu, 18) if nu else np.zeros((0, 18), np.uint8)
    scw = cws[:, :16].copy()
    tcw = cws[:, 16:].copy()
    fcw = buf[len(k) - 16 :].copy()
    if t > 1 or (tcw > 1).any() or (seed[0] & 1) or (scw[:, 0] & 1).any():
        raise ValueError("dpf: non-canonical key (control bytes/LSBs)")
    return seed, t, scw, tcw, fcw


def eval_point(k: DPFKey, x: int, log_n: int) -> int:
    """Evaluate one party's share at a single index ``x`` -> bit in {0, 1}.

    Root-to-leaf walk applying correction words whenever the control bit is
    set (reference dpf/dpf.go:171-211).
    """
    _check_params(x, log_n)
    seed, t, scw, tcw, fcw = parse_key(k, log_n)
    s = seed[None, :]
    stop = max(log_n - 7, 0)
    for i in range(stop):
        s_l, t_l, s_r, t_r = _prg(s)
        t_l, t_r = int(t_l[0]), int(t_r[0])
        if t:
            s_l = s_l ^ scw[i]
            s_r = s_r ^ scw[i]
            t_l ^= int(tcw[i, 0])
            t_r ^= int(tcw[i, 1])
        if (x >> (log_n - 1 - i)) & 1:
            s, t = s_r, t_r
        else:
            s, t = s_l, t_l
    out = _convert(s)[0]
    if t:
        out = out ^ fcw
    low = x & 127
    return int((out[low // 8] >> (low % 8)) & 1)


def eval_full(k: DPFKey, log_n: int) -> bytes:
    """Full-domain evaluation -> bit-packed output of 2^(log_n-3) bytes
    (16 bytes when log_n < 7).  Bit x of the domain is at byte x//8,
    bit x%8 (LSB-first), matching the reference (dpf/dpf.go:243-262).

    Level-synchronous: level i holds all 2^i seeds as one batch; children
    interleave [L0, R0, L1, R1, ...] so leaves come out in ascending index
    order, matching the reference's left-then-right DFS emit order.
    """
    if log_n > 63:
        raise ValueError("dpf: invalid parameters")
    seed, t, scw, tcw, fcw = parse_key(k, log_n)
    seeds = seed[None, :]
    ts = np.array([t], dtype=np.uint8)
    stop = max(log_n - 7, 0)
    for i in range(stop):
        s_l, t_l, s_r, t_r = _prg(seeds)
        mask = ts == 1  # parents with control bit set get the CW applied
        s_l[mask] ^= scw[i]
        s_r[mask] ^= scw[i]
        t_l = t_l ^ (mask * tcw[i, 0])
        t_r = t_r ^ (mask * tcw[i, 1])
        # Interleave children: node j -> children (2j, 2j+1).
        seeds = np.stack([s_l, s_r], axis=1).reshape(-1, 16)
        ts = np.stack([t_l, t_r], axis=1).reshape(-1).astype(np.uint8)
    leaves = _convert(seeds)
    leaves ^= (ts[:, None] * fcw[None, :]).astype(np.uint8)
    return leaves.tobytes()
