"""NumPy executable spec of the ChaCha-based DPF profile ("fast profile").

The port's copy of ``dpf_tpu/core/chacha_np.py`` (the port imports nothing of
``dpf_tpu``; ``tests/port/test_torch_chacha.py`` holds the two equal).

The reference's DPF is pinned to fixed-key AES-128-MMO because its target
hardware has AES-NI (dpf/aes_amd64.s:51-82).  The BGI construction only
requires *some* length-doubling PRG, so the fast profile swaps in a
ChaCha-based PRG -- pure 32-bit add/rotate/xor, no bitslicing -- and widens
the early-termination leaf from 128 to 512 bits (one ChaCha block = 512
output bits, mirroring the reference's leaf=one-AES-block choice at
dpf/dpf.go:54-57,160-162).

Scheme (binary GGM tree, exactly the reference's shape, dpf/dpf.go:71-169):
  - seeds: 128 bits; control bit = LSB of seed word 0, cleared after
    extraction (reference getT/clr semantics, dpf/dpf.go:46-52)
  - node expansion: one ChaCha block keyed by the seed under domain-sep
    constant EXPAND; output words 0..3 -> left child, 4..7 -> right child
  - leaf conversion: one ChaCha block under domain-sep LEAF; all 16 output
    words = the leaf's 512 output bits (bit x of the domain at leaf word
    (x>>5)&15, bit x&31 — LSB-first, extending the reference's bit order,
    dpf/dpf.go:207)
  - levels: nu = max(log_n - 9, 0); CW layout per level identical to the
    reference (16 B seed CW + 2 control-bit CW bytes); final CW = 64 B

Key layout: seed(16) | t(1) | nu * 18 | 64  ->  81 + 18*max(log_n-9, 0) B.

Rounds: 12 (double rounds: 6).  ChaCha12 has a comfortable security margin
(best published attacks reach 7 rounds); the round count is a module
constant so a paranoid profile can raise it.

The block function is standard RFC 8439 ChaCha (pinned by its test vector
in tests/test_chacha.py); only the state construction is scheme-specific:
key words 0..3 = the seed, key words 4..7 = domain-separation constants,
counter = 0, nonce = 0.
"""

from __future__ import annotations

import os

import numpy as np

ROUNDS = 12  # even; pairs of column+diagonal rounds

_CONSTANTS = np.array(
    [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], dtype=np.uint32
)  # "expand 32-byte k" (RFC 8439)

# Domain-separation constants occupying key words 4..7.  Arbitrary distinct
# non-symmetric values (hex digits of sqrt(2)/sqrt(3), SHA-style).
DS_EXPAND = np.array(
    [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A], dtype=np.uint32
)
DS_LEAF = np.array(
    [0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19], dtype=np.uint32
)

LEAF_BITS = 512  # one ChaCha block per leaf
LEAF_LOG = 9


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _quarter(s, a, b, c, d):
    s[a] = s[a] + s[b]
    s[d] = _rotl(s[d] ^ s[a], 16)
    s[c] = s[c] + s[d]
    s[b] = _rotl(s[b] ^ s[c], 12)
    s[a] = s[a] + s[b]
    s[d] = _rotl(s[d] ^ s[a], 8)
    s[c] = s[c] + s[d]
    s[b] = _rotl(s[b] ^ s[c], 7)


def double_round(s):
    """One ChaCha double round (column + diagonal) on a 16-element word
    state of numpy uint32 arrays, in place.  The torch evaluator
    (models/dpf_chacha) keeps its own copy over int32 carriers, whose ``>>``
    is arithmetic; the CUDA kernels (ops/csrc/chacha_expand.cu) a third."""
    _quarter(s, 0, 4, 8, 12)
    _quarter(s, 1, 5, 9, 13)
    _quarter(s, 2, 6, 10, 14)
    _quarter(s, 3, 7, 11, 15)
    _quarter(s, 0, 5, 10, 15)
    _quarter(s, 1, 6, 11, 12)
    _quarter(s, 2, 7, 8, 13)
    _quarter(s, 3, 4, 9, 14)


def grouped_masks(k: int, g: int, log_n: int):
    """(key_level, lowmask) uint32[k] for a level-major FSS gate batch of
    ``k`` keys over ``g`` gates (groups * log_n level blocks; models/fss.py
    layout).  key_level[j] is key j's comparison level; lowmask[j] is the
    level's in-leaf dyadic-prefix mask (0 when the whole leaf index is
    above the prefix).  Shared by the XLA pointwise body and the Pallas
    walk kernel so the two backends cannot drift."""
    key_level = (np.arange(k) // g) % log_n
    s_of_key = log_n - 1 - key_level
    lowmask = np.where(
        s_of_key >= LEAF_LOG,
        np.uint32(0),
        (np.uint32(LEAF_BITS - 1) & ~((1 << s_of_key) - 1)).astype(np.uint32),
    )
    return key_level.astype(np.uint32), lowmask


def chacha_block(
    key: np.ndarray, counter: int = 0, nonce=(0, 0, 0), rounds: int = 20
) -> np.ndarray:
    """RFC 8439 ChaCha block function, vectorized over leading batch axes.

    key: uint32[..., 8]; returns uint32[..., 16] (state + initial state).
    """
    key = np.asarray(key, dtype=np.uint32)
    batch = key.shape[:-1]
    init = np.empty(batch + (16,), dtype=np.uint32)
    init[..., 0:4] = _CONSTANTS
    init[..., 4:12] = key
    init[..., 12] = np.uint32(counter)
    init[..., 13] = np.uint32(nonce[0])
    init[..., 14] = np.uint32(nonce[1])
    init[..., 15] = np.uint32(nonce[2])
    s = [init[..., i].copy() for i in range(16)]
    with np.errstate(over="ignore"):
        for _ in range(rounds // 2):
            double_round(s)
        out = np.stack(s, axis=-1) + init
    return out.astype(np.uint32)


def prg_expand(seeds: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Node PRG: uint32[..., 4] seeds -> (left, right) child seeds.

    Control bits ride as the LSB of each child's word 0 (caller extracts
    and clears, reference prg semantics dpf/dpf.go:59-69)."""
    left, right, _ = prg_expand_v(seeds)
    return left, right


def prg_expand_v(
    seeds: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Node PRG with a VALUE word: uint32[..., 4] -> (left, right, v).

    ``v`` (output word 8 of the same ChaCha block that yields the two
    children — free, the permutation computes all 16 words anyway) is the
    per-node pseudorandom value the DCF construction (models/dcf.py)
    accumulates along the evaluation path; only its LSB is used for the
    single-bit comparison payload."""
    key = np.concatenate(
        [seeds, np.broadcast_to(DS_EXPAND, seeds.shape)], axis=-1
    )
    out = chacha_block(key, rounds=ROUNDS)
    return out[..., 0:4], out[..., 4:8], out[..., 8]


def convert_leaf(seeds: np.ndarray) -> np.ndarray:
    """Leaf conversion: uint32[..., 4] -> uint32[..., 16] (512 bits)."""
    key = np.concatenate(
        [seeds, np.broadcast_to(DS_LEAF, seeds.shape)], axis=-1
    )
    return chacha_block(key, rounds=ROUNDS)


# ---------------------------------------------------------------------------
# Host-side Gen / reference Eval / EvalFull (executable spec)
# ---------------------------------------------------------------------------


def nu_of(log_n: int) -> int:
    return max(log_n - LEAF_LOG, 0)


def key_len(log_n: int) -> int:
    """Serialized fast-profile key size: 17 + 18*nu + 64 bytes."""
    return 17 + 18 * nu_of(log_n) + 64


def gen(
    alpha: int, log_n: int, rng: np.random.Generator | None = None
) -> tuple[bytes, bytes]:
    """Single-key Gen (spec path; see keys_chacha.gen_batch for the
    vectorized production path).  Mirrors reference Gen (dpf/dpf.go:71-169)
    with the ChaCha PRG and 512-bit leaves."""
    from .keys_chacha import gen_batch

    ka, kb = gen_batch(np.array([alpha], dtype=np.uint64), log_n, rng=rng, device="cpu")
    return ka.to_bytes()[0], kb.to_bytes()[0]


def _parse(key: bytes, log_n: int):
    nu = nu_of(log_n)
    if len(key) != key_len(log_n):
        raise ValueError("dpf-fast: bad key length")
    a = np.frombuffer(key, dtype=np.uint8)
    seed = a[:16].copy().view("<u4")
    t = int(a[16])
    cws = a[17 : 17 + 18 * nu].reshape(nu, 18)
    scw = np.ascontiguousarray(cws[:, :16]).view("<u4")
    tcw = cws[:, 16:]
    fcw = a[-64:].copy().view("<u4")
    if t > 1 or (tcw > 1).any() or (seed[0] & 1) or (scw[:, 0] & 1).any():
        raise ValueError("dpf-fast: non-canonical key")
    return seed, t, scw, tcw, fcw


def eval_point(key: bytes, x: int, log_n: int) -> int:
    """Single-point evaluation -> bit (reference Eval, dpf/dpf.go:171-211)."""
    if x >> log_n:
        raise ValueError("dpf-fast: x out of domain")
    seed, t, scw, tcw, fcw = _parse(key, log_n)
    s = seed.copy()
    nu = nu_of(log_n)
    for i in range(nu):
        l, r = prg_expand(s)
        tl, tr = int(l[0] & 1), int(r[0] & 1)
        l[0] &= ~np.uint32(1)
        r[0] &= ~np.uint32(1)
        if t:
            l ^= scw[i]
            r ^= scw[i]
            tl ^= int(tcw[i, 0])
            tr ^= int(tcw[i, 1])
        if (x >> (log_n - 1 - i)) & 1:
            s, t = r, tr
        else:
            s, t = l, tl
    leaf = convert_leaf(s)
    if t:
        leaf ^= fcw
    low = x & (LEAF_BITS - 1) if log_n >= LEAF_LOG else x
    return int((leaf[(low >> 5) & 15] >> np.uint32(low & 31)) & 1)


def eval_full(key: bytes, log_n: int) -> bytes:
    """Full-domain evaluation -> bit-packed bytes: 2^(log_n-3) bytes for
    log_n >= 9, one full 64-byte leaf for log_n < 9 (the analogue of the
    reference's 16-byte minimum at dpf/dpf.go:251); bit x at byte x//8,
    bit x%8 (reference layout, dpf/dpf.go:207)."""
    seed, t, scw, tcw, fcw = _parse(key, log_n)
    nu = nu_of(log_n)
    seeds = seed[None, :]
    ts = np.array([t], dtype=np.uint8)
    for i in range(nu):
        l, r = prg_expand(seeds)
        tl = (l[:, 0] & 1).astype(np.uint8)
        tr = (r[:, 0] & 1).astype(np.uint8)
        l[:, 0] &= ~np.uint32(1)
        r[:, 0] &= ~np.uint32(1)
        mask = ts.astype(bool)
        l[mask] ^= scw[i]
        r[mask] ^= scw[i]
        tl = tl ^ (ts & tcw[i, 0])
        tr = tr ^ (ts & tcw[i, 1])
        seeds = np.stack([l, r], axis=1).reshape(-1, 4)
        ts = np.stack([tl, tr], axis=1).reshape(-1)
    leaves = convert_leaf(seeds)
    leaves[ts.astype(bool)] ^= fcw
    return bytes(leaves.reshape(-1).view("<u1"))


def gen_root_seeds(k: int, rng: np.random.Generator | None) -> np.ndarray:
    """K fresh 16-byte root seeds from the OS CSPRNG (or rng for tests)."""
    if rng is None:
        raw = np.frombuffer(os.urandom(16 * k), dtype=np.uint8)
        return raw.reshape(k, 16).copy()
    return rng.integers(0, 256, size=(k, 16), dtype=np.uint8)
