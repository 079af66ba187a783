"""Bitsliced AES-128 / AES-128-MMO on bit-planes, in plain PyTorch.

The port's counterpart of ``dpf_tpu/ops/aes_bitslice.py``: blocks live as
**128 bit-planes**, each plane a 32-bit word tensor whose 32 bits are 32
independent blocks, and the whole cipher is a fixed DAG of XOR/AND/NOT ops.
This module is the plain version of the CUDA kernels (``aes_cuda.py``): the
CPU path and the tests run it, and ``chip_smoke.py`` holds the kernels
against it on the card.

Layout
------
State ``S``: ``int32[128, B]``.  Plane index ``p = 8 * byte_pos + bit`` with
``bit`` LSB-first, i.e. plane ``p`` holds domain-bit ``p`` of each block.
Lane word ``S[p, b]`` packs blocks ``32b .. 32b+31`` (bit ``j`` = block
``32b + j``).

Words travel as ``int32`` carriers of the reference's ``uint32`` words: torch
has ``~``, shifts and comparisons on ``int32`` but not on ``uint32``.  A left
shift wraps, ``~`` is bitwise, and a logical right shift is :func:`lshr`.
:func:`to_carrier` / :func:`from_carrier` convert at the numpy boundary.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import aes_np
from .sbox_circuit import sbox_bp113

# ---------------------------------------------------------------------------
# int32 carriers of uint32 words
# ---------------------------------------------------------------------------


def to_carrier(words: np.ndarray, device=None) -> torch.Tensor:
    """uint32 numpy words -> int32 torch tensor with the same bits."""
    a = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def from_carrier(t: torch.Tensor) -> np.ndarray:
    """int32 torch tensor -> uint32 numpy words with the same bits."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def lshr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32 carriers by ``0 < k < 32``."""
    return (x >> k) & ((1 << (32 - k)) - 1)


# ---------------------------------------------------------------------------
# Round-key plane masks (constants)
# ---------------------------------------------------------------------------


def round_key_masks(round_keys: np.ndarray) -> np.ndarray:
    """[11, 16]-byte round keys -> [11, 128] uint32 masks (0 / 0xFFFFFFFF)."""
    rk = np.asarray(round_keys, dtype=np.uint8).reshape(11, 16)
    bits = (rk[:, :, None] >> np.arange(8)) & 1  # [11, 16, 8]
    return (bits.reshape(11, 128) * np.uint32(0xFFFFFFFF)).astype(np.uint32)


RK_MASKS_L: np.ndarray = round_key_masks(aes_np.ROUND_KEYS_L)
RK_MASKS_R: np.ndarray = round_key_masks(aes_np.ROUND_KEYS_R)

# ShiftRows as a flat permutation of the 128 planes.
_SHIFT_PLANES = torch.from_numpy(
    np.repeat(aes_np.SHIFT_ROWS_PERM * 8, 8) + np.tile(np.arange(8), 16)
)

# Bit positions that absorb the carry in xtime (reduction poly 0x11B), as
# int32 lane masks over the bit axis; position 0 gets a7 from the rotation.
_XTIME_CARRY = torch.tensor([0, -1, 0, -1, -1, 0, 0, 0], dtype=torch.int32)


def permute_planes(S: torch.Tensor, perm) -> torch.Tensor:
    """Rows of ``S`` in the order ``perm`` (a sequence of plane indices)."""
    idx = torch.as_tensor(perm, dtype=torch.long, device=S.device)
    return S.index_select(0, idx)


# ---------------------------------------------------------------------------
# Cipher rounds on planes
# ---------------------------------------------------------------------------


def _sub_bytes(S: torch.Tensor) -> torch.Tensor:
    """S-box (Boyar-Peralta 113) on all 16 bytes: [128, B] -> [128, B]."""
    s = S.reshape(16, 8, -1)
    # Circuit wants MSB-first planes; our bit axis is LSB-first.
    x = [s[:, 7 - i] for i in range(8)]
    y = sbox_bp113(x)
    return torch.stack(y[::-1], dim=1).reshape(128, -1)


def _shift_rows(S: torch.Tensor) -> torch.Tensor:
    return permute_planes(S, _SHIFT_PLANES)


def _xtime(a: torch.Tensor) -> torch.Tensor:
    """Multiply by 0x02 in GF(2^8) on a [..., 8, B] bit axis."""
    rot = torch.roll(a, 1, dims=-2)  # rot[..., k, :] = a[..., k-1, :]; k=0 gets a7
    carry = a[..., 7:8, :] & _XTIME_CARRY.to(a.device)[:, None]
    return rot ^ carry


def _mix_columns(S: torch.Tensor) -> torch.Tensor:
    s = S.reshape(4, 4, 8, -1)  # [column, row, bit, B]
    r1 = torch.roll(s, -1, dims=1)
    r2 = torch.roll(s, -2, dims=1)
    r3 = torch.roll(s, -3, dims=1)
    out = _xtime(s) ^ _xtime(r1) ^ r1 ^ r2 ^ r3  # 2*a_r + 3*a_{r+1} + a_{r+2} + a_{r+3}
    return out.reshape(128, -1)


def aes128_encrypt_planes(S: torch.Tensor, rk_masks: np.ndarray) -> torch.Tensor:
    """AES-128 on bitsliced state int32[128, B] with constant round-key masks:
    uint32[11, 128] (as :func:`round_key_masks` gives them), or
    uint32[11, 128, n] for n key schedules, schedule j on the j-th of n
    equal column blocks of S."""
    rk = to_carrier(rk_masks, S.device).reshape(11, 128, -1, 1)
    n = rk.shape[2]

    def add_round_key(S, rnd):
        return (S.reshape(128, n, -1) ^ rk[rnd]).reshape(128, -1)

    S = add_round_key(S, 0)
    for rnd in range(1, 10):
        S = _sub_bytes(S)
        S = _shift_rows(S)
        S = _mix_columns(S)
        S = add_round_key(S, rnd)
    S = _sub_bytes(S)
    S = _shift_rows(S)
    return add_round_key(S, 10)


def aes128_mmo_planes(S: torch.Tensor, rk_masks: np.ndarray) -> torch.Tensor:
    """Matyas-Meyer-Oseas: ``E_k(x) ^ x`` on bitsliced state."""
    return aes128_encrypt_planes(S, rk_masks) ^ S


# Both fixed keys' schedules side by side, uint32[11, 128, 2] (L, R).
_RK_MASKS_LR = np.stack([RK_MASKS_L, RK_MASKS_R], axis=-1)


def prg_planes(S: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """DPF length-doubling PRG: both fixed-key MMO expansions of the same
    seeds (reference dpf/dpf.go:59-69, minus the t-bit handling which the
    evaluator owns), run as one cipher over the seeds twice, side by side.
    Returns (left, right) children as planes."""
    B = S.shape[1]
    LR = aes128_mmo_planes(torch.cat([S, S], dim=1), _RK_MASKS_LR)
    return LR[:, :B], LR[:, B:]


# ---------------------------------------------------------------------------
# Bit-matrix transpose and pack/unpack
# ---------------------------------------------------------------------------


def _anti_transpose32(A: torch.Tensor) -> torch.Tensor:
    """Hacker's Delight fig. 7-3 in sliced form.  Under LSB-first bit
    indexing this computes the anti-transpose: out[i] bit j = A[31-j]
    bit (31-i).  It is an involution."""
    m = 0x0000FFFF
    j = 16
    B = tuple(A.shape[1:])
    while j:
        A = A.reshape((32 // (2 * j), 2, j) + B)
        t = (A[:, 0] ^ lshr(A[:, 1], j)) & m
        A = torch.stack([A[:, 0] ^ t, A[:, 1] ^ (t << j)], dim=1)
        A = A.reshape((32,) + B)
        j >>= 1
        m = m ^ (m << j)
    return A


def transpose32(A: torch.Tensor) -> torch.Tensor:
    """True 32x32 bit-matrix transpose on int32[32, ...] rows, LSB-first:
    bit j of out[i] = bit i of A[j].  Vectorized over trailing axes."""
    return torch.flip(_anti_transpose32(torch.flip(A, dims=(0,))), dims=(0,))


def pack_padded_keys(blocks_words: torch.Tensor) -> torch.Tensor:
    """int32[K, N, 4] block words (K multiple of 32) -> planes
    int32[128, N, K//32] packed over the key axis."""
    K, N, _ = blocks_words.shape
    if K % 32:
        raise ValueError(f"key axis {K} is not a multiple of 32")
    g = blocks_words.reshape(K // 32, 32, N, 4)
    g = g.movedim(1, 0)  # [32, Kp, N, 4], rows = key-within-group j
    t = transpose32(g)  # t[i, kp, n, q]: bit j = bit i of key (32kp+j)'s word q
    t = t.movedim((3, 0), (0, 1))  # [q, i, kp, n]
    t = t.reshape(128, K // 32, N)  # plane p = 32q + i
    return t.transpose(1, 2).contiguous()


def unpack_planes(planes: torch.Tensor) -> torch.Tensor:
    """planes int32[128, N, Kp] -> per-key block words int32[K, N, 4].

    Word q of key k at node n = planes[32q..32q+32, n, k // 32] bit (k % 32),
    i.e. four 32x32 bit transposes."""
    _, N, Kp = planes.shape
    p = planes.reshape(4, 32, N, Kp).movedim(0, -1)  # [i, n, kp, q]
    t = transpose32(p)  # [j, n, kp, q]: bit i of t[j] = plane 32q+i of key j
    return t.permute(2, 0, 1, 3).reshape(Kp * 32, N, 4)
