"""Bit-packed output contract: the packed layout of pointwise evaluation.

The port's copy of ``dpf_tpu/core/bitpack.py`` (its numpy helpers, and torch
counterparts of its device packers; the wire helpers wait for the sidecar):

    word layout   uint32[..., ceil(Q/32)]: query q -> word q // 32,
                  bit q % 32 (LSB-first within the word)
    byte layout   the little-endian view of those words: query q ->
                  byte q // 8, bit q % 8 (the reference's EvalFull order)
    tail bits     bits >= Q in the last word are ZERO (padded queries
                  evaluate garbage; producers mask them)

The compat walk kernel's output is these words; the fast walk's ``[Q, K]``
bits pack into them on the device (:func:`pack_bits_qmajor_torch`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def packed_words(q: int) -> int:
    """Words per row of a packed [.., Q] output: ceil(Q / 32)."""
    return -(-int(q) // 32)


def empty_rows(rows: int, q: int, packed: bool) -> np.ndarray:
    """The result of an evaluation with no keys or no queries: uint8[rows,
    q] bits, or uint32[rows, ceil(q/32)] words when ``packed``."""
    if packed:
        return np.zeros((rows, packed_words(q)), np.uint32)
    return np.zeros((rows, int(q)), np.uint8)


def mask_tail(words: np.ndarray, q: int) -> np.ndarray:
    """Zero bits >= q in the last word (copy only when masking applies)."""
    q = int(q)
    if q % 32 and words.shape[-1]:
        words = words.copy()
        words[..., -1] &= np.uint32((1 << (q % 32)) - 1)
    return words


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """Host pack: uint8[..., Q] 0/1 -> uint32[..., ceil(Q/32)], LSB-first,
    tail bits zero."""
    bits = np.asarray(bits)
    q = bits.shape[-1]
    pad = (-q) % 32
    if pad:
        bits = np.concatenate(
            [bits, np.zeros(bits.shape[:-1] + (pad,), bits.dtype)], axis=-1
        )
    b = bits.reshape(bits.shape[:-1] + (-1, 32)).astype(np.uint32)
    return (b << np.arange(32, dtype=np.uint32)).sum(-1, dtype=np.uint32)


def unpack_bits(words: np.ndarray, q: int) -> np.ndarray:
    """Host unpack: uint32[..., W] -> uint8[..., q] 0/1 bits."""
    w = np.asarray(words)
    bits = ((w[..., :, None] >> np.arange(32, dtype=np.uint32)) & 1).astype(
        np.uint8
    )
    return bits.reshape(w.shape[:-1] + (-1,))[..., : int(q)]


def byte_rows_to_words(rows: np.ndarray, q: int) -> np.ndarray:
    """uint8[K, ceil(q/8)] packed byte rows -> uint32[K, ceil(q/32)] words."""
    rows = np.asarray(rows, dtype=np.uint8)
    pad = packed_words(q) * 4 - rows.shape[1]
    if pad:
        rows = np.concatenate(
            [rows, np.zeros((rows.shape[0], pad), np.uint8)], axis=1
        )
    return np.ascontiguousarray(rows).view("<u4")


@functools.cache
def _lane_bits(device: torch.device) -> torch.Tensor:
    """int32[32]: 1 << l, lane 31 as the carrier of 0x80000000; made once
    per device."""
    return torch.tensor([1 << l for l in range(31)] + [-(1 << 31)],
                        dtype=torch.int32, device=device)


def pack_bits_torch(bits: torch.Tensor) -> torch.Tensor:
    """Device pack (``pack_bits_jnp``): int32 0/1 [..., Q] -> int32 carriers
    of uint32[..., ceil(Q/32)], tail bits zero.  The lanes' bits are
    distinct, so their int32 sum is their OR and never overflows."""
    pad = (-bits.shape[-1]) % 32
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    b = bits.reshape(bits.shape[:-1] + (bits.shape[-1] // 32, 32))
    return (b * _lane_bits(bits.device)).sum(-1, dtype=torch.int32)


def pack_bits_qmajor_torch(bits: torch.Tensor) -> torch.Tensor:
    """Device pack of a QUERY-MAJOR bit tensor (``pack_bits_qmajor_jnp``,
    the fast walk's layout): int32 0/1 [Q, K] -> int32 carriers of
    uint32[K, ceil(Q/32)], tail bits zero."""
    q, k = bits.shape
    pad = (-q) % 32
    if pad:
        bits = torch.nn.functional.pad(bits, (0, 0, 0, pad))
    b = bits.reshape(bits.shape[0] // 32, 32, k) * _lane_bits(bits.device)[None, :, None]
    return b.sum(1, dtype=torch.int32).T.contiguous()
