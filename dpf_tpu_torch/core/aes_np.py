"""Pure-NumPy AES-128 and AES-128-MMO — the port's executable crypto spec.

The port's own copy of ``dpf_tpu/core/aes_np.py`` (the port imports nothing
of ``dpf_tpu``); ``tests/port/test_torch_aes.py`` holds the two equal.  It is the
golden model for the port's CUDA kernels and their plain PyTorch versions.
Nothing here is performance-critical; it exists to be *obviously correct*:

- The S-box is derived from first principles (GF(2^8) inversion + affine map),
  not hardcoded, and is verified against FIPS-197 test vectors in
  ``tests/port/test_torch_aes.py``.
- ``aes128_mmo`` implements the Matyas-Meyer-Oseas one-way compression
  ``E_k(x) ^ x`` used as the DPF length-doubling PRG, mirroring the
  reference's AES-NI kernel (reference: dpf/aes_amd64.s:51-82, the
  ``aes128MMO`` routine) with the two fixed PRF keys hardcoded in the
  reference at dpf/dpf.go:23-24.

All block operations are vectorized over a leading batch axis: ``blocks`` has
shape ``[N, 16]`` uint8.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# GF(2^8) arithmetic (AES field, modulus x^8 + x^4 + x^3 + x + 1 = 0x11B)
# ---------------------------------------------------------------------------


def _gf_mul(a: int, b: int) -> int:
    """Multiply two elements of GF(2^8) mod 0x11B (schoolbook, host-side)."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        a <<= 1
        if a & 0x100:
            a ^= 0x11B
        b >>= 1
    return r


def _build_sbox() -> np.ndarray:
    """Derive the AES S-box from the field definition (FIPS-197 §5.1.1)."""
    # Multiplicative inverse table via exhaustive search (256 elements).
    inv = [0] * 256
    for x in range(1, 256):
        for y in range(1, 256):
            if _gf_mul(x, y) == 1:
                inv[x] = y
                break
    sbox = np.zeros(256, dtype=np.uint8)
    for x in range(256):
        b = inv[x]
        # Affine transform: b'_i = b_i ^ b_{i+4} ^ b_{i+5} ^ b_{i+6} ^ b_{i+7} ^ c_i
        res = 0
        for i in range(8):
            bit = (
                (b >> i)
                ^ (b >> ((i + 4) % 8))
                ^ (b >> ((i + 5) % 8))
                ^ (b >> ((i + 6) % 8))
                ^ (b >> ((i + 7) % 8))
                ^ (0x63 >> i)
            ) & 1
            res |= bit << i
        sbox[x] = res
    return sbox


SBOX: np.ndarray = _build_sbox()

# xtime table: multiplication by 0x02 in GF(2^8), vectorized via lookup.
XTIME: np.ndarray = np.array(
    [(x << 1) ^ 0x11B if (x << 1) & 0x100 else (x << 1) for x in range(256)],
    dtype=np.uint8,
)

# Round constants for key expansion.
_RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36]

# ShiftRows as a flat permutation of the 16-byte block.  AES state is
# column-major: state[r, c] = block[4c + r]; row r rotates left by r, so
# out[4c + r] = in[4*((c + r) % 4) + r].
SHIFT_ROWS_PERM: np.ndarray = np.array(
    [4 * ((c + r) % 4) + r for c in range(4) for r in range(4)], dtype=np.intp
)


def expand_key(key: bytes | np.ndarray) -> np.ndarray:
    """AES-128 key expansion -> round keys of shape [11, 16] uint8.

    Round keys are stored in flat block byte order (byte ``4c + r`` = row r of
    column c), i.e. the "uint128 format" the reference's asm uses
    (dpf/aes_amd64.s:86).
    """
    key = np.asarray(bytearray(key), dtype=np.uint8)
    assert key.shape == (16,)
    w = [key[4 * i : 4 * i + 4].copy() for i in range(4)]  # 4-byte words
    for i in range(4, 44):
        temp = w[i - 1].copy()
        if i % 4 == 0:
            temp = np.roll(temp, -1)  # RotWord
            temp = SBOX[temp]  # SubWord
            temp[0] ^= _RCON[i // 4 - 1]
        w.append(w[i - 4] ^ temp)
    return np.stack(w).reshape(11, 16)


def _mix_columns(state: np.ndarray) -> np.ndarray:
    """MixColumns on [N, 16] flat column-major state."""
    s = state.reshape(-1, 4, 4)  # [N, column, row]
    a0, a1, a2, a3 = s[:, :, 0], s[:, :, 1], s[:, :, 2], s[:, :, 3]
    b0, b1, b2, b3 = XTIME[a0], XTIME[a1], XTIME[a2], XTIME[a3]
    out = np.empty_like(s)
    out[:, :, 0] = b0 ^ a1 ^ b1 ^ a2 ^ a3
    out[:, :, 1] = a0 ^ b1 ^ a2 ^ b2 ^ a3
    out[:, :, 2] = a0 ^ a1 ^ b2 ^ a3 ^ b3
    out[:, :, 3] = a0 ^ b0 ^ a1 ^ a2 ^ b3
    return out.reshape(-1, 16)


def aes128_encrypt(round_keys: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    """AES-128 encryption of [N, 16] uint8 blocks (FIPS-197 §5.1)."""
    blocks = np.atleast_2d(np.asarray(blocks, dtype=np.uint8))
    state = blocks ^ round_keys[0]
    for rnd in range(1, 10):
        state = SBOX[state]
        state = state[:, SHIFT_ROWS_PERM]
        state = _mix_columns(state)
        state = state ^ round_keys[rnd]
    state = SBOX[state]
    state = state[:, SHIFT_ROWS_PERM]
    state = state ^ round_keys[10]
    return state


def aes128_mmo(round_keys: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    """Matyas-Meyer-Oseas compression: ``E_k(x) ^ x`` on [N, 16] blocks.

    Mirror of the reference's core primitive (dpf/aes_amd64.s:51-82).
    """
    blocks = np.atleast_2d(np.asarray(blocks, dtype=np.uint8))
    return aes128_encrypt(round_keys, blocks) ^ blocks


# ---------------------------------------------------------------------------
# The two fixed PRF keys of the DPF construction (reference dpf/dpf.go:23-24).
# Their round keys are compile-time constants in every backend.
# ---------------------------------------------------------------------------

PRF_KEY_L = bytes(
    [36, 156, 50, 234, 92, 230, 49, 9, 174, 170, 205, 160, 98, 236, 29, 243]
)
PRF_KEY_R = bytes(
    [209, 12, 199, 173, 29, 74, 44, 128, 194, 224, 14, 44, 2, 201, 110, 28]
)

ROUND_KEYS_L: np.ndarray = expand_key(PRF_KEY_L)
ROUND_KEYS_R: np.ndarray = expand_key(PRF_KEY_R)


def mmo_l(blocks: np.ndarray) -> np.ndarray:
    """Fixed-key MMO with the left PRF key (reference ``keyL``)."""
    return aes128_mmo(ROUND_KEYS_L, blocks)


def mmo_r(blocks: np.ndarray) -> np.ndarray:
    """Fixed-key MMO with the right PRF key (reference ``keyR``)."""
    return aes128_mmo(ROUND_KEYS_R, blocks)
