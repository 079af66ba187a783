"""2-server private information retrieval on top of batched DPF expansion.

The port's counterpart of the single-card routes of
``dpf_tpu/models/pir.py``.  Protocol (classic 2-server PIR): the client
hides row index ``alpha`` in a DPF key pair; each server expands its share
over the row domain and XORs together the database rows whose selection
bit is 1; the client XORs the two 1-row answers to recover row ``alpha``.

The XOR of the selected rows is GF(2) linear algebra, ``answer =
sel_bits[K, N] @ db_bits[N, B] (mod 2)``.  It runs as int8 x int8 -> int32
products (``torch._int_mm``, the counterpart of the reference's int8 MXU
matmul with an int32 accumulator) over chunks of ``chunk_rows`` rows, each
chunk's selection and database words unpacked to int8 bits, the low bit of
each count XORed into an accumulator.  A chunk's counts reach at most
``chunk_rows`` (2^16 by default), which int32 holds exactly; fp16 or bf16
products could not.  The selection words come from the full-domain
expansion of either profile, on the card: the compat profile's
``prg_bm_kernel`` level after level and one ``leaf_words_bm_kernel``, the
fast profile's ``fused_levels_kernel`` prefix and one
``expand_tail_kernel``.

The selection words are expanded once, then the parity product runs
slab by slab of ``stream_rows`` rows, each slab XORing into one
accumulator in place.  A database of at most ``db_chunk_bytes`` resident
bytes is one slab; the whole database stays on the device either way, so
the slab count changes only the loop bounds, never the answer bytes.

The database lives on ``device`` (None: the card) as int32 carriers of
its little-endian words, ``[dom, row_bytes / 4]``, rows zero-padded to the
full leaf domain.  The knobs ``DPF_CUDA_PIR_CHUNK_ROWS`` and
``DPF_CUDA_PIR_DB_CHUNK_BYTES`` (``core/knobs.py``) give the chunking's
defaults, and the compat selection expansion follows ``DPF_CUDA_PRG`` and
``DPF_CUDA_FUSE`` as full-domain evaluation does (the reference's fuse
route, without its failure latch).  The mesh (sharded) routes are not
ported.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import bitpack, knobs
from ..core.device import resolve_device
from ..core.keys import gen_batch
from ..core.keys_chacha import KeyBatchFast
from ..core.keys_chacha import gen_batch as gen_batch_fast
from ..ops.aes_bitslice import from_carrier, to_carrier
from ..ops import chacha_cuda as cp
from . import dpf as mdpf
from . import dpf_chacha as mdc

# Leaf width (log2 bits) per profile: compat = one AES block, fast = one
# ChaCha block (core/chacha_np.LEAF_LOG).
_LEAF_LOG = {"compat": 7, "fast": 9}

# torch._int_mm on CUDA wants more than 16 rows and inner and column sizes
# that are multiples of 8: the selection rows are zero-padded to this many
# at least, and to a multiple of 8.
_MM_MIN_ROWS = 32


def _pow2_floor(n: int) -> int:
    return 1 << (int(n).bit_length() - 1) if n >= 1 else 0


def row_domain(n_rows: int, profile: str = "compat") -> tuple[int, int]:
    """(log_n, padded domain size) for an ``n_rows``-row database.  Client
    and server must derive the domain identically."""
    log_n = max(int(n_rows - 1).bit_length(), 3)
    return log_n, 1 << max(log_n, _LEAF_LOG[profile])


# ---------------------------------------------------------------------------
# Client side
# ---------------------------------------------------------------------------


def pir_query(
    indices: np.ndarray | list[int],
    n_rows: int,
    rng: np.random.Generator | None = None,
    profile: str = "compat",
    *,
    device=None,
):
    """Build the two servers' query key batches for a batch of row indices,
    the Gen tower on ``device`` (None: the card; ``"cpu"``: the host tower).

    ``profile="fast"`` uses the ChaCha profile (``core/keys_chacha``):
    server and client must agree on the profile."""
    log_n, _ = row_domain(n_rows, profile)
    indices = np.asarray(indices, dtype=np.uint64)
    if (indices >= n_rows).any():
        raise ValueError("pir: row index out of range")
    if profile == "fast":
        return gen_batch_fast(indices, log_n, rng=rng, device=device)
    return gen_batch(indices, log_n, rng=rng, device=device)


def pir_reconstruct(ans_a: np.ndarray, ans_b: np.ndarray) -> np.ndarray:
    """XOR the two servers' answers -> the requested rows [K, row_bytes]."""
    return np.bitwise_xor(ans_a, ans_b)


# ---------------------------------------------------------------------------
# Server side
# ---------------------------------------------------------------------------


class PirServer:
    """One server's database, on ``device`` (None: the card).

    ``db``: uint8[N, row_bytes]; both servers hold identical copies.
    ``chunk_rows``: rows per parity-product chunk (None: the knob
    ``DPF_CUDA_PIR_CHUNK_ROWS``), rounded down to a power of two of at
    least 128 and at most the domain: chunking changes only the schedule,
    never the answer.  ``db_chunk_bytes``: resident bytes above which the
    scan streams slab by slab (None: the knob
    ``DPF_CUDA_PIR_DB_CHUNK_BYTES``; 0 disables streaming).  Without CUDA
    the constructor raises unless the caller passes ``device="cpu"``."""

    def __init__(
        self,
        db: np.ndarray,
        chunk_rows: int | None = None,
        profile: str = "compat",
        db_chunk_bytes: int | None = None,
        *,
        device=None,
    ):
        if profile not in _LEAF_LOG:
            raise ValueError(f"pir: unknown profile {profile!r}")
        db = np.ascontiguousarray(np.asarray(db, dtype=np.uint8))
        if db.ndim != 2:
            raise ValueError("db must be [n_rows, row_bytes]")
        self.profile = profile
        self.n_rows, self.row_bytes = db.shape
        if self.row_bytes % 4:
            raise ValueError("row_bytes must be a multiple of 4")
        self.device = resolve_device(device)
        self.log_n, dom = row_domain(self.n_rows, profile)
        self.nu = max(self.log_n - _LEAF_LOG[profile], 0)
        # Rows padded to the full leaf domain, so that selection words line
        # up 1:1 with expansion output words (and to whole chunks).
        self.dom = dom
        if chunk_rows is None:
            chunk_rows = knobs.get_int("DPF_CUDA_PIR_CHUNK_ROWS")
        self.chunk_rows = min(_pow2_floor(max(int(chunk_rows), 128)), dom)
        if db_chunk_bytes is None:
            db_chunk_bytes = knobs.get_int("DPF_CUDA_PIR_DB_CHUNK_BYTES")
        if db_chunk_bytes > 0 and dom * self.row_bytes > db_chunk_bytes:
            rows_per = _pow2_floor(max(db_chunk_bytes // self.row_bytes, 1))
            self.stream_rows = min(max(rows_per, 128), dom)
        else:
            self.stream_rows = dom
        self.stream_chunks = dom // self.stream_rows
        # The product's chunk never exceeds one streamed slab.
        self.chunk_rows = min(self.chunk_rows, self.stream_rows)
        padded = np.zeros((dom, self.row_bytes), np.uint8)
        padded[: self.n_rows] = db
        self.db_words = to_carrier(padded.view("<u4"), self.device)  # [dom, rb/4]

    def answer(self, queries) -> np.ndarray:
        """-> uint8[K, row_bytes]: per-query XOR of the selected rows.

        ``queries``: KeyBatch (compat profile) or KeyBatchFast (fast)."""
        want_fast = self.profile == "fast"
        if isinstance(queries, KeyBatchFast) != want_fast:
            raise ValueError(
                f"pir: {type(queries).__name__} queries sent to a "
                f"{self.profile!r}-profile server; client and server must "
                "agree on the profile"
            )
        if queries.log_n != self.log_n:
            raise ValueError(
                f"pir: query domain 2^{queries.log_n} != db domain 2^{self.log_n}"
            )
        if want_fast:
            dk = mdpf._cached_device_keys(queries, self.device, mdc._padded_device_keys)
            sel = _fast_expand_sel(dk)
        else:
            sel = _expand_sel_planes(mdpf._cached_device_keys(queries, self.device))
        words = self._stream_scan(sel)
        return mdpf._words_to_rows(from_carrier(words[: queries.k]), queries.k)

    def _stream_scan(self, sel: torch.Tensor) -> torch.Tensor:
        """The parity product slab by slab over the resident database
        (one slab when the scan does not stream), each slab's XORed into
        one accumulator in place (the reference's donated accumulator):
        selection words int32[K, dom/32] -> int32[K, R]."""
        K, R = sel.shape[0], self.db_words.shape[1]
        sw = self.stream_rows // 32
        inner = self.stream_rows // self.chunk_rows
        acc = torch.zeros((K, R), dtype=torch.int32, device=sel.device)
        for j in range(self.stream_chunks):
            acc ^= _parity_matmul(
                sel[:, j * sw : (j + 1) * sw],
                self.db_words[j * self.stream_rows : (j + 1) * self.stream_rows],
                self.chunk_rows, inner,
            )
        return acc


# ---------------------------------------------------------------------------
# The parity product and the selection expansions
# ---------------------------------------------------------------------------


@functools.cache
def _bit_shifts(device: torch.device) -> torch.Tensor:
    """uint8[8]: 0 .. 7, made once per device."""
    return torch.arange(8, dtype=torch.uint8, device=device)


def _unpack_bits_i8(words: torch.Tensor) -> torch.Tensor:
    """int32 carriers [M, W] -> int8[M, 32*W] bits, LSB-first per word:
    the one place where the packed words widen to bytes, one chunk at a
    time (int8 is the product's input type).  The words' little-endian
    bytes are unpacked, 8 bits a byte."""
    b = words.view(torch.uint8)  # [M, 4W]
    bits = torch.empty(b.shape + (8,), dtype=torch.uint8, device=b.device)
    torch.bitwise_right_shift(b[:, :, None], _bit_shifts(b.device), out=bits)
    return bits.bitwise_and_(1).view(torch.int8).reshape(words.shape[0], -1)


def _unpack_bits_i8_t(words: torch.Tensor) -> torch.Tensor:
    """int32 carriers [M, W] -> int8[32*W, M]: the bits of
    :func:`_unpack_bits_i8`, transposed (row-major, bit-major)."""
    b = words.view(torch.uint8).t()  # [4W, M]
    bits = torch.empty((b.shape[0], 8, b.shape[1]), dtype=torch.uint8, device=b.device)
    torch.bitwise_right_shift(b[:, None, :], _bit_shifts(b.device)[None, :, None], out=bits)
    return bits.bitwise_and_(1).view(torch.int8).reshape(-1, words.shape[0])


def _int_mm_bits(sel: torch.Tensor, db_t: torch.Tensor) -> torch.Tensor:
    """Counts int32[rows, bits] of the product of the selection bits
    int8[rows, chunk] and the database bits, given transposed as
    int8[bits, chunk] (:func:`_unpack_bits_i8_t`): the second operand
    reaches ``torch._int_mm`` column-major, the layout of cuBLAS's int8
    tensor-core kernels."""
    return torch._int_mm(sel, db_t.t())


def _parity_matmul(sel_words: torch.Tensor, db_words: torch.Tensor,
                   chunk_rows: int, n_chunks: int) -> torch.Tensor:
    """GF(2) product sel[K, N] x db[N, bits] over ``n_chunks`` chunks of
    ``chunk_rows`` rows: sel_words int32[K, N/32], db_words int32[N, R]
    -> int32[K, R].  Each chunk is one int8 product of the unpacked bits
    (:func:`_int_mm_bits`); the selection rows are zero-padded for it
    (``_MM_MIN_ROWS``)."""
    K = sel_words.shape[0]
    R = db_words.shape[1]
    rows = max(_MM_MIN_ROWS, K + (-K) % 8)
    if rows != K:
        sel_words = torch.nn.functional.pad(sel_words, (0, 0, 0, rows - K))
    cw = chunk_rows // 32
    acc = torch.zeros((rows, 32 * R), dtype=torch.int32, device=sel_words.device)
    for i in range(n_chunks):
        sel = _unpack_bits_i8(sel_words[:, i * cw : (i + 1) * cw])  # [rows, chunk]
        db_t = _unpack_bits_i8_t(db_words[i * chunk_rows : (i + 1) * chunk_rows])  # [32R, chunk]
        acc ^= _int_mm_bits(sel, db_t) & 1
    return bitpack.pack_bits_torch(acc[:K])


def _expand_sel_planes(dk: mdpf.DeviceKeys) -> torch.Tensor:
    """The compat profile's selection words int32[K_padded, dom/32] in
    ascending row order (row 128 w + 32 q + bit, LSB-first), with no
    subtree chunking, on the knobs' backend (``DPF_CUDA_PRG``): per level
    by default, nu ``prg_bm_kernel`` launches and one
    ``leaf_words_bm_kernel``; with ``DPF_CUDA_FUSE`` on, the reference's
    fuse route (``dpf_tpu/models/pir.py:251-266``, ``:346-361``):
    ``_fuse_plan``'s schedule, the levels from ``_FUSE_FLOOR`` down on
    ``fused_levels_bm_kernel``.  The words are the same either way."""
    whole = (1 << dk.nu) * (dk.k_padded // 32)  # one expansion: no chunks
    leaves = mdpf.eval_full_device(dk, whole)  # [K_padded, W, 4]
    return leaves.reshape(leaves.shape[0], -1)


def _fast_expand_sel(dk: mdc.DeviceKeysFast) -> torch.Tensor:
    """The fast profile's selection words int32[K, dom/32] in ascending row
    order: the classic route (the ``fused_levels`` prefix to the entry
    level, then one ``expand_tail``) or, for nu < 7, the whole-tree route,
    with no leaf cap, as the reference's single-card scan has none."""
    eligible, entry, _ = cp.expand_plan(dk.nu, dk.k, dk.k << dk.nu)
    words = mdc._eval_full_kernel_device(mdc._IMPLS[None], dk, entry if eligible else 0)
    return words.reshape(words.shape[0], -1)
