"""Secure aggregation: streamed folds of client share vectors on the card.

The port's counterpart of ``dpf_tpu/apps/aggregation.py``.  Every client
holds a SHARE VECTOR (packed uint32 words, the repo's wire format,
core/bitpack.py), and the aggregator's whole job is a fold over clients:

  ``xor``   bitwise XOR fold.  For XOR-shared bit vectors (what the DPF
            evaluators emit): the two aggregators' folded vectors
            XOR-reconstruct to the XOR of all client vectors; for one-hot
            client contributions, the odd-multiplicity presence bitmap over
            the domain.
  ``add``   elementwise sum mod 2^32.  For additively-shared uint32 vectors
            (secure-aggregation counters and histograms): the aggregators'
            folds ADD-reconstruct to the true sum.

Both folds are associative with an all-zeros identity, so the aggregator
streams the upload in chunks of :data:`AGG_CHUNK_BYTES` (the JAX package's
``DPF_TPU_AGG_CHUNK_BYTES``, 4 MiB): each chunk goes to the card and folds
into the running ``[words]`` carry through the plan cache
(``core/plans.run_agg_fold``, as the reference's folds do: the chunk's rows
and words padded to their plan bucket, the carry back on the host), so a
million-client sum never materializes on the host.  The folds are plain
PyTorch, as the JAX package's are XLA outside Pallas: torch has no XOR
reduction, so the XOR fold halves the rows (``log2 R`` launches); the add
fold sums in int64 and masks to 32 bits.

:func:`aggregate_eval_full` closes the loop with the DPF layer: the
aggregator holds client KEYS and folds their full-domain expansions chunk
by chunk on the card (the compat or fast ``eval_full_device`` words are
folded where they are made, through the same plan route), the 2-server
presence-bitmap protocol with only ``[words]`` vectors crossing back to
the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import plans
from ..core.device import resolve_device
from ..ops.aes_cuda import _fold

__all__ = [
    "OPS",
    "AGG_CHUNK_BYTES",
    "chunk_rows",
    "fold_rows",
    "aggregate_chunks",
    "aggregate_rows",
    "aggregate_eval_full",
    "reconstruct",
]

OPS = ("xor", "add")
AGG_CHUNK_BYTES = 4 << 20  # DPF_TPU_AGG_CHUNK_BYTES


def _check_op(op: str) -> None:
    if op not in OPS:
        raise ValueError(f"aggregation: unknown op {op!r} (use xor|add)")


def _fold_body(op: str, carry: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """One chunk of the streamed aggregation: fold int32 carriers
    [R, W] into the [W] carry, on their device.  Zero rows are the identity
    of both ops."""
    _check_op(op)
    if not rows.shape[0]:
        return carry
    if op == "xor":
        return carry ^ _fold(rows, torch.bitwise_xor)
    # torch sums int32 in int64: the sum of the carriers mod 2^32 is the
    # uint32 sum's; mask it and carry it back as int32.
    s = (carry.to(torch.int64) + rows.sum(dim=0, dtype=torch.int64)) & 0xFFFFFFFF
    return torch.where(s >= 1 << 31, s - (1 << 32), s).to(torch.int32)


def chunk_rows(words: int, chunk_bytes: int | None = None) -> int:
    """Rows per streamed fold: ``chunk_bytes`` (None: :data:`AGG_CHUNK_BYTES`)
    worth of ``words``-word rows (>= 1)."""
    if chunk_bytes is None:
        chunk_bytes = AGG_CHUNK_BYTES
    return max(1, int(chunk_bytes) // max(int(words) * 4, 1))


def fold_rows(rows, op: str, carry: np.ndarray | None = None,
              device=None) -> np.ndarray:
    """Fold one chunk of share rows uint32[R, W] (or int32 carriers already
    on the card) into ``carry`` (zeros when None) on ``device`` (None: the
    card) -> uint32[W], through the plan cache (``plans.run_agg_fold``)."""
    _check_op(op)
    return plans.run_agg_fold(op, carry, rows, device=device)


def _fold_chunks(chunks, op: str, words: int, dev) -> np.ndarray:
    """Fold an iterable of chunks [R_i, words] (host words or card
    carriers) into one uint32[words] vector, a plan dispatch a chunk."""
    carry = np.zeros(int(words), np.uint32)
    for chunk in chunks:
        if chunk.ndim != 2 or chunk.shape[1] != words:
            raise ValueError("aggregation: chunk shape mismatch")
        if chunk.shape[0]:
            carry = fold_rows(chunk, op, carry, dev)
    return carry


def aggregate_chunks(chunks, op: str, words: int, device=None) -> np.ndarray:
    """Streamed aggregation driver: fold an iterable of uint32[R_i, W]
    chunks into one uint32[W] vector on ``device`` (None: the card).  Only
    the carry and one chunk are ever live on the card."""
    _check_op(op)
    dev = resolve_device(device)
    return _fold_chunks((np.asarray(c, dtype=np.uint32) for c in chunks), op, words, dev)


def aggregate_rows(rows: np.ndarray, op: str, rows_per_chunk: int | None = None,
                   device=None) -> np.ndarray:
    """Chunk an in-memory uint32[K, W] share matrix and stream it through
    :func:`aggregate_chunks` (the same result as one giant fold)."""
    rows = np.asarray(rows, dtype=np.uint32)
    if rows.ndim != 2:
        raise ValueError("aggregation: rows must be [K, W]")
    k, words = rows.shape
    step = rows_per_chunk or chunk_rows(words)
    return aggregate_chunks((rows[i : i + step] for i in range(0, k, step)), op, words,
                            device)


def aggregate_eval_full(kb, op: str = "xor", device=None) -> np.ndarray:
    """Fold the full-domain expansions of a client KEY batch (either
    profile) chunk by chunk on ``device`` (None: the card) -> one
    uint32[out_bytes / 4] share vector.  Two aggregators running this over
    their halves of the client key pairs hold XOR-shares of the domain's
    odd-multiplicity presence bitmap; neither ever materializes the
    [K, out_bytes] expansion."""
    from ..core.keys_chacha import KeyBatchFast
    from ..models import dpf, dpf_chacha
    from .heavy_hitters import _profile_api, slice_batch

    _check_op(op)
    dev = resolve_device(device)
    fast = isinstance(kb, KeyBatchFast)
    _, cls, _ = _profile_api("fast" if fast else "compat")
    row_bytes = max((1 << kb.log_n) >> 3, 4)
    words = max(row_bytes // 4, 1)
    step = chunk_rows(words)

    def chunks():
        for i in range(0, kb.k, step):
            sub = slice_batch(kb, cls, slice(i, i + step))
            if fast:
                out = dpf_chacha.eval_full_device(sub, device=dev)
            else:
                out = dpf.eval_full_device(dpf.DeviceKeys(sub, dev))[: sub.k]
            yield out.reshape(sub.k, -1)[:, :words]

    return _fold_chunks(chunks(), op, words, dev)


def reconstruct(fold_a: np.ndarray, fold_b: np.ndarray, op: str) -> np.ndarray:
    """Combine the two aggregators' folded vectors into the public
    aggregate: XOR for ``xor`` shares, sum mod 2^32 for ``add`` shares."""
    a = np.asarray(fold_a, dtype=np.uint32)
    b = np.asarray(fold_b, dtype=np.uint32)
    if a.shape != b.shape:
        raise ValueError("aggregation: fold shapes differ")
    if op == "xor":
        return a ^ b
    if op == "add":
        return a + b  # uint32 wrap == mod 2^32
    raise ValueError(f"aggregation: unknown op {op!r} (use xor|add)")
