"""The heavy-hitter count fold on the card.

The port's counterpart of ``dpf_tpu/models/hh_fold.py``.  A descent round's
count reconstruction is a sum over the client axis: the driver XORs the two
aggregators' packed share rows (PUBLIC once reconstructed: exactly the
per-candidate predicate bits) and sums each candidate's column.  The JAX
package runs that sum as one int8 matmul of an all-ones row against the
unpacked bits, outside any Pallas kernel.  Here it is plain PyTorch on the
card: unpack the words to 0/1 bytes and sum them over the clients in int32
(``torch._int_mm`` wants a first dimension above 16, which a ones row is
not).

Only PUBLIC data flows through this fold; the secret share rows never reach
it un-XORed (per-aggregator integer sums of XOR share bits reconstruct
nothing).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import bitpack
from ..core.device import resolve_device
from ..ops.aes_bitslice import to_carrier


def count_fold_torch(x: torch.Tensor) -> torch.Tensor:
    """Packed XOR-reconstructed rows int32[G, W] -> int32[W * 32]
    per-candidate counts (``_count_fold_body``), on ``x``'s device."""
    return bitpack.unpack_bits_torch(x, x.shape[1] * 32).sum(dim=0, dtype=torch.int32)


def count_fold(x: np.ndarray, device=None) -> np.ndarray:
    """Host entry: uint32[G, W] packed public rows -> int64[W * 32], the
    fold on ``device`` (None: the card)."""
    dev = resolve_device(device)
    x = np.asarray(x, dtype=np.uint32)
    return count_fold_torch(to_carrier(x, dev)).cpu().numpy().astype(np.int64)
