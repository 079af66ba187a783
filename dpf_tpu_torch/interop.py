"""Key material carried across from the JAX package.

The key bytes are the interchange format; :func:`from_jax_keybatch` takes the
numpy arrays of a ``dpf_tpu`` ``KeyBatch`` (its ``log_n``, ``seeds``, ``ts``,
``scw``, ``tcw`` and ``fcw`` fields) and returns the port's ``KeyBatch``
without importing anything of ``dpf_tpu``; :func:`from_jax_keybatch_fast`
does the same for a fast-profile ``KeyBatchFast``.
"""

from __future__ import annotations

import numpy as np

from .core import chacha_np
from .core.keys import KeyBatch
from .core.keys_chacha import KeyBatchFast


def from_jax_keybatch(log_n, seeds, ts, scw, tcw, fcw) -> KeyBatch:
    """The port's KeyBatch over copies of a ``dpf_tpu`` KeyBatch's arrays."""
    log_n = int(log_n)
    arrays = _checked_copies(max(log_n - 7, 0), 4, seeds, ts, scw, tcw, fcw)
    return KeyBatch(log_n, **arrays)


def from_jax_keybatch_fast(log_n, seeds, ts, scw, tcw, fcw) -> KeyBatchFast:
    """The port's KeyBatchFast over copies of a ``dpf_tpu`` KeyBatchFast's
    arrays."""
    log_n = int(log_n)
    arrays = _checked_copies(chacha_np.nu_of(log_n), 16, seeds, ts, scw, tcw, fcw)
    return KeyBatchFast(log_n, **arrays)


def _checked_copies(nu, fcw_words, seeds, ts, scw, tcw, fcw) -> dict:
    """Copies of the five arrays, each checked for its dtype and shape."""
    K = len(seeds)
    want = {
        "seeds": (seeds, np.uint32, (K, 4)),
        "ts": (ts, np.uint8, (K,)),
        "scw": (scw, np.uint32, (K, nu, 4)),
        "tcw": (tcw, np.uint8, (K, nu, 2)),
        "fcw": (fcw, np.uint32, (K, fcw_words)),
    }
    arrays = {}
    for name, (a, dtype, shape) in want.items():
        a = np.asarray(a)
        if a.dtype != dtype or a.shape != shape:
            raise ValueError(
                f"{name}: expected {np.dtype(dtype)}{list(shape)}, "
                f"got {a.dtype}{list(a.shape)}"
            )
        arrays[name] = a.copy()
    return arrays
