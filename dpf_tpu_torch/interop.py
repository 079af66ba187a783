"""Key material carried across from the JAX package.

The key bytes are the interchange format; :func:`from_jax_keybatch` takes the
numpy arrays of a ``dpf_tpu`` ``KeyBatch`` (its ``log_n``, ``seeds``, ``ts``,
``scw``, ``tcw`` and ``fcw`` fields) and returns the port's ``KeyBatch``
without importing anything of ``dpf_tpu``; :func:`from_jax_keybatch_fast`
does the same for a fast-profile ``KeyBatchFast``,
:func:`from_jax_dcfkeybatch` for a ``DcfKeyBatch`` (plus its ``vcw`` and
``fvcw``), and :func:`from_jax_hhshare` for a heavy-hitters ``HHShare``.  The FSS gate
batches are made of ordinary key batches and convert through the first
two.
"""

from __future__ import annotations

import numpy as np

from .core import chacha_np
from .core.keys import KeyBatch
from .core.keys_chacha import KeyBatchFast
from .models.dcf import DcfKeyBatch


def from_jax_keybatch(log_n, seeds, ts, scw, tcw, fcw) -> KeyBatch:
    """The port's KeyBatch over copies of a ``dpf_tpu`` KeyBatch's arrays."""
    log_n = int(log_n)
    arrays = _checked_copies(_key_arrays(max(log_n - 7, 0), seeds, ts, scw, tcw,
                                         fcw=(fcw, 4)))
    return KeyBatch(log_n, **arrays)


def from_jax_keybatch_fast(log_n, seeds, ts, scw, tcw, fcw) -> KeyBatchFast:
    """The port's KeyBatchFast over copies of a ``dpf_tpu`` KeyBatchFast's
    arrays."""
    log_n = int(log_n)
    arrays = _checked_copies(_key_arrays(chacha_np.nu_of(log_n), seeds, ts, scw, tcw,
                                         fcw=(fcw, 16)))
    return KeyBatchFast(log_n, **arrays)


def from_jax_dcfkeybatch(log_n, seeds, ts, scw, tcw, vcw, fvcw) -> DcfKeyBatch:
    """The port's DcfKeyBatch over copies of a ``dpf_tpu`` DcfKeyBatch's
    arrays."""
    log_n = int(log_n)
    nu = chacha_np.nu_of(log_n)
    want = _key_arrays(nu, seeds, ts, scw, tcw, fvcw=(fvcw, 16))
    want["vcw"] = (vcw, np.uint8, (len(seeds), nu))
    return DcfKeyBatch(log_n, **_checked_copies(want))


def _key_arrays(nu, seeds, ts, scw, tcw, **final) -> dict:
    """name -> (array, dtype, shape) of a key batch's arrays; ``final`` is
    its one final-CW array as name=(array, words)."""
    K = len(seeds)
    want = {
        "seeds": (seeds, np.uint32, (K, 4)),
        "ts": (ts, np.uint8, (K,)),
        "scw": (scw, np.uint32, (K, nu, 4)),
        "tcw": (tcw, np.uint8, (K, nu, 2)),
    }
    for name, (a, words) in final.items():
        want[name] = (a, np.uint32, (K, words))
    return want


def _checked_copies(want: dict) -> dict:
    """Copies of the arrays of ``want``, each checked for its dtype and
    shape."""
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


def from_jax_hhshare(log_n, profile, seeds, ts, scw, tcw, fcw):
    """The port's ``apps.heavy_hitters.HHShare`` over copies of a ``dpf_tpu``
    HHShare's ``levels`` arrays (level-major, ``log_n * G`` keys), in its
    ``profile`` (``"compat"`` or ``"fast"``)."""
    from .apps.heavy_hitters import HHShare

    convert = {"compat": from_jax_keybatch, "fast": from_jax_keybatch_fast}.get(profile)
    if convert is None:
        raise ValueError(f"heavy_hitters: unknown profile {profile!r}")
    return HHShare(int(log_n), convert(log_n, seeds, ts, scw, tcw, fcw), profile)
