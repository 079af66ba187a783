"""Public API of the ChaCha fast profile, in the port.

The counterpart of ``dpf_tpu/fast.py``: the same surface as the compat API,
over the fast-profile scheme (ChaCha12 PRG, 512-bit leaves;
``core/chacha_np.py``).  Its keys are not byte-compatible with the
reference's, which pins fixed-key AES-128-MMO (dpf/dpf.go:22-44).

    ka, kb = fast.Gen(alpha, log_n)              # host
    bit    = fast.Eval(ka, x, log_n)             # host
    out    = fast.EvalFull(ka, log_n)            # the card

    kba, kbb = fast.gen_batch(alphas, log_n)     # host, vectorized
    leaves   = fast.eval_full_batch(kba)         # uint8[K, max(2^(n-3), 64)]

Gen and Eval run on the host through the numpy spec.  Full-domain
evaluation runs on the card (``device=None`` means ``"cuda"``) through the
kernels of ``ops/chacha_cuda.py`` and raises without one, unless the caller
passes ``device="cpu"``.  Pointwise batches and DCF are not ported yet.
"""

from __future__ import annotations

import numpy as np

from .core import chacha_np as _cc
from .core.chacha_np import key_len
from .core.keys_chacha import KeyBatchFast, gen_batch
from .models.dpf_chacha import DeviceKeysFast, eval_full_device
from .models.dpf_chacha import eval_full as _eval_full

__all__ = [
    "Gen",
    "Eval",
    "EvalFull",
    "KeyBatchFast",
    "DeviceKeysFast",
    "gen_batch",
    "eval_full_batch",
    "eval_full_device",
    "key_len",
]


def Gen(alpha: int, log_n: int, rng=None) -> tuple[bytes, bytes]:
    """Generate a fast-profile key pair for ``alpha`` in [0, 2^log_n), on
    the host."""
    return _cc.gen(alpha, log_n, rng)


def Eval(key: bytes, x: int, log_n: int) -> int:
    """Evaluate one share at one point -> bit, on the host: one point does
    not amortize a launch."""
    return _cc.eval_point(key, x, log_n)


def EvalFull(key: bytes, log_n: int, device=None) -> bytes:
    """Full-domain evaluation of one share -> bit-packed bytes
    (2^(log_n-3), at least 64)."""
    kb = KeyBatchFast.from_bytes([key], log_n)
    return eval_full_batch(kb, device=device)[0].tobytes()


def eval_full_batch(kb: KeyBatchFast, device=None, **kwargs) -> np.ndarray:
    """Full-domain evaluation of a key batch -> uint8[K, out_bytes].
    ``kwargs`` go to :func:`dpf_tpu_torch.models.dpf_chacha.eval_full`."""
    return _eval_full(kb, device=device, **kwargs)
