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
    bits     = fast.eval_points_batch(kba, xs)   # xs uint64[K, Q] -> uint8[K, Q]

One key per comparison gate (DCF, ``models/dcf.py``):

    ca, cb = fast.dcf_gen_lt_batch(alphas, log_n)        # host
    shares = fast.dcf_eval_lt_points(ca, xs)             # 1{x < alpha} shares
    ia, ib = fast.dcf_gen_interval_batch(lo, hi, log_n)  # host
    shares = fast.dcf_eval_interval_points(ia, xs)       # 1{lo <= x <= hi}

Gen and Eval run on the host through the numpy spec.  Full-domain,
pointwise and DCF evaluation run on the card (``device=None`` means
``"cuda"``) through the kernels of ``ops/chacha_cuda.py`` and raise without
one, unless the caller passes ``device="cpu"``.  The FSS gates over
level-grouped DPFs of either profile are ``dpf_tpu_torch.fss``.
"""

from __future__ import annotations

import numpy as np

from .core import chacha_np as _cc
from .core.chacha_np import key_len
from .core.keys_chacha import KeyBatchFast, gen_batch
from .models.dpf_chacha import DeviceKeysFast, eval_full_device
from .models.dpf_chacha import eval_full as _eval_full
from .models.dpf_chacha import eval_points as _eval_points
from .models.dcf import (
    DcfKeyBatch,
    eval_interval_points as dcf_eval_interval_points,
    eval_lt_points as dcf_eval_lt_points,
    gen_interval_batch as dcf_gen_interval_batch,
    gen_lt_batch as dcf_gen_lt_batch,
)
from .models.dcf import key_len as dcf_key_len

__all__ = [
    "Gen",
    "Eval",
    "EvalFull",
    "KeyBatchFast",
    "DeviceKeysFast",
    "gen_batch",
    "eval_full_batch",
    "eval_full_device",
    "eval_points_batch",
    "key_len",
    # one-key-per-gate comparison (DCF; models/dcf.py)
    "DcfKeyBatch",
    "dcf_gen_lt_batch",
    "dcf_eval_lt_points",
    "dcf_gen_interval_batch",
    "dcf_eval_interval_points",
    "dcf_key_len",
]


def Gen(alpha: int, log_n: int, rng=None) -> tuple[bytes, bytes]:
    """Generate a fast-profile key pair for ``alpha`` in [0, 2^log_n), on
    the host."""
    return _cc.gen(alpha, log_n, rng)


def Eval(key: bytes, x: int, log_n: int, backend: str = "auto", device=None) -> int:
    """Evaluate one share at one point -> bit.  ``backend`` "auto" and
    "cpu" run on the host (one point does not amortize a launch); any
    other sends the point to the walk on ``device``."""
    if backend in ("auto", "cpu"):
        return _cc.eval_point(key, x, log_n)
    kb = KeyBatchFast.from_bytes([key], log_n)
    return int(_eval_points(kb, np.array([[x]], dtype=np.uint64), device=device)[0, 0])


def EvalFull(key: bytes, log_n: int, backend: str = "auto", device=None) -> bytes:
    """Full-domain evaluation of one share -> bit-packed bytes
    (2^(log_n-3), at least 64).  ``backend="cpu"`` runs the host spec;
    otherwise the evaluation runs on ``device``."""
    if backend == "cpu":
        return _cc.eval_full(key, log_n)
    kb = KeyBatchFast.from_bytes([key], log_n)
    return eval_full_batch(kb, device=device)[0].tobytes()


def eval_full_batch(kb: KeyBatchFast, device=None, **kwargs) -> np.ndarray:
    """Full-domain evaluation of a key batch -> uint8[K, out_bytes].
    ``kwargs`` go to :func:`dpf_tpu_torch.models.dpf_chacha.eval_full`."""
    return _eval_full(kb, device=device, **kwargs)


def eval_points_batch(kb: KeyBatchFast, xs: np.ndarray, backend: str = "auto",
                      packed: bool = False, device=None) -> np.ndarray:
    """Batched pointwise evaluation: xs uint64[K, Q] -> uint8[K, Q], one walk
    launch.  ``packed=True`` returns bit-packed words uint32[K, ceil(Q/32)]
    (query q at word q//32, bit q%32, LSB-first, tail zero), packed on the
    device.  ``backend="cpu"`` is the host route (the same as
    ``device="cpu"``); ``"auto"`` evaluates on ``device``."""
    if backend == "cpu":
        device = "cpu"
    return _eval_points(kb, xs, packed=packed, device=device)
