"""dpf_tpu_torch — the PyTorch/CUDA port of ``dpf_tpu``, for NVIDIA Hopper.

A second package beside the JAX reference: the same key bytes go in and the
same output bytes come out.  It carries the compat profile (keys
byte-compatible with dkales/dpf-go) from host Gen to full-domain evaluation,
whose PRG and leaf convert run as hand-written CUDA kernels
(``ops/csrc/aes_mmo.cu``), and the same path for the ChaCha fast profile in
:mod:`dpf_tpu_torch.fast` (kernels ``ops/csrc/chacha_expand.cu``).  The
package imports neither JAX nor ``dpf_tpu``.

Reference-parity scalar API (dpf/dpf.go: Gen, Eval, EvalFull):

    ka, kb = dpf_tpu_torch.Gen(alpha, log_n)          # host
    bit    = dpf_tpu_torch.Eval(ka, x, log_n)         # host
    shares = dpf_tpu_torch.EvalFull(ka, log_n)        # the card

Batch API:

    kba, kbb = dpf_tpu_torch.gen_batch(alphas, log_n)   # host, vectorized
    out      = dpf_tpu_torch.eval_full_batch(kba)       # uint8[K, 2^(n-3)]

Device evaluation runs on the card (``device=None`` means ``"cuda"``) and
raises without one, unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np

from . import fast
from .core import spec
from .core.keys import KeyBatch, gen_batch
from .core.spec import key_len
from .models import dpf as _dpf

__all__ = [
    "Gen",
    "Eval",
    "EvalFull",
    "KeyBatch",
    "gen_batch",
    "eval_full_batch",
    "key_len",
    "fast",
]


def Gen(alpha: int, log_n: int, rng=None) -> tuple[bytes, bytes]:
    """Generate a DPF key pair for point ``alpha`` in [0, 2^log_n), on the
    host (reference dpf/dpf.go:71-169)."""
    return spec.gen(alpha, log_n, rng)


def Eval(key: bytes, x: int, log_n: int) -> int:
    """Evaluate one share at a single point -> bit (reference
    dpf/dpf.go:171), on the host: one point does not amortize a launch."""
    return spec.eval_point(key, x, log_n)


def EvalFull(key: bytes, log_n: int, device=None) -> bytes:
    """Full-domain evaluation of one key -> 2^(log_n-3) bit-packed bytes
    (16 bytes when log_n < 7), byte-identical to the reference EvalFull
    (dpf/dpf.go:243-262)."""
    kb = KeyBatch.from_bytes([key], log_n)
    return eval_full_batch(kb, device=device)[0].tobytes()


def eval_full_batch(kb: KeyBatch, device=None, **kwargs) -> np.ndarray:
    """Full-domain evaluation of a key batch -> uint8[K, 2^(log_n-3)].
    ``kwargs`` go to :func:`dpf_tpu_torch.models.dpf.eval_full`."""
    return _dpf.eval_full(kb, device=device, **kwargs)
