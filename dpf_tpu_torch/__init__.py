"""dpf_tpu_torch — the PyTorch/CUDA port of ``dpf_tpu``, for NVIDIA Hopper.

A second package beside the JAX reference: the same key bytes go in and the
same output bytes come out.  It carries the compat profile (keys
byte-compatible with dkales/dpf-go) from host Gen to full-domain evaluation,
whose PRG and leaf convert run as hand-written CUDA kernels
(``ops/csrc/aes_mmo.cu``), and to pointwise evaluation, whose whole walk is
one kernel (``ops/csrc/aes_walk.cu``).  Full-domain evaluation takes the
JAX package's kernel options: ``backend="pallas_bm"`` (the default; bit-major
level state, ``prg_bm_kernel`` and ``leaf_words_bm_kernel`` replacing
``_prg_kernel_bm`` and ``_mmo_canon_kernel_bm`` with the final CW and the
unpack to per-key words after it), ``"pallas_bm_il"`` (``prg_bm_il_kernel``
for ``_prg_kernel_bm_il``), ``"pallas"`` or ``"xla"`` (canonical order,
``prg_canon_kernel`` and ``leaf_words_canon_kernel`` for ``_prg_kernel`` and
``_mmo_kernel``), and ``fuse=g`` on a bit-major backend
(``ops/csrc/aes_fused.cu::fused_levels_bm_kernel`` for
``_fused_levels_kernel_bm``), all with the same bytes.  The same paths for
the ChaCha fast
profile are in :mod:`dpf_tpu_torch.fast` (kernels
``ops/csrc/chacha_expand.cu``, ``ops/csrc/chacha_walk.cu``).  The package
imports neither JAX nor ``dpf_tpu``.

Reference-parity scalar API (dpf/dpf.go: Gen, Eval, EvalFull):

    ka, kb = dpf_tpu_torch.Gen(alpha, log_n)          # host
    bit    = dpf_tpu_torch.Eval(ka, x, log_n)         # host
    shares = dpf_tpu_torch.EvalFull(ka, log_n)        # the card

Batch API:

    kba, kbb = dpf_tpu_torch.gen_batch(alphas, log_n)   # the card's dealer
    kba, kbb = dpf_tpu_torch.gen_batch(alphas, log_n, device="cpu")  # host tower
    out      = dpf_tpu_torch.eval_full_batch(kba)       # uint8[K, 2^(n-3)]
    out      = dpf_tpu_torch.eval_full_batch(kba, backend="pallas", fuse=None)
    bits     = dpf_tpu_torch.eval_points_batch(kba, xs)  # xs uint64[K, Q] -> uint8[K, Q]
    words    = dpf_tpu_torch.eval_points_batch(kba, xs, packed=True)  # uint32[K, ceil(Q/32)]

FSS comparison and interval gates over level-grouped DPFs of either
profile (``dpf_tpu_torch.fss``, ``models/fss.py``):

    ca, cb = fss.gen_lt_batch(alphas, log_n)          # 1{x < alpha} shares, the card
    ia, ib = fss.gen_interval_batch(lo, hi, log_n)    # 1{lo <= x <= hi}, the card
    shares = fss.eval_lt_points(ca, xs)               # the card
    table  = fss.ge_full_from_dpf(kba)                # 1{x >= alpha}, whole domain

One-key-per-gate comparison (DCF) is in :mod:`dpf_tpu_torch.fast`.  The
heavy-hitter descent and the secure aggregation folds are in
:mod:`dpf_tpu_torch.apps`.

Batched Gen (``gen_batch`` of both profiles, the DCF and FSS gens,
``pir.pir_query``, ``apps.heavy_hitters.gen_shares``) draws its root seeds
on the host and runs its correction-word tower on the card
(``models/keys_gen.py``; ``ops/csrc/chacha_gen.cu`` for the ChaCha
families); ``device="cpu"`` runs the host tower, with the same bytes.
Device evaluation, and Gen, run on the card (``device=None`` means
``"cuda"``) and raise without one, unless the caller passes
``device="cpu"``.  Nothing falls back to the host.
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
    "eval_points_batch",
    "key_len",
    "fss",
    "fast",
]


def __getattr__(name):
    if name == "fss":
        import importlib

        return importlib.import_module(".models.fss", __name__)
    raise AttributeError(f"module 'dpf_tpu_torch' has no attribute {name!r}")


def Gen(alpha: int, log_n: int, rng=None) -> tuple[bytes, bytes]:
    """Generate a DPF key pair for point ``alpha`` in [0, 2^log_n), on the
    host (reference dpf/dpf.go:71-169)."""
    return spec.gen(alpha, log_n, rng)


def Eval(key: bytes, x: int, log_n: int, backend: str = "auto", device=None) -> int:
    """Evaluate one share at a single point -> bit (reference
    dpf/dpf.go:171).  ``backend`` "auto" and "cpu" run on the host (one
    point does not amortize a launch); any other ("jax", the reference's
    accelerated route) sends the point to the walk on ``device``."""
    if backend in ("auto", "cpu"):
        return spec.eval_point(key, x, log_n)
    kb = KeyBatch.from_bytes([key], log_n)
    return int(eval_points_batch(kb, np.array([[x]], dtype=np.uint64), device=device)[0, 0])


def EvalFull(key: bytes, log_n: int, backend: str = "auto", device=None) -> bytes:
    """Full-domain evaluation of one key -> 2^(log_n-3) bit-packed bytes
    (16 bytes when log_n < 7), byte-identical to the reference EvalFull
    (dpf/dpf.go:243-262).  ``backend="cpu"`` runs the host spec; otherwise
    the evaluation runs on ``device``."""
    if backend == "cpu":
        return spec.eval_full(key, log_n)
    kb = KeyBatch.from_bytes([key], log_n)
    return eval_full_batch(kb, device=device)[0].tobytes()


def eval_full_batch(kb: KeyBatch, device=None, **kwargs) -> np.ndarray:
    """Full-domain evaluation of a key batch -> uint8[K, 2^(log_n-3)].
    ``kwargs`` go to :func:`dpf_tpu_torch.models.dpf.eval_full`:
    ``max_plane_words``, ``backend`` (``"pallas_bm"`` by default,
    ``"pallas_bm_il"``, ``"pallas"`` or ``"xla"``) and ``fuse`` (None or 0:
    per level; g >= 1: fused groups of at most g levels on the bit-major
    backends).  Every choice gives the same bytes."""
    return _dpf.eval_full(kb, device=device, **kwargs)


def eval_points_batch(kb: KeyBatch, xs: np.ndarray, packed: bool = False,
                      device=None) -> np.ndarray:
    """Pointwise evaluation of a key batch at xs uint64[K, Q] -> uint8[K, Q].

    ``packed=True`` returns the walk's native bit-packed form instead:
    uint32[K, ceil(Q/32)] words, query q at word q//32 bit q%32 (LSB-first;
    bits >= Q zero), so the device-to-host copy shrinks 32x.
    ``core.bitpack.unpack_bits(words, Q)`` recovers the byte-per-bit form."""
    return _dpf.eval_points(kb, xs, packed=packed, device=device)
