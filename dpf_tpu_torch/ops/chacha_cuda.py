"""The fast profile's expansion kernels for Hopper, and their routing plan.

The port's counterpart of the expansion half of
``dpf_tpu/ops/chacha_pallas.py``.  Two wrappers, each beside its plain
PyTorch version:

- :func:`expand_tail` (``csrc/chacha_expand.cu::expand_tail_kernel``,
  replacing ``_expand_kernel``): the last L GGM levels plus the 512-bit leaf
  convert and final CW, state ``[5, K, W]`` in, leaf words
  ``[K, W << L, 16]`` out in ascending leaf order;
- :func:`fused_levels` (``fused_levels_kernel``, replacing
  ``_fused_levels_kernel``): G GGM levels, state ``[5, K, W]`` in,
  ``[5, K, W << G]`` out in ascending node order.

State rows 0..3 are the four seed words, row 4 the control bit (0/1); the
CWs are the compact per-key ``scw[K, L, 4]``, ``tcw[K, L, 2]`` and
``fcw[K, 16]`` of the levels the call runs (views of the key arrays are
taken as they are, through their strides).  All tensors are int32 carriers
of the uint32 words.  The Pallas kernels emit block order and need
``deinterleave_nodes`` afterwards; these write ascending order directly.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  Each counts its kernel launches in its
``launches`` attribute.

The plan functions below are copies of ``chacha_pallas``'s, as pure
functions, as they decide on the TPU with ``DPF_TPU_EXPAND_ENTRY`` unset:
the port's routes take the card's schedule on either device.  The TPU-only
parts (failure latches, env knobs, the 128-lane CW padding) are not ported.
"""

from __future__ import annotations

import torch

from . import build

_EKT = 8  # key tile of the Pallas kernel: the plan's key padding quantum
_EWT = 128  # node tile of the Pallas kernel at its entry
_EXP_LEVELS = 5  # levels the tail runs at most (entry_level)
# The deepest subtree one kernel thread walks (csrc/chacha_expand.cu::
# kMaxLevels); the JAX whole-tree route's deepest tree.
_EXP_SMALL_MAX_NU = 12
# Cap on padded-key lanes at the chunked route's entry level.
_MAX_PREFIX_LANES = 1 << 24


def fuse_auto_levels() -> int:
    """Group size of a fused-levels launch: the tail's depth, as in
    ``chacha_pallas.fuse_auto_levels``."""
    return _EXP_LEVELS


def small_tree_entry(nu: int):
    """Entry level of the whole-tree route (0) where the classic route
    cannot run (1 <= nu < 7), else None."""
    return 0 if 1 <= nu < 7 else None


def expand_plan(nu: int, k: int, max_leaf_nodes: int):
    """(eligible, entry_level, padded_k) of the one-shot kernel route.  The
    padded key count's leaves must fit under the cap."""
    kp = k + (-k) % _EKT
    fits = (kp << nu) <= max_leaf_nodes
    small = small_tree_entry(nu)
    if small is not None and fits:
        return True, small, kp
    eligible = kernel_usable(nu, kp) and fits
    return eligible, entry_level(nu), kp


def kernel_usable(nu: int, k: int) -> bool:
    """The classic route's entry must be >= 128 nodes wide, and the key
    count a multiple of the 8-key quantum."""
    return nu >= 7 and k % _EKT == 0


def entry_level(nu: int, floor: int = 7) -> int:
    """The tail's entry level: at most _EXP_LEVELS levels below it, never
    narrower than 2^floor nodes."""
    return max(floor, nu - _EXP_LEVELS)


def expand_plan_chunked(nu: int, k: int, max_leaf_nodes: int):
    """(eligible, entry_level, padded_k, n_chunks) of the chunked route:
    the tail runs over ``n_chunks`` node ranges of the entry state (each
    an independent set of subtrees)."""
    kp = k + (-k) % _EKT
    total = kp << nu
    n_chunks = -(-total // max_leaf_nodes)
    chunk_bits = max(0, (n_chunks - 1).bit_length())
    s = entry_level(nu, 7 + chunk_bits)
    if not kernel_usable(nu, kp) or s > nu or (kp << s) > _MAX_PREFIX_LANES:
        return False, s, kp, 0
    return True, s, kp, 1 << chunk_bits


# ---------------------------------------------------------------------------
# Plain versions (the torch level body of models/dpf_chacha.py)
# ---------------------------------------------------------------------------


def fused_levels_plain(state: torch.Tensor, scw: torch.Tensor,
                       tcw: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`fused_levels`: the ``_level_step_cc`` loop."""
    from ..models import dpf_chacha as m

    S, T = m._expand_levels_cc(list(state[:4]), state[4], scw, tcw)
    return torch.stack(S + [T])


def expand_tail_plain(state: torch.Tensor, scw: torch.Tensor, tcw: torch.Tensor,
                      fcw: torch.Tensor, out: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Plain version of :func:`expand_tail`: the ``_level_step_cc`` loop,
    then ``_convert_leaves_cc``."""
    from ..models import dpf_chacha as m

    S, T = m._expand_levels_cc(list(state[:4]), state[4], scw, tcw)
    leaves = m._convert_leaves_cc(S, T, [fcw[:, j] for j in range(16)])
    if out is None:
        return leaves
    out.copy_(leaves)
    return out


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(name: str, x: torch.Tensor, shape, inner: tuple[int, ...], dev) -> None:
    """Raise unless ``x`` is int32 on ``dev`` with ``shape`` (None: any) and
    its trailing strides equal ``inner`` (where a dimension has more than
    one element, of a tensor that has any: the kernels never step along the
    others)."""
    if x.device != dev:
        raise ValueError(f"{name}: expected a tensor on {dev}, got {x.device}")
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {x.dtype}")
    if x.dim() != len(shape) or any(
        want is not None and got != want for got, want in zip(x.shape, shape)
    ):
        raise ValueError(f"{name}: expected shape {list(shape)}, got {list(x.shape)}")
    tail = range(len(shape) - len(inner), len(shape))
    if x.numel() and any(
        x.shape[d] > 1 and x.stride(d) != want for d, want in zip(tail, inner)
    ):
        raise ValueError(f"{name}: strides {x.stride()} need trailing {inner}")


def _operands(state, scw, tcw):
    """Check the state and level CWs for a launch -> (K, W, levels)."""
    if state.device.type != "cuda":
        raise ValueError(f"expected a CUDA or CPU tensor, got {state.device}")
    dev = state.device
    _check("state", state, (5, None, None), (1,), dev)
    K, W = state.shape[1:]
    if K < 1 or W < 1:
        raise ValueError(f"state: expected [5, K >= 1, W >= 1], got {list(state.shape)}")
    levels = scw.shape[1] if scw.dim() == 3 else -1
    _check("scw", scw, (K, levels, 4), (4, 1), dev)
    _check("tcw", tcw, (K, levels, 2), (2, 1), dev)
    if levels > _EXP_SMALL_MAX_NU:
        raise ValueError(f"{levels} levels in one launch; the kernels take "
                         f"at most {_EXP_SMALL_MAX_NU}")
    return K, W, levels


def _launch(kernel: str, cfn, dev, *args) -> None:
    """Launch ``cfn`` on ``dev``'s current stream; raise on its error."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = cfn(*args, stream)
    if rc:
        msg = build.load("chacha_expand").dpf_chacha_error_string(rc).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} ({msg})")


def fused_levels(state: torch.Tensor, scw: torch.Tensor,
                 tcw: torch.Tensor) -> torch.Tensor:
    """G = ``scw.shape[1]`` GGM levels: state int32[5, K, W] ->
    int32[5, K, W << G], ascending node order.  Contract of
    ``deinterleave(dpf_tpu.ops.chacha_pallas.fused_levels_raw(...))``."""
    if state.device.type == "cpu":
        return fused_levels_plain(state, scw, tcw)
    K, W, levels = _operands(state, scw, tcw)
    out = torch.empty((5, K, W << levels), dtype=torch.int32, device=state.device)
    _launch(
        "fused_levels_kernel", build.load("chacha_expand").dpf_chacha_fused,
        state.device, state.data_ptr(), state.stride(0), state.stride(1), K, W,
        levels, scw.data_ptr(), scw.stride(0), tcw.data_ptr(), tcw.stride(0),
        out.data_ptr(), out.stride(0), out.stride(1),
    )
    fused_levels.launches += 1
    return out


fused_levels.launches = 0


def expand_tail(state: torch.Tensor, scw: torch.Tensor, tcw: torch.Tensor,
                fcw: torch.Tensor, out: torch.Tensor | None = None
                ) -> torch.Tensor:
    """L = ``scw.shape[1]`` GGM levels, then the leaf convert and final CW:
    state int32[5, K, W] -> leaf words int32[K, W << L, 16], ascending leaf
    order (written into ``out``, which may be a node-range view of a larger
    output, when given).  Contract of ``dpf_tpu.models.dpf_chacha._finish_pk``
    (``_expand_raw`` and its deinterleave)."""
    if state.device.type == "cpu":
        return expand_tail_plain(state, scw, tcw, fcw, out)
    K, W, levels = _operands(state, scw, tcw)
    _check("fcw", fcw, (K, 16), (1,), state.device)
    if out is None:
        out = torch.empty((K, W << levels, 16), dtype=torch.int32, device=state.device)
    _check("out", out, (K, W << levels, 16), (16, 1), state.device)
    if out.data_ptr() % 16 or out.stride(0) % 4:
        raise ValueError("out: leaf rows must be 16-byte aligned (whole 16-word rows)")
    _launch(
        "expand_tail_kernel", build.load("chacha_expand").dpf_chacha_tail,
        state.device, state.data_ptr(), state.stride(0), state.stride(1), K, W,
        levels, scw.data_ptr(), scw.stride(0), tcw.data_ptr(), tcw.stride(0),
        fcw.data_ptr(), fcw.stride(0), out.data_ptr(), out.stride(0),
    )
    expand_tail.launches += 1
    return out


expand_tail.launches = 0
