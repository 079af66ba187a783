"""Batched key generation on the card: the dealer.

The port's counterpart of ``dpf_tpu/models/keys_gen.py``.  Across a K-key
batch each of Gen's ``nu`` sequential tree levels is a K-wide PRG expansion,
so the correction-word tower runs on the card, K keys at once, for all three
key families:

  * ``fast`` -- the ChaCha12 tree (``core/keys_chacha.gen_batch``'s math)
    and ``dcf`` -- the same tree plus the per-level value CW
    (``models/dcf.gen_lt_batch``): the whole tower is ONE
    ``ops/chacha_cuda.gen_tower`` launch (kernel
    ``csrc/chacha_gen.cu::gen_tower_cc_kernel``, one key a thread, the seeds
    in registers across every level).  Its plain version is
    :func:`_gen_cc_body`, this module's torch loop of :func:`_level_gen_cc`.
  * ``compat`` -- fixed-key AES-128-MMO (``core/keys.gen_batch``) on
    bitsliced ``[128, K/32]`` planes: per level ONE
    ``aes_cuda.prg_planes_canon`` launch covers both parties (their planes
    side by side on the lane axis), the CW selects are plain torch ops on
    ``[128, W]``, and the final MMO is the L half of one more launch
    (:func:`_gen_compat_body`).

The CSPRNG boundary stays on the host: the callers draw the root seeds
exactly as the host towers do (``_draw_roots``: ``os.urandom`` or the given
rng, the same call order), because seed entropy is the only part of Gen that
needs a CSPRNG.  Given the same roots the tower is deterministic, so the
card's keys are byte-identical to the host tower's (``_gen_from_roots``).
Alpha's bits and the control bits are host-made operands; on the card every
per-level select is mask arithmetic (``msk = 0 - bit``), never a branch or a
secret index.

:func:`gen_device_cc` and :func:`gen_device_compat` run on ``device`` (None:
the card).  On the card they launch the kernels or raise; with
``device="cpu"`` they run the plain versions, which the CPU tests hold
against the JAX package.  Their ``kp`` pads the drawn roots with zero rows
to a plan's K bucket (the pad lanes tower keys that are sliced off).  The
``gen_batch`` entry points send a card request through the plan cache
(``core/plans.run_gen``, as the JAX package's do) and a CPU request to the
host numpy tower (cheaper there), and never fall back to it; :func:`warm`
warms one gen plan.  The JAX package's routing knob (``DPF_TPU_GEN``), its
fallback counter and ``host_only()`` have no counterpart here, nor its
donation and mesh sharding.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import chacha_np as cc
from ..core.device import resolve_device
from ..ops import aes_cuda, chacha_cuda
from ..ops.aes_bitslice import from_carrier, pack_blocks_np, to_carrier, unpack_planes
from . import dpf_chacha as _dc

# ---------------------------------------------------------------------------
# ChaCha tower (fast + DCF): 4x int32[K] seed-word lanes
# ---------------------------------------------------------------------------


def _level_gen_cc(s0w, s1w, t0, t1, bit, dcf):
    """One Gen level for both parties: expand, publish the level's CWs,
    descend alpha's KEEP child.  All selects are mask arithmetic on the
    secret alpha bit (``msk = 0 - bit``): no branches, no indexing.  Words
    are int32 carriers; ``t0``, ``t1`` and ``bit`` are 0/1."""
    if dcf:
        o0 = _dc._chacha_core(s0w, _dc._DSX, 9)
        o1 = _dc._chacha_core(s1w, _dc._DSX, 9)
        v0, v1 = o0[8], o1[8]
    else:
        o0 = _dc._chacha_core(s0w, _dc._DSX, 8)
        o1 = _dc._chacha_core(s1w, _dc._DSX, 8)
    l0, r0, l1, r1 = o0[0:4], o0[4:8], o1[0:4], o1[4:8]
    t0l, t0r = l0[0] & 1, r0[0] & 1
    t1l, t1r = l1[0] & 1, r1[0] & 1
    for half in (l0, r0, l1, r1):
        half[0] = half[0] & ~1

    msk = -bit  # all ones where alpha descends right
    # LOSE child = the one alpha does NOT descend into.
    scw = [((l0[i] ^ l1[i]) & msk) | ((r0[i] ^ r1[i]) & ~msk) for i in range(4)]
    tlcw = t0l ^ t1l ^ bit ^ 1
    trcw = t0r ^ t1r ^ bit
    vcw = ((v0 ^ v1 ^ bit) & 1) if dcf else None

    keep0 = [(r0[i] & msk) | (l0[i] & ~msk) for i in range(4)]
    keep1 = [(r1[i] & msk) | (l1[i] & ~msk) for i in range(4)]
    kt0 = (t0r & msk) | (t0l & ~msk)
    kt1 = (t1r & msk) | (t1l & ~msk)
    ktcw = (trcw & msk) | (tlcw & ~msk)

    tm0, tm1 = -t0, -t1
    ns0 = [keep0[i] ^ (scw[i] & tm0) for i in range(4)]
    ns1 = [keep1[i] ^ (scw[i] & tm1) for i in range(4)]
    nt0 = kt0 ^ (t0 & ktcw)
    nt1 = kt1 ^ (t1 & ktcw)
    return ns0, ns1, nt0, nt1, scw, tlcw, trcw, vcw


def _gen_cc_body(nu, dcf, s0, s1, t0, t1, bits):
    """The ChaCha tower, plain: cleared root seed words int32[K, 4] x2, root
    control bits int32[K] x2, alpha bits int32[nu, K] (level-major) ->
    (scw [nu, K, 4], tlcw / trcw [nu, K], fcw [K, 16][, vcw [nu, K]]), the
    JAX body's contract (``fcw`` before alpha's bit is set)."""
    K = s0.shape[0]
    s0w = [s0[:, i] for i in range(4)]
    s1w = [s1[:, i] for i in range(4)]
    scw_l, tl_l, tr_l, vcw_l = [], [], [], []
    for i in range(nu):
        s0w, s1w, t0, t1, scw, tl, tr, vcw = _level_gen_cc(s0w, s1w, t0, t1, bits[i], dcf)
        scw_l.append(torch.stack(scw, dim=-1))
        tl_l.append(tl)
        tr_l.append(tr)
        vcw_l.append(vcw)
    z = torch.zeros((0, K), dtype=torch.int32, device=s0.device)
    out = (
        torch.stack(scw_l) if nu else torch.zeros((0, K, 4), dtype=torch.int32,
                                                  device=s0.device),
        torch.stack(tl_l) if nu else z,
        torch.stack(tr_l) if nu else z,
        torch.stack([a ^ b for a, b in zip(_dc._convert(s0w), _dc._convert(s1w))], dim=-1),
    )
    if dcf:
        out += (torch.stack(vcw_l) if nu else z,)
    return out


# ---------------------------------------------------------------------------
# AES compat tower: bitsliced [128, K/32] planes per party
# ---------------------------------------------------------------------------


def _level_gen_compat(S0, S1, T0, T1, bm):
    """One compat Gen level on bitsliced planes, both parties in one
    ``prg_planes_canon`` call over ``[S0 | S1]``.  Plane row 0 is every
    key's byte-0 LSB (the control bit); clearing it zeroes the row, and the
    per-key ``^ 1`` of tlcw is a lane-wide complement."""
    W = S0.shape[1]
    L, R = aes_cuda.prg_planes_canon(torch.cat([S0, S1], dim=1))
    tl, tr = L[0].clone(), R[0].clone()
    L[0] = 0
    R[0] = 0
    L0, L1, R0, R1 = L[:, :W], L[:, W:], R[:, :W], R[:, W:]
    t0l, t1l, t0r, t1r = tl[:W], tl[W:], tr[:W], tr[W:]

    scw = ((L0 ^ L1) & bm) | ((R0 ^ R1) & ~bm)  # LOSE side
    tlcw = ~(t0l ^ t1l ^ bm)
    trcw = t0r ^ t1r ^ bm

    keep0 = (R0 & bm) | (L0 & ~bm)
    keep1 = (R1 & bm) | (L1 & ~bm)
    kt0 = (t0r & bm) | (t0l & ~bm)
    kt1 = (t1r & bm) | (t1l & ~bm)
    ktcw = (trcw & bm) | (tlcw & ~bm)
    S0 = keep0 ^ (scw & T0)
    S1 = keep1 ^ (scw & T1)
    T0 = kt0 ^ (T0 & ktcw)
    T1 = kt1 ^ (T1 & ktcw)
    return S0, S1, T0, T1, scw, tlcw, trcw


def _gen_compat_body(nu, S0, S1, T0, T1, BM):
    """The compat tower on bitsliced planes: cleared root seed planes
    int32[128, W] x2 (32 keys a lane word), root control-bit lane words
    int32[W] x2, alpha-bit lane masks int32[nu, W] -> (scw int32[32 W, nu,
    4] per-key words, tlcw / trcw int32[nu, W] lane words, fcw int32[32 W,
    4]), the JAX body's contract.  Each PRG is one ``prg_canon_kernel``
    launch on the card (its plain version on the CPU)."""
    W = S0.shape[1]
    scw_l, tl_l, tr_l = [], [], []
    for i in range(nu):
        S0, S1, T0, T1, scw, tl, tr = _level_gen_compat(S0, S1, T0, T1, BM[i])
        scw_l.append(scw)
        tl_l.append(tl)
        tr_l.append(tr)
    C = aes_cuda.prg_planes_canon(torch.cat([S0, S1], dim=1))[0]  # the leaf MMO: L half
    fcw = unpack_planes((C[:, :W] ^ C[:, W:])[:, None, :])[:, 0, :]
    if not nu:
        z = torch.zeros((0, W), dtype=torch.int32, device=S0.device)
        return torch.zeros((W * 32, 0, 4), dtype=torch.int32, device=S0.device), z, z, fcw
    # [128, nu, W] -> per-key words [K, nu, 4] on the device.
    scw_words = unpack_planes(torch.stack(scw_l, dim=1))
    return scw_words, torch.stack(tl_l), torch.stack(tr_l), fcw


# ---------------------------------------------------------------------------
# Host-side operand prep + output marshalling
# ---------------------------------------------------------------------------


def _alpha_bits(alphas: np.ndarray, log_n: int, nu: int) -> np.ndarray:
    """Level-major alpha path bits uint32[nu, K] (a secret-derived host
    operand: the dealer knows alpha)."""
    shifts = np.uint64(log_n) - 1 - np.arange(nu, dtype=np.uint64)
    return ((alphas[None, :] >> shifts[:, None]) & np.uint64(1)).astype(np.uint32)


def _pack_lane_bits(bits: np.ndarray, w: int) -> np.ndarray:
    """0/1 rows [..., K] -> lane words uint32[..., w] (key k at word k//32
    bit k%32: the aes_bitslice plane lane order)."""
    k = bits.shape[-1]
    padded = np.zeros(bits.shape[:-1] + (w * 32,), np.uint32)
    padded[..., :k] = bits
    padded = padded.reshape(bits.shape[:-1] + (w, 32))
    return (padded << np.arange(32, dtype=np.uint32)).sum(-1, dtype=np.uint32)


def _unpack_lane_bits(words: np.ndarray, k: int) -> np.ndarray:
    """Inverse of :func:`_pack_lane_bits`: uint32[..., W] -> uint8[..., k]."""
    bits = (words[..., :, None] >> np.arange(32, dtype=np.uint32)) & np.uint32(1)
    flat = words.shape[:-1] + (words.shape[-1] * 32,)
    return bits.reshape(flat)[..., :k].astype(np.uint8)


def _fast_low(alphas: np.ndarray, log_n: int) -> np.ndarray:
    """Alpha's bit index inside its 512-bit leaf."""
    if log_n >= cc.LEAF_LOG:
        return alphas & np.uint64(cc.LEAF_BITS - 1)
    return alphas


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """Zero-pad axis 0 to ``n`` rows (``dpf_tpu``'s ``keys_gen._pad_rows``)."""
    if a.shape[0] >= n:
        return a
    return np.concatenate([a, np.zeros((n - a.shape[0],) + a.shape[1:], a.dtype)])


def gen_device_cc(kind: str, alphas: np.ndarray, log_n: int, s0: np.ndarray,
                  t0: np.ndarray, s1: np.ndarray, t1: np.ndarray, kp: int = 0, *,
                  device=None):
    """ChaCha-tree Gen (``kind`` ``"fast"`` or ``"dcf"``) on ``device`` (None:
    the card): drawn roots (uint32[K, 4] seeds, uint8[K] control bits) ->
    (key_a, key_b), byte-identical to the host tower on the same roots.  On
    the card the tower is one ``gen_tower`` launch over ``max(K, kp)`` lanes
    (zero roots past K); the roots go up and the CWs come down once each."""
    if kind not in ("fast", "dcf"):
        raise ValueError(f"gen: unknown kind {kind!r} (fast|dcf)")
    dev = resolve_device(device)
    K = alphas.shape[0]
    nu = cc.nu_of(log_n)
    dcf = kind == "dcf"
    bits = _pad_rows(_alpha_bits(alphas, log_n, nu).T, kp).T
    args = (s0, s1, t0.astype(np.uint32), t1.astype(np.uint32))
    out = chacha_cuda.gen_tower(
        *(to_carrier(_pad_rows(np.ascontiguousarray(a), kp), dev) for a in args),
        to_carrier(np.ascontiguousarray(bits), dev), dcf)
    scw = from_carrier(out[0][:, :K].transpose(0, 1).contiguous())  # [K, nu, 4]
    tcw = from_carrier(torch.stack([out[1][:, :K].T, out[2][:, :K].T], dim=2)).astype(np.uint8)
    conv_diff = from_carrier(out[3][:K]).copy()
    low = _fast_low(alphas, log_n)
    if dcf:
        from . import dcf as dcf_mod

        fvcw = conv_diff ^ dcf_mod._lt_leaf_mask(low)
        vcw = from_carrier(out[4][:, :K].T.contiguous()).astype(np.uint8)

        def mk(root, rt):
            return dcf_mod.DcfKeyBatch(log_n, root, rt, scw.copy(), tcw.copy(),
                                       vcw.copy(), fvcw)

        return mk(s0, t0), mk(s1, t1)
    from ..core.keys_chacha import KeyBatchFast

    low_i = low.astype(np.int64)
    conv_diff[np.arange(K), low_i >> 5] ^= np.uint32(1) << (low_i & 31).astype(np.uint32)

    def mk(root, rt):
        return KeyBatchFast(log_n, root, rt, scw.copy(), tcw.copy(), conv_diff)

    return mk(s0, t0), mk(s1, t1)


def gen_device_compat(alphas: np.ndarray, log_n: int, s0: np.ndarray, t0: np.ndarray,
                      s1: np.ndarray, t1: np.ndarray, kp: int = 0, *, device=None):
    """AES-compat Gen on bitsliced planes on ``device`` (None: the card):
    drawn roots (uint8[K, 16] seeds, uint8[K] control bits) -> (key_a,
    key_b), byte-identical to the host tower on the same roots.  ``max(K,
    kp)`` pads to whole 32-key lane words (the pad lanes tower garbage keys
    that are sliced off; the roots are drawn for the actual K, as the rng
    order is part of the byte-identity contract)."""
    from ..core.keys import KeyBatch

    dev = resolve_device(device)
    K = alphas.shape[0]
    nu = max(log_n - 7, 0)
    if K == 0:  # no keys: nothing to launch
        return tuple(
            KeyBatch(log_n, root.view("<u4"), rt, np.zeros((0, nu, 4), np.uint32),
                     np.zeros((0, nu, 2), np.uint8), np.zeros((0, 4), "<u4"))
            for root, rt in ((s0, t0), (s1, t1)))
    w = -(-max(K, kp) // 32)
    bm = _pack_lane_bits(_alpha_bits(alphas, log_n, nu), w)
    t0_w = _pack_lane_bits(t0.astype(np.uint32), w)
    args = (pack_blocks_np(_pad_rows(s0, 32 * w)), pack_blocks_np(_pad_rows(s1, 32 * w)),
            t0_w, t0_w ^ np.uint32(0xFFFFFFFF), bm)
    scw_d, tl_d, tr_d, fcw_d = _gen_compat_body(nu, *(to_carrier(a, dev) for a in args))

    scw = np.ascontiguousarray(from_carrier(scw_d)[:K])
    tcw = np.stack([_unpack_lane_bits(from_carrier(tl_d), K).T,
                    _unpack_lane_bits(from_carrier(tr_d), K).T], axis=2)
    fcw = from_carrier(fcw_d)[:K].copy().view(np.uint8).reshape(K, 16)
    low = (alphas & np.uint64(127)).astype(np.int64)
    fcw[np.arange(K), low // 8] ^= (1 << (low % 8)).astype(np.uint8)
    fcw = fcw.view("<u4")

    def mk(root, rt):
        return KeyBatch(log_n, root.view("<u4"), rt, scw.copy(), tcw.copy(), fcw)

    return mk(s0, t0), mk(s1, t1)


def warm(kind: str, log_n: int, k: int, rng, *, device=None) -> None:
    """Warm the gen plan of one (kind, log_n, K bucket): draw roots the way
    the host gen draws them and run the card route once
    (``dpf_tpu.models.keys_gen.warm``)."""
    from ..core import plans

    alphas = np.zeros(k, np.uint64)
    if kind == "compat":
        from ..core.keys import _draw_roots
    elif kind in ("fast", "dcf"):
        from ..core.keys_chacha import _draw_roots
    else:
        raise ValueError(f"gen: unknown kind {kind!r} (compat|fast|dcf)")
    s0, t0, s1, t1 = _draw_roots(k, rng)
    plans.run_gen(kind, alphas, log_n, s0, t0, s1, t1, device=device)
