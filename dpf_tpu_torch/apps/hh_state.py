"""Frontier state on the card for the incremental heavy-hitter descent.

The port's counterpart of ``dpf_tpu/apps/hh_state.py``: its descent engine
and :func:`warm_ladder` (the serving session registry, ``SessionCache`` and
``serve_extend``, come with the port's sidecar).

The stateless driver (apps/heavy_hitters.py) re-walks every candidate from
the ROOT each round: a level-``l`` evaluation of G clients x Q candidates
costs ``G * Q * (nu + 1)`` PRG expansions (nu GGM levels plus the leaf
conversion) however deep the descent already is.  But the descent only ever
asks about CHILDREN of prefixes that already survived, and the GGM walk of
a client's level-``(n-1)`` key computes, at every tree node it visits, a
control bit that IS an XOR share of "does this client's value start with
this node's prefix".  This module caches that walk: the per-client seeds and
control bits at the current surviving frontier stay on the card between
rounds, and each round extends every cached parent ONE level (both children
in one launch: the compat profile's ``prg_canon_kernel``, the fast profile's
``fused_levels_kernel``) for ``G * parents`` PRG expansions.  Every
extension goes through the plan cache (``core/plans.run_hh_extend``), which
brings back only the round's packed rows.

Past the tree depth ``nu`` the cached seeds convert to leaf state ONCE
(``leaf_first``: the compat leaf MMO, or a 0-level ``expand_tail_kernel``
launch); deeper rounds are pure XOR folds over the resident leaf state
(``leaf_fold``, ZERO PRG evaluations).

The frontier cache is an OPTIMIZATION of a pure function: the share rows it
produces are exactly the rows a from-root walk of the same level-``(n-1)``
keys computes, bit for bit.  When the cache cannot serve a round
(:class:`StaleState`: ancestors pruned beyond recovery, or a descent that
does not deepen) the owner replants the frontier at the root
(:meth:`FrontierState.reset`) and replays the same extend pipeline, which is
byte-identical by construction.  A device failure is not such a case: it
propagates.  The frontier is pruned on the PUBLICLY reconstructed survivor
set, the same public output the stateless protocol reveals.

The plan buckets (``plans.q_bucket``) shape the column axis: the column
bucket ``cb`` only grows, and padding columns repeat column 0, as the
reference's ``_sel`` does.  They change shapes only; the rows emitted are
the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import bitpack, plans
from ..core.device import resolve_device

__all__ = [
    "StaleState",
    "PRG_EVALS",
    "FrontierState",
    "stateless_round_evals",
    "warm_ladder",
]


class StaleState(Exception):
    """The cached frontier cannot serve this round: rebuild from the root
    (byte-identical by construction; see the module docstring)."""


class _EvalCounter:
    """Process-wide PRG level-evaluation odometer (one unit = one PRG
    expansion or leaf conversion of one client's node).  Both the stateless
    from-root path and the incremental path report here, so a descent's
    cost ratio is a plain counter quotient."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def add(self, n: int) -> None:
        self.value += int(n)

    def reset(self) -> int:
        v, self.value = self.value, 0
        return v


PRG_EVALS = _EvalCounter()


def stateless_round_evals(nu: int, g: int, q: int) -> int:
    """PRG level-evals one from-root round costs one aggregator: every
    (client, candidate) pair walks ``nu`` GGM levels + one leaf conversion
    regardless of the requested level."""
    return int(g) * int(q) * (int(nu) + 1)


def _children(parents: np.ndarray) -> np.ndarray:
    """Sorted depth-(d+1) children of sorted depth-d prefixes, in the
    L,R-interleaved column order the level steps emit."""
    return (
        (parents[:, None] << np.uint64(1)) | np.arange(2, dtype=np.uint64)[None, :]
    ).reshape(-1)


class FrontierState:
    """One aggregator's descent frontier on ``device`` (None: the card) over
    a G-key level-``(n-1)`` sub-batch (``HHShare.level_keys(log_n - 1)``).

    At tree depth ``d <= nu`` the state is the UNPRUNED children of the last
    round's surviving parents: seeds and control bits for ``len(emitted)``
    columns (``emitted``: the sorted depth-``d`` prefixes they hold), padded
    to the bucket ``cb``.  Pruning is fused into the NEXT extension: the
    public survivor selector gathers only the surviving parent columns.
    Crossing depth ``nu`` converts the gathered seeds to leaf state once;
    from then on it is immutable and every round is a pure XOR fold
    addressed by a public gather index.

    Layouts: fast, the ``fused_levels`` state int32[5, K, cb] (rows 0..3
    the seed words, row 4 the control bit) and leaf words int32[K, A, 16];
    compat, bitsliced seed planes int32[128, cb, Kp] with key-packed control
    words int32[cb, Kp] (K padded to whole 32-key words) and leaf planes
    int32[128, A, Kp]."""

    def __init__(self, profile: str, kb, *, device=None):
        if profile not in ("fast", "compat"):
            raise ValueError(f"hh_state: unknown profile {profile!r}")
        self.profile = profile
        self.device = resolve_device(device)
        self.log_n = int(kb.log_n)
        self.g = int(kb.k)
        self.nu = int(kb.nu)
        self.ibits = self.log_n - self.nu
        if profile == "fast":
            from ..models.dpf_chacha import DeviceKeysFast

            self._dk = DeviceKeysFast(kb, self.device)
            self.kp = self.g
        else:
            from ..models import dpf

            self._dk = dpf._cached_device_keys(kb, self.device)
            self.kp = self._dk.k_padded
        self.reset()

    # -- lifecycle ---------------------------------------------------

    def reset(self) -> None:
        """(Re)plant the frontier at the root: depth 0, one real column (the
        key's root seed and t bit), bucket-padded by repetition.  The
        per-level correction operands are never written, so reset always
        recovers."""
        self.depth = 0
        self.cb = 32
        self.planes = None
        self.anc = None
        self.emitted = np.zeros(1, np.uint64)
        dk = self._dk
        if self.profile == "fast":
            self.seed_state = (dk.root_state().repeat(1, 1, self.cb),)
        else:
            self.seed_state = (dk.seed_planes.repeat(1, self.cb, 1),
                               dk.t_words.repeat(self.cb, 1))

    # -- round API ---------------------------------------------------

    def advance(self, cands: np.ndarray, depth: int) -> np.ndarray:
        """Extend the frontier to ``depth`` and return the packed
        prefix-predicate share rows uint32[G, ceil(Q/32)] for ``cands``
        (depth-``depth`` prefixes, any order, duplicates allowed), byte
        identical to a from-root evaluation of the same keys.

        Raises :class:`StaleState` when the cache cannot serve (the caller
        rebuilds via :meth:`reset` and retries: a root replant serves ANY
        depth).  Any other failure propagates."""
        cands = np.asarray(cands, dtype=np.uint64).reshape(-1)
        D = int(depth)
        if cands.size == 0 or not 0 < D <= self.log_n:
            raise ValueError("hh_state: bad candidate set or depth")
        if (cands >> np.uint64(D)).any():
            raise ValueError("hh_state: candidate exceeds its depth")
        if D <= self.depth and not (self.planes is not None and D > self.nu):
            raise StaleState("descent must deepen")
        return self._advance(cands, D)

    def _advance(self, cands: np.ndarray, D: int) -> np.ndarray:
        rows = None
        for di in range(self.depth + 1, min(D, self.nu) + 1):
            parents = np.unique(cands >> np.uint64(D - di + 1))
            sel, cbn = self._sel(parents)
            rows = self._tree_step(di, parents, sel, cbn)
        if D > self.nu:
            m = D - self.nu
            fresh_planes = self.planes is None
            if fresh_planes:
                anc = np.unique(cands >> np.uint64(m))
                sel, cbn = self._sel(anc)
                rows = self._leaf_first(anc, sel, cbn)
            if m > 1 or not fresh_planes:
                out = self._leaf_fold(cands, m)
                self.depth = D
                return out
        self.depth = D
        return self._gather(rows, cands)

    # -- internals ---------------------------------------------------

    def _index(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a.astype(np.int64)).to(self.device)

    def _sel(self, parents: np.ndarray):
        """Survivor selector: positions of ``parents`` in the emitted column
        order, padded to the (monotone) new bucket's parent width by
        repeating column 0 (a valid column; its garbage children are never
        gathered)."""
        pos = np.searchsorted(self.emitted, parents)
        if (pos >= self.emitted.size).any() or (
            self.emitted[np.minimum(pos, self.emitted.size - 1)] != parents
        ).any():
            raise StaleState("round ancestors not in cached frontier")
        cbn = max(self.cb, plans.q_bucket(2 * parents.size))
        sel = np.zeros(cbn // 2, np.int64)
        sel[: pos.size] = pos
        return self._index(sel), cbn

    def _extend(self, phase: str, args: tuple, cbn: int, m: int = 0):
        return plans.run_hh_extend(self.profile, self.log_n, self.kp, phase,
                                   self.seed_state, args, q=cbn, m=m, ibits=self.ibits,
                                   device=self.device)

    def _tree_step(self, di: int, parents, sel, cbn: int) -> np.ndarray:
        dk, lv = self._dk, di - 1
        if self.profile == "fast":
            level = (dk.scw[:, lv:lv + 1], dk.tcw[:, lv:lv + 1])
        else:
            level = (dk.scw_planes[lv], dk.tl_words[lv], dk.tr_words[lv])
        self.seed_state, rows = self._extend("tree", (sel, *level), cbn)
        PRG_EVALS.add(self.g * parents.size)
        self.emitted = _children(parents)
        self.depth = di
        self.cb = cbn
        return rows

    def _leaf_first(self, anc, sel, cbn: int) -> np.ndarray:
        dk = self._dk
        if self.profile == "fast":
            args = (sel, dk.scw[:, self.nu:], dk.tcw[:, self.nu:], dk.fcw)
        else:
            args = (sel, dk.fcw_planes)
        (planes,), rows = self._extend("leaf_first", args, cbn)
        PRG_EVALS.add(self.g * anc.size)
        self.planes = planes
        self.seed_state = (planes,)
        self.anc = anc
        self.emitted = _children(anc)
        self.cb = cbn
        return rows

    def _leaf_fold(self, cands: np.ndarray, m: int) -> np.ndarray:
        """Intra-leaf depths: a pure XOR fold over the resident leaf state,
        addressed per requested candidate: zero PRG evaluations, no column
        gather on the host (the index IS the request order)."""
        anc_pos = np.searchsorted(self.anc, cands >> np.uint64(m))
        if (anc_pos >= self.anc.size).any() or (
            self.anc[np.minimum(anc_pos, self.anc.size - 1)] != (cands >> np.uint64(m))
        ).any():
            raise StaleState("leaf ancestors not in converted planes")
        cbn = max(self.cb, plans.q_bucket(cands.size))
        idx = np.zeros(cbn, np.int64)
        idx[: cands.size] = (anc_pos.astype(np.int64) << m) | (
            cands & np.uint64((1 << m) - 1)).astype(np.int64)
        self.cb = cbn
        _, rows = self._extend("leaf_fold", (self._index(idx),), cbn, m)
        return bitpack.mask_tail(
            np.ascontiguousarray(rows[: self.g, : bitpack.packed_words(cands.size)]),
            cands.size,
        )

    def _gather(self, rows: np.ndarray, cands: np.ndarray) -> np.ndarray:
        """Re-pack the requested candidate columns (request order) out of
        the emitted column order of the last device rows."""
        pos = np.searchsorted(self.emitted, cands)
        if (pos >= self.emitted.size).any() or (
            self.emitted[np.minimum(pos, self.emitted.size - 1)] != cands
        ).any():
            raise StaleState("requested candidates not in emitted columns")
        bits = bitpack.unpack_bits(rows[: self.g], self.emitted.size)
        return bitpack.pack_bits(bits[:, pos])


def warm_ladder(profile: str, log_n: int, k: int, q: int, *, device=None) -> None:
    """Drive one synthetic maximal descent (every candidate survives until
    the ``q`` cap, one level a round) over a zero key batch dealt on
    ``device``: it visits the bucket ladder 32, 64, ..., ``q`` of every
    ``hh_extend`` phase (tree growth and steady state, the leaf crossing,
    every intra-leaf fold depth), the shapes a saturating session touches
    (``core/plans.warmup`` route ``hh_extend``)."""
    from . import heavy_hitters as hh

    gen, _, _ = hh._profile_api(profile)
    ka, _ = gen(np.zeros(max(int(k), 1), np.uint64), int(log_n),
                rng=np.random.default_rng(0), device=device)
    st = FrontierState(profile, ka, device=device)
    q = max(plans.q_bucket(max(int(q), 2)), 32)
    frontier = np.zeros(1, np.uint64)
    for d in range(1, int(log_n) + 1):
        cands = _children(frontier)
        st.advance(cands, d)
        frontier = cands
        if 2 * frontier.size > q:
            frontier = frontier[: q // 2]
