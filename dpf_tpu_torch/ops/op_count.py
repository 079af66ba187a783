"""How many instructions the kernels' work takes.

The fast profile's count (ChaCha12, :func:`chacha_instructions`) is at the
end of this module, and each profile's pointwise walk is counted from its
ciphers (:func:`walk_lop3_per_column`, :func:`walk_chacha_ops`,
:func:`walk_dcf_ops`); the compat leaf kernels add their epilogue to the
MMO's count (:data:`LEAF_EPILOGUE`, :func:`leaf_words_per_column`).  The
rest counts the compat profile's AES-MMO:

``chip_smoke.py`` divides this count by the card's logic-instruction issue
rate to get each kernel's operation bound.  It is counted, not estimated by
hand:

1. :func:`trace_mmo` runs AES-128-MMO on symbols and records the circuit as a
   DAG of two-input XOR and AND gates.  It uses the cheapest circuits at hand:
   the Boyar-Peralta S-box of ``sbox_circuit`` and MixColumns as
   ``out_r = a_r ^ t ^ xtime(a_r ^ a_{r+1})`` with ``t`` the column's XOR.
   NOTs and the round keys' all-zero/all-one masks become edge polarities,
   which cost nothing: every Hopper logic instruction (``LOP3``) inverts its
   inputs for free.  Equal gates are merged, so the PRG's two keys share
   their first S-box layer.
2. :func:`lop3_cover` counts the ``LOP3`` instructions of a cover of that
   DAG, and :func:`lop3_program` lists them (the PRG kernels run the lists
   of the S-box with round-key masks on its outputs,
   :func:`masked_sbox_circuit`, and of MixColumns, :func:`mix_column_circuit`,
   generated into ``csrc/sbox_bp113.cuh``).  Every value used more than
   once, or stored, is one instruction's output; between them each
   fan-out-free cone is split into pieces of at most three inputs, with XOR
   chains regrouped freely.  The cover is a count that a kernel can reach,
   not a proven minimum: a better circuit or cover would lower it.

:func:`evaluate` runs the DAG on numbers, which is how the tests check that
the counted circuit computes the kernels' function.
"""

from __future__ import annotations

import functools
import itertools
from collections import Counter

import numpy as np

from .aes_bitslice import RK_MASKS_L, RK_MASKS_R, _SHIFT_PLANES
from .sbox_circuit import sbox_bp113

_INPUT, _XOR, _AND = "in", "^", "&"


class _Dag:
    """Gates ``(op, a, b)`` on node ids; inputs are ``("in", index, None)``.
    Structural hashing merges equal gates."""

    def __init__(self):
        self.nodes: list[tuple] = []
        self._index: dict[tuple, int] = {}

    def node(self, key: tuple) -> int:
        if key not in self._index:
            self._index[key] = len(self.nodes)
            self.nodes.append(key)
        return self._index[key]


class _Sig:
    """A symbolic 32-bit value: node ``n`` of ``dag``, inverted if ``inv``."""

    def __init__(self, dag: _Dag, n: int, inv: bool = False):
        self.dag, self.n, self.inv = dag, n, inv

    def __invert__(self) -> "_Sig":
        return _Sig(self.dag, self.n, not self.inv)

    def __xor__(self, other: "_Sig") -> "_Sig":
        a, b = sorted((self.n, other.n))
        return _Sig(self.dag, self.dag.node((_XOR, a, b)), self.inv ^ other.inv)

    def __and__(self, other: "_Sig") -> "_Sig":
        a, b = sorted(((self.n, self.inv), (other.n, other.inv)))
        return _Sig(self.dag, self.dag.node((_AND, a, b)))

    def __or__(self, other: "_Sig") -> "_Sig":
        return ~(~self & ~other)


def _xtime(a: list[_Sig]) -> list[_Sig]:
    """Doubling in GF(2^8) on 8 LSB-first bits (reduction polynomial 0x11B)."""
    return [a[7]] + [a[k - 1] ^ a[7] if k in (1, 3, 4) else a[k - 1] for k in range(1, 8)]


def _mix_column(col: list[list[_Sig]]) -> list[list[_Sig]]:
    """MixColumns on one column's 4 bytes: 2 a_r + 3 a_{r+1} + a_{r+2} + a_{r+3}."""
    t = [col[0][k] ^ col[1][k] ^ col[2][k] ^ col[3][k] for k in range(8)]
    out = []
    for r in range(4):
        d = _xtime([col[r][k] ^ col[(r + 1) % 4][k] for k in range(8)])
        out.append([col[r][k] ^ t[k] ^ d[k] for k in range(8)])
    return out


def _encrypt(dag: _Dag, S: list[_Sig], rk_masks: np.ndarray) -> list[_Sig]:
    """AES-128 on canonical planes p = 8 * byte + bit with constant round keys."""

    def xor_round_key(s, rnd):
        return [~x if rk_masks[rnd, p] else x for p, x in enumerate(s)]

    s = xor_round_key(S, 0)
    for rnd in range(1, 11):
        for b in range(16):
            y = sbox_bp113([s[8 * b + 7 - i] for i in range(8)])  # MSB-first
            s[8 * b : 8 * b + 8] = y[::-1]
        s = [s[int(q)] for q in _SHIFT_PLANES]
        if rnd < 10:
            s = [x for c in range(4) for byte in _mix_column(
                [s[8 * (4 * c + r) : 8 * (4 * c + r) + 8] for r in range(4)]
            ) for x in byte]
        s = xor_round_key(s, rnd)
    return s


def trace_mmo(rk_sets: tuple[np.ndarray, ...]) -> tuple[_Dag, list[_Sig]]:
    """``AES_k(S) ^ S`` for each round-key mask set in ``rk_sets``, on one
    DAG over the 128 canonical input planes -> (DAG, outputs in key order)."""
    dag = _Dag()
    S = [_Sig(dag, dag.node((_INPUT, p, None))) for p in range(128)]
    outs = []
    for rk in rk_sets:
        outs += [e ^ x for e, x in zip(_encrypt(dag, list(S), rk), S)]
    return dag, outs


def evaluate(dag: _Dag, outs: list[_Sig], planes: np.ndarray) -> np.ndarray:
    """Run the DAG on uint32[128, B] canonical planes -> uint32[len(outs), B]."""
    ones = np.uint32(0xFFFFFFFF)
    val: list[np.ndarray] = []
    for op, a, b in dag.nodes:
        if op == _INPUT:
            val.append(planes[a])
        elif op == _XOR:
            val.append(val[a] ^ val[b])
        else:
            (na, ia), (nb, ib) = a, b
            val.append((val[na] ^ (ones * ia)) & (val[nb] ^ (ones * ib)))
    return np.stack([val[o.n] ^ (ones * o.inv) for o in outs])


def two_input_gates(dag: _Dag) -> int:
    """XOR and AND gates of the DAG (NOTs and constant masks are free)."""
    return sum(op != _INPUT for op, _, _ in dag.nodes)


def _operands(key: tuple) -> tuple[int, int]:
    op, a, b = key
    return (a[0], b[0]) if op == _AND else (a, b)


class _Fn:
    """A function of at most three leaves (node ids, or ids of values an
    earlier instruction made): ``tt`` bit ``i`` is its value where leaf
    ``leaves[k]`` is bit ``k`` of ``i``."""

    __slots__ = ("leaves", "tt")

    def __init__(self, leaves: tuple, tt: int):
        self.leaves, self.tt = leaves, tt

    @staticmethod
    def leaf(n: int, inv: bool = False) -> "_Fn":
        return _Fn((n,), 0b01 if inv else 0b10)

    def at(self, env: dict) -> int:
        return (self.tt >> sum(env[x] << k for k, x in enumerate(self.leaves))) & 1

    @staticmethod
    def combine(op: str, fns: list) -> "_Fn":
        leaves = tuple(sorted(frozenset().union(*(f.leaves for f in fns))))
        tt = 0
        for i in range(1 << len(leaves)):
            env = {x: (i >> k) & 1 for k, x in enumerate(leaves)}
            vals = [f.at(env) for f in fns]
            v = functools.reduce(lambda u, w: u ^ w, vals) if op == _XOR else min(vals)
            tt |= v << i
        return _Fn(leaves, tt)

    def lut(self) -> int:
        """The LOP3 immediate with leaves[0], [1], [2] as operands a, b, c."""
        imm = 0
        for a, b, c in itertools.product((0, 1), repeat=3):
            env = dict(zip(self.leaves, (a, b, c)))
            imm |= self.at(env) << (4 * a + 2 * b + c)
        return imm


def _cover(dag: _Dag, outs: list[_Sig], program: list | None = None) -> int:
    """LOP3 count of the cover of :func:`lop3_cover`; with ``program``, also
    append its instructions ``(dst, (a, b, c), immediate)`` in an order that
    computes each before its use (dst and operands are node ids, or ids from
    ``len(dag.nodes)`` up for values an instruction made on the way).  An
    output's inversion folds into the instruction that makes it."""
    fanout = Counter(o.n for o in outs)
    for key in dag.nodes:
        if key[0] != _INPUT:
            fanout.update(_operands(key))
    kept = {n for n, key in enumerate(dag.nodes)
            if key[0] == _INPUT or fanout[n] != 1} | {o.n for o in outs}
    fresh = itertools.count(len(dag.nodes))
    inv_out = {o.n: o.inv for o in outs}

    def emit(dst: int, fn: _Fn, invert: bool = False) -> None:
        if program is not None:
            ops = fn.leaves + (fn.leaves[0],) * (3 - len(fn.leaves))
            program.append((dst, ops, fn.lut() ^ (0xFF if invert else 0)))

    def reduce(op: str, items: list) -> tuple[list, int]:
        """Merge items until they take at most three leaves: each step
        spends one instruction on the group of items that takes the most
        leaves (at most three) and leaves one new leaf."""
        cost = 0
        while len(frozenset().union(*(f.leaves for f in items))) > 3:
            best = max(
                (g for r in (1, 2, 3) for g in itertools.combinations(range(len(items)), r)
                 if len(frozenset().union(*(items[i].leaves for i in g))) <= 3
                 and (r > 1 or len(items[g[0]].leaves) > 1)),
                key=lambda g: (len(frozenset().union(*(items[i].leaves for i in g))), len(g)),
            )
            t = next(fresh)
            emit(t, _Fn.combine(op, [items[i] for i in best]))
            items = [x for i, x in enumerate(items) if i not in best] + [_Fn.leaf(t)]
            cost += 1
        return items, cost

    def cone(n: int) -> tuple[_Fn, int]:
        """The cone below node n as a function of at most three leaves, left
        open for its consumer to absorb, and its instructions."""
        op = dag.nodes[n][0]
        if op == _XOR:
            parity: Counter = Counter()
            stack = [n]
            while stack:  # flatten XOR chains whose inner values are used once
                for c in _operands(dag.nodes[stack.pop()]):
                    if dag.nodes[c][0] == _XOR and c not in kept:
                        stack.append(c)
                    else:
                        parity[c] ^= 1
            operands = [(c, False) for c, odd in parity.items() if odd]
        else:
            operands = list(dict.fromkeys(dag.nodes[n][1:]))
        items, cost = [], 0
        for c, inv in operands:
            if c in kept:
                items.append(_Fn.leaf(c, inv))
            else:
                f, k = cone(c)
                items.append(_Fn(f.leaves, f.tt ^ ((1 << (1 << len(f.leaves))) - 1))
                             if inv else f)
                cost += k
        items, k = reduce(op, items)
        return _Fn.combine(op, items), cost + k

    total = 0
    for n in sorted(kept):
        if dag.nodes[n][0] == _INPUT:
            continue
        f, cost = cone(n)
        if len(f.leaves) > 1:
            emit(n, f, inv_out.get(n, False))
            cost += 1
        else:  # one leaf: reduce()'s output, or a copy
            if f.tt != 0b10 or inv_out.get(n, False):
                raise ValueError(f"node {n} is a copy with an inversion")
            if program is not None:
                program.append((n, (f.leaves[0],) * 3, 0xF0))
        total += cost
    return total


def lop3_cover(dag: _Dag, outs: list[_Sig]) -> int:
    """``LOP3`` instructions (any function of three inputs) of a cover of
    the DAG that computes ``outs``."""
    return _cover(dag, outs)


def lop3_program(dag: _Dag, outs: list[_Sig]) -> list[tuple]:
    """The instructions of :func:`lop3_cover`'s cover, as ``(dst, (a, b,
    c), immediate)``; a copy (a node whose cone is one earlier value) is
    ``(dst, (a, a, a), 0xF0)`` and is not counted."""
    program: list = []
    _cover(dag, outs, program)
    return program


def masked_sbox_circuit() -> tuple[_Dag, list[_Sig]]:
    """The S-box with a mask XORed into each output, on inputs 0-7 (x,
    MSB-first) and 8-15 (the masks): the PRG kernels' SubBytes
    (csrc/aes_bm.cuh::sub_bytes_masked)."""
    dag = _Dag()
    v = [_Sig(dag, dag.node((_INPUT, i, None))) for i in range(16)]
    return dag, [y ^ m for y, m in zip(sbox_bp113(v[:8]), v[8:])]


def mix_column_circuit() -> tuple[_Dag, list[_Sig]]:
    """MixColumns of one column in the counted form (:func:`_mix_column`) on
    inputs 8 * row + bit, outputs in the same order."""
    dag = _Dag()
    col = [[_Sig(dag, dag.node((_INPUT, 8 * r + k, None))) for k in range(8)]
           for r in range(4)]
    return dag, [x for byte in _mix_column(col) for x in byte]


@functools.cache
def lop3_per_column(n_keys: int) -> int:
    """``LOP3`` instructions of ``n_keys`` fixed-key MMOs of one column word
    (32 blocks): 2 for the PRG (keys L and R), 1 for the leaf MMO (L)."""
    dag, outs = trace_mmo((RK_MASKS_L, RK_MASKS_R)[:n_keys])
    return lop3_cover(dag, outs)


# The leaf kernels' epilogue on one column word (csrc/aes_mmo.cu::leaf_store):
# the final CW under t, one LOP3 a plane (x ^ (f & t)) beside the MMO's own
# feed-forward, and four 32x32 bit transposes (transpose32), each 16 pairs
# of rows at each of five stages: two PRMT a pair at the 16- and 8-bit
# stages, two SHF and two LOP3 a pair at the 4-, 2- and 1-bit stages.
LEAF_EPILOGUE = Counter(LOP3=128 + 4 * 3 * 16 * 2, PRMT=4 * 2 * 16 * 2, SHF=4 * 3 * 16 * 2)


def leaf_words_per_column() -> int:
    """Instructions of the leaf convert on one column word (32 keys at one
    leaf): the MMO with key L (:func:`lop3_per_column`) and
    :data:`LEAF_EPILOGUE`, all on the integer pipe at the LOP3 rate."""
    return lop3_per_column(1) + sum(LEAF_EPILOGUE.values())


def fused_prg_columns(entry_columns: int, levels: int) -> int:
    """PRG column words of ``levels`` GGM levels grown from
    ``entry_columns`` column words (each level doubles them): the tree's
    work, which bounds csrc/aes_fused.cu's launches however they walk it.
    The plane order does not change a count: the canonical kernels and the
    interleaved PRG run the same circuit as the bit-major ones."""
    return entry_columns * ((1 << levels) - 1)


def walk_lop3_per_column(nu: int) -> int:
    """``LOP3`` instructions of the compat walk's ciphers on one column word
    (32 queries of one key, csrc/aes_walk.cu): a PRG (both MMOs) per level
    and the leaf MMO.  The CW, path-select and bit-select work around them
    (about 4 instructions per plane and level) is not counted, so the bound
    stays a least time."""
    return nu * lop3_per_column(2) + lop3_per_column(1)


# ---------------------------------------------------------------------------
# ChaCha12 (the fast profile's kernels, csrc/chacha_expand.cu)
# ---------------------------------------------------------------------------

CHACHA_DOUBLE_ROUNDS = 6  # ChaCha12 (core/chacha_np.ROUNDS // 2)
CHACHA_QUARTER_ROUNDS = 8 * CHACHA_DOUBLE_ROUNDS
# One quarter round: 4 adds (IADD3), 4 xors (LOP3), 4 rotates (SHF, a funnel
# shift; in torch each rotate is a shift, a masked shift and an OR).
QUARTER_ROUND = Counter(IADD=4, LOP3=4, SHF=4)
# The level step's work around its core: 2 control-bit extracts and 2 clears
# (LOP3), the mask 0 - t (IADD), 8 seed-CW and 2 t-CW XORs each under the
# mask (one LOP3 each: a ^ (b & m)).
LEVEL_STEP_EXTRA = Counter(LOP3=2 + 2 + 8 + 2, IADD=1)
# The leaf convert's: the mask (IADD) and 16 final-CW XORs under it (LOP3).
LEAF_EXTRA = Counter(LOP3=16, IADD=1)


# The fast profile's counter words (state words 12..15) are zero.
CHACHA_ZERO_WORDS = range(12, 16)


def chacha_core_ops(n_out: int) -> Counter:
    """Instructions of one ChaCha12 block with the feed-forward on its first
    ``n_out`` words, by kind.  An operation with a zero word as an operand
    is a copy and is not counted: the first column round's XOR of each
    counter word and the counter words' feed-forward adds.  Adds of the
    nonzero constants are counted."""
    ops = Counter()
    for kind, n in QUARTER_ROUND.items():
        ops[kind] = n * CHACHA_QUARTER_ROUNDS
    ops["LOP3"] -= len(CHACHA_ZERO_WORDS)
    ops["IADD"] += sum(i not in CHACHA_ZERO_WORDS for i in range(n_out))
    return ops


def chacha_ops(kind: str) -> Counter:
    """Instructions by kind of one GGM expansion (``"expand"``: the core
    with 8 output words and the level step's CW work) or one leaf convert
    (``"leaf"``: 16 output words and the final CW)."""
    if kind == "expand":
        return chacha_core_ops(8) + LEVEL_STEP_EXTRA
    if kind == "leaf":
        return chacha_core_ops(16) + LEAF_EXTRA
    raise ValueError(f"kind must be expand or leaf, got {kind!r}")


def chacha_instructions(kind: str) -> int:
    """All instructions of :func:`chacha_ops`: 595 per expansion, 601 per
    leaf convert."""
    return sum(chacha_ops(kind).values())


def walk_chacha_ops(nu: int) -> Counter:
    """Instructions by kind of the fast walk's ciphers for one (query, key)
    lane (csrc/chacha_walk.cu): an expansion block (8 output words) per level
    and the leaf block (16).  The CW and path-select work around them is not
    counted: the walk needs only the chosen child's words."""
    ops = Counter()
    for kind, n in chacha_core_ops(8).items():
        ops[kind] = nu * n
    return ops + chacha_core_ops(16)


def walk_dcf_ops(nu: int) -> Counter:
    """Instructions by kind of the DCF walk's ciphers for one (query, key)
    lane (csrc/chacha_walk.cu::walk_dcf_kernel): an expansion block that
    feeds forward 9 words (the children and the value word; one IADD more
    than the walk's 8) per level and the leaf block (16).  Counted as
    :func:`walk_chacha_ops`: the CW, accumulator and path-select work around
    the ciphers is not."""
    ops = Counter()
    for kind, n in chacha_core_ops(9).items():
        ops[kind] = nu * n
    return ops + chacha_core_ops(16)


def gen_tower_ops(nu: int, dcf: bool) -> Counter:
    """Instructions by kind of the dealer's ciphers for one key
    (csrc/chacha_gen.cu::gen_tower_cc_kernel): both parties' expansion
    blocks per level (8 output words; 9 with the DCF's value word) and both
    leaf blocks (16).  Counted as :func:`walk_chacha_ops`: the CW selects
    around the ciphers are not."""
    ops = Counter()
    for kind, n in chacha_core_ops(9 if dcf else 8).items():
        ops[kind] = 2 * nu * n
    for kind, n in chacha_core_ops(16).items():
        ops[kind] += 2 * n
    return ops
