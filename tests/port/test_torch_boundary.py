"""The port's boundaries: no JAX and nothing of dpf_tpu inside it, the card
by default with no quiet fallback to the CPU, and a generated S-box header
that is up to date.
"""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from collections import Counter  # noqa: E402

from torch.overrides import TorchFunctionMode  # noqa: E402

import chip_smoke  # noqa: E402
import dpf_tpu_torch as port  # noqa: E402
from dpf_tpu_torch import fast  # noqa: E402
from dpf_tpu_torch.models import dpf as port_dpf  # noqa: E402
from dpf_tpu_torch.models import dpf_chacha as port_dc  # noqa: E402
from dpf_tpu_torch.ops import aes_cuda, build, chacha_cuda, gen_sbox, op_count  # noqa: E402
from dpf_tpu_torch.ops.aes_bitslice import from_carrier, prg_planes, to_carrier  # noqa: E402
from dpf_tpu_torch.ops.sbox_circuit import sbox_bp113  # noqa: E402
from test_golden_vectors import VECTORS  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
PORT_FILES = sorted((ROOT / "dpf_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "time_chacha_split.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "dpf_tpu")


def test_import_loads_no_jax_and_no_dpf_tpu():
    code = (
        "import sys\n"
        "import chip_smoke, dpf_tpu_torch, dpf_tpu_torch.interop\n"
        "import dpf_tpu_torch.ops.aes_cuda, dpf_tpu_torch.ops.build\n"
        "import dpf_tpu_torch.ops.gen_sbox, dpf_tpu_torch.ops.op_count, dpf_tpu_torch.models.dpf\n"
        "import dpf_tpu_torch.fast, dpf_tpu_torch.models.dpf_chacha, dpf_tpu_torch.ops.chacha_cuda\n"
        "import dpf_tpu_torch.core.chacha_np, dpf_tpu_torch.core.keys_chacha\n"
        "import dpf_tpu_torch.core.bitpack, dpf_tpu_torch.models.dcf, dpf_tpu_torch.models.fss\n"
        "import dpf_tpu_torch.core.stream, dpf_tpu_torch.models.pir\n"
        "import dpf_tpu_torch.models.keys_gen, dpf_tpu_torch.models.hh_fold\n"
        "import dpf_tpu_torch.apps, dpf_tpu_torch.apps.heavy_hitters\n"
        "import dpf_tpu_torch.apps.hh_state, dpf_tpu_torch.apps.aggregation\n"
        "import dpf_tpu_torch.core.knobs, dpf_tpu_torch.core.plans\n"
        "import dpf_tpu_torch.apps.pir_store\n"
        "dpf_tpu_torch.fss\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'dpf_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax_and_no_dpf_tpu(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_eval_full_batch_without_cuda_raises_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ka, _ = port.gen_batch([5, 9], 8, np.random.default_rng(0), device="cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port.eval_full_batch(ka)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port.EvalFull(ka.to_bytes()[0], 8)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port_dpf.DeviceKeys(ka)
    assert port.eval_full_batch(ka, device="cpu").shape == (2, 32)


@pytest.mark.parametrize("wrapper", ["prg_planes_bm", "convert_leaves_bm"])
def test_wrappers_take_only_cpu_or_cuda_tensors(wrapper):
    fn = getattr(aes_cuda, wrapper)
    before = fn.launches
    shapes = [(128, 32)] if wrapper == "prg_planes_bm" else [(128, 4, 2), (4, 2), (128, 1, 2)]
    with pytest.raises(ValueError):
        fn(*(torch.empty(s, dtype=torch.int32, device="meta") for s in shapes))
    fn(*(torch.zeros(s, dtype=torch.int32) for s in shapes))  # the plain version: no launch
    assert fn.launches == before


@pytest.mark.parametrize("name", sorted(build.LIBRARIES))
def test_bound_c_functions_are_defined_in_their_source(name):
    # Every C function a library's ctypes binding names is defined, with as
    # many parameters, in that library's source.
    source = build.LIBRARIES[name][0].read_text()
    for fn, (argtypes, _) in build._SIGNATURES[name].items():
        m = re.search(rf'extern "C" [\w ]+\*? ?{fn}\(([^)]*)\)', source)
        assert m, fn
        assert len(m.group(1).split(",")) == len(argtypes), fn


def test_port_source_scan_covers_the_fast_profile():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {
        "dpf_tpu_torch/fast.py",
        "dpf_tpu_torch/core/chacha_np.py",
        "dpf_tpu_torch/core/keys_chacha.py",
        "dpf_tpu_torch/models/dpf_chacha.py",
        "dpf_tpu_torch/ops/chacha_cuda.py",
    } <= names


def test_fast_eval_full_batch_without_cuda_raises_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ka, _ = fast.gen_batch([5, 9], 12, np.random.default_rng(0), device="cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fast.eval_full_batch(ka)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fast.EvalFull(ka.to_bytes()[0], 12)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port_dc.DeviceKeysFast(ka)
    assert fast.eval_full_batch(ka, device="cpu").shape == (2, 512)


def _chacha_operands(device, K=2, W=4, levels=2):
    i32 = dict(dtype=torch.int32, device=device)
    return (torch.zeros((5, K, W), **i32), torch.zeros((K, levels, 4), **i32),
            torch.zeros((K, levels, 2), **i32), torch.zeros((K, 16), **i32))


@pytest.mark.parametrize("wrapper", ["fused_levels", "expand_tail"])
def test_chacha_wrappers_take_only_cpu_or_cuda_tensors(wrapper):
    fn = getattr(chacha_cuda, wrapper)
    n_args = 3 if wrapper == "fused_levels" else 4
    before = fn.launches
    with pytest.raises(ValueError):
        fn(*_chacha_operands("meta")[:n_args])
    out = fn(*_chacha_operands("cpu")[:n_args])  # the plain version: no launch
    assert out.shape == ((5, 2, 16) if wrapper == "fused_levels" else (2, 16, 16))
    assert fn.launches == before


@pytest.mark.parametrize(
    "shape, strides, ok",
    [
        ((1, 0, 4), (0, 0, 0), True),  # no levels: nothing is read
        ((3, 1, 4), (4, 99, 1), True),  # one level: its stride is never used
        ((3, 2, 4), (8, 4, 1), True),
        ((3, 2, 4), (8, 1, 2), False),
    ],
)
def test_chacha_operand_stride_check(shape, strides, ok):
    x = torch.zeros(64, dtype=torch.int32).as_strided(shape, strides)
    check = lambda: chacha_cuda._check("scw", x, shape, (4, 1), x.device)  # noqa: E731
    if ok:
        check()
    else:
        with pytest.raises(ValueError, match="strides"):
            check()


def _traced_ops(fn, *args) -> Counter:
    """How often each torch operation runs in ``fn(*args)``.  An add or XOR
    with a tensor that ``zeros_like`` made (or an add or XOR of two such)
    is a copy and is not counted."""
    folds = ("add", "__xor__")

    class Count(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.ops = Counter()
            self.zeros = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            name = getattr(func, "__name__", str(func))
            out = func(*args, **(kwargs or {}))
            zero = [any(a is z for z in self.zeros) for a in args]
            if name == "zeros_like" or (name in folds and all(zero)):
                self.zeros.append(out)
            elif not (name in folds and any(zero)):
                self.ops[name] += 1
            return out

    with Count() as mode:
        fn(*args)
    return mode.ops


@pytest.mark.parametrize("n_out", [8, 16])
def test_chacha_core_count_matches_traced_run(n_out):
    # One torch add is one IADD, one xor one LOP3, and one rotate (shift,
    # masked logical shift, OR) one SHF; those with a zero counter word fold.
    seed = [torch.zeros((2, 3), dtype=torch.int32) for _ in range(4)]
    ops = _traced_ops(port_dc._chacha_core, seed, port_dc._DSX, n_out)
    rotates = ops["__or__"]
    assert ops["__lshift__"] == ops["__rshift__"] == ops["__and__"] == rotates
    assert op_count.chacha_core_ops(n_out) == Counter(
        IADD=ops["add"], LOP3=ops["__xor__"], SHF=rotates
    )


@pytest.mark.parametrize("kind", ["expand", "leaf"])
def test_chacha_cw_work_count_matches_traced_run(kind):
    # Around the core: each AND is one LOP3, and each XOR folds into the LOP3
    # of the AND that feeds it; the mask 0 - t is one IADD.
    S = [torch.zeros((2, 3), dtype=torch.int32) for _ in range(4)]
    T = torch.zeros((2, 3), dtype=torch.int32)
    w = torch.zeros(2, dtype=torch.int32)
    if kind == "expand":
        ops = _traced_ops(port_dc._level_step_cc, S, T, [w] * 4, w, w)
        core, extra = _traced_ops(port_dc._chacha_core, S, port_dc._DSX, 8), op_count.LEVEL_STEP_EXTRA
    else:
        ops = _traced_ops(port_dc._convert_leaves_cc, S, T, [w] * 16)
        core, extra = _traced_ops(port_dc._chacha_core, S, port_dc._DSL, 16), op_count.LEAF_EXTRA
    ands = ops["__and__"] - core["__and__"]
    assert ops["__xor__"] - core["__xor__"] <= ands
    assert extra == Counter(LOP3=ands, IADD=ops["neg"])
    assert op_count.chacha_instructions(kind) == {"expand": 595, "leaf": 601}[kind]


def test_eval_full_device_rejects_unknown_impl():
    ka, _ = port.gen_batch([1], 8, np.random.default_rng(0), device="cpu")
    with pytest.raises(ValueError):
        port_dpf.eval_full_device(port_dpf.DeviceKeys(ka, "cpu"), impl="triton")


def test_generated_sbox_header_is_up_to_date():
    assert gen_sbox.HEADER_PATH.read_text() == gen_sbox.generate()


class _GateCount:
    """A value that counts the gates computed from it, by operator."""

    def __init__(self, ops: Counter):
        self.ops = ops

    def _op(self, name):
        self.ops[name] += 1
        return _GateCount(self.ops)

    def __xor__(self, other):
        return self._op("^")

    def __and__(self, other):
        return self._op("&")

    def __invert__(self):
        return self._op("~")


def test_sbox_gate_count():
    # 32 AND + 83 XOR + 4 NOT: the circuit's 4 XNORs count as XOR then NOT.
    ops = Counter()
    sbox_bp113([_GateCount(ops) for _ in range(8)])
    assert (ops["&"], ops["^"], ops["~"]) == (32, 83, 4)
    # The operation bound's counts (NOTs free): 115 gates -> 85 LOP3 per
    # S-box; one MMO column 22,992 gates -> 16,236 LOP3; the PRG's two share
    # their first S-box layer.
    dag = op_count._Dag()
    x = [op_count._Sig(dag, dag.node(("in", i, None))) for i in range(8)]
    y = sbox_bp113(x)
    assert (op_count.two_input_gates(dag), op_count.lop3_cover(dag, y)) == (115, 85)
    dag, outs = op_count.trace_mmo((op_count.RK_MASKS_L,))
    assert op_count.two_input_gates(dag) == 22992
    assert op_count.lop3_per_column(1) == 16236
    assert op_count.lop3_per_column(2) == 32094


@pytest.mark.parametrize(
    "expr, want",
    [
        # (a & b) ^ c is one instruction; a five-way XOR is two.
        (lambda a, b, c, d, e: (a & b) ^ c, 1),
        (lambda a, b, c, d, e: a ^ b ^ c ^ d ^ e, 2),
        (lambda a, b, c, d, e: ((a ^ b) ^ (c ^ d)) ^ e, 2),
        (lambda a, b, c, d, e: ~(a ^ ~b), 1),
        (lambda a, b, c, d, e: (a & b) ^ (c & d), 2),
    ],
)
def test_lop3_cover_small_circuits(expr, want):
    dag = op_count._Dag()
    x = [op_count._Sig(dag, dag.node(("in", i, None))) for i in range(5)]
    assert op_count.lop3_cover(dag, [expr(*x)]) == want


@pytest.mark.parametrize("n_keys", [1, 2])
def test_counted_circuit_is_the_kernels_function(n_keys):
    # The DAG whose gates the bound counts computes AES-MMO (both PRG keys).
    planes = np.random.default_rng(n_keys).integers(0, 1 << 32, (128, 4), dtype=np.uint32)
    dag, outs = op_count.trace_mmo((op_count.RK_MASKS_L, op_count.RK_MASKS_R)[:n_keys])
    want = prg_planes(to_carrier(planes))[:n_keys]
    assert np.array_equal(op_count.evaluate(dag, outs, planes),
                          np.concatenate([from_carrier(w) for w in want]))


def test_parse_sass():
    text = (
        "\t\tFunction : prg_bm_kernel\n"
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;\n"
        "                                                  /* 0x000fe20000000800 */\n"
        "        /*0010*/                   LOP3.LUT R4, R2, R3, R5, 0x96, !PT ;\n"
        "        /*0020*/                @P1 LOP3.LUT R4, R2, R3, R5, 0x96, !PT ;\n"
        "        /*0030*/               @!P0 BRA 0x70 ;\n"
        "\t\tFunction : leaf_words_bm_kernel\n"
        "        /*0000*/                   EXIT ;\n"
    )
    assert build.parse_sass(text) == {
        "prg_bm_kernel": {"LDC": 1, "LOP3": 2, "BRA": 1},
        "leaf_words_bm_kernel": {"EXIT": 1},
    }


def test_parse_ptxas():
    text = (
        "ptxas info    : Compiling entry function 'prg_bm_kernel' for 'sm_90a'\n"
        "ptxas info    : Function properties for prg_bm_kernel\n"
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 168 registers, 384 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function 'leaf_words_bm_kernel' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 170 registers\n"
    )
    assert build.parse_ptxas(text) == {
        "prg_bm_kernel": dict(
            registers=168, stack_bytes=8, spill_store_bytes=4, spill_load_bytes=4
        ),
        "leaf_words_bm_kernel": dict(
            registers=170, stack_bytes=0, spill_store_bytes=0, spill_load_bytes=0
        ),
    }


def test_chip_smoke_vectors_are_the_frozen_ones():
    assert chip_smoke.VECTORS == VECTORS


def test_chip_smoke_without_cuda_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_port_source_scan_covers_the_point_path():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert "dpf_tpu_torch/core/bitpack.py" in names
    assert {"aes_walk.cu", "chacha_walk.cu", "aes_bm.cuh", "chacha12.cuh"} <= {
        p.name for p in build.CSRC.iterdir()
    }
    assert {"aes_walk", "chacha_walk"} <= set(build.LIBRARIES)


def test_eval_points_batch_without_cuda_raises_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xs = np.array([[1, 5], [9, 200]], np.uint64)
    ka, _ = port.gen_batch([5, 9], 8, np.random.default_rng(0), device="cpu")
    fa, _ = fast.gen_batch([5, 9], 8, np.random.default_rng(0), device="cpu")
    for fn, kb in ((port.eval_points_batch, ka), (fast.eval_points_batch, fa)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            fn(kb, xs)
        assert fn(kb, xs, device="cpu").shape == (2, 2)
    for model, kb in ((port_dpf, ka), (port_dc, fa)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            model.eval_points_level_grouped(kb, xs[:1, :1] // 8, 1, levels=(0, 3))


def test_port_source_scan_covers_the_stream_and_pir():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"dpf_tpu_torch/core/stream.py", "dpf_tpu_torch/models/pir.py"} <= names


def test_stream_and_pir_without_cuda_raise_unless_cpu(monkeypatch):
    from dpf_tpu_torch.core import stream
    from dpf_tpu_torch.models import pir

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ka, _ = port.gen_batch([5, 9], 8, np.random.default_rng(0), device="cpu")
    fa, _ = fast.gen_batch([5, 9], 12, np.random.default_rng(0), device="cpu")
    db = np.zeros((300, 8), np.uint8)
    for profile in ("compat", "fast"):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            pir.PirServer(db, profile=profile)
        assert pir.PirServer(db, profile=profile, device="cpu").db_words.device.type == "cpu"
    # The streams are generators: they raise at their first next.
    for model, kb in ((port_dpf, ka), (port_dc, fa)):
        gen = model.eval_full_stream(kb)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            next(gen)
        assert len(list(model.eval_full_stream(kb, device="cpu"))) == 2
    words = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        next(stream.stream_chunks(1, lambda j: words, lambda w: w))
    assert len(list(stream.stream_chunks(1, lambda j: words, lambda w: w, device="cpu"))) == 2


def _walk_bm_operands(device, K=2, qp=3, nu=2):
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=device)  # noqa: E731
    return (z(128, K), z(K), z(nu, 128, K), z(nu, K), z(nu, K), z(128, K), z(nu, K, qp),
            z(128, K, qp), nu)


def _walk_operands(device, Q=3, K=2, nu=2):
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=device)  # noqa: E731
    return (z(3, K), z(4, K), z(4 * nu, K), z(2 * nu, K), z(16, K), z(Q, K), z(Q, K), 20, nu)


def _walk_dcf_operands(device, Q=3, K=2, nu=2):
    ops = _walk_operands(device, Q, K, nu)
    return ops[:4] + (torch.zeros((nu, K), dtype=torch.int32, device=device),) + ops[4:]


@pytest.mark.parametrize("wrapper", ["eval_points_walk_planes", "walk", "walk_dcf"])
def test_walk_wrappers_take_only_cpu_or_cuda_tensors(wrapper):
    fn, operands = {
        "eval_points_walk_planes": (aes_cuda.eval_points_walk_planes, _walk_bm_operands),
        "walk": (chacha_cuda.walk, _walk_operands),
        "walk_dcf": (chacha_cuda.walk_dcf, _walk_dcf_operands),
    }[wrapper]
    before = fn.launches
    with pytest.raises(ValueError):
        fn(*operands("meta"))
    out = fn(*operands("cpu"))  # the plain version: no launch
    assert out.shape == ((2, 3) if wrapper == "eval_points_walk_planes" else (3, 2))
    assert fn.launches == before


def test_port_source_scan_covers_the_gates():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"dpf_tpu_torch/models/dcf.py", "dpf_tpu_torch/models/fss.py"} <= names
    assert "dpf_chacha_walk_dcf" in build._SIGNATURES["chacha_walk"]
    assert "walk_dcf_kernel" in (build.CSRC / "chacha_walk.cu").read_text()


@pytest.mark.parametrize("nu", [0, 1, 23])
def test_walk_counts_are_their_ciphers(nu):
    # The compat walk: a PRG column per level and a leaf MMO column; the fast
    # walk: an expansion block per level and a leaf block, 380 ALU-pipe
    # instructions each (the expansion's 394 less its 14 CW LOP3).
    assert op_count.walk_lop3_per_column(nu) == nu * 32094 + 16236
    ops = op_count.walk_chacha_ops(nu)
    assert ops == Counter({k: nu * n for k, n in op_count.chacha_core_ops(8).items()}) + \
        op_count.chacha_core_ops(16)
    expand = op_count.chacha_ops("expand")
    assert expand["LOP3"] + expand["SHF"] - op_count.LEVEL_STEP_EXTRA["LOP3"] == 380
    assert ops["LOP3"] + ops["SHF"] == 380 * (nu + 1)


def test_port_source_scan_covers_the_dealer_and_the_apps():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {
        "dpf_tpu_torch/models/keys_gen.py",
        "dpf_tpu_torch/models/hh_fold.py",
        "dpf_tpu_torch/apps/__init__.py",
        "dpf_tpu_torch/apps/heavy_hitters.py",
        "dpf_tpu_torch/apps/hh_state.py",
        "dpf_tpu_torch/apps/aggregation.py",
    } <= names


def _gen_entry_points():
    from dpf_tpu_torch import fss
    from dpf_tpu_torch.apps import heavy_hitters
    from dpf_tpu_torch.models import pir

    return {
        "gen_batch": lambda **kw: port.gen_batch([5, 9], 8, np.random.default_rng(0), **kw),
        "fast.gen_batch": lambda **kw: fast.gen_batch([5, 9], 12, np.random.default_rng(0),
                                                      **kw),
        "dcf_gen_lt_batch": lambda **kw: fast.dcf_gen_lt_batch(
            [3, 5], 8, np.random.default_rng(0), **kw),
        "dcf_gen_interval_batch": lambda **kw: fast.dcf_gen_interval_batch(
            [1, 2], [3, 4], 8, np.random.default_rng(0), **kw),
        "fss.gen_lt_batch": lambda **kw: fss.gen_lt_batch(
            [3, 5], 8, np.random.default_rng(0), "fast", **kw),
        "fss.gen_interval_batch": lambda **kw: fss.gen_interval_batch(
            [1, 2], [3, 4], 8, np.random.default_rng(0), **kw),
        "pir_query": lambda **kw: pir.pir_query([1, 7], 100, np.random.default_rng(0), **kw),
        "gen_shares": lambda **kw: heavy_hitters.gen_shares(
            [3, 5, 5], 8, "fast", np.random.default_rng(0), **kw),
    }


@pytest.mark.parametrize("name", sorted(_gen_entry_points()))
def test_gen_without_cuda_raises_unless_cpu(monkeypatch, name):
    # Gen runs on the card by default: with CUDA hidden, a call with no
    # device raises; device="cpu" runs the host tower.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = _gen_entry_points()[name]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call()
    assert call(device="cpu") is not None


def test_gen_tower_takes_only_cpu_or_cuda_tensors():
    before = chacha_cuda.gen_tower.launches
    shapes = [(3, 4), (3, 4), (3,), (3,), (2, 3)]
    with pytest.raises(ValueError):
        chacha_cuda.gen_tower(*(torch.empty(s, dtype=torch.int32, device="meta")
                                for s in shapes), False)
    chacha_cuda.gen_tower(*(torch.zeros(s, dtype=torch.int32) for s in shapes), True)
    assert chacha_cuda.gen_tower.launches == before


def test_port_source_scan_covers_the_plans():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {
        "dpf_tpu_torch/core/knobs.py",
        "dpf_tpu_torch/core/plans.py",
        "dpf_tpu_torch/apps/pir_store.py",
    } <= names


def _run_routes():
    from dpf_tpu_torch.apps import pir_store
    from dpf_tpu_torch.core import keys, plans
    from dpf_tpu_torch.models import dcf

    rng = np.random.default_rng(0)
    ka, _ = port.gen_batch([5, 9], 9, rng, device="cpu")
    fa, _ = fast.gen_batch([5, 9], 10, rng, device="cpu")
    da, _ = dcf.gen_lt_batch([5, 9], 10, rng, device="cpu")
    ia, _ = dcf.gen_interval_batch([1, 2], [3, 4], 10, rng, device="cpu")
    xs = np.array([[1, 5], [9, 200]], np.uint64)
    db = pir_store.PirDB("b", np.zeros((300, 4), np.uint8))
    roots = keys._draw_roots(2, rng)
    sel = torch.zeros(16, dtype=torch.int64)
    dk = port_dpf.DeviceKeys(ka, "cpu")
    state = (dk.seed_planes.repeat(1, 32, 1), dk.t_words.repeat(32, 1))
    rows = np.zeros((3, 2), np.uint32)
    return {
        "run_points": lambda **kw: plans.run_points("points", "fast", fa, xs, **kw),
        "run_points_dcf": lambda **kw: plans.run_points("dcf_points", "fast", da, xs, **kw),
        "run_interval": lambda **kw: plans.run_interval(ia, xs, **kw),
        "run_evalfull": lambda **kw: plans.run_evalfull("compat", ka, **kw),
        "run_hh_level": lambda **kw: plans.run_hh_level("compat", ka, xs, 1, **kw),
        "run_hh_extend": lambda **kw: plans.run_hh_extend(
            "compat", 9, 32, "tree", state,
            (sel, dk.scw_planes[0], dk.tl_words[0], dk.tr_words[0]), q=32, **kw),
        "run_hh_fold": lambda **kw: plans.run_hh_fold(rows, **kw),
        "run_agg_fold": lambda **kw: plans.run_agg_fold("xor", None, rows, **kw),
        "run_pir": lambda **kw: plans.run_pir(db, ka, **kw),
        "run_gen": lambda **kw: plans.run_gen("compat", np.array([3, 4], np.uint64), 9,
                                              *roots, **kw),
        "warmup": lambda **kw: plans.warmup(
            [{"route": "points", "profile": "compat", "log_n": 9, "k": 2}], **kw),
    }


@pytest.mark.parametrize("name", ["run_agg_fold", "run_evalfull", "run_gen", "run_hh_extend",
                                  "run_hh_fold", "run_hh_level", "run_interval", "run_pir",
                                  "run_points", "run_points_dcf", "warmup"])
def test_plan_routes_without_cuda_raise_unless_cpu(monkeypatch, name):
    # Every run_* means the card when it is given no device.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = _run_routes()[name]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call()
    assert call(device="cpu") is not None


def _chacha_ops_calls():
    from dpf_tpu_torch.models import dcf

    rng = np.random.default_rng(0)
    fa, _ = fast.gen_batch([5, 9], 10, rng, device="cpu")
    da, _ = dcf.gen_lt_batch([5, 9], 10, rng, device="cpu")
    xs = np.array([[1, 5], [9, 200]], np.uint64)
    return {
        "walk_operands": lambda **kw: chacha_cuda.walk_operands(fa, **kw),
        "walk_args": lambda **kw: chacha_cuda.walk_args(fa, xs, **kw),
        "eval_points_walk": lambda **kw: chacha_cuda.eval_points_walk(fa, xs, **kw),
        "dcf_walk_operands": lambda **kw: chacha_cuda.dcf_walk_operands(da, **kw),
        "dcf_walk_args": lambda **kw: chacha_cuda.dcf_walk_args(da, xs, **kw),
        "eval_points_walk_dcf": lambda **kw: chacha_cuda.eval_points_walk_dcf(da, xs, **kw),
    }


@pytest.mark.parametrize("name", ["dcf_walk_args", "dcf_walk_operands", "eval_points_walk",
                                  "eval_points_walk_dcf", "walk_args", "walk_operands"])
def test_chacha_ops_without_cuda_raise_unless_cpu(monkeypatch, name):
    # ROADMAP C.6: these ops-level entry points defaulted to the CPU; like
    # every entry point they now mean the card unless given device="cpu".
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = _chacha_ops_calls()[name]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call()
    assert call(device="cpu") is not None
