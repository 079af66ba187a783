"""Secure aggregation (``dpf_tpu_torch/apps/aggregation.py``) against the
JAX package: ``aggregate_rows`` (XOR and add folds over chunks, ragged
tails, empty chunks), ``fold_rows`` with a carry, ``aggregate_eval_full`` of
a small key batch of either profile (carried across through ``interop``),
and the two aggregators' folds reconstructing the presence bitmap.  The
fast profile's reference is ``dpf_tpu``'s ``aggregate_eval_full``; the
compat one's is ``dpf_tpu``'s ``aggregate_rows`` over the reference spec's
expansions of the same keys, the fold that ``aggregate_eval_full`` is (its
XLA expansion compiles for 7-11 s on the CPU).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from dpf_tpu.apps import aggregation as ref_agg  # noqa: E402
from dpf_tpu.core import spec as ref_spec  # noqa: E402
from dpf_tpu.core.keys import gen_batch as ref_gen  # noqa: E402
from dpf_tpu.models.keys_chacha import gen_batch as ref_gen_fast  # noqa: E402
from dpf_tpu_torch import interop  # noqa: E402
from dpf_tpu_torch.apps import aggregation as agg  # noqa: E402

LOG_N, K = 8, 40


@pytest.mark.parametrize("op", ["xor", "add"])
@pytest.mark.parametrize("shape,step", [((1000, 7), 300), ((64, 16), None), ((5, 1), 2),
                                        ((33, 3), 33)])
def test_aggregate_rows_match_reference(op, shape, step):
    rows = np.random.default_rng(shape[0] + shape[1]).integers(
        0, 1 << 32, size=shape, dtype=np.uint32)
    want = ref_agg.aggregate_rows(rows, op, rows_per_chunk=step)
    got = agg.aggregate_rows(rows, op, rows_per_chunk=step, device="cpu")
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.bitwise_xor.reduce(rows, axis=0) if op == "xor"
        else rows.astype(np.uint64).sum(0).astype(np.uint32))


@pytest.mark.parametrize("op", ["xor", "add"])
def test_fold_rows_and_chunks_match_reference(op):
    rng = np.random.default_rng(5)
    rows, carry = rng.integers(0, 1 << 32, size=(9, 4), dtype=np.uint32), rng.integers(
        0, 1 << 32, size=4, dtype=np.uint32)
    np.testing.assert_array_equal(agg.fold_rows(rows, op, carry, device="cpu"),
                                  ref_agg._fold_jit(op, carry, rows))
    chunks = [rows[:4], rows[4:4], rows[4:]]  # an empty chunk is the identity
    np.testing.assert_array_equal(agg.aggregate_chunks(chunks, op, 4, device="cpu"),
                                  ref_agg.aggregate_chunks(chunks, op, 4))


def test_chunk_rows_is_the_reference():
    for words in (1, 7, 16, 64, 1 << 15):
        assert agg.chunk_rows(words) == ref_agg.chunk_rows(words)
        assert agg.chunk_rows(words, 1000) == ref_agg.chunk_rows(words, 1000)


@pytest.fixture(scope="module", params=["compat", "fast"])
def keys(request):
    """Two aggregators' halves of K client key pairs and the reference's
    folds of them."""
    fast = request.param == "fast"
    rng = np.random.default_rng(8)
    alphas = rng.integers(0, 1 << LOG_N, size=K, dtype=np.uint64)
    ra, rb = (ref_gen_fast if fast else ref_gen)(alphas, LOG_N, rng=rng)
    conv = interop.from_jax_keybatch_fast if fast else interop.from_jax_keybatch
    port = [conv(LOG_N, k.seeds, k.ts, k.scw, k.tcw, k.fcw) for k in (ra, rb)]
    if fast:
        want = {op: [ref_agg.aggregate_eval_full(k, op) for k in (ra, rb)] for op in agg.OPS}
    else:
        rows = [np.frombuffer(b"".join(ref_spec.eval_full(key, LOG_N) for key in k.to_bytes()),
                              np.uint8).reshape(K, -1).view("<u4") for k in (ra, rb)]
        want = {op: [ref_agg.aggregate_rows(r, op) for r in rows] for op in agg.OPS}
    return alphas, port, want


@pytest.mark.parametrize("op", ["xor", "add"])
def test_aggregate_eval_full_matches_reference(keys, op):
    alphas, port, want = keys
    got = [agg.aggregate_eval_full(k, op, device="cpu") for k in port]
    for g, w in zip(got, want[op]):
        assert g.dtype == np.uint32
        np.testing.assert_array_equal(g, w)
    if op == "xor":  # the odd-multiplicity presence bitmap over the domain
        bitmap = np.unpackbits(agg.reconstruct(*got, op).view(np.uint8), bitorder="little")
        counts = np.bincount(alphas.astype(np.int64), minlength=1 << LOG_N)
        np.testing.assert_array_equal(bitmap, counts % 2)
    np.testing.assert_array_equal(agg.reconstruct(*got, op), ref_agg.reconstruct(*want[op], op))


def test_unknown_op_raises():
    with pytest.raises(ValueError, match="unknown op"):
        agg.aggregate_rows(np.zeros((2, 2), np.uint32), "or", device="cpu")
    with pytest.raises(ValueError, match="unknown op"):
        agg.reconstruct(np.zeros(2, np.uint32), np.zeros(2, np.uint32), "or")
