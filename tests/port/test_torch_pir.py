"""The port's single-card 2-server PIR (``dpf_tpu_torch/models/pir.py``)
against dpf_tpu's.

Byte-exact throughout (integer cryptography: the tolerance is zero).  The
database and the queries come from numpy.random.default_rng(seed); the port
runs on device="cpu", where its kernel wrappers run their plain PyTorch
versions.  The reference's compat answer compiles its XLA expansion for
seconds, so it runs once, one-shot, for the module: the port's one-shot and
streamed answers are both held to it (the reference's own tests hold its
streamed answer to its one-shot one).  The fast profile's reference runs
both.
"""

import inspect

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from dpf_tpu.models import pir as ref_pir  # noqa: E402
from dpf_tpu_torch.core.keys import KeyBatch  # noqa: E402
from dpf_tpu_torch.core.keys_chacha import KeyBatchFast  # noqa: E402
from dpf_tpu_torch.models import pir  # noqa: E402

N_ROWS, ROW_BYTES = 512, 8
STREAM_CHUNK_BYTES = 1024  # 4 slabs of 128 rows over 512 x 8 B
INDICES = [0, 3, 100, 257, 511]


def _db(seed=1, n_rows=N_ROWS, row_bytes=ROW_BYTES):
    return np.random.default_rng(seed).integers(0, 256, size=(n_rows, row_bytes),
                                                dtype=np.uint8)


def _port_keys(kb, profile):
    cls = KeyBatchFast if profile == "fast" else KeyBatch
    return cls.from_bytes(kb.to_bytes(), kb.log_n)


@pytest.fixture(scope="module")
def reference():
    """dpf_tpu's queries and answers, run once: {profile: (query pair,
    {db_chunk_bytes: answer})}; the compat profile's one-shot only."""
    db = _db()
    out = {}
    for profile, chunk_bytes in (("compat", (0,)), ("fast", (0, STREAM_CHUNK_BYTES))):
        qa, qb = ref_pir.pir_query(INDICES, N_ROWS, rng=np.random.default_rng(7),
                                   profile=profile)
        answers = {}
        for cb in chunk_bytes:
            server = ref_pir.PirServer(db, profile=profile, db_chunk_bytes=cb)
            answers[cb] = (server.answer(qa), server.answer(qb))
        out[profile] = ((qa, qb), answers)
    return out


@pytest.mark.parametrize("chunk_bytes", [0, STREAM_CHUNK_BYTES], ids=["one-shot", "stream"])
@pytest.mark.parametrize("profile", ["compat", "fast"])
def test_answer_matches_reference(reference, profile, chunk_bytes):
    (qa, qb), answers = reference[profile]
    want_a, want_b = answers.get(chunk_bytes, answers[0])
    db = _db()
    server = pir.PirServer(db, profile=profile, db_chunk_bytes=chunk_bytes, device="cpu")
    assert server.stream_chunks == (4 if chunk_bytes else 1)
    got_a = server.answer(_port_keys(qa, profile))
    got_b = server.answer(_port_keys(qb, profile))
    for got, want in ((got_a, want_a), (got_b, want_b)):
        assert got.dtype == np.uint8 and got.shape == (len(INDICES), ROW_BYTES)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pir.pir_reconstruct(got_a, got_b), db[INDICES])


@pytest.mark.parametrize("profile", ["compat", "fast"])
def test_pir_query_matches_reference(reference, profile):
    (qa, qb), _ = reference[profile]
    pa, pb = pir.pir_query(INDICES, N_ROWS, rng=np.random.default_rng(7), profile=profile, device="cpu")
    assert pa.to_bytes() == qa.to_bytes() and pb.to_bytes() == qb.to_bytes()


@pytest.mark.parametrize("profile,n_rows,row_bytes,chunk_bytes,chunk_rows", [
    ("compat", 100, 4, 0, None),  # log_n 7: one leaf, padded rows
    ("fast", 100, 12, 0, 128),
    ("compat", 300, 8, 1024, 100),  # chunk_rows rounds down to 128 = the slab
    ("fast", 1000, 4, 1, None),  # the least slab, 128 rows
    ("compat", 5000, 16, 3000, 1000),
])
def test_answer_matches_spec_across_shapes(profile, n_rows, row_bytes, chunk_bytes,
                                           chunk_rows):
    # Port-only shapes: the answer is the XOR of the rows whose selection
    # bit is set, the two answers reconstruct the rows.
    db = _db(n_rows, n_rows, row_bytes)
    idx = [0, n_rows // 3, n_rows - 1]
    qa, qb = pir.pir_query(idx, n_rows, rng=np.random.default_rng(n_rows), profile=profile, device="cpu")
    server = pir.PirServer(db, chunk_rows, profile, chunk_bytes, device="cpu")
    np.testing.assert_array_equal(
        pir.pir_reconstruct(server.answer(qa), server.answer(qb)), db[idx])


def test_server_arithmetic_matches_reference():
    for profile in ("compat", "fast"):
        for n_rows in (1, 8, 9, 128, 129, 512, 513, 5000):
            assert pir.row_domain(n_rows, profile) == ref_pir.row_domain(n_rows, profile)
            for row_bytes in (4, 32):
                db = np.zeros((n_rows, row_bytes), np.uint8)
                for chunk_rows in (None, 1, 200, 1 << 20):
                    for chunk_bytes in (None, 0, 1, 512, 4096, 1 << 20):
                        want = ref_pir.PirServer(db, None, chunk_rows, profile, chunk_bytes)
                        got = pir.PirServer(db, chunk_rows, profile, chunk_bytes,
                                            device="cpu")
                        for name in ("log_n", "nu", "dom", "chunk_rows", "stream_rows",
                                     "stream_chunks", "n_rows", "row_bytes"):
                            assert getattr(got, name) == getattr(want, name), (
                                profile, n_rows, row_bytes, chunk_rows, chunk_bytes, name)
                        assert tuple(got.db_words.shape) == tuple(want.db_words.shape)


def test_module_constants_are_the_reference_knob_defaults():
    # The module constants became the port's knobs (core/knobs.py), with the
    # reference's defaults.
    from dpf_tpu.core import knobs
    from dpf_tpu_torch.core import knobs as port_knobs

    for name in ("PIR_CHUNK_ROWS", "PIR_DB_CHUNK_BYTES"):
        assert (port_knobs.knob(f"DPF_CUDA_{name}").default
                == knobs.knob(f"DPF_TPU_{name}").default)


@pytest.mark.parametrize("K", [1, 7, 32, 33])
def test_parity_matmul_matches_gf2_model(K):
    rng = np.random.default_rng(K)
    N, R, chunk_rows = 512, 3, 128
    sel = rng.integers(0, 1 << 32, size=(K, N // 32), dtype=np.uint32)
    db = rng.integers(0, 1 << 32, size=(N, R), dtype=np.uint32)
    sel_bits = np.unpackbits(sel.view(np.uint8), axis=1, bitorder="little").astype(np.int64)
    db_bits = np.unpackbits(db.view(np.uint8), axis=1, bitorder="little").astype(np.int64)
    want = np.packbits((sel_bits @ db_bits) & 1, axis=1, bitorder="little").view(np.uint32)
    got = pir._parity_matmul(torch.from_numpy(sel.view(np.int32)),
                             torch.from_numpy(db.view(np.int32)), chunk_rows, N // chunk_rows)
    assert got.dtype == torch.int32 and tuple(got.shape) == (K, R)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def _raises_as_reference(port_call, ref_call):
    with pytest.raises(Exception) as want:
        ref_call()
    with pytest.raises(want.type):
        port_call()


def test_errors_match_reference(reference):
    db = _db()
    (qa, _), _ = reference["compat"]
    (fa, _), _ = reference["fast"]
    _raises_as_reference(lambda: pir.PirServer(db, profile="slow", device="cpu"),
                         lambda: ref_pir.PirServer(db, profile="slow"))
    _raises_as_reference(lambda: pir.PirServer(db[:, :6], device="cpu"),
                         lambda: ref_pir.PirServer(db[:, :6]))
    _raises_as_reference(lambda: pir.PirServer(db[0], device="cpu"),
                         lambda: ref_pir.PirServer(db[0]))
    _raises_as_reference(lambda: pir.pir_query([N_ROWS], N_ROWS, device="cpu"),
                         lambda: ref_pir.pir_query([N_ROWS], N_ROWS))
    for profile, ref_keys, other_keys in (("compat", qa, fa), ("fast", fa, qa)):
        server = pir.PirServer(db, profile=profile, device="cpu")
        ref_server = ref_pir.PirServer(db, profile=profile)
        # A query of the other profile.
        other = "fast" if profile == "compat" else "compat"
        _raises_as_reference(lambda: server.answer(_port_keys(other_keys, other)),
                             lambda: ref_server.answer(other_keys))
        # A query over another domain.
        small = ref_pir.pir_query([1], 100, rng=np.random.default_rng(0), profile=profile)[0]
        if small.log_n != ref_keys.log_n:
            _raises_as_reference(lambda: server.answer(_port_keys(small, profile)),
                                 lambda: ref_server.answer(small))


def test_signatures_extend_reference():
    # The reference's parameters and defaults, in order; pir_query takes
    # the Gen tower's device after them; the server leaves out the
    # reference's mesh (the sharded routes are not ported) and takes device
    # after them.
    def params(fn):
        return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()]

    for name in ("row_domain", "pir_reconstruct"):
        assert params(getattr(pir, name)) == params(getattr(ref_pir, name))
    assert params(pir.pir_query) == params(ref_pir.pir_query) + [("device", None)]
    want = [p for p in params(ref_pir.PirServer.__init__) if p[0] != "mesh"]
    assert params(pir.PirServer.__init__) == want + [("device", None)]
