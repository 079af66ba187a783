"""Double-buffered chunk streaming: the one copy of the overlap driver.

The port's counterpart of ``dpf_tpu/core/stream.py``.  Both profiles'
``eval_full_stream`` (``models/dpf.py``, ``models/dpf_chacha.py``) drive
the same pipeline: chunk j+1's compute is dispatched BEFORE chunk j's
device-to-host copy is waited on, so on the card the copy of a finished
chunk runs under the next chunk's compute and a streaming consumer gets
its first bytes after about one chunk.  The callers supply only the
profile's pieces: the per-chunk dispatch and the words-to-rows view.

On the card the copies run on a copy stream of their own, into pinned
host buffers, so that they overlap the compute stream.  On the CPU the
copy is a plain copy.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .device import resolve_device


def chunk_levels(total: int, cap: int, min_chunks: int, nu: int) -> int:
    """Levels ``c`` to split at: enough that each of the 2^c chunks fits
    ``cap``, at least ``min_chunks`` chunks (streaming a single block
    would be the blocking path with extra steps), never more than nu."""
    n_chunks = -(-total // cap)
    c = max(
        (n_chunks - 1).bit_length(),
        (max(min_chunks, 1) - 1).bit_length(),
    )
    return min(c, nu)


def stream_chunks(c: int, dispatch, to_rows, events=None, timer=None, *, device=None):
    """Yield 2^c chunk-row blocks from the double-buffered pipeline.

    ``dispatch(j)`` issues chunk j's device computation on the current
    stream and returns its words (an int32 tensor, not waited on);
    ``to_rows(np_words)`` converts a fetched chunk (uint32 numpy words)
    to the rows to yield.  ``events``, when a list, records
    ("dispatch"|"d2h_start"|"d2h_done", j) in order: dispatch of chunk
    j+1 precedes d2h_done of chunk j.  ``timer`` is any object whose
    ``.phase(name)`` is a context manager; it times the "dispatch" and
    "d2h" phases.

    ``device`` (None: the card) is where ``dispatch`` computes; without
    CUDA the driver raises unless the caller passes ``device="cpu"``.  On
    the card an event recorded after ``dispatch(j)`` marks chunk j's end
    on the compute stream.  Its copy then runs on a copy stream that
    waits on that event (not on the compute stream's later work, the next
    chunk), with ``non_blocking=True`` into a pinned host tensor that the
    yielded block alone owns; the device words are marked as used by the
    copy stream (``record_stream``), and ``d2h_done`` waits on an event
    recorded after the copy."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if cuda:
        compute = torch.cuda.current_stream(dev)
        copy = torch.cuda.Stream(dev)

    def ph(name):
        return timer.phase(name) if timer else contextlib.nullcontext()

    def rec(ev, j):
        if events is not None:
            events.append((ev, j))

    def issue(j):
        with ph("dispatch"):
            words = dispatch(j)
        done = None
        if cuda:
            done = torch.cuda.Event()
            done.record(compute)
        rec("dispatch", j)
        return words, done

    def finalize(words, done, j):
        if cuda:
            with torch.cuda.stream(copy):
                copy.wait_event(done)
                host = torch.empty(words.shape, dtype=words.dtype, pin_memory=True)
                host.copy_(words, non_blocking=True)
                words.record_stream(copy)
                ready = torch.cuda.Event()
                ready.record(copy)
        else:
            host = words.clone()
        rec("d2h_start", j)
        with ph("d2h"):
            if cuda:
                ready.synchronize()
        rec("d2h_done", j)
        return to_rows(host.numpy().view(np.uint32))

    prev = None
    for j in range(1 << c):
        cur = issue(j)
        if prev is not None:
            yield finalize(*prev, j - 1)
        prev = cur
    yield finalize(*prev, (1 << c) - 1)
