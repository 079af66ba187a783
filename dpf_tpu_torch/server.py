"""DPF evaluation sidecar of the port: its HTTP/1.1 front.

The port's counterpart of ``dpf_tpu/server.py``.  Foreign-language clients
(the reference's Go programs, C++ services, ...) reach the evaluator
through this sidecar: raw key bytes in and raw result bytes out, the same
keys-as-bytes wire contract as the reference (``type DPFkey []byte``,
dpf/dpf.go:7), so a Go client is ~20 lines of net/http with no codegen.
The routes, params, statuses, error codes, headers and metric names are
the JAX sidecar's (``docs/CONTRACT.json``), and with the same request bytes
the replies are the same bytes.  The route logic lives in the
transport-neutral core ``serving/handlers.py``; this module is only the
HTTP/1.1 byte I/O around it.  Every dispatch runs on the sidecar's device:
the card, unless started with ``--device cpu`` / ``serve(device="cpu")``;
without CUDA and without that, start-up raises.  The wire2 binary front
of the JAX sidecar comes with a later slice.

Endpoints (all POST, binary bodies, profile/params in the query string):

  /v1/gen?log_n=N[&alpha=A][&profile=fast]   -> key_a || key_b
  /v1/eval?log_n=N&x=X[&profile=fast]        body: one key  -> 1 byte (0/1)
  /v1/evalfull?log_n=N[&profile=fast][&stream=0|1]
        body: one key  -> bit-packed bytes.  ``stream=1`` (or the
        DPF_CUDA_STREAM=on|auto default, auto streaming responses >=
        DPF_CUDA_STREAM_MIN_BYTES) writes the response progressively from
        the double-buffered chunked expansion (``eval_full_stream``: CUDA
        streams, a pinned buffer per block): each subtree chunk's bytes
        go onto the socket while the next chunk computes.
        Content-Length is always exact; the byte stream is identical to
        the blocking reply, so clients need no changes.
  /v1/evalfull_batch?log_n=N&k=K[&profile=fast]
        body: K concatenated keys -> K concatenated expansions
  /v1/eval_points_batch?log_n=N&k=K&q=Q[&profile=fast][&format=packed]
        body: K concatenated keys || K*Q little-endian uint64 indices
        -> K*Q bytes of 0/1 bits (row-major [K, Q]); with format=packed,
           K rows of ceil(Q/8) bit-packed bytes instead (bit j of row i at
           byte j//8, bit j%8 LSB-first — the /v1/evalfull convention and
           the reference's, dpf/dpf.go:207-209; tail bits zero) — an 8x
           cut of the dominant serving-traffic response
  /v1/dcf_gen?log_n=N&k=K                     body: K uint64 alphas
        -> K DCF keys (party A) || K DCF keys (party B)  (fast profile)
  /v1/dcf_eval_points?log_n=N&k=K&q=Q[&format=packed]
        body: keys || uint64 indices
        -> K*Q comparison-share bits (models/dcf.py; one key per gate),
           or K * ceil(Q/8) packed bytes with format=packed
  /v1/dcf_interval_gen?log_n=N&k=K            body: K uint64 lo || K uint64 hi
        -> party A blob || party B blob, each 2K DCF keys (upper, lower)
           || K public const bytes
  /v1/dcf_interval_eval?log_n=N&k=K&q=Q[&format=packed]
        body: one party blob || indices
        -> K*Q interval-share bits (1{lo <= x <= hi} after XOR), or
           K * ceil(Q/8) packed bytes with format=packed
  /v1/hh/gen?log_n=N&k=K[&profile=fast]       body: K uint64 client values
        -> share blob A || share blob B (trusted-dealer helper for the
           prefix-tree heavy-hitters protocol, apps/heavy_hitters.py;
           each blob is K clients x log_n level keys, client-major)
  /v1/hh/eval?log_n=N&k=K&q=Q&level=L[&profile=fast][&format=packed]
        body: K level-L client keys (key_len bytes each) || Q uint64
        candidate prefixes (ONE shared set, depth L+1 shifted up to n
        bits — uploaded once, not per key)
        -> K*Q share bits [client, candidate] (packed: K rows of
           ceil(Q/8) bytes) — the single-aggregator round primitive;
           two aggregators' replies XOR+popcount into public counts
  /v1/agg/submit?op=xor|add&k=K&words=W       body: K rows x W uint32
        -> the W folded uint32 words (secure aggregation,
           apps/aggregation.py).  The body is read AND folded in
           aggregation.AGG_CHUNK_BYTES (4 MiB) chunks — a million-client upload
           never materializes on host.
  /v1/pir/db?name=X&rows=N&row_bytes=B[&profile=fast]
        body: N rows x B bytes — register (or replace) a named PIR
        database (apps/pir_store.py).  The body is read off the socket
        in DPF_CUDA_PIR_DB_CHUNK_BYTES chunks straight into the packed
        host buffer; the rows then live on the card until replaced.
        Replies JSON {name, rows, row_bytes, log_n, db_bytes, shards,
        stream_chunks}.  The DB is PUBLIC protocol data (both PIR
        servers hold identical copies); the query is the secret.
  /v1/pir/query?db=X&k=K                      body: K concatenated DPF
        keys (the database's profile) -> K rows x row_bytes answer
        bytes: each query's XOR of the selected database rows
        (models/pir.py: the selection expansion, then the parity scan).
        XOR the two servers' replies to reconstruct the rows.
        Concurrent queries coalesce into ONE scan; databases past
        DPF_CUDA_PIR_DB_CHUNK_BYTES answer through the streamed slab
        scan, byte-identically.
  /v1/warmup                                  body: JSON
        {"shapes": [{"route": "points"|"dcf_points"|"dcf_interval"|
        "evalfull"|"hh_level"|"agg_xor"|"agg_add"|"gen"|"pir", "profile":
        "compat"|"fast", "log_n": N, "k": K,
        "q": Q}, ...]} — build the dispatch plans for those shapes NOW
        (core/plans.py; on the card, capture the evalfull and pointwise
        plans' CUDA graphs) so no first-request capture lands on user
        traffic.  An evalfull spec with "stream": true also drives the
        streaming pipeline once; a pir spec names a REGISTERED database
        ({"route": "pir", "db": name, "k": K}).  Replies JSON
        {warmed: per-shape seconds, trace_cache_entries: graphs held}.
  /healthz                                    -> "ok" (liveness ONLY:
        200 while the process serves, regardless of breaker/warmup)
  /readyz (GET)                               -> readiness: 200 "ready",
        or 503 {code:"breaker_open"} while the circuit breaker is not
        closed / {code:"cold"} until the first POST /v1/warmup — load
        generators (bridge/go/cmd/loadgen -wait-ready) hold fire on it
  /v1/stats (GET)                             -> JSON observability:
        plan-cache hit/miss + graphs held, micro-batcher
        coalescing (requests, dispatches, batch_coalesced mean/max,
        queue-wait, live queue_depth) plus load-survival counters
        (shed_depth/shed_age, expired_queue vs expired_flight, dispatch
        EWMA), key-repack LRU hits, circuit-breaker state
        (closed|open|half_open, trips, retries, fast-fails), active
        fault-injection clauses (when any), flight-recorder ring state,
        per-phase timers (queue_wait, pack, dispatch, compute, d2h,
        reply — utils/profiling.PhaseTimer), and the per-front ``wire``
        marshalling ledger (requests, body bytes, bytes COPIED between
        socket and dispatch operand).  The whole payload is ONE critical
        section under a single stats lock — never a torn read.
  /v1/metrics (GET)                           -> the same snapshot in
        Prometheus text format (obs/metrics.py): counters (sheds,
        expirations, breaker transitions, plan compiles, keycache hits),
        gauges (queue depth, breaker state, the card's memory), and
        fixed-bucket histograms for per-phase latency + coalesce size
        (DPF_CUDA_METRICS_BUCKETS_MS).  Counter equality with /v1/stats
        is structural: both render one snapshot dict.
  /v1/trace (GET)                             -> the flight recorder
        (obs/trace.py; DPF_CUDA_TRACE / DPF_CUDA_TRACE_RING): one span
        tree per recent request — ingress/admission/queue_wait/coalesce/
        dispatch/plan_lookup/compute/d2h/reply, with shed / expired /
        breaker-rejected outcomes recorded too.  Query params:
        ?n=N (recent N), ?slowest=1, ?id=<trace-id>, ?outcome=shed|....
        Trace ids arrive via the X-DPF-Trace request header (the Go
        client stamps one per request) or are generated at ingress.
  /v1/profile (POST, JSON)                    -> on-demand torch.profiler
        capture of the LIVE process (obs/profile.py): {"action":
        "start"|"stop"|"status"[, "seconds": S][, "dir": path]}.  Refused
        (403) unless DPF_CUDA_PROFILE_ALLOW is set; every capture stops
        itself after min(S, DPF_CUDA_PROFILE_MAX_S); stop writes
        trace.json (a Chrome trace) into the reported directory.

Run: ``python -m dpf_tpu_torch.server --port 8990`` (on the card), or
``--device cpu``.
"""

from __future__ import annotations

import argparse
import math
import socket
import struct
import threading
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse

from .core import knobs
from .core.device import resolve_device
from .obs import trace as obs_trace
from .serving import faults, handlers
from .serving.handlers import (  # noqa: F401 — the sidecar's public surface
    reset_serving_state,
)
from .serving.headers import (  # noqa: F401 — shared wire vocabulary
    DEADLINE_HEADER,
    RETRY_AFTER_HEADER,
    TRACE_HEADER,
)

# Back-compat aliases: tests and benches reach the serving singleton
# through this module (the machinery itself lives in serving/handlers).
_serving_state = handlers.serving_state
_evalfull_out_bytes = handlers._evalfull_out_bytes


class _Handler(BaseHTTPRequestHandler):
    server_version = "dpf-cuda-sidecar/1"
    # HTTP/1.1 so connections persist (BaseHTTPRequestHandler defaults to
    # 1.0, which closes after every response — that would defeat both the
    # Go client's pooled keep-alive Transport and the micro-batcher, whose
    # coalescing needs requests to ARRIVE concurrently, not serialized
    # behind per-request TCP handshakes).  Safe here: every response path
    # sends an exact Content-Length, including the streaming one.
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):  # quiet by default
        pass

    def _abort_connection(self):
        """Hard-abort the connection: SO_LINGER(1, 0) + close sends a
        TCP RST, so a mid-stream failure is an unambiguous connection
        error at the client — never a silently truncated body that
        parses as a short-but-well-formed reply."""
        try:
            self.connection.setsockopt(
                socket.SOL_SOCKET, socket.SO_LINGER,
                struct.pack("ii", 1, 0),
            )
        except OSError:
            pass
        try:
            self.connection.close()
        except OSError:
            pass
        self.close_connection = True

    def _write_reply(self, reply: handlers.Reply) -> None:
        """One buffered Reply onto the socket: status line, exact
        Content-Length, Retry-After when the error carries a backoff
        hint, then the gathered body chunks (buffer views write without
        an intermediate join)."""
        self.send_response(reply.status)
        self.send_header("Content-Type", reply.ctype)
        self.send_header("Content-Length", str(reply.body_len))
        if reply.retry_after_s is not None:
            self.send_header(
                RETRY_AFTER_HEADER,
                str(max(1, math.ceil(reply.retry_after_s))),
            )
        self.end_headers()
        for chunk in reply.chunks:
            self.wfile.write(chunk)
        if reply.close_connection:
            # The handler left body bytes unread (an error mid-upload):
            # the next pipelined request would parse mid-body.
            self.close_connection = True

    def _write_stream(self, reply: handlers.Reply, st) -> None:
        """A progressive Reply (streamed EvalFull): exact Content-Length
        up front, each generated chunk written as it arrives.  The
        status line is already committed when a mid-stream failure
        (deadline, injected chunk fault, dispatch error) surfaces, so
        the only honest signal is an aborted connection — truncation is
        a loud client-side error, and a keep-alive client can never
        read the next response out of frame."""
        self.send_response(reply.status)
        self.send_header("Content-Type", reply.ctype)
        self.send_header("Content-Length", str(reply.stream_len))
        self.end_headers()
        written = 0
        aborted = False
        try:
            # Only the socket writes belong to the "reply" phase — the
            # generator's resumption does device dispatch + D2H, which
            # the stream's own timer already records as dispatch/d2h.
            for chunk in reply.stream:
                with st.phase("reply"):
                    self.wfile.write(chunk)
                written += handlers._blen(chunk)
        except Exception:  # noqa: BLE001
            aborted = True
        finally:
            if aborted or written != reply.stream_len:
                self._abort_connection()

    def _send(self, reply: handlers.Reply, st) -> None:
        if reply.stream is not None:
            self._write_stream(reply, st)
        elif reply.timed:
            # Serving replies: the write is a "reply" phase observation,
            # a reply span on the request's trace, and the reply.write
            # fault site (injected write failures map like any other).
            with st.phase("reply"), obs_trace.maybe_span(
                reply.trace, "reply"
            ):
                faults.fire("reply.write")
                self._write_reply(reply)
        else:
            self._write_reply(reply)

    def do_GET(self):
        url = urlparse(self.path)
        reply = handlers.respond_get(
            url.path, handlers.parse_params(url.query),
            _serving_state(self.server.device),
        )
        self._write_reply(reply)

    def do_POST(self):
        st = _serving_state(self.server.device)
        url = urlparse(self.path)
        route = url.path
        try:
            clen = int(self.headers.get("Content-Length", 0))
        except ValueError:
            # A malformed header is a clean 400, never a dropped
            # connection with a server-side traceback.
            self._write_reply(handlers._reply_error(
                "bad_request", "Content-Length is not an integer"
            ))
            self.close_connection = True  # the body, if any, is unread
            return
        req = handlers.Request(
            route=route,
            params=handlers.parse_params(url.query),
            content_length=clen,
            deadline_ms=self.headers.get(DEADLINE_HEADER),
            trace_id=self.headers.get(TRACE_HEADER),
            front="http",
        )
        if route in handlers.SINK_ROUTES:
            # Streamed uploads: the handler pulls the body through the
            # short-read-robust reader in route-sized chunks (ONE
            # reusable scratch buffer — the copy the ledger charges).
            req.body_reader = handlers.FileBodyReader(self.rfile, clen)
        else:
            # The HTTP/1.1 front's structural marshalling copy: the
            # body materializes once between socket and handler.
            req.body = self.rfile.read(clen)
        st.note_body("http", clen, clen)
        reply = handlers.respond(req, st)
        try:
            self._send(reply, st)
        except Exception as e:  # noqa: BLE001 — write-time failure
            # An injected reply.write fault (or a dispatch error inside
            # a timed write) maps exactly like a handler error; if the
            # socket itself is gone the error write below fails too and
            # http.server drops the connection.
            err = handlers.map_error(e, st)
            reply.outcome = err.outcome
            try:
                self._write_reply(err)
            except OSError:
                self.close_connection = True
        finally:
            # Shed/expired/breaker-rejected requests are recorded too —
            # an overload incident must be reconstructable from the
            # flight recorder after the fact.
            st.tracer.finish(reply.trace, reply.outcome)


def audit_knobs() -> list[str]:
    """Boot-time knob audit: warn about every DPF_CUDA_* env var present
    but not declared in the registry (a typo'd knob — e.g.
    a ``_MS`` where the knob says ``_US`` — would otherwise fail silent, quietly
    serving with the default).  Returns the unknown names (tests)."""
    unknown = knobs.audit_environ()
    for name in unknown:
        warnings.warn(
            f"unknown knob {name} is set but not declared in "
            "dpf_tpu_torch/core/knobs.py — a typo? It has NO effect",
            RuntimeWarning,
            stacklevel=2,
        )
    return unknown


class _Server(ThreadingHTTPServer):
    # A load-surviving sidecar must not drop SYNs at 4x offered load:
    # the stdlib default listen backlog (5) converts connection churn
    # into 1-3 s SYN-retransmit latency spikes at the CLIENT long before
    # the batcher's admission control ever sees the request.  Shedding
    # must happen in the application (429 + Retry-After), not in the
    # kernel's accept queue.
    request_queue_size = 128

    # The device every request of this server dispatches on.
    device = None


def _start(port: int, host: str, device) -> _Server:
    """Boot checks, then the bound server on ``device``: the knob audit,
    a refusal of a leaked DPF_CUDA_FAULTS spec (a boot error with the full
    message, not a mystery 500 on the first request), and the device
    (None: the card, raising without CUDA unless ``"cpu"``)."""
    dev = resolve_device(device)
    audit_knobs()
    faults.install_from_env()
    srv = _Server((host, port), _Handler)
    srv.device = dev
    return srv


def serve(port: int = 8990, host: str = "127.0.0.1", device=None) -> ThreadingHTTPServer:
    """Start the sidecar in a daemon thread on ``device`` (None: the card;
    ``"cpu"`` for the plain versions); returns the server object (call
    ``.shutdown()`` then ``.server_close()`` to stop).  One serving state
    serves the process: reset it (``reset_serving_state``) between servers
    on different devices."""
    srv = _start(port, host, device)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--port", type=int, default=8990)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default=None,
                    help='"cuda" (default: the card) or "cpu"')
    args = ap.parse_args()
    srv = _start(args.port, args.host, args.device)
    print(f"dpf-cuda sidecar on {args.host}:{args.port} ({srv.device})")
    srv.serve_forever()


if __name__ == "__main__":
    main()
