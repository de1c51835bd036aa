"""REST serving front end: transcription over HTTP, stdlib-only (this
package's own copy of the JAX package's ``server.py``, over the port's
``Transcriber``).

The reference stops at CSV-writing inference (src/infer.py:36-195); a
production deployment needs a network surface. This wraps the serving
stack (``Transcriber`` -> ``StreamingTranscriber`` request queue) in a
``ThreadingHTTPServer`` — concurrent POSTs are batched together by the
streaming queue, so HTTP concurrency translates directly into device batch
efficiency. No web framework: http.server + json only.

API (JSON in/out):

  GET  /healthz        liveness — 200 always (process is up)
  GET  /readyz         readiness — 200 once the warmup ladder's first
                       bucket is warm (Transcriber.wait_ready: the kernels
                       built and one batch run), else 503
  GET  /v1/meta        model/bucket metadata
  POST /v1/transcribe  {"features": [[...frame...], ...]}          -> {"transcript": str}
                       {"instances": [{"features": ...}, ...]}     -> {"transcripts": [str, ...]}

Features are per-utterance (T, input_dim) float lists/arrays; for
bandwidth-sensitive clients, ``"features_b64"`` carries the same frames as
base64 of row-major little-endian float32 (about half the bytes and far
cheaper to parse than a JSON float list). Malformed input -> 400 with
{"error": ...}; oversize batch -> 413.

Run it: ``python -m attention_based_e2e_asr_dnn_tpu_torch.tools.serve_http
experiments/<run> --port 8080``.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from attention_based_e2e_asr_dnn_tpu_torch.serving import (
    StreamingTranscriber,
    Transcriber,
)

_MAX_INSTANCES = 256  # per request; the streaming queue re-batches anyway


class _Metrics:
    """Thread-safe request metrics, rendered in Prometheus text format at
    GET /metrics. Tracks the transcribe POST path: per-status request
    counts, utterance throughput, an end-to-end latency histogram (covers
    queueing + batching + decode), and in-flight gauge."""

    BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

    def __init__(self):
        self._lock = threading.Lock()
        self.requests_by_status: dict = {}
        self.utterances = 0
        self.lat_sum = 0.0
        self.lat_count = 0
        self.lat_buckets = [0] * len(self.BUCKETS)
        self.in_flight = 0

    def observe(self, status: int, n_utts: int, seconds: float) -> None:
        with self._lock:
            self.requests_by_status[status] = (
                self.requests_by_status.get(status, 0) + 1)
            self.utterances += n_utts
            self.lat_sum += seconds
            self.lat_count += 1
            for i, edge in enumerate(self.BUCKETS):
                if seconds <= edge:
                    self.lat_buckets[i] += 1

    def render(self) -> str:
        with self._lock:
            lines = [
                "# HELP asr_requests_total transcribe requests by status",
                "# TYPE asr_requests_total counter",
            ]
            for status in sorted(self.requests_by_status):
                lines.append(
                    f'asr_requests_total{{status="{status}"}} '
                    f"{self.requests_by_status[status]}")
            lines += [
                "# HELP asr_utterances_total utterances transcribed",
                "# TYPE asr_utterances_total counter",
                f"asr_utterances_total {self.utterances}",
                "# HELP asr_request_seconds end-to-end request latency",
                "# TYPE asr_request_seconds histogram",
            ]
            for edge, count in zip(self.BUCKETS, self.lat_buckets):
                lines.append(
                    f'asr_request_seconds_bucket{{le="{edge}"}} {count}')
            lines += [
                f'asr_request_seconds_bucket{{le="+Inf"}} {self.lat_count}',
                f"asr_request_seconds_sum {self.lat_sum:.6f}",
                f"asr_request_seconds_count {self.lat_count}",
                "# HELP asr_in_flight transcribe requests currently "
                "being handled",
                "# TYPE asr_in_flight gauge",
                f"asr_in_flight {self.in_flight}",
            ]
        return "\n".join(lines) + "\n"


class _InFlight:
    """Context manager bumping the in-flight gauge for one request."""

    def __init__(self, metrics: _Metrics):
        self._m = metrics

    def __enter__(self):
        with self._m._lock:
            self._m.in_flight += 1

    def __exit__(self, *exc):
        with self._m._lock:
            self._m.in_flight -= 1
        return False


class AsrHttpServer:
    """HTTP front end over a Transcriber. ``port=0`` picks a free port
    (recorded in ``self.port``). Use ``start()`` for a background thread or
    ``serve_forever()`` to block; ``close()`` drains and shuts down."""

    def __init__(
        self,
        transcriber: Transcriber,
        host: str = "127.0.0.1",
        port: int = 8080,
        max_wait_ms: float = 10.0,
        max_body_bytes: int = 128 * 1024 * 1024,
    ):
        self.max_body_bytes = max_body_bytes
        self.transcriber = transcriber
        self.streaming = StreamingTranscriber(transcriber,
                                              max_wait_ms=max_wait_ms)
        self.metrics = _Metrics()
        server = self

        class Handler(BaseHTTPRequestHandler):
            # quiet per-request stderr logging; errors still surface as
            # HTTP statuses
            def log_message(self, fmt, *args):
                pass

            def _send(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {"ok": True})
                elif self.path == "/readyz":
                    try:
                        ready = server.transcriber.wait_ready(timeout=0.0)
                    except RuntimeError as exc:  # background warmup died
                        self._send(503, {"ready": False,
                                         "error": str(exc)})
                        return
                    self._send(200 if ready else 503, {"ready": ready})
                elif self.path == "/v1/meta":
                    t = server.transcriber
                    meta = {
                        "input_dim": t.n_feats,
                        "batch_size": t.batch_size,
                        "pad_time_multiple": t.pad_time_multiple,
                        "vocab_size": len(t.vocab),
                        "corrector": t.corrector is not None,
                        # a transcriber with a hard frame cap reports it;
                        # null = any length accepted
                        "max_frames": getattr(t, "max_frames", None),
                        "buckets": getattr(t, "bucket_t_pads", None),
                    }
                    self._send(200, meta)
                elif self.path == "/metrics":
                    body = server.metrics.render().encode("utf-8")
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                t0 = time.monotonic()
                with _InFlight(server.metrics):
                    code, payload, n_utts = self._handle_post()
                    # observe BEFORE writing the response: a client that
                    # hung up makes _send raise, and the slow requests it
                    # abandons are exactly the ones operators need counted
                    server.metrics.observe(code, n_utts,
                                           time.monotonic() - t0)
                self._send(code, payload)

            def _handle_post(self):
                if self.path != "/v1/transcribe":
                    return 404, {"error": f"no route {self.path}"}, 0
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    if length <= 0:
                        # a NEGATIVE length would make read() block until
                        # connection close — an unauthenticated thread-
                        # exhaustion hole; zero/missing is just a bad call
                        return 400, {"error": "missing or invalid "
                                              "Content-Length"}, 0
                    if length > server.max_body_bytes:
                        return 413, {
                            "error": f"body {length} bytes > limit "
                                     f"{server.max_body_bytes}"}, 0
                    req = json.loads(self.rfile.read(length))
                except (ValueError, json.JSONDecodeError) as exc:
                    return 400, {"error": f"bad JSON: {exc}"}, 0
                try:
                    texts, single = server._transcribe_request(req)
                except _BadRequest as exc:
                    return exc.code, {"error": str(exc)}, 0
                except Exception as exc:  # decode failure -> 500
                    return 500, {
                        "error": f"{type(exc).__name__}: {exc}"}, 0
                if single:
                    return 200, {"transcript": texts[0]}, 1
                return 200, {"transcripts": texts}, len(texts)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # -- request handling ---------------------------------------------------

    def _parse_features(self, obj, where: str) -> np.ndarray:
        b64 = None
        if isinstance(obj, dict):
            b64 = obj.get("features_b64")
            obj = obj.get("features")
        if b64 is not None:
            # compact wire format: base64 of row-major little-endian
            # float32 — ~half the bytes of a JSON float list and decoded
            # by one frombuffer instead of a million-literal JSON parse
            import base64

            try:
                raw = base64.b64decode(b64, validate=True)
            except Exception as exc:
                raise _BadRequest(400, f"{where}: bad features_b64 ({exc})")
            n_feats = self.transcriber.n_feats
            if len(raw) == 0 or len(raw) % (4 * n_feats):
                raise _BadRequest(
                    400, f"{where}: features_b64 has {len(raw)} bytes — "
                         f"not a whole number of {n_feats}-dim float32 "
                         f"frames")
            arr = np.frombuffer(raw, dtype="<f4").reshape(-1, n_feats)
        elif obj is None:
            raise _BadRequest(
                400, f"{where}: missing 'features' (or 'features_b64')")
        else:
            try:
                arr = np.asarray(obj, dtype=np.float32)
            except (ValueError, TypeError) as exc:
                raise _BadRequest(400,
                                  f"{where}: not a numeric array ({exc})")
        if arr.ndim != 2 or arr.shape[0] == 0:
            raise _BadRequest(
                400, f"{where}: features must be (T, input_dim), "
                     f"got shape {arr.shape}")
        if arr.shape[1] != self.transcriber.n_feats:
            raise _BadRequest(
                400, f"{where}: feature dim {arr.shape[1]} != model "
                     f"input_dim {self.transcriber.n_feats}")
        cap = getattr(self.transcriber, "max_frames", None)
        if cap is not None and arr.shape[0] > cap:
            # reject BEFORE batching: raising inside the shared streaming
            # batch would 500 every co-batched request
            raise _BadRequest(
                400, f"{where}: {arr.shape[0]} frames > server capacity "
                     f"{cap}")
        return arr

    def _transcribe_request(self, req):
        if not isinstance(req, dict):
            raise _BadRequest(400, "request body must be a JSON object")
        if "instances" in req:
            instances = req["instances"]
            if not isinstance(instances, list) or not instances:
                raise _BadRequest(400, "'instances' must be a non-empty list")
            if len(instances) > _MAX_INSTANCES:
                raise _BadRequest(
                    413, f"{len(instances)} instances > limit "
                         f"{_MAX_INSTANCES}")
            feats = [self._parse_features(inst, f"instances[{i}]")
                     for i, inst in enumerate(instances)]
            single = False
        else:
            feats = [self._parse_features(req, "request")]
            single = True
        futures = [self.streaming.submit(f) for f in feats]
        return [f.result() for f in futures], single

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "AsrHttpServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join()
        self.streaming.close()


class _BadRequest(Exception):
    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code
