"""Network front door — the wire half of the continual service.

Port of ``lightgbm_tpu/service/frontdoor.py``: a stdlib threaded HTTP
server over the serving tier's ``submit()``:

- **routes**: ``POST /v1/predict`` and ``POST /v1/explain`` (a solo
  server), ``POST /v1/tenants/<name>/predict`` and
  ``POST /v1/tenants/<name>/explain`` (a fleet), ``GET /healthz``,
  ``GET /readyz``, ``GET /v1/stats``. Explain answers per-row SHAP
  contribution matrices ``[rows, (F+1)*k]`` through the coalesced explain
  route (``submit(kind="contrib")``), with the same body formats and
  failure map as predict.
- **liveness vs readiness**: ``/healthz`` says the process is alive and
  speaks HTTP; it stays 200 while the tier is degraded to the host walk,
  since restarting a live process never fixes degradation. ``/readyz``
  says whether a load balancer should route fresh traffic here: **503**
  while the tier is degraded or any tenant is quarantined by the
  integrity probe (``serving/fleet.py``). Both are 503 once closed.
- **bodies**: ``application/json`` (``{"rows": [[...], ...]}``) or raw
  ``application/x-npy`` (an ``np.save`` payload — exact f64 on the wire);
  the response mirrors the request's format.
- **wire deadlines**: ``X-Deadline-Ms`` rides into the serving tier's
  deadline path: an expired request is dropped BEFORE coalescing and
  answers **504**. Admission control's ``Overloaded`` is **429** (with
  ``Retry-After``), shutdown **503**, a malformed body, shape or a value
  f32 cannot hold **400**, an unknown route or tenant **404**, an
  oversize body **413**. A malformed request fails only its own
  connection: ``submit()`` validates it before it can join a batch.
- **streaming**: a response of more than ``chunk_rows`` rows goes out
  chunked (``Transfer-Encoding: chunked``).
- **freshness**: every response carries ``X-Model-Generation`` and, when
  the gateway knows the generation's training watermark,
  ``X-Watermark-Rows``, ``X-Watermark-Ts`` and ``X-Staleness-Ms``
  (response time minus the newest training row the model saw); the
  gateway records each staleness so ``/v1/stats`` reports its p50/p99.

The handler touches only the gateway's ``submit``/``stats``/
``freshness`` surface: the device, batching and failure machinery stay
in ``serving/``.
"""
from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..serving.batcher import (DeadlineExceeded, Overloaded,
                               ShutdownError)
from ..serving.metrics import LatencyRecorder
from ..utils import log


class ServerGateway:
    """Adapter mounting a plain :class:`~..serving.ModelServer` (or a
    ``FleetServer``) behind the front door. The continual service
    (``service/__init__.py``) implements the same surface with live
    watermarks; this adapter serves static models (watermarks optional
    through ``set_watermark``)."""

    def __init__(self, server, fleet=None):
        self.server = server
        self.fleet = fleet
        self.staleness = LatencyRecorder()
        self._marks = {}

    def submit(self, X, deadline_ms=None, tenant: Optional[str] = None,
               kind: str = "score"):
        if tenant is not None:
            if self.fleet is None:
                raise KeyError(tenant)
            return self.fleet.submit(tenant, X, deadline_ms=deadline_ms,
                                     kind=kind)
        if self.server is None:
            raise KeyError("no solo server mounted")
        return self.server.submit(X, deadline_ms=deadline_ms, kind=kind)

    def set_watermark(self, version: int, rows: int, ts: float,
                      iteration: Optional[int] = None) -> None:
        self._marks[int(version)] = {
            "watermark_rows": int(rows), "watermark_ts": float(ts),
            **({"iteration": int(iteration)}
               if iteration is not None else {})}

    def freshness(self, version: int) -> Optional[dict]:
        return self._marks.get(int(version))

    def stats(self) -> dict:
        src = self.server if self.server is not None else self.fleet
        s = src.stats()
        s.update({f"staleness_{k}": v
                  for k, v in self.staleness.summary_ms().items()
                  if k != "n"})
        return s

    @property
    def closed(self) -> bool:
        src = self.server if self.server is not None else self.fleet
        return bool(getattr(src, "closed", False))

    @property
    def degraded(self) -> bool:
        src = self.server if self.server is not None else self.fleet
        return bool(src.stats().get("degraded"))


class FrontDoor:
    """Threaded HTTP server over a gateway (``ServerGateway`` or the
    ``ContinualService`` itself). ``port=0`` binds an ephemeral port
    (``.port`` carries the real one)."""

    def __init__(self, gateway, host: str = "127.0.0.1", port: int = 0,
                 max_body_mb: float = 64.0, chunk_rows: int = 4096,
                 result_timeout_s: float = 120.0):
        self.gateway = gateway
        self.max_body_bytes = int(max_body_mb * (1 << 20))
        self.chunk_rows = int(chunk_rows)
        self.result_timeout_s = float(result_timeout_s)
        self.t_started = time.time()
        door = self

        class Handler(_Handler):
            frontdoor = door

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.host, self.port = self.httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True,
            name="lgbm-frontdoor")
        self._thread.start()
        log.info(f"front door listening on {self.host}:{self.port}")

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(10.0)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    frontdoor: FrontDoor = None       # bound per FrontDoor subclass

    # -- plumbing ------------------------------------------------------
    def log_message(self, fmt, *args):   # stdlib default spams stderr
        log.debug(f"frontdoor: {fmt % args}")

    def _fail(self, code: int, message: str, retry_after: bool = False
              ) -> None:
        body = json.dumps({"error": message}).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if retry_after:
            self.send_header("Retry-After", "1")
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _send_body(self, code: int, body: bytes, ctype: str,
                   headers=()) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_chunked(self, code: int, chunks, ctype: str,
                      headers=()) -> None:
        """Manual chunked framing (BaseHTTPRequestHandler leaves
        transfer encoding to the handler)."""
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Transfer-Encoding", "chunked")
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        for chunk in chunks:
            if not chunk:
                continue
            self.wfile.write(f"{len(chunk):x}\r\n".encode())
            self.wfile.write(chunk)
            self.wfile.write(b"\r\n")
        self.wfile.write(b"0\r\n\r\n")

    # -- GET -----------------------------------------------------------
    def do_GET(self) -> None:  # noqa: N802 — stdlib contract
        door = self.frontdoor
        try:
            if self.path == "/healthz":
                gw = door.gateway
                status = ("closed" if gw.closed else
                          "degraded" if gw.degraded else "ok")
                body = {"status": status,
                        "uptime_sec": round(time.time() - door.t_started,
                                            1)}
                self._send_body(200 if status != "closed" else 503,
                                json.dumps(body).encode(),
                                "application/json")
                return
            if self.path == "/readyz":
                gw = door.gateway
                closed = bool(getattr(gw, "closed", False))
                st = {} if closed else gw.stats()
                quarantined = sorted(st.get("quarantined") or [])
                degraded = bool(st.get("degraded"))
                ready = not (closed or degraded or quarantined)
                body = {"ready": ready,
                        "status": ("closed" if closed else
                                   "degraded" if degraded else
                                   "quarantined" if quarantined
                                   else "ok")}
                if quarantined:
                    body["quarantined"] = quarantined
                self._send_body(200 if ready else 503,
                                json.dumps(body).encode(),
                                "application/json")
                return
            if self.path == "/v1/stats":
                self._send_body(200,
                                json.dumps(door.gateway.stats(),
                                           default=str).encode(),
                                "application/json")
                return
            self._fail(404, f"no route {self.path!r}")
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:    # noqa: BLE001 — wire boundary
            self._fail(500, repr(e))

    # -- POST ----------------------------------------------------------
    def _read_request(self):
        """(X, fmt) from the body, or raises ValueError for 400s."""
        ln = self.headers.get("Content-Length")
        if ln is None:
            raise ValueError("Content-Length required")
        try:
            n = int(ln)
        except ValueError:
            raise ValueError(f"bad Content-Length {ln!r}")
        if n < 0:
            # read(-1) would block on a keep-alive socket until the
            # client hangs up — pinning one handler thread forever
            raise ValueError(f"bad Content-Length {ln!r}")
        if n > self.frontdoor.max_body_bytes:
            # drain the declared body first: responding 413 with unread
            # bytes in flight makes the CLIENT die on a broken pipe
            # before it ever sees the status. Bounded at 4x the cap —
            # past that the connection is closed instead of drained.
            left = min(n, 4 * self.frontdoor.max_body_bytes)
            while left > 0:
                got = self.rfile.read(min(left, 1 << 20))
                if not got:
                    break
                left -= len(got)
            self.close_connection = True
            return None, None      # sentinel: 413 handled by caller
        body = self.rfile.read(n)
        ctype = (self.headers.get("Content-Type") or
                 "application/json").split(";")[0].strip().lower()
        if ctype == "application/x-npy":
            try:
                X = np.load(io.BytesIO(body), allow_pickle=False)
            except Exception as e:
                raise ValueError(f"unparseable npy body: {e!r}")
            return np.asarray(X, np.float64), "npy"
        if ctype == "application/json":
            try:
                obj = json.loads(body)
                rows = obj["rows"]
            except Exception as e:
                raise ValueError(f"unparseable JSON body: {e!r}")
            try:
                X = np.asarray(rows, np.float64)
            except Exception as e:
                raise ValueError(f"rows are not a numeric matrix: {e!r}")
            return X, "json"
        raise ValueError(f"unsupported Content-Type {ctype!r} (use "
                         "application/json or application/x-npy)")

    def do_POST(self) -> None:  # noqa: N802 — stdlib contract
        door = self.frontdoor
        tenant = None
        kind = "score"
        path = self.path
        if path.startswith("/v1/tenants/") and \
                path.endswith("/predict"):
            tenant = path[len("/v1/tenants/"):-len("/predict")]
        elif path.startswith("/v1/tenants/") and \
                path.endswith("/explain"):
            tenant = path[len("/v1/tenants/"):-len("/explain")]
            kind = "contrib"
        elif path == "/v1/explain":
            kind = "contrib"
        elif path != "/v1/predict":
            self._fail(404, f"no route {path!r}")
            return
        try:
            try:
                X, fmt = self._read_request()
            except ValueError as e:
                self._fail(400, str(e))
                return
            if X is None:
                self._fail(413, "request body exceeds "
                           f"{door.max_body_bytes} bytes")
                return
            deadline_ms = None
            hdr = self.headers.get("X-Deadline-Ms")
            if hdr is not None:
                try:
                    deadline_ms = float(hdr)
                except ValueError:
                    self._fail(400, f"bad X-Deadline-Ms {hdr!r}")
                    return
            t0 = time.time()
            try:
                fut = door.gateway.submit(X, deadline_ms=deadline_ms,
                                          tenant=tenant, kind=kind)
            except Overloaded as e:
                self._fail(429, str(e), retry_after=True)
                return
            except (ValueError, TypeError) as e:
                self._fail(400, str(e))
                return
            except KeyError as e:
                self._fail(404, f"unknown tenant {e}")
                return
            except RuntimeError as e:
                # closed batcher / server shutting down
                self._fail(503, str(e))
                return
            timeout = door.result_timeout_s
            if deadline_ms:
                timeout = min(timeout, deadline_ms / 1e3 + 30.0)
            try:
                scores = fut.result(timeout)
            except DeadlineExceeded as e:
                self._fail(504, str(e))
                return
            except ShutdownError as e:
                self._fail(503, str(e))
                return
            except TimeoutError as e:
                self._fail(504, f"DEADLINE_EXCEEDED: {e}")
                return
            self._respond_scores(scores, fut, fmt, tenant, t0)
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:    # noqa: BLE001 — wire boundary
            log.warning(f"frontdoor 500: {e!r}")
            try:
                self._fail(500, repr(e))
            except Exception:     # noqa: BLE001 — client gone
                pass

    def _respond_scores(self, scores, fut, fmt, tenant, t0) -> None:
        door = self.frontdoor
        gen = fut.generation
        version = getattr(gen, "version", None)
        headers = []
        if version is not None:
            headers.append(("X-Model-Generation", str(version)))
            headers.append(("X-Model-Trees",
                            str(getattr(gen, "num_trees", ""))))
        mark = door.gateway.freshness(version) \
            if version is not None else None
        staleness_ms = None
        if mark is not None:
            headers.append(("X-Watermark-Rows",
                            str(mark["watermark_rows"])))
            headers.append(("X-Watermark-Ts",
                            repr(mark["watermark_ts"])))
            staleness_ms = max((t0 - mark["watermark_ts"]) * 1e3, 0.0)
            headers.append(("X-Staleness-Ms", f"{staleness_ms:.3f}"))
            door.gateway.staleness.record(staleness_ms / 1e3)
        out = np.asarray(scores)
        if fmt == "npy":
            buf = io.BytesIO()
            np.save(buf, out, allow_pickle=False)
            payload = buf.getvalue()
            if out.shape[0] > door.chunk_rows:
                step = max(1 << 16, 1)
                self._send_chunked(
                    200, (payload[i:i + step]
                          for i in range(0, len(payload), step)),
                    "application/x-npy", headers)
            else:
                self._send_body(200, payload, "application/x-npy",
                                headers)
            return
        meta = {"generation": version,
                "num_trees": getattr(gen, "num_trees", None)}
        if tenant is not None:
            meta["tenant"] = tenant
        if staleness_ms is not None:
            meta["staleness_ms"] = round(staleness_ms, 3)
            meta["watermark"] = mark
        if out.shape[0] > door.chunk_rows:
            # stream: {"meta": ..., "scores": [r0, r1, ...]} with the
            # scores array emitted in chunk_rows segments
            def chunks():
                yield (b'{"meta": ' + json.dumps(meta).encode() +
                       b', "scores": [')
                first = True
                for lo in range(0, out.shape[0], door.chunk_rows):
                    seg = json.dumps(
                        out[lo:lo + door.chunk_rows].tolist())[1:-1]
                    yield (b"" if first else b", ") + seg.encode()
                    first = False
                yield b"]}"
            self._send_chunked(200, chunks(), "application/json",
                               headers)
            return
        body = json.dumps({"meta": meta, "scores": out.tolist()}
                          ).encode()
        self._send_body(200, body, "application/json", headers)
