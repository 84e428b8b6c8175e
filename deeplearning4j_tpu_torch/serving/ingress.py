"""HTTP request ingress: the network front door onto the serving
engine — the port of ``deeplearning4j_tpu/serving/ingress.py``.

A stdlib ``http.server`` stack (threaded, zero dependencies) puts
:class:`~deeplearning4j_tpu_torch.serving.server.ModelServer` on a wire:
it maps wire requests onto ``submit()`` with **end-to-end deadline
propagation** and the documented error taxonomy (``serving.errors`` —
each exception carries its wire ``status_code``/``retriable``, so the
contract lives in one place).

Endpoints::

    POST /v1/models/<name>:predict      one inference request
    GET  /v1/models                     routing table snapshot
    GET  /v1/models/<name>              one model's versions/state
    GET  /v1/load                       autoscaling / LB hints
    GET  /healthz                       process + breaker liveness
    GET  /readyz                        warmed & admitting (LB rotation)
    GET  /metrics                       this process's registry (OpenMetrics
                                        with exemplars when negotiated)
    GET  /v1/fleet/metrics              merged cross-host exposition
    GET  /v1/fleet/load                 merged autoscaling hints
    GET  /v1/slo                        SLO burn-rate verdict

The fleet endpoints answer from a ``profiler.aggregate.MetricsAggregator``
(``fleet=`` / :meth:`HttpIngress.attach_fleet`, typically fed by a
``FleetScraper``) and ``/v1/slo`` from a ``profiler.slo.SLOGate``
(``slo=`` / :meth:`HttpIngress.attach_slo`); without one attached each
answers 404, as in the JAX package. A failing SLO answers 200 with
``passing: false``: the endpoint reports budget state, ``/healthz`` and
``/readyz`` own liveness.

Tracing: predict requests honor an incoming W3C ``traceparent`` header
(else mint a fresh trace); responses — success and error alike — carry
``trace_id`` in the JSON and a ``traceparent`` response header, and the
flow records ``ingress:request`` / ``serve:*`` / ``ingress:respond``
spans when tracing is enabled (see ``profiler.tracecontext``).

Predict bodies (Content-Type):

- ``application/json``: ``{"instances": [[...], ...]}`` (row-major
  feature rows; ``"deadline_ms"`` may ride in the body too).
- ``application/octet-stream``: a raw little-endian tensor;
  ``X-Tensor-Shape: 8,3,224,224`` (required) and ``X-Tensor-Dtype``
  (default float32) describe it — the zero-copy path for fat clients.
- ``image/*``: one raw encoded image (JPEG/PNG); the model's
  :class:`DecodePreset` decodes/resizes it to ``[1, C, H, W]`` (with
  ``cv2`` when importable, else PIL, imported at the first image).

Deadline semantics: a ``deadline_ms`` header (also accepted:
``X-Deadline-Ms``, or ``deadline_ms`` in a JSON body) becomes the
request's server-side deadline. A request whose deadline expires while
queued is shed *before dispatch* and surfaces as **504** carrying the
server-stamped wait (``latency_ms``) — the client's budget, enforced at
the server, end to end. Responses from completed requests carry the
same server-stamped ``latency_ms`` (admission to resolution).

Error taxonomy on the wire (see ``serving.errors`` for the table):
429 overload, 503 draining / breaker-open / closed (all with
``Retry-After`` and ``"retriable": true``), 504 deadline exceeded
(``"retriable": false`` — the budget is spent), 404 unknown model or
version, 400 malformed body, 413 oversized body, 415 image body with
no decode preset, 500 dispatch failure after retries.

Hot-swap rides underneath: the ingress routes by *name* through a
:class:`~deeplearning4j_tpu_torch.serving.registry.ModelRegistry`, so a
``roll()`` moves traffic atomically between captured versions without the
ingress (or any client) noticing — responses stamp the serving version.
A bare :class:`ModelServer` is also accepted and served as the model
``"default"``.

Metrics: ``dl4j_ingress_requests_total{code=}``,
``dl4j_ingress_latency_seconds`` (wire-side, recv to response write),
``dl4j_ingress_disconnects_total`` (client vanished mid-response).
"""

from __future__ import annotations

import io
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from deeplearning4j_tpu_torch import profiler as _prof
from deeplearning4j_tpu_torch.profiler import tracecontext as _tracectx
from deeplearning4j_tpu_torch.serving.errors import ServingError

logger = logging.getLogger("deeplearning4j_tpu_torch")

_REG = _prof.get_registry()
INGRESS_REQUESTS = _REG.counter(
    "dl4j_ingress_requests_total",
    "Ingress responses by HTTP status code",
    labelnames=("code",))
INGRESS_LATENCY = _REG.histogram(
    "dl4j_ingress_latency_seconds",
    "Wire-side request latency: body received to response written "
    "(predict requests only)")
INGRESS_DISCONNECTS = _REG.counter(
    "dl4j_ingress_disconnects_total",
    "Clients that vanished mid-request (read failure or broken pipe "
    "while writing the response)")

#: default Retry-After (seconds) for retriable errors that carry no
#: better hint (overload / draining / closed); the breaker's own
#: cooldown wins when present
DEFAULT_RETRY_AFTER = 1.0


# ------------------------------------------------------------ decode preset
class DecodePreset:
    """Raw-image request decoding for one model route: the same
    (height, width, channels) contract as the training pipeline's
    decode stage, applied to an encoded request body.

    ``scale`` multiplies the decoded uint8 pixels (e.g. ``1/255`` for
    nets trained on normalized input); default leaves raw ``[0, 255]``
    floats, matching ``ImagePreProcessingScaler``-free configs.
    """

    def __init__(self, height: int, width: int, channels: int = 3,
                 scale: Optional[float] = None, dtype=np.float32):
        self.height = int(height)
        self.width = int(width)
        self.channels = int(channels)
        self.scale = scale
        self.dtype = np.dtype(dtype)

    @classmethod
    def from_pipeline(cls, pipeline, scale: Optional[float] = None
                      ) -> "DecodePreset":
        """Wire an :class:`~deeplearning4j_tpu_torch.data.pipeline.
        ImagePipeline`'s declared decode stage (or a built
        ``StagedImageIterator``) into the request path: the serving
        decode is exactly the training decode — same geometry, same
        channel order."""
        decode = getattr(pipeline, "_decode", None)
        if decode is not None:       # an ImagePipeline builder
            p = decode.params
            return cls(p["height"], p["width"], p["channels"], scale=scale)
        if hasattr(pipeline, "height") and hasattr(pipeline, "width"):
            return cls(pipeline.height, pipeline.width,
                       getattr(pipeline, "channels", 3), scale=scale)
        raise TypeError(
            "from_pipeline wants an ImagePipeline with a decode stage "
            "(or a built StagedImageIterator)")

    def decode(self, data: bytes) -> np.ndarray:
        """Encoded image bytes -> ``[1, C, H, W]`` feature tensor."""
        try:
            import cv2
            flag = (cv2.IMREAD_GRAYSCALE if self.channels == 1
                    else cv2.IMREAD_COLOR)
            img = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
            if img is None:
                raise ValueError("cv2 failed to decode the image body")
            if img.shape[:2] != (self.height, self.width):
                img = cv2.resize(img, (self.width, self.height),
                                 interpolation=cv2.INTER_LINEAR)
            if self.channels == 1:
                img = img[:, :, None]
            else:
                img = img[:, :, ::-1]           # BGR -> RGB (PIL parity)
            chw = np.transpose(img, (2, 0, 1))
        except ImportError:
            from PIL import Image
            img = Image.open(io.BytesIO(data)).convert(
                "L" if self.channels == 1 else "RGB")
            if img.size != (self.width, self.height):
                img = img.resize((self.width, self.height), Image.BILINEAR)
            arr = np.asarray(img, np.uint8)
            if arr.ndim == 2:
                arr = arr[:, :, None]
            chw = np.transpose(arr, (2, 0, 1))
        out = chw.astype(self.dtype)
        if self.scale is not None:
            out = out * self.dtype.type(self.scale)
        return out[None]

    def __repr__(self):
        return (f"DecodePreset({self.height}x{self.width}x{self.channels}"
                f"{', scale=%g' % self.scale if self.scale else ''})")


# ------------------------------------------------------------ router shims
class _SingleModelRouter:
    """Serve a bare ModelServer through the registry-shaped routing
    surface the handler speaks, as the model ``"default"``."""

    def __init__(self, server, decode: Optional[DecodePreset] = None):
        self._server = server
        self._decode = decode

    def submit(self, name, x, deadline=None, version=None, trace=None):
        self._resolve(name, version)
        return self._server.submit(x, deadline=deadline, trace=trace)

    def _resolve(self, name, version):
        from deeplearning4j_tpu_torch.serving.registry import ModelNotFoundError
        if name != "default" or version not in (None, 1):
            raise ModelNotFoundError(name, version)

    def decode_preset(self, name):
        self._resolve(name, None)
        return self._decode

    def active_version(self, name):
        self._resolve(name, None)
        return 1

    def models(self):
        return {"default": {
            "active": 1, "previous": None,
            "accepts_images": self._decode is not None,
            "versions": {1: {"state": self._server.state,
                             "ready": self._server.ready,
                             "retired": False,
                             "warmed_shapes": [
                                 list(s) for s in
                                 self._server._warm_shapes]}}}}

    def load_hints(self):
        hints = self._server.load_hints()
        hints["version"] = 1
        return {"models": {"default": hints},
                "totals": {"queue_depth": hints["queue_depth"],
                           "max_queue": hints["max_queue"],
                           "shed_rate": hints["shed_rate"],
                           "ready": hints["ready"],
                           "breakers_open":
                               1 if hints["breaker"] == "open" else 0}}

    @property
    def ready(self):
        return self._server.ready

    @property
    def healthy(self):
        return self._server.healthy


def _as_router(target, decode=None):
    if hasattr(target, "submit") and hasattr(target, "models"):
        return target                      # a ModelRegistry (or lookalike)
    if hasattr(target, "submit"):
        return _SingleModelRouter(target, decode=decode)
    raise TypeError(
        f"HttpIngress wants a ModelRegistry or ModelServer, got "
        f"{type(target).__name__}")


# ------------------------------------------------------------------ handler
def _jsonable(out):
    if isinstance(out, tuple):
        return [_jsonable(o) for o in out]
    return np.asarray(out).tolist()


class _IngressHandler(BaseHTTPRequestHandler):
    # bound socket reads: a stalled client holds one handler thread, not
    # the server — ThreadingHTTPServer keeps accepting
    timeout = 60.0
    protocol_version = "HTTP/1.1"

    @property
    def ingress(self) -> "HttpIngress":
        return self.server.dl4j_ingress

    def log_message(self, *a):           # silence per-request stderr noise
        pass

    # --------------------------------------------------------- plumbing
    # per-request trace context, stamped by _predict; None for the GET
    # surface (reset per request: a keep-alive connection reuses the
    # handler instance and must not leak one request's trace to the next)
    _trace: Optional[_tracectx.TraceContext] = None

    def _respond(self, code: int, payload: dict,
                 retry_after: Optional[float] = None):
        trace = self._trace
        if trace is not None and isinstance(payload, dict):
            # every response in a traced flow — success OR error —
            # reports its trace_id, so clients/logs can correlate
            payload.setdefault("trace_id", trace.trace_id)
        body = json.dumps(payload).encode()
        t0_us = _prof.now_us()
        try:
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if trace is not None:
                self.send_header("traceparent", trace.to_traceparent())
            if retry_after is not None:
                self.send_header("Retry-After", f"{max(retry_after, 0.0):g}")
            if self.close_connection:
                # a refusal that left the body unread must advertise the
                # close, or a keep-alive client would pipeline into a
                # desynced stream
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError, OSError):
            # the client hung up mid-response: nothing to answer, but
            # the server must not care (wire-chaos pin)
            INGRESS_DISCONNECTS.inc()
            self.close_connection = True
        _tracectx.record_span(
            "ingress:respond",
            trace.child() if trace is not None else None,
            t0_us, _prof.now_us() - t0_us,
            args={"code": code, "bytes": len(body)})
        INGRESS_REQUESTS.labels(code=str(code)).inc()

    def _respond_text(self, code: int, text: str, content_type: str):
        """Non-JSON response (the metrics expositions)."""
        body = text.encode("utf-8")
        try:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError, OSError):
            INGRESS_DISCONNECTS.inc()
            self.close_connection = True
        INGRESS_REQUESTS.labels(code=str(code)).inc()

    def _error(self, code: int, message: str, *, typ: str = None,
               retriable: Optional[bool] = None,
               retry_after: Optional[float] = None, **extra):
        payload = {"error": message}
        if typ is not None:
            payload["type"] = typ
        if retriable is not None:
            payload["retriable"] = bool(retriable)
        if retry_after is not None:
            payload["retry_after_ms"] = round(retry_after * 1e3, 3)
        payload.update(extra)
        self._respond(code, payload, retry_after=retry_after)

    def _serving_error(self, e: ServingError, **extra):
        retry_after = None
        if e.retriable:
            retry_after = getattr(e, "retry_after", None)
            if retry_after is None:
                retry_after = DEFAULT_RETRY_AFTER
        self._error(e.status_code, str(e), typ=type(e).__name__,
                    retriable=e.retriable, retry_after=retry_after, **extra)

    def _read_body(self) -> Optional[bytes]:
        length = self.headers.get("Content-Length")
        if length is None:
            # refusing without reading the body desyncs a keep-alive
            # stream (the unread bytes would parse as the next request
            # line) — drop the connection with the refusal
            self.close_connection = True
            self._error(411, "Content-Length required")
            return None
        try:
            length = int(length)
        except ValueError:
            self.close_connection = True
            self._error(400, f"malformed Content-Length: {length!r}")
            return None
        if length > self.ingress.max_body:
            self.close_connection = True
            self._error(413, f"body of {length} bytes exceeds the "
                             f"{self.ingress.max_body} byte limit")
            return None
        try:
            data = self.rfile.read(length)
        except (TimeoutError, OSError):
            data = b""
        if len(data) != length:
            # slow-client timeout or mid-upload disconnect
            INGRESS_DISCONNECTS.inc()
            self._error(400, f"body truncated: read {len(data)} of "
                             f"{length} bytes")
            self.close_connection = True
            return None
        return data

    def _deadline_ms(self, body_json) -> Optional[float]:
        raw = (self.headers.get("deadline_ms")
               or self.headers.get("X-Deadline-Ms"))
        if raw is None and isinstance(body_json, dict):
            raw = body_json.get("deadline_ms")
        if raw is None:
            return None
        ms = float(raw)
        if ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {ms:g}")
        return ms

    # ---------------------------------------------------------- payloads
    def _features(self, name: str, data: bytes):
        """(features, deadline_seconds) from the request body, by
        Content-Type (module doc). Raises ValueError for malformed
        payloads (-> 400) and LookupError when an image body arrives
        for a route with no decode preset (-> 415)."""
        ctype = (self.headers.get("Content-Type") or
                 "application/json").split(";")[0].strip().lower()
        if ctype.startswith("image/"):
            preset = self.ingress.router.decode_preset(name)
            if preset is None:
                raise LookupError(
                    f"model {name!r} has no decode preset — raw-image "
                    "bodies are not routable to it (load(..., decode="
                    "DecodePreset(...)) wires one)")
            return preset.decode(data), self._deadline_ms(None)
        if ctype == "application/octet-stream":
            shape = self.headers.get("X-Tensor-Shape")
            if not shape:
                raise ValueError("octet-stream bodies need an "
                                 "X-Tensor-Shape header (e.g. '2,4')")
            dims = tuple(int(d) for d in shape.split(","))
            dtype = np.dtype(self.headers.get("X-Tensor-Dtype", "float32"))
            want = int(np.prod(dims)) * dtype.itemsize
            if len(data) != want:
                raise ValueError(
                    f"tensor body is {len(data)} bytes; shape {dims} "
                    f"dtype {dtype.name} needs {want}")
            return (np.frombuffer(data, dtype=dtype).reshape(dims),
                    self._deadline_ms(None))
        # default: JSON
        try:
            payload = json.loads(data.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"malformed JSON body: {e}") from None
        if not isinstance(payload, dict) or "instances" not in payload:
            raise ValueError('JSON body must be {"instances": [...]}')
        feats = np.asarray(payload["instances"], dtype=np.float32)
        if feats.ndim < 1 or feats.shape[0] == 0:
            raise ValueError("instances must be a non-empty array of "
                             "feature rows")
        return feats, self._deadline_ms(payload)

    # ------------------------------------------------------------ routes
    def do_POST(self):
        self._trace = None
        url = urlparse(self.path)
        path = url.path
        if path.startswith("/v1/models/") and path.endswith(":predict"):
            name = path[len("/v1/models/"):-len(":predict")]
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            version = None
            if "version" in q:
                try:
                    version = int(q["version"])
                except ValueError:
                    return self._error(
                        400, f"malformed version: {q['version']!r}")
            return self._predict(name, version)
        self._error(404, f"no such endpoint: POST {path}")

    def _predict(self, name: str, version: Optional[int]):
        # trace context for the whole request: honor an incoming W3C
        # traceparent header (this hop becomes its child), else mint a
        # fresh root — IDs are always minted so even untraced runs
        # return a trace_id; recording stays gated on tracing_enabled
        incoming = _tracectx.TraceContext.from_traceparent(
            self.headers.get("traceparent"))
        ctx = (incoming.child() if incoming is not None
               else _tracectx.TraceContext.new())
        self._trace = ctx
        t0_us = _prof.now_us()
        err = None
        try:
            with _tracectx.use(ctx):
                self._predict_inner(name, version, ctx)
        except BaseException as e:
            err = type(e).__name__
            raise
        finally:
            args = {"model": name, "path": self.path}
            if err is not None:
                args["error"] = err
            _tracectx.record_span("ingress:request", ctx, t0_us,
                                  _prof.now_us() - t0_us, args=args)

    def _predict_inner(self, name: str, version: Optional[int],
                       ctx: _tracectx.TraceContext):
        import time as _time
        from deeplearning4j_tpu_torch.serving.registry import ModelNotFoundError
        data = self._read_body()
        if data is None:
            return
        t0 = _time.perf_counter()
        try:
            feats, deadline_ms = self._features(name, data)
        except LookupError as e:
            return self._error(415, str(e))
        except ModelNotFoundError as e:
            return self._error(404, str(e.args[0]) if e.args else str(e))
        except (ValueError, TypeError) as e:
            return self._error(400, str(e))
        deadline_s = deadline_ms / 1e3 if deadline_ms is not None else None
        try:
            req = self.ingress.router.submit(name, feats,
                                             deadline=deadline_s,
                                             version=version, trace=ctx)
        except ModelNotFoundError as e:
            return self._error(404, str(e.args[0]) if e.args else str(e))
        except ServingError as e:
            return self._serving_error(e)
        except ValueError as e:          # oversize batch / unwarmed shape
            return self._error(400, str(e))
        wait = (deadline_s + self.ingress.deadline_grace
                if deadline_s is not None else self.ingress.default_timeout)
        try:
            result = req.get(wait)
        except ServingError as e:
            # server-stamped latency: admission to resolution, measured
            # where the deadline was enforced (the 504 pin asserts this)
            stamped = ((req.resolved_at - req.enqueued_at) * 1e3
                       if req.resolved_at is not None else None)
            return self._serving_error(
                e, latency_ms=round(stamped, 3) if stamped else None)
        except TimeoutError:
            return self._error(
                504, f"no result within {wait:g}s (request may still "
                     "complete server-side)", typ="TimeoutError",
                retriable=False)
        except Exception as e:           # dispatch failure after retries
            return self._error(500, f"{type(e).__name__}: {e}",
                               typ=type(e).__name__, retriable=False)
        stamped = (req.resolved_at - req.enqueued_at) * 1e3
        served_by = req.server or name
        ver = None
        if ":v" in served_by:
            try:
                ver = int(served_by.rsplit(":v", 1)[1])
            except ValueError:
                ver = None
        if ver is None:     # custom-named / single-server routes
            try:
                ver = self.ingress.router.active_version(name)
            except Exception:
                ver = None
        self._respond(200, {
            "model": name,
            "version": ver,
            "predictions": _jsonable(result),
            "latency_ms": round(stamped, 3),
        })
        INGRESS_LATENCY.observe(_time.perf_counter() - t0,
                                exemplar=ctx.trace_id)

    def do_GET(self):
        from deeplearning4j_tpu_torch.serving.registry import ModelNotFoundError
        self._trace = None
        url = urlparse(self.path)
        path = url.path
        router = self.ingress.router
        if path == "/v1/load":
            return self._respond(200, router.load_hints())
        if path == "/metrics":
            # this process's registry on the serving port; OpenMetrics
            # (with histogram exemplars) when the client negotiates it
            om = ("application/openmetrics-text"
                  in (self.headers.get("Accept") or ""))
            return self._respond_text(
                200, _prof.get_registry().exposition(openmetrics=om),
                ("application/openmetrics-text; version=1.0.0; "
                 "charset=utf-8") if om
                else "text/plain; version=0.0.4; charset=utf-8")
        if path == "/v1/fleet/metrics":
            agg = self.ingress.fleet
            if agg is None:
                return self._error(
                    404, "no fleet aggregator attached — "
                         "HttpIngress(..., fleet=MetricsAggregator()) "
                         "or ingress.attach_fleet(agg)")
            return self._respond_text(
                200, agg.exposition(),
                "text/plain; version=0.0.4; charset=utf-8")
        if path == "/v1/fleet/load":
            agg = self.ingress.fleet
            if agg is None:
                return self._error(404, "no fleet aggregator attached")
            return self._respond(200, agg.fleet_load())
        if path == "/v1/slo":
            gate = self.ingress.slo
            if gate is None:
                return self._error(
                    404, "no SLO gate attached — HttpIngress(..., "
                         "slo=SLOGate(engine)) or ingress.attach_slo()")
            verdict = gate()
            return self._respond(200, {"passing": verdict.passing,
                                       "failing": verdict.failures,
                                       **verdict.detail})
        if path == "/v1/models":
            return self._respond(200, {"models": router.models()})
        if path.startswith("/v1/models/"):
            name = path[len("/v1/models/"):]
            try:
                snap = router.models()[name]
            except KeyError:
                return self._error(404, f"model {name!r} is not loaded")
            return self._respond(200, {"model": name, **snap})
        if path == "/healthz":
            if router.healthy:
                return self._respond(200, {"status": "ok"})
            return self._respond(503, {"status": "unhealthy"})
        if path == "/readyz":
            if router.ready:
                return self._respond(200, {"ready": True})
            return self._respond(503, {"ready": False},
                                 retry_after=DEFAULT_RETRY_AFTER)
        self._error(404, f"no such endpoint: GET {path}")


# ------------------------------------------------------------------ ingress
class _Server(ThreadingHTTPServer):
    # the stdlib listen backlog is 5: a burst of more simultaneous
    # connects overflows it and the excess are dropped or reset before
    # any handler runs — a front door must queue them instead
    request_queue_size = 128
    daemon_threads = True


class HttpIngress:
    """The HTTP front door (module doc). ``target`` is a
    :class:`~deeplearning4j_tpu_torch.serving.registry.ModelRegistry` (multi-
    model routing) or a bare :class:`ModelServer` (served as
    ``"default"``). ``start()`` binds and serves on a daemon thread;
    context-manager use stops on exit. ``port=0`` picks a free port
    (tests); ``decode`` wires a :class:`DecodePreset` for the
    single-server form."""

    def __init__(self, target, port: int = 8500, host: str = "127.0.0.1",
                 default_timeout: float = 30.0, deadline_grace: float = 5.0,
                 max_body_mb: float = 64.0,
                 decode: Optional[DecodePreset] = None,
                 fleet=None, slo=None):
        self.router = _as_router(target, decode=decode)
        self.host = host
        self.port = int(port)
        self.default_timeout = float(default_timeout)
        self.deadline_grace = float(deadline_grace)
        self.max_body = int(max_body_mb * 1024 * 1024)
        self.fleet = None
        self.slo = None
        if fleet is not None:
            self.attach_fleet(fleet)
        if slo is not None:
            self.attach_slo(slo)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._lifecycle = _prof.InstrumentedLock("ingress:lifecycle")

    def attach_fleet(self, aggregator) -> "HttpIngress":
        """Serve ``aggregator``'s merged fleet view at
        ``GET /v1/fleet/metrics`` and ``GET /v1/fleet/load`` (a
        :class:`~deeplearning4j_tpu_torch.profiler.aggregate.
        MetricsAggregator`, typically fed by a ``FleetScraper``)."""
        self.fleet = aggregator
        return self

    def attach_slo(self, gate) -> "HttpIngress":
        """Serve ``gate``'s verdict at ``GET /v1/slo``: an
        :class:`~deeplearning4j_tpu_torch.profiler.slo.SLOGate` or a bare
        ``SLOEngine`` (wrapped in one)."""
        if not callable(gate):
            from deeplearning4j_tpu_torch.profiler.slo import SLOGate
            gate = SLOGate(gate)
        self.slo = gate
        return self

    def start(self) -> "HttpIngress":
        with self._lifecycle:
            if self._httpd is None:
                self._httpd = _Server((self.host, self.port),
                                      _IngressHandler)
                self._httpd.dl4j_ingress = self
                self.port = self._httpd.server_address[1]
                self._thread = threading.Thread(
                    target=self._httpd.serve_forever, daemon=True,
                    name="dl4j-ingress")
                self._thread.start()
                logger.info("ingress: serving on %s", self.url)
        return self

    def stop(self) -> None:
        with self._lifecycle:
            if self._httpd is not None:
                self._httpd.shutdown()
                if self._thread is not None:
                    self._thread.join(timeout=10.0)
                self._httpd.server_close()
                self._httpd = None
                self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def __enter__(self) -> "HttpIngress":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
