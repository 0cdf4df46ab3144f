"""The request plumbing of the port's HTTP servers, on `http.server`.

The daemon's API server, the controller and the broker share it; each
gives its own routes and a context object. The JAX package serves them
with tornado, and what a client can see of tornado is kept: a route's
pattern matches the whole path, the first match wins; arguments take
their last value, stripped, from the query or a form-encoded body; a
handler's `prepare` runs before its method and may answer on its own; an
unmatched path is a 404, a method the handler lacks a 405, an
`HTTPError` tornado's HTML error page, an uncaught exception a 500.
Every connection is served on a thread of its own; a handler class with
`serialized` set runs under the context's `lock`, as tornado runs
handlers one at a time on its IOLoop.

A context has `lock` (a lock) and `metrics` (a metrics scope, or None
for a server that counts no handler calls).
"""

from __future__ import annotations

import html
import json
import logging
import re
import threading
import time
from http import HTTPStatus
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qs, unquote, urlsplit

from aresdb_tpu_torch.utils import metrics as M
from aresdb_tpu_torch.utils import tracing

_LOG = logging.getLogger("aresdb_tpu_torch.api")
_CONTROL_CHARS = re.compile(r"[\x00-\x08\x0e-\x1f]")
_METHODS = ("get", "post", "put", "delete", "head")


class HTTPError(Exception):
    """An error answered with tornado's HTML error page."""

    def __init__(self, status: int, reason: Optional[str] = None):
        super().__init__(status, reason)
        self.status = status
        self.reason = reason or HTTPStatus(status).phrase


class Request:
    """One parsed HTTP request: method, path, arguments, headers, body."""

    def __init__(self, method: str, target: str, headers, body: bytes):
        parts = urlsplit(target)
        self.method = method
        self.path = parts.path
        self.headers = headers
        self.body = body
        self.query_arguments = parse_qs(parts.query, keep_blank_values=True)
        # tornado also reads arguments from a form-encoded body
        self.arguments = {k: list(v) for k, v in
                          self.query_arguments.items()}
        ctype = headers.get("Content-Type", "")
        if ctype.startswith("application/x-www-form-urlencoded"):
            form = parse_qs(body.decode("utf-8", "replace"),
                            keep_blank_values=True)
            for k, v in form.items():
                self.arguments.setdefault(k, []).extend(v)


class Handler:
    """tornado.web.RequestHandler's surface that the handlers use."""

    serialized = False   # True: runs under the context's lock

    def __init__(self, ctx, request: Request):
        self.ctx = ctx
        self.request = request
        self.status = 200
        self.reason: Optional[str] = None
        self.headers: Dict[str, str] = {
            "Content-Type": "text/html; charset=UTF-8"}
        self.out = b""   # the answer's body
        self.finished = False

    def prepare(self):
        """Runs before the method; a handler that finishes here answers
        without its method."""

    def set_status(self, status: int, reason: Optional[str] = None):
        self.status = status
        self.reason = reason

    def set_header(self, name: str, value: str):
        self.headers[name] = value

    def finish(self, chunk=None):
        if chunk is not None:
            self.out += chunk.encode() if isinstance(chunk, str) \
                else bytes(chunk)
        self.finished = True

    def get_argument(self, name: str, default):
        """The last value of a query or form argument, stripped."""
        return self._argument(self.request.arguments, name, default)

    def get_query_argument(self, name: str, default):
        return self._argument(self.request.query_arguments, name, default)

    @staticmethod
    def _argument(source, name, default):
        values = source.get(name)
        if not values:
            return default
        return _CONTROL_CHARS.sub(" ", values[-1]).strip()

    def write_json(self, obj, status: int = 200):
        self.set_status(status)
        self.set_header("Content-Type", "application/json")
        with tracing.span("respond"):
            self.finish(json.dumps(obj, default=str))

    def write_error_json(self, status: int, message: str):
        self.write_json({"message": message}, status=status)

    def json_body(self) -> Dict[str, Any]:
        try:
            return json.loads(self.request.body or b"{}")
        except json.JSONDecodeError as e:
            raise HTTPError(400, f"invalid json: {e}")


def compile_routes(routes) -> list:
    return [(re.compile(p), h) for p, h in routes]


def dispatch(ctx, request: Request, compiled) -> Handler:
    """Route one request (patterns matched in full, in order, first match
    wins) and run its handler; returns the finished handler."""
    t0 = time.perf_counter()
    for pattern, cls in compiled:
        m = pattern.fullmatch(request.path)
        if m is not None:
            break
    else:
        cls, m = Handler, None
    handler = cls(ctx, request)
    try:
        if m is None:
            raise HTTPError(404)
        args = [None if g is None else unquote(g) for g in m.groups()]
        if cls.serialized:
            with ctx.lock:
                _run(handler, request.method.lower(), args)
        else:
            _run(handler, request.method.lower(), args)
        handler.finished = True
    except HTTPError as e:
        handler = _error_page(ctx, request, e.status, e.reason)
    except Exception:  # noqa: BLE001 — a handler fault answers 500
        _LOG.exception("%s %s", request.method, request.path)
        handler = _error_page(ctx, request, 500, None)
    if m is not None and ctx.metrics is not None:
        # utils/metrics.go HTTPHandlerCall/Latency (per-handler tags)
        name = cls.__name__
        ctx.metrics.count(M.HTTP_HANDLER_CALL, 1, tags={"handler": name})
        ctx.metrics.record_timer(M.HTTP_HANDLER_LATENCY,
                                 time.perf_counter() - t0,
                                 tags={"handler": name})
    return handler


def _run(handler: Handler, method: str, args) -> None:
    handler.prepare()
    if handler.finished:
        return
    if method not in _METHODS or not hasattr(handler, method):
        raise HTTPError(405)
    getattr(handler, method)(*args)


def _error_page(ctx, request, status: int, reason: Optional[str]) -> Handler:
    """tornado's default error page (RequestHandler.write_error)."""
    page = Handler(ctx, request)
    reason = reason or HTTPStatus(status).phrase
    page.set_status(status, reason)
    page.finish(f"<html><title>{status}: {html.escape(reason)}</title>"
                f"<body>{status}: {html.escape(reason)}</body></html>")
    return page


class _HTTPHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "aresdb_tpu_torch"
    # headers and body go out as two writes; as tornado does, send each
    # at once rather than hold the body until the headers are acked
    disable_nagle_algorithm = True

    def _serve(self):
        """One request, in an `http` span from the body's read to the
        answer's write (the root of the request's trace, its id the
        `X-Request-ID` header where one is sent), the write a `respond`
        span."""
        with tracing.span("http") as span:
            if span is not None:
                span.trace = self.headers.get("X-Request-ID") or span.trace
            n = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(n) if n > 0 else b""
            request = Request(self.command, self.path, self.headers, body)
            handler = dispatch(self.server.ctx, request, self.server.routes)
            with tracing.span("respond"):
                self.send_response(handler.status, handler.reason)
                for k, v in handler.headers.items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(handler.out)))
                self.end_headers()
                if self.command != "HEAD":
                    self.wfile.write(handler.out)
            if span is not None:
                span.attrs.update(handler=type(handler).__name__,
                                  status=handler.status)

    do_GET = do_POST = do_PUT = do_DELETE = do_HEAD = do_PATCH = \
        do_OPTIONS = _serve

    def log_message(self, format, *args):  # noqa: A002 — base signature
        pass


class _Server(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, port: int, ctx, routes):
        super().__init__(("", port), _HTTPHandler)
        self.ctx = ctx
        self.routes = routes


class Service:
    """One server over `routes` (compiled) and `ctx`, on a background
    thread or the caller's."""

    def __init__(self, ctx, routes, port: int = 0, name: str = "ares-http"):
        self.ctx = ctx
        self.routes = routes
        self.port = port
        self.name = name
        self._server: Optional[_Server] = None
        self._thread: Optional[threading.Thread] = None

    def bind(self) -> int:
        """Open the listening socket; returns the bound port (a free one
        where the port given is 0)."""
        if self._server is None:
            self._server = _Server(self.port, self.ctx, self.routes)
            self.port = self._server.server_address[1]
        return self.port

    def start_background(self) -> int:
        """Start serving on a background thread; returns the bound port."""
        self.bind()
        server = self._server
        self._thread = threading.Thread(target=server.serve_forever,
                                        daemon=True, name=self.name)
        self._thread.start()
        return self.port

    def shutdown(self) -> None:
        """Stop serving and close the listening socket."""
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def serve_forever(self):
        """Serve on the caller's thread until interrupted."""
        self.bind()
        try:
            self._server.serve_forever()
        finally:
            self._server.server_close()
