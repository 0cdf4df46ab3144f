"""The port's HTTP client against `requests`, request by request.

A local `http.server` answers both with the same bytes; the port's
`Session` must give what `requests.Session` gives for each request: the
status code, the body as `content`, `text` and `json()`, the headers, and
whether `raise_for_status()` raises. The server also echoes what it was
sent (method, path, body, Content-Type, Accept), so the two clients must
send alike too. A 404, 410 or 503 comes back as a response; a refused
port raises `RequestException`, a timeout `Timeout`.
"""

from __future__ import annotations

import base64
import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import requests

from aresdb_tpu_torch.utils import http_client


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def _answer(self):
        n = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(n) if n else b""
        path = self.path.split("?")[0]
        ctype, out = "application/json", None
        status = 200
        if path.startswith("/status/"):
            status = int(path.rsplit("/", 1)[1])
            out = json.dumps({"message": f"status {status}"}).encode()
        elif path == "/text":
            ctype, out = "text/plain; charset=utf-8", "héllo wörld".encode()
        elif path == "/bytes":
            ctype, out = "application/octet-stream", bytes(range(256)) * 64
        elif path == "/slow":
            time.sleep(1.0)
            out = b"{}"
        else:
            out = json.dumps({
                "method": self.command, "path": self.path,
                "body": base64.b64encode(body).decode(),
                "contentType": self.headers.get("Content-Type"),
                "accept": self.headers.get("Accept")}).encode()
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("X-Ares-Test", "yes")
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    do_GET = do_POST = do_PUT = do_DELETE = _answer

    def log_message(self, *a):
        pass


class _Server(ThreadingHTTPServer):
    daemon_threads = True

    def handle_error(self, request, client_address):
        pass   # /slow writes to a client that timed out and left


@pytest.fixture(scope="module")
def server():
    srv = _Server(("127.0.0.1", 0), _Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()


# (name, method, path, keyword arguments)
CASES = [
    ("get", "get", "/echo?x=1&y=two", {}),
    ("post json", "post", "/echo", {"json": {"a": [1, 2.5, None]}}),
    ("post bytes", "post", "/echo", {"data": b"\x00\x01binary\xff"}),
    ("post str", "post", "/echo", {"data": json.dumps({"k": "v"})}),
    ("put json", "put", "/echo", {"json": {"shardRows": {"0": 5}}}),
    ("delete", "delete", "/echo/session/ab12", {}),
    ("accept header", "post", "/echo",
     {"json": {"queries": []}, "headers": {"Accept": "application/hll"}}),
    ("headers none", "post", "/echo", {"json": {}, "headers": None}),
    ("text", "get", "/text", {}),
    ("bytes", "get", "/bytes", {}),
    ("404", "get", "/status/404", {}),
    ("410", "get", "/status/410", {}),
    ("503", "post", "/status/503", {"json": {}}),
    ("500", "get", "/status/500", {}),
    ("400", "put", "/status/400", {"data": b"x"}),
]


def _outcome(session, base, method, path, kw):
    r = getattr(session, method)(base + path, timeout=10, **kw)
    try:
        doc = r.json()
    except ValueError:
        doc = "not json"
    try:
        r.raise_for_status()
        raised = None
    except Exception as e:  # noqa: BLE001 — the kind is compared below
        raised = type(e).__name__
    return {"status": r.status_code, "content": r.content, "text": r.text,
            "json": doc, "type": r.headers["Content-Type"],
            "custom": r.headers.get("x-ares-test"), "raised": raised}


@pytest.mark.parametrize("name,method,path,kw", CASES,
                         ids=[c[0] for c in CASES])
def test_answers_as_requests_does(server, name, method, path, kw):
    want = _outcome(requests.Session(), server, method, path, kw)
    got = _outcome(http_client.Session(), server, method, path, kw)
    assert got == want
    if got["raised"] is not None:
        with pytest.raises(http_client.RequestException):
            http_client.Session().request(method.upper(), server + path,
                                          **kw).raise_for_status()


def test_request_passes_keywords_through(server):
    r = http_client.Session().request("POST", server + "/echo",
                                      json={"a": 1}, timeout=5)
    doc = r.json()
    assert doc["method"] == "POST" and doc["contentType"] == \
        "application/json"
    assert json.loads(base64.b64decode(doc["body"])) == {"a": 1}


def test_a_refused_port_raises_a_request_exception():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with pytest.raises(requests.RequestException):
        requests.get(f"http://127.0.0.1:{port}/", timeout=5)
    with pytest.raises(http_client.ConnectionError) as e:
        http_client.Session().get(f"http://127.0.0.1:{port}/", timeout=5)
    assert isinstance(e.value, http_client.RequestException)


def test_a_timeout_raises_timeout(server):
    with pytest.raises(requests.Timeout):
        requests.get(server + "/slow", timeout=0.2)
    with pytest.raises(http_client.Timeout) as e:
        http_client.Session().get(server + "/slow", timeout=0.2)
    assert isinstance(e.value, http_client.RequestException)


MODULE_CASES = [c for c in CASES if c[1] in ("get", "post")]


@pytest.mark.parametrize("name,method,path,kw", MODULE_CASES,
                         ids=[c[0] for c in MODULE_CASES])
def test_the_modules_functions_answer_as_requests_does(server, name, method,
                                                       path, kw):
    """requests.get/post and http_client.get/post, which arescli calls on
    the module its `_http()` returns, with `timeout=` and `json=`."""
    assert _outcome(http_client, server, method, path, kw) == \
        _outcome(requests, server, method, path, kw)


def test_the_modules_request_answers_as_requests_does(server):
    want = requests.request("PUT", server + "/echo", json={"a": 2},
                            timeout=5)
    got = http_client.request("PUT", server + "/echo", json={"a": 2},
                              timeout=5)
    assert (got.status_code, got.json()) == (want.status_code, want.json())
