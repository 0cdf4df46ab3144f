"""A small HTTP client: the part of `requests` that the cluster uses.

The controller, datanode, bootstrap and broker clients of the JAX package
talk HTTP through `requests.Session`; the GPU machine has no `requests`,
so the port's copies of them talk through this module, on the standard
library. It keeps what those call sites see of `requests`:

- `Session.request/get/post/put/delete(url, json=, data=, headers=,
  timeout=)`, and the module's `request`, `get` and `post`, as
  `requests.request/get/post` (arescli calls them on the module);
- a `Response` for every answer, 4xx and 5xx included (callers branch on
  404, 410 and 503), with `status_code`, `content`, `text`, `headers`,
  `json()` and `raise_for_status()`;
- `RequestException`, and under it `ConnectionError` (refused, reset, or
  closed early), `Timeout` and `HTTPError` (raised by
  `raise_for_status`).

A request runs on `http.client` over a connection of its own, closed once
the whole body is read. `http.client` and not `urllib.request`: the
latter sends `Content-Type: application/x-www-form-urlencoded` with any
body that has no type, and `requests` sends none, so a binary upsert
would reach the server as a form.
"""

from __future__ import annotations

import http.client
import json as _json
import socket
from typing import Any, Dict, Optional
from urllib.parse import urlsplit

_USER_AGENT = "aresdb_tpu_torch"


class RequestException(IOError):
    """Any failure of a request (requests.RequestException)."""


class ConnectionError(RequestException):  # noqa: A001 — requests' name
    """The connection was refused, reset or closed before the answer."""


class Timeout(RequestException):
    """No answer within the request's timeout."""


class HTTPError(RequestException):
    """A 4xx or 5xx answer, raised by Response.raise_for_status."""


class Response:
    def __init__(self, url: str, status_code: int, reason: str, headers,
                 content: bytes):
        self.url = url
        self.status_code = status_code
        self.reason = reason
        self.headers = headers
        self.content = content

    @property
    def encoding(self) -> str:
        ctype = self.headers.get("Content-Type", "") or ""
        for part in ctype.split(";")[1:]:
            key, _, value = part.strip().partition("=")
            if key.lower() == "charset" and value:
                return value.strip("\"'")
        return "utf-8"

    @property
    def text(self) -> str:
        return self.content.decode(self.encoding, "replace")

    def json(self) -> Any:
        return _json.loads(self.content)

    def raise_for_status(self) -> None:
        if 400 <= self.status_code < 600:
            kind = "Client" if self.status_code < 500 else "Server"
            raise HTTPError(f"{self.status_code} {kind} Error: "
                            f"{self.reason} for url: {self.url}")


class Session:
    """requests.Session's request methods; holds no connection between
    requests."""

    def request(self, method: str, url: str, *, json: Any = None,
                data: Any = None, headers: Optional[Dict[str, str]] = None,
                timeout: Optional[float] = None) -> Response:
        parts = urlsplit(url)
        if parts.scheme != "http" or not parts.hostname:
            raise RequestException(f"unsupported URL {url!r}")
        send = {"User-Agent": _USER_AGENT, "Accept": "*/*"}
        body = None
        if json is not None:
            body = _json.dumps(json).encode()
            send["Content-Type"] = "application/json"
        elif data is not None:
            body = data.encode() if isinstance(data, str) else bytes(data)
        for k, v in (headers or {}).items():
            send[k] = v
        path = parts.path or "/"
        if parts.query:
            path += "?" + parts.query
        conn = http.client.HTTPConnection(parts.hostname, parts.port or 80,
                                          timeout=timeout)
        try:
            conn.request(method, path, body=body, headers=send)
            r = conn.getresponse()
            content = r.read()
        except socket.timeout as e:
            raise Timeout(f"{method} {url}: {e}") from e
        except (OSError, http.client.HTTPException) as e:
            raise ConnectionError(f"{method} {url}: {e!r}") from e
        finally:
            conn.close()
        return Response(url, r.status, r.reason, r.headers, content)

    def get(self, url: str, **kw) -> Response:
        return self.request("GET", url, **kw)

    def post(self, url: str, **kw) -> Response:
        return self.request("POST", url, **kw)

    def put(self, url: str, **kw) -> Response:
        return self.request("PUT", url, **kw)

    def delete(self, url: str, **kw) -> Response:
        return self.request("DELETE", url, **kw)


def request(method: str, url: str, **kw) -> Response:
    """requests.request: one request on a Session of its own."""
    return Session().request(method, url, **kw)


def get(url: str, **kw) -> Response:
    return request("GET", url, **kw)


def post(url: str, **kw) -> Response:
    return request("POST", url, **kw)
