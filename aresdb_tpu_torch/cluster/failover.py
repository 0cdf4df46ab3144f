"""Controller-failover HTTP session.

Reference: the reference's clients reach whichever controller holds the
etcd leadership lease via m3cluster service discovery. Here, clients get
the full controller address list ("host:port,host:port") and this session
fails over: it rewrites request URLs to the current-best controller and
rotates on connection errors or 503 "not leader" answers (following the
leader hint when the follower supplies one).

Drop-in for http_client.Session at every call site that already accepts an
injectable `session` (datanode, topology, broker, subscriber controller
client). URLs whose host:port is not in the controller list pass through
untouched, so the same session object can serve peer/datanode traffic.
"""

from __future__ import annotations

from typing import List, Optional
from urllib.parse import urlsplit, urlunsplit

from aresdb_tpu_torch.utils import http_client


def parse_addresses(spec: str) -> List[str]:
    """'host:port[,host:port...]' -> list (whitespace tolerated)."""
    return [a.strip() for a in spec.split(",") if a.strip()]


class FailoverSession:
    def __init__(self, addresses,
                 session: Optional[http_client.Session] = None):
        if isinstance(addresses, str):
            addresses = parse_addresses(addresses)
        self.addresses = list(addresses)
        self.session = session or http_client.Session()
        self._preferred = 0  # index of last-known leader

    # http_client.Session surface used by the clients
    def get(self, url, **kw):
        return self.request("GET", url, **kw)

    def post(self, url, **kw):
        return self.request("POST", url, **kw)

    def put(self, url, **kw):
        return self.request("PUT", url, **kw)

    def delete(self, url, **kw):
        return self.request("DELETE", url, **kw)

    def request(self, method, url, **kw):
        kw.setdefault("timeout", 10)  # never hang on a dead controller
        parts = urlsplit(url)
        if parts.netloc not in self.addresses:
            return self.session.request(method, url, **kw)
        last_exc = None
        resp = None
        n = len(self.addresses)
        tried = set()
        idx = self._preferred
        for _ in range(n):
            while idx in tried:
                idx = (idx + 1) % n
            tried.add(idx)
            target = urlunsplit(parts._replace(netloc=self.addresses[idx]))
            try:
                r = self.session.request(method, target, **kw)
            except http_client.RequestException as e:
                last_exc = e
                idx = (idx + 1) % n
                continue
            if r.status_code == 503:
                resp = r
                leader = self._leader_hint(r)
                if leader and leader in self.addresses:
                    idx = self.addresses.index(leader)  # try the hint next
                else:
                    idx = (idx + 1) % n
                continue
            self._preferred = idx
            return r
        if resp is not None:
            return resp  # everyone said 503: surface it
        raise last_exc

    @staticmethod
    def _leader_hint(r) -> Optional[str]:
        try:
            doc = r.json()
            if isinstance(doc, dict) and doc.get("message") == "not leader":
                return doc.get("leader")
        except ValueError:
            pass
        return None
