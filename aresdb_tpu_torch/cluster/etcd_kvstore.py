"""etcd adapter for the coordination KV seam.

Reference: cluster/kvstore/etcd.go (the reference's etcd client wrapper)
and controller/mutators/etcd/*.go — its controllers coordinate through
etcd keys with value-compare transactions.

This adapter speaks etcd's standard v3 gRPC-JSON gateway over plain HTTP
(`/v3/kv/range|put|deleterange|txn`, base64 keys/values — available on
every etcd >= 3.4 without any client library), so it carries zero new
dependencies: this image has no etcd binary and no grpc/etcd3 package,
and the seam must not grow an import that can't be satisfied.

Mapping (one call each, all linearizable server-side):
- get     -> Range(key)
- put     -> Put(key, value)
- delete  -> DeleteRange(key)
- cas(key, expected, new):
    expected is None  -> Txn(compare key.create_revision == 0, put)
    expected is value -> Txn(compare key.value == expected, put)

tests/test_etcd_kvstore.py runs the shared KVStore contract (and the
LeaderElector, unchanged) against this adapter twice: against an
in-process gateway fake that implements the four endpoints' JSON shapes,
and — when ARES_ETCD_ENDPOINT is set — against a real etcd.
"""

from __future__ import annotations

import base64
import json
from typing import Optional

from aresdb_tpu_torch.cluster.kvstore import KVStore


def _b64(s: str) -> str:
    return base64.b64encode(s.encode()).decode()


def _unb64(s: str) -> str:
    return base64.b64decode(s).decode()


class EtcdKVStore(KVStore):
    """KVStore over an etcd v3 gRPC-JSON gateway endpoint.

    endpoint: "http://host:2379" (no trailing slash). api_prefix covers
    older gateways ("/v3beta" on etcd 3.3). All methods raise on transport
    errors — the election loop treats exceptions as a failed renew/acquire
    and retries, same as a flaky etcd connection in the reference.
    """

    def __init__(self, endpoint: str, api_prefix: str = "/v3",
                 timeout: float = 5.0, session=None):
        from aresdb_tpu_torch.utils import http_client

        self.base = endpoint.rstrip("/") + api_prefix
        self.timeout = timeout
        self._http = session or http_client.Session()

    def _post(self, path: str, body: dict) -> dict:
        r = self._http.post(self.base + path, data=json.dumps(body),
                            timeout=self.timeout)
        r.raise_for_status()
        return r.json()

    def get(self, key: str) -> Optional[str]:
        out = self._post("/kv/range", {"key": _b64(key)})
        kvs = out.get("kvs") or []
        if not kvs:
            return None
        return _unb64(kvs[0].get("value", ""))

    def put(self, key: str, value: str) -> None:
        self._post("/kv/put", {"key": _b64(key), "value": _b64(value)})

    def delete(self, key: str) -> None:
        self._post("/kv/deleterange", {"key": _b64(key)})

    def cas(self, key: str, expected: Optional[str], new: str) -> bool:
        if expected is None:
            compare = {"key": _b64(key), "result": "EQUAL",
                       "target": "CREATE", "create_revision": "0"}
        else:
            compare = {"key": _b64(key), "result": "EQUAL",
                       "target": "VALUE", "value": _b64(expected)}
        out = self._post("/kv/txn", {
            "compare": [compare],
            "success": [{"request_put": {"key": _b64(key),
                                         "value": _b64(new)}}],
        })
        return bool(out.get("succeeded", False))
