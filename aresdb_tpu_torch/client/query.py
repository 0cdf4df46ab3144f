"""Query client: JSON AQL plus the `application/hll` binary path.

Reference: the Go client consumes /query/aql and parses binary HLL
responses with queryCom.ParseHLLQueryResults (query/common/hll.go:583);
examples use Content-Accept negotiation (api/query_handler.go:76).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from aresdb_tpu_torch.utils import http_client

from aresdb_tpu_torch.query import hll_wire as W


class QueryClientError(Exception):
    pass


class QueryClient:
    def __init__(self, address: str, session: Optional[http_client.Session] = None,
                 timeout: float = 120.0):
        self.base = address if address.startswith("http") \
            else f"http://{address}"
        self.session = session or http_client.Session()
        self.timeout = timeout

    def query_aql(self, queries: List[Dict[str, Any]],
                  verbose: bool = False) -> Dict[str, Any]:
        r = self.session.post(f"{self.base}/query/aql",
                              json={"queries": queries, "verbose": verbose},
                              timeout=self.timeout)
        r.raise_for_status()
        return r.json()

    def query_hll(self, queries: List[Dict[str, Any]],
                  compute: bool = True
                  ) -> Tuple[List[Optional[Dict[str, Any]]],
                             List[Optional[str]]]:
        """Binary HLL query: returns (results, errors) per query. With
        compute=True the HLL leaves become numeric estimates; otherwise the
        raw HLL register structs are returned for client-side merging."""
        r = self.session.post(f"{self.base}/query/aql",
                              json={"queries": queries},
                              headers={"Accept": W.CONTENT_TYPE},
                              timeout=self.timeout)
        r.raise_for_status()
        ctype = r.headers.get("Content-Type", "")
        if W.CONTENT_TYPE not in ctype:
            raise QueryClientError(
                f"expected {W.CONTENT_TYPE} response, got {ctype}")
        results, errors = W.parse_hll_query_results(r.content)
        if compute:
            results = [W.compute_hll_result(t) if t is not None else None
                       for t in results]
        return results, errors

    def query_sql(self, statements: List[str]) -> Dict[str, Any]:
        r = self.session.post(f"{self.base}/query/sql",
                              json={"queries": statements},
                              timeout=self.timeout)
        r.raise_for_status()
        return r.json()
