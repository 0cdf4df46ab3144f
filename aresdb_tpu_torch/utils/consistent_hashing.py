"""Consistent hashing ring for job→instance assignment.

Reference: utils/consistenthasing/consistenthashing.go:51 (sic) — used by the
controller's ingestion-assignment task to spread Kafka jobs over subscriber
instances.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, List


def _hash(key: str) -> int:
    return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "big")


class HashRing:
    def __init__(self, replicas: int = 64):
        self.replicas = replicas
        self._ring: List[int] = []
        self._nodes: Dict[int, str] = {}

    def add(self, node: str) -> None:
        for i in range(self.replicas):
            h = _hash(f"{node}#{i}")
            if h not in self._nodes:
                bisect.insort(self._ring, h)
                self._nodes[h] = node

    def remove(self, node: str) -> None:
        for i in range(self.replicas):
            h = _hash(f"{node}#{i}")
            if self._nodes.get(h) == node:
                self._ring.remove(h)
                del self._nodes[h]

    def get(self, key: str) -> str:
        if not self._ring:
            raise KeyError("empty hash ring")
        h = _hash(key)
        idx = bisect.bisect(self._ring, h) % len(self._ring)
        return self._nodes[self._ring[idx]]

    def assign(self, keys: List[str]) -> Dict[str, List[str]]:
        """Stable assignment of keys to nodes."""
        out: Dict[str, List[str]] = {}
        for k in sorted(keys):
            out.setdefault(self.get(k), []).append(k)
        return out
