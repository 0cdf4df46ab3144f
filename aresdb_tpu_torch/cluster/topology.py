"""Topology: static and controller-backed dynamic shard→host maps.

Reference: cluster/topology/ (Topology/Map/ShardOwner types.go:104,
static.go, dynamic.go — etcd/m3-watched in the reference, controller-polled
here) and healthtracking_dynamic.go (the broker's health-filtered view).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from aresdb_tpu_torch.utils import http_client

SHARD_INITIALIZING = "Initializing"
SHARD_AVAILABLE = "Available"
SHARD_LEAVING = "Leaving"


@dataclass
class HostInstance:
    name: str
    host: str
    port: int

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"


@dataclass
class TopologyView:
    """Immutable shard→replicas snapshot."""

    num_shards: int
    # shard id -> [(instance, state)]
    shards: Dict[int, List[Tuple[HostInstance, str]]] = field(
        default_factory=dict)

    def shard_ids(self) -> List[int]:
        return sorted(self.shards)

    def available_hosts(self, shard_id: int) -> List[HostInstance]:
        return [h for h, st in self.shards.get(shard_id, [])
                if st == SHARD_AVAILABLE]

    def bootstrap_sources(self, shard_id: int) -> List[HostInstance]:
        """Peers that can serve a data copy: Available or Leaving replicas."""
        return [h for h, st in self.shards.get(shard_id, [])
                if st in (SHARD_AVAILABLE, SHARD_LEAVING)]


class StaticTopology:
    """Fixed single-node/static placement (reference static.go: shard 0)."""

    def __init__(self, view: TopologyView):
        self._view = view

    def get(self) -> TopologyView:
        return self._view

    @classmethod
    def single_node(cls, host: str, port: int) -> "StaticTopology":
        inst = HostInstance("local", host, port)
        return cls(TopologyView(num_shards=1,
                                shards={0: [(inst, SHARD_AVAILABLE)]}))


class DynamicTopology:
    """Polls the controller's placement + membership with hash short-circuit.

    Reference: cluster/topology/dynamic.go (etcd watch → we poll; the
    SchemaFetchJob pattern, metastore/schema_fetch.go:29, applied to
    placement).
    """

    def __init__(self, controller_address: str, namespace: str,
                 kind: str = "datanode", poll_seconds: float = 5.0,
                 session=None):
        from aresdb_tpu_torch.cluster.failover import (
            FailoverSession, parse_addresses)

        addresses = parse_addresses(controller_address)
        self.base = f"http://{addresses[0]}"
        self.namespace = namespace
        self.kind = kind
        self.poll_seconds = poll_seconds
        self.session = session or FailoverSession(addresses)
        self._view = TopologyView(num_shards=0)
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def refresh(self) -> TopologyView:
        p = self.session.get(
            f"{self.base}/placement/{self.namespace}/{self.kind}", timeout=5)
        if p.status_code == 404:
            view = TopologyView(num_shards=0)
            with self._lock:
                self._view = view
            return view
        p.raise_for_status()
        placement = p.json()
        m = self.session.get(
            f"{self.base}/membership/{self.namespace}/instances", timeout=5)
        m.raise_for_status()
        instances = {
            name: HostInstance(name, desc["host"], int(desc["port"]))
            for name, desc in m.json().items()
        }
        shards: Dict[int, List[Tuple[HostInstance, str]]] = {}
        for sd in placement["shards"]:
            entries = []
            for name, state in sd["instances"].items():
                inst = instances.get(name)
                if inst is not None:
                    entries.append((inst, state))
            shards[sd["shardId"]] = entries
        view = TopologyView(num_shards=placement["numShards"], shards=shards)
        with self._lock:
            self._view = view
        return view

    def get(self) -> TopologyView:
        with self._lock:
            return self._view

    def start(self) -> None:
        if self._thread is not None:
            return

        def loop():
            while not self._stop.wait(self.poll_seconds):
                try:
                    self.refresh()
                except http_client.RequestException:
                    pass

        try:
            self.refresh()
        except http_client.RequestException:
            pass
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="topology-poll")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


class HealthTrackingTopology:
    """Wraps a topology, filtering hosts the broker marked unhealthy.

    Reference: cluster/topology/healthtracking_dynamic.go + the broker's
    (un)healthy marking per RPC outcome (broker/query_plan_agg.go:154).
    """

    def __init__(self, inner, unhealthy_ttl_seconds: float = 30.0):
        self.inner = inner
        self.ttl = unhealthy_ttl_seconds
        self._unhealthy: Dict[str, float] = {}
        self._lock = threading.Lock()

    def mark_unhealthy(self, instance_name: str) -> None:
        with self._lock:
            self._unhealthy[instance_name] = time.time()

    def mark_healthy(self, instance_name: str) -> None:
        with self._lock:
            self._unhealthy.pop(instance_name, None)

    def is_healthy(self, instance_name: str) -> bool:
        with self._lock:
            t = self._unhealthy.get(instance_name)
            if t is None:
                return True
            if time.time() - t > self.ttl:
                del self._unhealthy[instance_name]
                return True
            return False

    def get(self) -> TopologyView:
        view = self.inner.get()
        shards = {
            sid: [(h, st) for h, st in entries if self.is_healthy(h.name)]
            for sid, entries in view.shards.items()
        }
        return TopologyView(num_shards=view.num_shards, shards=shards)
