"""Controller state: namespaces, schemas, membership, placement, assignment.

Reference: controller/ (handlers/{schema,membership,placement,assignment,
namespace}.go + mutators/etcd/*). The reference stores everything in etcd via
m3cluster; this rebuild keeps the same logical model in an in-process store
with JSON snapshots on local disk — the control plane is a single HTTP
service (its availability story is process supervision + state snapshots,
replacing the etcd quorum).

Schema changes bump a hash so clients (SchemaFetchJob) can short-circuit
(reference: controller hash-based change detection).

Two departures from the JAX package's copy, for controllers in an HA
election: `reload` (a promotion) counts each persisted instance's
heartbeat timeout from the promotion, since heartbeats are not persisted;
and `_persist` writes through `fence` where one is set (the elector's
`fenced`), so that a controller that lost its lease cannot overwrite its
successor's snapshot.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional

from aresdb_tpu_torch.common.schema import Table
from aresdb_tpu_torch.metastore.validator import validate_table
from aresdb_tpu_torch.utils.consistent_hashing import HashRing

SHARD_INITIALIZING = "Initializing"
SHARD_AVAILABLE = "Available"
SHARD_LEAVING = "Leaving"


@dataclass
class Instance:
    name: str
    host: str
    port: int
    last_heartbeat: float = 0.0
    # ephemeral per-shard row counts from the latest heartbeat (load stats
    # for skew-aware rebalancing; not persisted)
    shard_rows: Dict[int, int] = field(default_factory=dict)


@dataclass
class ShardAssignment:
    shard_id: int
    instances: Dict[str, str] = field(default_factory=dict)  # name -> state


@dataclass
class Placement:
    num_shards: int
    replica_factor: int
    shards: List[ShardAssignment] = field(default_factory=list)


@dataclass
class JobConfig:
    """Kafka ingestion job (reference controller/models JobConfig)."""

    name: str
    table: str
    topic: str
    cluster: str = ""
    config: Dict[str, Any] = field(default_factory=dict)


class Namespace:
    def __init__(self, name: str):
        self.name = name
        self.tables: Dict[str, Table] = {}
        self.enums: Dict[tuple, List[str]] = {}
        self.schema_hash = ""
        self.instances: Dict[str, Instance] = {}
        self.subscribers: Dict[str, float] = {}  # name -> last heartbeat
        self.placements: Dict[str, Placement] = {}  # "datanode" etc.
        self.jobs: Dict[str, JobConfig] = {}
        self.assignments: Dict[str, List[str]] = {}  # subscriber -> job names

    def bump_schema_hash(self) -> None:
        m = hashlib.md5()
        for name in sorted(self.tables):
            m.update(json.dumps(self.tables[name].to_json(),
                                sort_keys=True).encode())
        for key in sorted(self.enums):
            m.update(json.dumps([key, self.enums[key]]).encode())
        self.schema_hash = m.hexdigest()


class ControllerState:
    def __init__(self, root_path: Optional[str] = None,
                 heartbeat_timeout: float = 30.0):
        self.lock = threading.RLock()
        self.namespaces: Dict[str, Namespace] = {}
        self.root_path = root_path
        self.heartbeat_timeout = heartbeat_timeout
        # runs each snapshot write (None: written as is)
        self.fence: Optional[Callable[[Callable[[], None]], None]] = None
        if root_path:
            self._load()

    def reload(self) -> None:
        """Re-read the disk snapshot, replacing in-memory state — called
        when a follower is promoted to leader so it serves the previous
        leader's persisted mutations. Heartbeats are not persisted, so
        each persisted instance is stamped alive at the promotion: a live
        one is never dropped between two leaders, and a dead one drops
        out heartbeat_timeout later, as on the old leader."""
        with self.lock:
            if self.root_path:
                self.namespaces = {}
                self._load()
                now = time.time()
                for n in self.namespaces.values():
                    for inst in n.instances.values():
                        inst.last_heartbeat = now

    # -- namespaces --

    def create_namespace(self, name: str) -> None:
        with self.lock:
            if name in self.namespaces:
                raise ValueError(f"namespace {name!r} exists")
            self.namespaces[name] = Namespace(name)
            self._persist()

    def list_namespaces(self) -> List[str]:
        with self.lock:
            return sorted(self.namespaces)

    def ns(self, name: str) -> Namespace:
        n = self.namespaces.get(name)
        if n is None:
            raise KeyError(f"unknown namespace {name!r}")
        return n

    # -- schema --

    def create_table(self, namespace: str, table: Table) -> None:
        with self.lock:
            n = self.ns(namespace)
            if table.name in n.tables:
                raise ValueError(f"table {table.name!r} exists")
            validate_table(table)
            n.tables[table.name] = table
            for col in table.columns:
                if col.is_enum_column():
                    key = (table.name, col.name)
                    n.enums.setdefault(key, [])
                    if col.default_value is not None:
                        n.enums[key].append(col.default_value)
            n.bump_schema_hash()
            self._persist()

    def update_table(self, namespace: str, table: Table) -> None:
        with self.lock:
            n = self.ns(namespace)
            if table.name not in n.tables:
                raise KeyError(f"unknown table {table.name!r}")
            validate_table(table, old=n.tables[table.name])
            table.version = n.tables[table.name].version + 1
            n.tables[table.name] = table
            n.bump_schema_hash()
            self._persist()

    def delete_table(self, namespace: str, name: str) -> None:
        with self.lock:
            n = self.ns(namespace)
            if name not in n.tables:
                raise KeyError(f"unknown table {name!r}")
            del n.tables[name]
            n.enums = {k: v for k, v in n.enums.items() if k[0] != name}
            n.bump_schema_hash()
            self._persist()

    def get_tables(self, namespace: str) -> Dict[str, Table]:
        with self.lock:
            return dict(self.ns(namespace).tables)

    def get_hash(self, namespace: str) -> str:
        with self.lock:
            return self.ns(namespace).schema_hash

    def extend_enum(self, namespace: str, table: str, column: str,
                    cases: List[str]) -> List[int]:
        with self.lock:
            n = self.ns(namespace)
            key = (table, column)
            existing = n.enums.setdefault(key, [])
            known = {c: i for i, c in enumerate(existing)}
            ranks = []
            changed = False
            for c in cases:
                if c in known:
                    ranks.append(known[c])
                else:
                    known[c] = len(existing)
                    existing.append(c)
                    ranks.append(known[c])
                    changed = True
            if changed:
                n.bump_schema_hash()
                self._persist()
            return ranks

    def get_enums(self, namespace: str, table: str, column: str) -> List[str]:
        with self.lock:
            return list(self.ns(namespace).enums.get((table, column), []))

    # -- membership --

    def join(self, namespace: str, instance: Instance) -> None:
        with self.lock:
            n = self.ns(namespace)
            instance.last_heartbeat = time.time()
            n.instances[instance.name] = instance
            self._persist()

    def heartbeat(self, namespace: str, name: str,
                  shard_rows: Optional[Dict[int, int]] = None) -> None:
        with self.lock:
            n = self.ns(namespace)
            inst = n.instances.get(name)
            if inst is None:
                raise KeyError(f"unknown instance {name!r}")
            inst.last_heartbeat = time.time()
            if shard_rows is not None:
                inst.shard_rows = {int(k): int(v)
                                   for k, v in shard_rows.items()}

    def leave(self, namespace: str, name: str) -> None:
        with self.lock:
            self.ns(namespace).instances.pop(name, None)
            self._persist()

    def alive_instances(self, namespace: str) -> Dict[str, Instance]:
        with self.lock:
            n = self.ns(namespace)
            cutoff = time.time() - self.heartbeat_timeout
            return {k: v for k, v in n.instances.items()
                    if v.last_heartbeat >= cutoff}

    # -- placement --

    def init_placement(self, namespace: str, kind: str, num_shards: int,
                       replica_factor: int, instances: List[str]) -> Placement:
        with self.lock:
            n = self.ns(namespace)
            if kind in n.placements:
                raise ValueError(f"placement {kind!r} exists")
            p = Placement(num_shards=num_shards, replica_factor=replica_factor)
            for s in range(num_shards):
                sa = ShardAssignment(shard_id=s)
                for r in range(replica_factor):
                    owner = instances[(s * replica_factor + r) % len(instances)]
                    sa.instances[owner] = SHARD_INITIALIZING
                p.shards.append(sa)
            n.placements[kind] = p
            self._persist()
            return p

    def get_placement(self, namespace: str, kind: str) -> Placement:
        with self.lock:
            p = self.ns(namespace).placements.get(kind)
            if p is None:
                raise KeyError(f"no placement {kind!r}")
            return p

    def mark_available(self, namespace: str, kind: str, instance: str,
                       shard_id: Optional[int] = None) -> None:
        with self.lock:
            p = self.get_placement(namespace, kind)
            for sa in p.shards:
                if shard_id is not None and sa.shard_id != shard_id:
                    continue
                if instance in sa.instances:
                    sa.instances[instance] = SHARD_AVAILABLE
                    # once a replacement is available, leaving replicas of
                    # the shard can finally be dropped (m3 semantics)
                    for name in [n for n, st in sa.instances.items()
                                 if st == SHARD_LEAVING]:
                        del sa.instances[name]
            self._persist()

    def rebalance(self, namespace: str, kind: str) -> Dict[str, object]:
        """Skew-aware shard rebalance (BASELINE.md config 5).

        Shard weight = max per-shard row count reported by any alive
        replica's heartbeat. Greedy weighted reassignment: heaviest shard
        first onto the least-loaded alive instances, with stickiness — a
        current owner keeps its shard unless moving it would actually
        reduce imbalance (load exceeds the lightest node by more than the
        shard's own weight). Displaced owners go Leaving (bootstrap source)
        and joiners Initializing, the same m3-style lifecycle as
        replace_instance; datanodes converge via their placement poll.
        """
        with self.lock:
            p = self.get_placement(namespace, kind)
            n = self.ns(namespace)
            cutoff = time.time() - self.heartbeat_timeout
            alive = sorted(k for k, v in n.instances.items()
                           if v.last_heartbeat >= cutoff)
            if not alive:
                raise ValueError("no alive instances to rebalance onto")
            rf = min(p.replica_factor, len(alive))
            weights: Dict[int, int] = {}
            for sa in p.shards:
                w = 1
                for owner in sa.instances:
                    inst = n.instances.get(owner)
                    if inst is not None:
                        w = max(w, inst.shard_rows.get(sa.shard_id, 0))
                weights[sa.shard_id] = max(w, 1)

            load = {name: 0 for name in alive}
            chosen_by_shard: Dict[int, List[str]] = {}
            for sa in sorted(p.shards, key=lambda s: -weights[s.shard_id]):
                sid = sa.shard_id
                current = [o for o, st in sa.instances.items()
                           if st != SHARD_LEAVING and o in load]
                chosen: List[str] = []
                min_load = min(load.values())
                for o in sorted(current, key=lambda x: load[x]):
                    # strict <: at load == lightest + weight, moving the
                    # shard balances the pair exactly (e.g. two equal
                    # shards on one node + an empty joiner must split)
                    if len(chosen) < rf and \
                            load[o] < min_load + weights[sid]:
                        chosen.append(o)
                for o in sorted(alive, key=lambda x: (load[x], x)):
                    if len(chosen) >= rf:
                        break
                    if o not in chosen:
                        chosen.append(o)
                chosen_by_shard[sid] = chosen
                for o in chosen:
                    load[o] += weights[sid]

            moves = 0
            for sa in p.shards:
                chosen = set(chosen_by_shard[sa.shard_id])
                for o in list(sa.instances):
                    if o not in chosen:
                        sa.instances[o] = SHARD_LEAVING
                for o in chosen:
                    if sa.instances.get(o) not in (SHARD_AVAILABLE,
                                                   SHARD_INITIALIZING):
                        sa.instances[o] = SHARD_INITIALIZING
                        moves += 1
            self._persist()
            return {"moves": moves,
                    "load": load,
                    "weights": {str(k): v for k, v in weights.items()}}

    def replace_instance(self, namespace: str, kind: str, leaving: str,
                         joining: str) -> None:
        """Gradual replacement: the leaving instance stays as a bootstrap
        source (Leaving) until the joiner marks its shards Available
        (reference: m3 placement add/replace semantics the controller's
        placement handlers wrap)."""
        with self.lock:
            p = self.get_placement(namespace, kind)
            for sa in p.shards:
                if leaving in sa.instances:
                    sa.instances[leaving] = SHARD_LEAVING
                    sa.instances[joining] = SHARD_INITIALIZING
            self._persist()

    # -- ingestion jobs + assignment (reference ingestion_assignment.go) --

    def add_job(self, namespace: str, job: JobConfig) -> None:
        with self.lock:
            self.ns(namespace).jobs[job.name] = job
            self._recompute_assignments(namespace)
            self._persist()

    def delete_job(self, namespace: str, name: str) -> None:
        with self.lock:
            self.ns(namespace).jobs.pop(name, None)
            self._recompute_assignments(namespace)
            self._persist()

    def subscriber_heartbeat(self, namespace: str, name: str) -> None:
        with self.lock:
            n = self.ns(namespace)
            is_new = name not in n.subscribers
            n.subscribers[name] = time.time()
            if is_new:
                self._recompute_assignments(namespace)

    def _recompute_assignments(self, namespace: str) -> None:
        n = self.ns(namespace)
        cutoff = time.time() - self.heartbeat_timeout
        alive = sorted(s for s, hb in n.subscribers.items() if hb >= cutoff)
        if not alive:
            n.assignments = {}
            return
        ring = HashRing()
        for s in alive:
            ring.add(s)
        n.assignments = ring.assign(sorted(n.jobs))

    def get_assignment(self, namespace: str, subscriber: str) -> List[JobConfig]:
        with self.lock:
            n = self.ns(namespace)
            return [n.jobs[j] for j in n.assignments.get(subscriber, [])
                    if j in n.jobs]

    # -- persistence --

    def _persist(self) -> None:
        if not self.root_path:
            return
        os.makedirs(self.root_path, exist_ok=True)
        doc = {}
        for name, n in self.namespaces.items():
            doc[name] = {
                "tables": {t: tb.to_json() for t, tb in n.tables.items()},
                "enums": {f"{t}\x01{c}": v for (t, c), v in n.enums.items()},
                "placements": {
                    k: {
                        "numShards": p.num_shards,
                        "replicaFactor": p.replica_factor,
                        "shards": [
                            {"shardId": sa.shard_id, "instances": sa.instances}
                            for sa in p.shards
                        ],
                    } for k, p in n.placements.items()
                },
                "instances": {
                    k: {"name": v.name, "host": v.host, "port": v.port}
                    for k, v in n.instances.items()
                },
                "jobs": {k: asdict(v) for k, v in n.jobs.items()},
            }

        def write():
            tmp = os.path.join(self.root_path, "state.json.tmp")
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, os.path.join(self.root_path, "state.json"))

        if self.fence is None:
            write()
        else:
            self.fence(write)

    def _load(self) -> None:
        path = os.path.join(self.root_path, "state.json")
        if not os.path.exists(path):
            return
        with open(path) as f:
            doc = json.load(f)
        for name, nd in doc.items():
            n = Namespace(name)
            n.tables = {t: Table.from_json(td)
                        for t, td in nd.get("tables", {}).items()}
            n.enums = {tuple(k.split("\x01")): v
                       for k, v in nd.get("enums", {}).items()}
            for k, pd in nd.get("placements", {}).items():
                p = Placement(num_shards=pd["numShards"],
                              replica_factor=pd["replicaFactor"])
                for sd in pd["shards"]:
                    p.shards.append(ShardAssignment(
                        shard_id=sd["shardId"], instances=sd["instances"]))
                n.placements[k] = p
            for k, idesc in nd.get("instances", {}).items():
                n.instances[k] = Instance(**idesc)
            for k, jd in nd.get("jobs", {}).items():
                n.jobs[k] = JobConfig(**jd)
            n.bump_schema_hash()
            self.namespaces[name] = n
