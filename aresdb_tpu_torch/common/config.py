"""Server configuration with YAML ← flags overlay semantics.

Reference: common/config.go:119 AresServerConfig (viper/cobra overlay in
cmd/aresd/cmd/config.go). YAML field names match the reference so existing
config documents load unchanged.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class TimezoneConfig:
    table_name: str = ""

    _MAP = {"table_name": "table_name"}


@dataclass
class QueryConfig:
    device_memory_utilization: float = 0.95
    device_choosing_timeout: int = -1
    timezone_table: TimezoneConfig = field(default_factory=TimezoneConfig)
    enable_hash_reduction: bool = False
    # per-query execution deadline in seconds (0 = unlimited); extension
    # beyond the reference's QueryConfig (common/config.go:29), which only
    # bounds the wait for a device
    query_timeout: int = 0


@dataclass
class DiskStoreConfig:
    write_sync: bool = True


@dataclass
class HTTPConfig:
    max_connections: int = 300
    read_time_out_in_seconds: int = 20
    write_time_out_in_seconds: int = 300


@dataclass
class RedoLogConfig:
    disk_enabled: bool = True
    kafka_enabled: bool = False
    kafka_brokers: List[str] = field(default_factory=list)


@dataclass
class ClusterConfig:
    enable: bool = False
    distributed: bool = False
    namespace: str = ""
    instance_name: str = ""
    controller_address: str = ""
    heartbeat_interval_seconds: int = 10
    heartbeat_timeout_seconds: int = 30


@dataclass
class AresServerConfig:
    port: int = 9374
    debug_port: int = 43202
    root_path: str = "ares-root"
    total_memory_size: int = 0
    scheduler_off: bool = False
    version: str = ""
    query: QueryConfig = field(default_factory=QueryConfig)
    disk_store: DiskStoreConfig = field(default_factory=DiskStoreConfig)
    http: HTTPConfig = field(default_factory=HTTPConfig)
    redo_log: RedoLogConfig = field(default_factory=RedoLogConfig)
    cluster: ClusterConfig = field(default_factory=ClusterConfig)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AresServerConfig":
        cfg = cls()
        _apply(cfg, d, {
            "port": "port",
            "debug_port": "debug_port",
            "root_path": "root_path",
            "total_memory_size": "total_memory_size",
            "scheduler_off": "scheduler_off",
            "version": "version",
        })
        if "query" in d:
            _apply(cfg.query, d["query"], {
                "device_memory_utilization": "device_memory_utilization",
                "device_choosing_timeout": "device_choosing_timeout",
                "enable_hash_reduction": "enable_hash_reduction",
                "query_timeout": "query_timeout",
            })
            tz = d["query"].get("timezone_table", {})
            cfg.query.timezone_table.table_name = tz.get("table_name", "")
        if "disk_store" in d:
            _apply(cfg.disk_store, d["disk_store"], {"write_sync": "write_sync"})
        if "http" in d:
            _apply(cfg.http, d["http"], {
                "max_connections": "max_connections",
                "read_time_out_in_seconds": "read_time_out_in_seconds",
                "write_time_out_in_seconds": "write_time_out_in_seconds",
            })
        if "redo_log" in d:
            rl = d["redo_log"]
            cfg.redo_log.disk_enabled = rl.get("disk", {}).get("enabled", True)
            cfg.redo_log.kafka_enabled = rl.get("kafka", {}).get("enabled", False)
            cfg.redo_log.kafka_brokers = rl.get("kafka", {}).get("brokers", [])
        if "cluster" in d:
            _apply(cfg.cluster, d["cluster"], {
                "enable": "enable",
                "distributed": "distributed",
                "namespace": "namespace",
                "instance_name": "instance_name",
                "controller_address": "controller_address",
                "heartbeat_interval_seconds": "heartbeat_interval_seconds",
                "heartbeat_timeout_seconds": "heartbeat_timeout_seconds",
            })
        return cfg

    @classmethod
    def load(cls, path: Optional[str] = None,
             overrides: Optional[Dict[str, Any]] = None) -> "AresServerConfig":
        """defaults ← yaml file ← overrides (reference overlay semantics)."""
        d: Dict[str, Any] = {}
        if path:
            import yaml

            with open(path) as f:
                d = yaml.safe_load(f) or {}
        cfg = cls.from_dict(d)
        for k, v in (overrides or {}).items():
            obj = cfg
            parts = k.split(".")
            for p in parts[:-1]:
                obj = getattr(obj, p)
            setattr(obj, parts[-1], v)
        return cfg


def _apply(obj, d: Dict[str, Any], mapping: Dict[str, str]) -> None:
    for attr, key in mapping.items():
        if key in d:
            setattr(obj, attr, d[key])
