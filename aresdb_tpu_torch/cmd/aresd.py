"""aresd: the single-node daemon.

Reference: cmd/aresd/cmd/cmd.go:129-371 — metastore + diskstore + redolog +
memstore construction, schema fetch, shard recovery, scheduler start, HTTP
serving. Port of `aresdb_tpu/cmd/aresd.py`; queries run on `cuda` unless
`--device cpu` is given. With `--controller` the daemon is a datanode of
a cluster (run_datanode).

    python -m aresdb_tpu_torch.cmd.aresd --port 9374 --root-path ares-root
    python -m aresdb_tpu_torch.cmd.aresd --port 0 --root-path dn0-root \
        --controller localhost:9474 --namespace prod --instance dn0
"""

from __future__ import annotations

import argparse
import sys
import threading


def build_server(cfg, device=None):
    """(ApiServer, MemStore, Scheduler) over cfg.root_path: the store's
    schemas fetched and its shards recovered, the scheduler started unless
    cfg.scheduler_off, and the batch-stats reporter started. The server is
    not started."""
    from aresdb_tpu_torch.api.server import ApiServer
    from aresdb_tpu_torch.diskstore.local_diskstore import LocalDiskStore
    from aresdb_tpu_torch.memstore.batchstats import BatchStatsReporter
    from aresdb_tpu_torch.memstore.memstore import MemStore
    from aresdb_tpu_torch.memstore.scheduler import Scheduler
    from aresdb_tpu_torch.metastore.disk_metastore import DiskMetaStore

    metastore = DiskMetaStore(cfg.root_path)
    diskstore = LocalDiskStore(cfg.root_path)
    memstore = MemStore(metastore, diskstore,
                        total_memory_bytes=cfg.total_memory_size)
    memstore.fetch_schema()
    memstore.init_shards()

    scheduler = Scheduler(memstore)
    if not cfg.scheduler_off:
        scheduler.start()
        scheduler.enable()

    stats_reporter = BatchStatsReporter(memstore)
    stats_reporter.start()

    server = ApiServer(memstore, scheduler, port=cfg.port,
                       timezone_table=cfg.query.timezone_table.table_name,
                       query_config=cfg.query, device=device)
    return server, memstore, scheduler


def start_datanode(cfg, device=None):
    """Distributed mode (reference: cmd/aresd cluster flow — etcd advertise
    + topology watch replaced by the HTTP controller): the node registers
    with the controller, polls placement for its shard set, bootstraps
    shards from peers, and serves queries for its shards on `device`; its
    scheduler runs unless cfg.scheduler_off. Returns the serving DataNode.
    Each peer copy's attempts are logged to standard error."""
    import logging

    from aresdb_tpu_torch.datanode.datanode import DataNode
    from aresdb_tpu_torch.diskstore.local_diskstore import LocalDiskStore
    from aresdb_tpu_torch.memstore.memstore import MemStore
    from aresdb_tpu_torch.memstore.scheduler import Scheduler
    from aresdb_tpu_torch.metastore.disk_metastore import DiskMetaStore

    logging.basicConfig(stream=sys.stderr)
    logging.getLogger("aresdb.datanode").setLevel(logging.INFO)
    memstore = MemStore(DiskMetaStore(cfg.root_path),
                        LocalDiskStore(cfg.root_path),
                        total_memory_bytes=cfg.total_memory_size)
    node = DataNode(
        memstore, Scheduler(memstore),
        controller_address=cfg.cluster.controller_address,
        namespace=cfg.cluster.namespace,
        instance_name=cfg.cluster.instance_name,
        port=cfg.port,
        heartbeat_seconds=cfg.cluster.heartbeat_interval_seconds,
        device=device)
    port = node.open()
    node.serve(scheduler_on=not cfg.scheduler_off)
    print(f"aresd datanode {cfg.cluster.instance_name!r} serving on :{port} "
          f"(namespace={cfg.cluster.namespace}, "
          f"controller={cfg.cluster.controller_address}, "
          f"device={node.server.ctx.device})", file=sys.stderr, flush=True)
    return node


def run_datanode(cfg, device=None) -> int:
    """start_datanode, then serve until interrupted."""
    node = start_datanode(cfg, device)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        node.close()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="aresd", description=__doc__)
    p.add_argument("--config", help="YAML config file")
    p.add_argument("--port", type=int, help="HTTP port")
    p.add_argument("--root-path", dest="root_path", help="data root directory")
    p.add_argument("--scheduler-off", action="store_true", default=None)
    p.add_argument("--controller", help="controller host:port "
                   "(enables distributed datanode mode)")
    p.add_argument("--namespace", help="cluster namespace")
    p.add_argument("--instance", help="instance name in the placement")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where queries run")
    args = p.parse_args(argv)

    from aresdb_tpu_torch.common.config import AresServerConfig

    overrides = {}
    if args.port is not None:
        overrides["port"] = args.port
    if args.root_path is not None:
        overrides["root_path"] = args.root_path
    if args.scheduler_off:
        overrides["scheduler_off"] = True
    if args.controller:
        overrides["cluster.enable"] = True
        overrides["cluster.distributed"] = True
        overrides["cluster.controller_address"] = args.controller
        overrides["cluster.namespace"] = args.namespace or "default"
        overrides["cluster.instance_name"] = args.instance or "datanode0"
    cfg = AresServerConfig.load(args.config, overrides)

    if cfg.cluster.enable and cfg.cluster.distributed:
        return run_datanode(cfg, device=args.device)

    server, memstore, scheduler = build_server(cfg, device=args.device)
    port = server.start_background()
    print(f"aresd serving on :{port} (root={cfg.root_path}, "
          f"device={server.ctx.device})", file=sys.stderr, flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.stop()
        scheduler.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
