"""Subscriber daemon: controller-assigned streaming → Ares ETL jobs.

Reference: cmd/subscriber + subscriber/ (uber/fx app). Job configs come from
the controller's assignment endpoint; each job's `config` block describes
the transport, rules, and sink:

    {
      "name": "trips-ingest", "table": "trips", "topic": "trips-topic",
      "config": {
        "source": {"type": "file", "path": "/data/trips.jsonl"},
        "columns": ["request_at", "id", "fare"],
        "transformations": {
          "request_at": {"type": "timestamp", "source": "event_time"}
        },
        "sink": {"host": "localhost", "port": 9374, "numShards": 1,
                 "pkPositions": [1]}
      }
    }

    python -m aresdb_tpu_torch.cmd.subscriber --controller localhost:9474 \
        --namespace prod --name sub1
"""

from __future__ import annotations

import argparse
import sys
import time


def make_processor_factory(default_sink_host: str, default_sink_port: int):
    from aresdb_tpu_torch.client import Connector
    from aresdb_tpu_torch.subscriber.subscriber import (
        AresSink,
        FileConsumer,
        JobRules,
        KafkaConsumer,
        ListConsumer,
        StreamingProcessor,
        Transformation,
    )

    def make_processor(job: dict) -> StreamingProcessor:
        cfg = job.get("config", {})
        src = cfg.get("source", {})
        stype = src.get("type", "kafka")
        if stype == "file":
            consumer = FileConsumer(src["path"], topic=job.get("topic", ""))
        elif stype == "kafka":
            consumer = KafkaConsumer(src.get("brokers", []),
                                     job.get("topic", ""),
                                     src.get("group", job["name"]))
        else:
            consumer = ListConsumer([])
        rules = JobRules(
            job=job["name"],
            table=job["table"],
            columns=cfg.get("columns", []),
            sources={
                col: Transformation(
                    type=t.get("type", ""), source=t.get("source", col),
                    default=t.get("default"), context=t.get("context", {}))
                for col, t in cfg.get("transformations", {}).items()
            },
        )
        sink_cfg = cfg.get("sink", {})
        conn = Connector(sink_cfg.get("host", default_sink_host),
                         sink_cfg.get("port", default_sink_port))
        sink = AresSink(conn, num_shards=sink_cfg.get("numShards", 1),
                        pk_positions=sink_cfg.get("pkPositions", [0]))
        return StreamingProcessor(rules, consumer, sink,
                                  batch_size=cfg.get("batchSize", 1000))

    return make_processor


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ares-subscriber", description=__doc__)
    p.add_argument("--controller", required=True)
    p.add_argument("--namespace", required=True)
    p.add_argument("--name", required=True)
    p.add_argument("--sink-host", default="localhost")
    p.add_argument("--sink-port", type=int, default=9374)
    args = p.parse_args(argv)

    from aresdb_tpu_torch.subscriber.subscriber import SubscriberController

    sc = SubscriberController(
        args.controller, args.namespace, args.name,
        make_processor_factory(args.sink_host, args.sink_port))
    sc.start()
    print(f"ares-subscriber {args.name} running", file=sys.stderr)
    try:
        while True:
            time.sleep(5)
    except KeyboardInterrupt:
        sc.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
