"""examples: load a reference-format dataset and run its query documents.

Reference: examples/examples.go (cobra tool with tables/data/query
subcommands over examples/1k_trips). Dataset layout:

    <dataset>/schema/<table>.json     table schemas
    <dataset>/data/<table>.csv        rows ({Nd}/{Nh}/{Nm} time placeholders)
    <dataset>/queries/<name>.aql|.sql query documents

    python -m aresdb_tpu_torch.cmd.examples tables --dataset .../1k_trips
    python -m aresdb_tpu_torch.cmd.examples data   --dataset .../1k_trips
    python -m aresdb_tpu_torch.cmd.examples query  --dataset .../1k_trips
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import random
import sys
import time

_UNIT_SECONDS = {"d": 86400, "h": 3600, "m": 60}


def parse_time_placeholder(s: str, now: int) -> int:
    """'{1d}' → random ts in [now-1d, now) (reference examples/utils)."""
    t = s.strip().strip("{}")
    n, unit = int(t[:-1]), t[-1]
    secs = n * _UNIT_SECONDS[unit]
    return now - secs + random.randint(0, secs - 1)


def cmd_tables(args, conn):
    d = os.path.join(args.dataset, "schema")
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f)) as fh:
            schema = json.load(fh)
        try:
            conn.create_table(schema)
            print(f"created table {schema['name']}")
        except Exception as e:
            print(f"table {schema['name']}: {e}", file=sys.stderr)


def cmd_data(args, conn):
    now = int(time.time())
    d = os.path.join(args.dataset, "data")
    for f in sorted(os.listdir(d)):
        table = os.path.splitext(f)[0]
        if table == "arraytest":
            # reference ingestDataForArrayTestTable: deterministic
            # generated batches, not the raw templated CSV
            from aresdb_tpu_torch.cmd.example_data import (ARRAYTEST_COLUMNS,
                                                     gen_arraytest_batches)
            total = 0
            for rows in gen_arraytest_batches(now):
                stats = conn.insert(table, ARRAYTEST_COLUMNS, rows)
                total += stats.get("inserted", 0) + stats.get("updated", 0)
            print(f"{table}: {total} rows")
            continue
        with open(os.path.join(d, f)) as fh:
            reader = csv.reader(fh)
            columns = next(reader)
            rows = []
            for rec in reader:
                row = []
                for v in rec:
                    v = v.strip()
                    if v.startswith("{") and v.endswith("}"):
                        row.append(parse_time_placeholder(v, now))
                    elif v == "":
                        row.append(None)
                    else:
                        row.append(v)
                rows.append(row)
        stats = conn.insert(table, columns, rows)
        print(f"{table}: {stats}")


def cmd_query(args, conn):
    d = os.path.join(args.dataset, "queries")
    for f in sorted(os.listdir(d)):
        path = os.path.join(d, f)
        name, ext = os.path.splitext(f)
        with open(path) as fh:
            doc = json.load(fh)
        if ext == ".aql":
            resp = conn.session.post(
                f"http://{conn.host}:{conn.port}/query/aql", json=doc).json()
        elif ext == ".sql":
            resp = conn.session.post(
                f"http://{conn.host}:{conn.port}/query/sql", json=doc).json()
        else:
            continue
        print(f"=== {name} ===")
        print(json.dumps(resp, indent=1, default=str)[:2000])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="examples", description=__doc__)
    p.add_argument("command", choices=["tables", "data", "query"])
    p.add_argument("--dataset", required=True)
    p.add_argument("--host", default="localhost")
    p.add_argument("--port", type=int, default=9374)
    args = p.parse_args(argv)

    from aresdb_tpu_torch.client import Connector

    conn = Connector(args.host, args.port)
    {"tables": cmd_tables, "data": cmd_data, "query": cmd_query}[
        args.command](args, conn)
    return 0


if __name__ == "__main__":
    sys.exit(main())
