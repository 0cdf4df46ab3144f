"""A client process of the benchmark: the open-loop dashboards of a
cell, or an open-loop upsert sender, against the daemon's HTTP API on
localhost.

    python3 portbench/client.py <spec.json>

Standard library and numpy only: it imports neither torch nor the port.
It reads its spec, pins itself to the spec's cores, connects, sends its
warm-up requests, prints "ready", then waits for a line "go <start>
<end>" (time.monotonic() seconds, which every process of the host
shares) on standard input, works from start to end, and prints one JSON
object of what it recorded.

The dashboards refresh on a fixed schedule (`schedule`): each sends its
panels at once every `refresh_s` seconds, the dashboards' phases spread
evenly over the period. A pool of `connections` threads, each on a
connection of its own, sends every request at its due time, or as soon
as a thread is free where they all are busy, and goes on past the close
until every request due in the window has been sent and answered. Each
request is recorded as (query, due, sent, answered, ok, seq); the body of
the answers whose seq the seed picked (`keep` of them) and of every
answer that failed is kept. A sender posts its upserts each at its due
time (start + due[k]), or at once where it runs late, and records (k,
due, sent, acknowledged, ok).
"""

from __future__ import annotations

import http.client
import json
import os
import sys
import threading
import time

import numpy as np

LATE_S = 60.0   # as bench.LATE_S: a request may be sent this long after
                # the close


def post(conn, path: str, body: bytes, ctype: str) -> tuple:
    conn.request("POST", path, body=body,
                 headers={"Content-Type": ctype,
                          "Content-Length": str(len(body))})
    resp = conn.getresponse()
    return resp.status, resp.read()


def query(conn, body: bytes) -> tuple:
    """(ok, body text) of one AQL request."""
    try:
        status, data = post(conn, "/query/aql", body, "application/json")
    except (OSError, http.client.HTTPException) as e:
        return False, f"error: {e!r}"
    text = data.decode()
    if status != 200:
        return False, text
    answer = json.loads(text)
    return not answer.get("errors"), text


def schedule(spec: dict, start: float, end: float) -> list:
    """[(due, query)] of every request due in [start, end), by due time:
    dashboard d's k-th refresh is due at start + (phase[d] + k) * period
    / dashboards, every panel of it at once. The seed orders the phases
    and each refresh's panels, and never changes the set of due times."""
    rng = np.random.default_rng(spec["seed"])
    n, period = spec["dashboards"], spec["refresh_s"]
    phase = rng.permutation(n)
    out = []
    for d in range(n):
        k = 0
        while True:
            due = start + (phase[d] / n + k) * period
            if due >= end:
                break
            out += [(due, spec["queries"][i])
                    for i in rng.permutation(len(spec["queries"]))]
            k += 1
    out.sort(key=lambda r: r[0])
    return out


def dashboards(spec: dict) -> dict:
    """Open-loop dashboards over a pool of connections. A request still
    unsent LATE_S after the close is recorded as failed."""
    bodies = {n: spec["bodies"][n] for n in spec["queries"]}
    conns = [http.client.HTTPConnection("127.0.0.1", spec["port"],
                                        timeout=600)
             for _ in range(spec["connections"])]
    warm = json.dumps({"queries": [bodies[spec["warm_query"]]]}).encode()
    for conn in conns:
        ok, text = query(conn, warm)
        if not ok:
            raise SystemExit(f"warm-up: {text[:500]}")
    start, end = ready()
    todo = schedule(spec, start, end)
    pick = np.random.default_rng(spec["seed"] + [1])
    keep = set(pick.choice(len(todo), min(spec["keep"], len(todo)),
                           replace=False).tolist()) if todo else set()
    records, kept, failed = [None] * len(todo), [], []
    lock = threading.Lock()
    at = [0]

    def work(conn):
        while True:
            with lock:
                seq = at[0]
                at[0] += 1
            if seq >= len(todo):
                return
            due, name = todo[seq]
            wait = due - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            t0 = time.monotonic()
            if t0 > end + LATE_S:
                ok, text, t1 = False, "not sent by the deadline", t0
            else:
                body = json.dumps({"queries": [bodies[name]],
                                   "portbenchId": f"0-{seq}"}).encode()
                ok, text = query(conn, body)
                t1 = time.monotonic()
            with lock:
                records[seq] = [name, due, t0, t1, ok, seq]
                if not ok:
                    failed.append([seq, name, text])
                elif seq in keep:
                    kept.append([seq, name, text])

    threads = [threading.Thread(target=work, args=(c,)) for c in conns]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for conn in conns:
        conn.close()
    kept.sort()
    return {"records": records, "kept": kept, "failed": failed}


def sender(spec: dict) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", spec["port"], timeout=600)
    with open(spec["blobs"], "rb") as f:
        data = f.read()
    blobs, at = [], 0
    for size in spec["sizes"]:
        blobs.append(data[at:at + size])
        at += size
    start, end = ready()
    records = []
    for k, (due, blob) in enumerate(zip(spec["due"], blobs)):
        due_at = start + due
        if due_at >= end:
            break
        wait = due_at - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        t0 = time.monotonic()
        try:
            status, body = post(conn, spec["path"], blob,
                                "application/octet-stream")
            ok = status == 200
        except (OSError, http.client.HTTPException):
            ok = False
        records.append([k, due_at, t0, time.monotonic(), ok])
    conn.close()
    return {"records": records}


def ready() -> tuple:
    print("ready", flush=True)
    line = sys.stdin.readline().split()
    if not line or line[0] != "go":
        raise SystemExit("no go")
    start, end = float(line[1]), float(line[2])
    wait = start - time.monotonic()
    if wait > 0:
        time.sleep(wait)
    return start, end


def main() -> int:
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    if spec.get("cpus"):
        os.sched_setaffinity(0, spec["cpus"])
    out = (dashboards if spec["role"] == "dashboards" else sender)(spec)
    sys.stdout.write(json.dumps(out) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
