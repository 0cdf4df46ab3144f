"""One run of one cell: set-up, the measured window, the per-layer
readings of a traced run, and the comparison that decides `correct`.

Everything that belongs to a cell is found by name:
- the cell's configuration, `BENCHMARK.json`'s `configs[].file`, with
  its generator and reference in `reference/<config>.py`;
- its traffic mix, `traffic/<config>.<traffic>.json`;
- its query set, `queries/<config>/<query>.json`;
- each per-layer metric's reader, `metrics/<metric>.py`.

Set-up draws the rows from the seed, loads them through the port's own
ingest (`TableShard.save_upsert_batch`, fed with `wire.py`'s bytes, the
redo log on), runs the Archiver, starts the daemon's HTTP API
(`cmd/aresd.build_server`, `ApiServer`) in this process, warms the
cell's queries once, and starts the cell's dashboards, and in an ingest
cell its senders, as processes of their own (`client.py`), on cores of
their own. The window drives `POST /query/aql` and, in an ingest cell,
`POST /data/<table>/0`, open loop, at the rates the traffic file fixes.
Once it has closed, the device's peak is read, the daemon stopped, and
the sampled answers judged by the numpy reference.
"""

from __future__ import annotations

import copy
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

import numpy as np

from portbench import stats as S
from portbench.reference import engine as E

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "aresdb_tpu")
LATE_S = 60.0          # an answer may come this long after the close
NAME_CHARS = 160       # a device operation's name in the breakdown


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """A workload of BENCHMARK.json with what it names, found by name.
    scale: configuration keys set anew (a rehearsal's tiny sizes; the
    table's `batchSize` under that key); traffic: traffic keys set anew."""

    def __init__(self, name: str, bench=None, root: Path = ROOT,
                 scale=None, traffic=None):
        bench = bench or load_json(root / "BENCHMARK.json")
        here = root / "portbench"
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise ValueError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = found[0]
        cfg_entry = next(c for c in bench["configs"]
                         if c["name"] == self.entry["config"])
        self.config = load_json(root / cfg_entry["file"])
        for k, v in (scale or {}).items():
            if k == "batchSize":
                self.config["table"]["config"]["batchSize"] = v
            else:
                self.config[k] = v
        self.traffic = load_json(here / "traffic" / (
            f"{self.entry['config']}.{self.entry['traffic']}.json"))
        self.traffic.update(traffic or {})
        qdir = here / "queries" / self.entry["config"]
        self.queries = {q: load_json(qdir / f"{q}.json")
                        for q in self.traffic["queries"]}
        self.end_to_end = [m for m in bench["end_to_end"]
                           if applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m, name)]
        self.gen = importlib.import_module(
            f"portbench.reference.{self.entry['config']}")


def body_of(q: dict, now: int) -> dict:
    """A query file's AQL with its "$now" set."""
    aql = copy.deepcopy(q["aql"])
    if aql.get("now") == "$now":
        aql["now"] = now
    return aql


def http_json(port: int, path: str, body: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


# ---------------------------------------------------------------------------
# set-up


class Daemon:
    """The port's daemon over a root of its own: the table created, the
    rows ingested, the Archiver run, the HTTP API started."""

    def __init__(self, cell: Cell, dep, root: str, device: str, log):
        from aresdb_tpu_torch.cmd import aresd
        from aresdb_tpu_torch.common.config import AresServerConfig
        from aresdb_tpu_torch.common.schema import Table
        from aresdb_tpu_torch.common.upsert_batch import UpsertBatch
        from aresdb_tpu_torch.memstore.archiving import Archiver

        cfg = AresServerConfig.load(None, {"root_path": root, "port": 0,
                                           "scheduler_off": True})
        self.server, self.ms, self.scheduler = aresd.build_server(
            cfg, device=device)
        table = cell.config["table"]
        self.table = table["name"]
        self.ms.create_table(Table.from_json(table))
        self.ms.add_table_shard(self.table, 0)
        schema = self.ms.get_schema(self.table)
        for col, cases in cell.config.get("enums", {}).items():
            schema.extend_enum(col, cases)
            self.ms.metastore.extend_enum_cases(self.table, col, cases)
        shard = self.ms.get_table_shard(self.table)
        t0 = time.monotonic()
        inserted = skipped = 0
        for blob in dep.upserts():
            st = shard.save_upsert_batch(UpsertBatch(blob))
            inserted += st.inserted
            skipped += (st.skipped_null_pk + st.skipped_retention
                        + st.skipped_future + st.updated + st.backfilled)
        ingest_s = time.monotonic() - t0
        if inserted != len(dep.rows) or skipped:
            raise RuntimeError(f"set-up: {inserted} of {len(dep.rows)} rows "
                               f"inserted, {skipped} otherwise")
        t0 = time.monotonic()
        got = Archiver(shard, self.ms.metastore, self.ms.diskstore).archive(
            dep.cutoff).rows_archived
        archive_s = time.monotonic() - t0
        if got != dep.n_archived:
            raise RuntimeError(f"set-up: {got} rows archived, "
                               f"{dep.n_archived} expected")
        log(f"set-up: {inserted} rows ingested in {ingest_s:.3f} s, "
            f"{got} archived in {archive_s:.3f} s")
        self.port = self.server.start_background()

    def stop(self) -> None:
        self.server.stop()
        self.scheduler.stop()
        self.ms.host_memory_manager.stop()
        self.ms.redolog_master.stop_all()


class Clients:
    """The cell's client processes, started at set-up."""

    def __init__(self, specs, workdir: str):
        self.procs = []
        try:
            for i, spec in enumerate(specs):
                path = os.path.join(workdir, f"client{i}.json")
                with open(path, "w") as f:
                    json.dump(spec, f)
                self.procs.append(subprocess.Popen(
                    [sys.executable, str(HERE / "client.py"), path],
                    cwd=str(ROOT), stdin=subprocess.PIPE,
                    stdout=subprocess.PIPE, text=True))
            for p in self.procs:
                line = p.stdout.readline()
                if line.strip() != "ready":
                    raise RuntimeError(f"a client did not start: {line!r}")
        except BaseException:
            self.kill()
            raise

    def go(self, start: float, end: float) -> None:
        for p in self.procs:
            p.stdin.write(f"go {start!r} {end!r}\n")
            p.stdin.flush()

    def results(self, deadline: float) -> list:
        out = []
        for p in self.procs:
            left = max(1.0, deadline - time.monotonic())
            text, _ = p.communicate(timeout=left)
            if p.returncode != 0:
                raise RuntimeError(f"a client exited with {p.returncode}")
            out.append(json.loads(text.strip().splitlines()[-1]))
        return out

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def client_specs(cell: Cell, dep, port: int, seed: int, workdir: str,
                 stream=None, cpus=None) -> list:
    """The dashboards' spec, then each sender's. cpus: the cores the
    client processes are pinned to (None: not pinned)."""
    t = cell.traffic
    bodies = {n: body_of(q, dep.now) for n, q in cell.queries.items()}
    seed_words = [int(x) for x in E.rng_of(seed, 9).integers(
        0, 2 ** 32, 2)]
    specs = [{"role": "dashboards", "port": port, "queries": t["queries"],
              "bodies": bodies, "dashboards": t["dashboards"],
              "refresh_s": t["refresh_s"], "connections": t["connections"],
              "warm_query": t["warm_query"], "seed": seed_words,
              "keep": t["answers_checked"], "cpus": cpus}]
    if stream is not None:
        ing = t["ingest"]
        gap = ing["rows_per_upsert"] / ing["rate_rows_per_s"] * ing["senders"]
        for s, blobs in enumerate(stream.blobs):
            path = os.path.join(workdir, f"sender{s}.bin")
            with open(path, "wb") as f:
                for b in blobs:
                    f.write(b)
            # sender s's k-th upsert is due at (k + s / senders) * gap
            specs.append({"role": "sender", "id": s, "port": port,
                          "path": f"/data/{cell.config['table']['name']}/0",
                          "blobs": path, "sizes": [len(b) for b in blobs],
                          "due": [(k + s / ing["senders"]) * gap
                                  for k in range(len(blobs))],
                          "cpus": cpus})
    return specs


def split_cores(client_cores: int = 2):
    """Pin this process to all its cores but the last `client_cores`, and
    return those for the client processes; None, pinning nothing, where
    it has fewer than twice as many."""
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) < 2 * client_cores:
        return None
    os.sched_setaffinity(0, cpus[:-client_cores])
    return cpus[-client_cores:]


def make_stream(cell: Cell, dep, seed: int, seconds: float):
    ing = cell.traffic.get("ingest")
    if not ing:
        return None
    per_sender = int(np.ceil(seconds * ing["rate_rows_per_s"]
                             / ing["rows_per_upsert"] / ing["senders"]))
    return cell.gen.Stream(dep, seed, ing["senders"], per_sender,
                           ing["rows_per_upsert"], ing["new_share"],
                           ing["window_s"])


# ---------------------------------------------------------------------------
# readings


class Context:
    """What a per-layer metric's reader reads: the window, the clients'
    records, the spans, the column cache's counts before and after, the
    device's activity, and each query's bytes."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def query_records(results: list) -> list:
    """[query, due, sent, answered, ok, request id] of every dashboard
    request due in the window."""
    return [[q, due, t0, t1, ok, f"0-{seq}"]
            for q, due, t0, t1, ok, seq in results[0]["records"]]


def upsert_records(results: list) -> list:
    """[sender, k, due, sent, acknowledged, ok] of every upsert due in
    the window."""
    return [[s] + rec for s, r in enumerate(results[1:])
            for rec in r["records"]]


def end_to_end(cell: Cell, queries: list, upserts: list, start: float,
               end: float, setup_s: float) -> dict:
    seconds = end - start
    ok = [r for r in queries if r[4]]
    vals = {"setup_s": setup_s}
    if ok:
        vals["query_p95_ms"] = S.percentile(
            [(r[3] - r[1]) * 1e3 for r in ok], 95)
    vals["queries_per_s"] = sum(1 for r in ok if r[3] <= end) / seconds
    acked = [r for r in upserts if r[5]]
    if acked:
        vals["upsert_p95_ms"] = S.percentile(
            [(r[4] - r[2]) * 1e3 for r in acked], 95)
    return {m["name"]: {"value": vals[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if m["name"] in vals}


def query_bytes(cell: Cell, dep) -> dict:
    """{query: the least bytes it moves}: each used column's values (and
    validity bits) read once over the rows it needs, and its output
    written once. The rows it needs are those in its time range; a
    filter drops a row's other columns, and drops the row entirely in the
    archive, where a filter on a sort column skips whole runs. The time
    column counts only where the query buckets by time."""
    rows = dep.rows
    t = rows.columns[rows.time_column]
    widths = {c["name"]: (16 if c["type"] == "UUID" else
                          np.dtype(rows.columns[c["name"]].dtype).itemsize)
              for c in cell.config["table"]["columns"]}
    sort_cols = {cell.config["table"]["columns"][i]["name"]
                 for i in cell.config["table"].get("archivingSortColumns",
                                                   [])}
    out = {}
    for name, q in cell.queries.items():
        spec = q["spec"]
        lo, hi = E.time_range(spec, dep.now)
        in_range = (t >= lo) & (t < hi)
        passing = E.selection(spec, rows, dep.now)
        filt = [f["column"] for f in spec.get("filters", ())]
        used = {d["column"] for d in spec["dims"]
                if d["column"] != rows.time_column or "time" in d}
        if spec["measure"] != "count":
            used.add(spec["column"])
        per_row = sum(widths[c] + (0.125 if c in rows.valid else 0)
                      for c in used | set(filt))
        filt_only = sum(widths[c] for c in filt)
        archived = t < dep.cutoff
        failing = in_range & ~passing
        skip_archived = bool(filt) and set(filt) <= sort_cols
        n_fail = int(np.count_nonzero(failing & ~archived)) + (
            0 if skip_archived else int(np.count_nonzero(failing & archived)))
        out[name] = dict(rows=int(np.count_nonzero(passing)),
                         per_row=per_row, filt_only=filt_only,
                         n_fail=n_fail, out_row=4 * len(spec["dims"]) + 8)
    return out


def bytes_of(qb: dict, groups: int) -> float:
    return (qb["rows"] * qb["per_row"] + qb["n_fail"] * qb["filt_only"]
            + groups * qb["out_row"])


def per_layer(cell: Cell, ctx: Context) -> dict:
    out = {}
    for m in cell.per_layer:
        reader = importlib.import_module(f"portbench.metrics.{m['name']}")
        v = reader.read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def breakdown(ctx: Context) -> dict:
    """The device operations that took most time in the window, and its
    longest idle gaps, each named by what the benchmark's spans say the
    host was doing."""
    by_name = {}
    for name, s, e in ctx.device:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    ops = [(k if len(k) <= NAME_CHARS else k[:NAME_CHARS] + "...", v)
           for k, v in ops]
    spans = [(s, e) for s, e, _ in ctx.spans.values()]
    idle = sorted(S.gaps([(s, e) for _, s, e in ctx.device], *ctx.window),
                  key=lambda g: g[0] - g[1])[:10]
    named = []
    for s, e in idle:
        mid = (s + e) / 2
        n_q = sum(1 for a, b in spans if a <= mid < b)
        n_u = sum(1 for a, b in ctx.store_spans if a <= mid < b)
        what = (f"{n_q} queries in the service" if n_q else
                "no query in the service")
        if n_u:
            what += f", {n_u} upserts in the store"
        named.append([what, e - s])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}


# ---------------------------------------------------------------------------
# correctness


def judge(cell: Cell, dep, results: list, stream, readback, upserts,
          wants: dict) -> tuple:
    """([(name, value, limit)] of the numbers compared, how many answers
    were compared). Over the sampled answers of the window (and, in an
    ingest cell, the answers read back after it with every acknowledged
    upsert applied): whether none was compared, the groups that differ
    from the reference's, the counts that differ, the largest relative
    error of a sum or an average, and the answers that failed; in an
    ingest cell also the upserts never acknowledged. wants: the
    reference's answers by key, filled as they are worked out."""
    limits = cell.traffic["limits"]
    got = {"group_mismatches": 0, "count_mismatches": 0, "sum_rel_err": 0.0,
           "answers_failed": 0}
    stable = stream is None
    final = dep.rows
    if stream is not None:
        acked = {}
        for s, k, _due, _t0, _t1, ok in sorted(upserts):
            if ok:
                acked.setdefault(s, []).append(k)
        final = stream.applied(dep, acked)

    def want(name, rows, key):
        if key not in wants:
            wants[key] = E.answer(cell.queries[name]["spec"], rows, dep.now)
        return wants[key]

    def add(name, text, rows, key):
        answer = json.loads(text)
        if answer.get("errors"):
            got["answers_failed"] += 1
            return
        c = E.compare(cell.queries[name]["spec"], answer["results"][0],
                      want(name, rows, key))
        got["group_mismatches"] += c["group_mismatch"]
        got["count_mismatches"] += c["count_mismatch"]
        got["sum_rel_err"] = max(got["sum_rel_err"], c["sum_rel_err"])

    bounds = {}
    if stream is not None:
        every = stream.applied(dep, stream.every())
        for name in cell.traffic["ingest"]["checked_in_window"]:
            spec = cell.queries[name]["spec"]
            bounds[name] = (E.answer(spec, dep.rows, dep.now),
                            E.answer(spec, every, dep.now))
    n = 0
    for r in results:
        for _seq, name, text in r.get("failed", []):
            got["answers_failed"] += 1
        for _seq, name, text in r.get("kept", []):
            if stable:
                add(name, text, final, name)
                n += 1
            else:
                n += add_window_bounds(cell, bounds, name, text, got)
    for name, text in (readback or {}).items():
        add(name, text, final, ("final", name))
    compared = n + len(readback or {})
    checks = [("no_answer_compared", int(compared == 0), 0)]
    checks += [(k, got[k], limits[k]) for k in
               ("group_mismatches", "count_mismatches", "sum_rel_err",
                "answers_failed")]
    if stream is not None:
        checks.append(("upserts_unacknowledged",
                       sum(1 for u in upserts if not u[5]), 0))
    return checks, compared


def add_window_bounds(cell, bounds, name, text, got) -> bool:
    """An ingest cell's answer of the window, of a query that the
    traffic's upserts only raise (`checked_in_window`: no update moves a
    row between its groups, no new row lowers one): every group lies
    between the reference over the set-up's rows and that over every
    upsert. The other queries' answers are read back after the window."""
    if name not in bounds:
        return False
    spec = cell.queries[name]["spec"]
    answer = json.loads(text)
    if answer.get("errors"):
        got["answers_failed"] += 1
        return True
    lo, hi = bounds[name]
    tol = 0.0 if spec["measure"] == "count" else \
        cell.traffic["limits"]["sum_rel_err"]
    flat = E.flatten(answer["results"][0])
    for k, v in flat.items():
        if k not in hi or not isinstance(v, (int, float)):
            got["group_mismatches"] += 1
            continue
        a, b = lo.get(k, 0.0), hi[k]
        if not (a * (1 - tol) <= v <= b * (1 + tol)):
            if spec["measure"] == "count":
                got["count_mismatches"] += 1
            else:
                got["sum_rel_err"] = max(got["sum_rel_err"], abs(
                    v - min(max(v, a), b)) / max(abs(b), 1e-30))
    for k in lo:
        if k not in flat:
            got["group_mismatches"] += 1
    return True


# ---------------------------------------------------------------------------
# the run


def set_up(cell: Cell, seed: int, device: str, work: str, log):
    """(deployment, daemon, bodies): the rows drawn from the seed, loaded
    into a daemon over a root in `work`, and each of the cell's queries
    answered once, which compiles whatever it needs."""
    t0 = time.monotonic()
    dep = cell.gen.generate(cell.config, seed, int(time.time()))
    log(f"set-up: {len(dep.rows)} rows drawn in "
        f"{time.monotonic() - t0:.3f} s")
    daemon = Daemon(cell, dep, os.path.join(work, "root"), device, log)
    try:
        t0 = time.monotonic()
        bodies = {n: body_of(q, dep.now) for n, q in cell.queries.items()}
        for n, b in bodies.items():
            resp = http_json(daemon.port, "/query/aql", {"queries": [b]})
            if resp.get("errors"):
                raise RuntimeError(f"warm-up {n}: {resp['errors']}")
        log(f"set-up: each query answered once in "
            f"{time.monotonic() - t0:.3f} s")
    except BaseException:
        daemon.stop()
        raise
    return dep, daemon, bodies


def drive(cell: Cell, dep, port: int, seed: int, seconds: float,
          work: str, cpus=None, at_start=None, at_close=None) -> dict:
    """One window: the cell's client processes started, then sent off
    together for `seconds`; their records once each has finished.
    at_start() runs just before the window opens, at_close() as it
    closes. {results, stream, start, end, cpu}: cpu, the CPU seconds this
    process took in the window."""
    stream = make_stream(cell, dep, seed, seconds)
    clients = Clients(client_specs(cell, dep, port, seed, work, stream,
                                   cpus), work)
    try:
        if at_start is not None:
            at_start()
        start = time.monotonic() + 0.05
        end = start + seconds
        cpu0 = os.times()
        clients.go(start, end)
        time.sleep(max(0.0, end - time.monotonic()))
        cpu1 = os.times()
        if at_close is not None:
            at_close()
        results = clients.results(end + LATE_S + 30.0)
    finally:
        clients.kill()
    cpu = (cpu1.user + cpu1.system) - (cpu0.user + cpu0.system)
    return {"results": results, "stream": stream, "start": start,
            "end": end, "cpu": cpu}


class Tracer:
    """The traced run's readings: the benchmark's spans, the profiler and
    the column cache's counts over the window."""

    def __init__(self, cuda: bool):
        from portbench.devtrace import DeviceTrace, Spans

        self.spans = Spans()
        self.dtrace = DeviceTrace() if cuda else None
        self.cache = []

    def start(self) -> None:
        from aresdb_tpu_torch.query import executor as X

        self.spans.install()
        self.cache.append(X.GLOBAL_DEVICE_CACHE.stats())
        if self.dtrace is not None:
            self.dtrace.start()

    def close(self) -> None:
        from aresdb_tpu_torch.query import executor as X

        if self.dtrace is not None:
            self.dtrace.stop()
        self.cache.append(X.GLOBAL_DEVICE_CACHE.stats())


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start=None, log=None, cpus=None,
             keep=None) -> dict:
    """One run of `cell`: the result line's object, `checks` last. t_start:
    the process's start on time.monotonic() (set-up counts from it).
    cpus: the cores of the client processes. keep: a dict that takes the
    window and the upserts' records."""
    t_start = time.monotonic() if t_start is None else t_start
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    cuda = device == "cuda"
    import torch

    tracer = Tracer(cuda) if trace else None
    readback = None
    with tempfile.TemporaryDirectory(prefix="portbench-") as work:
        dep, daemon, bodies = set_up(cell, seed, device, work, log)
        try:
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            w = drive(cell, dep, daemon.port, seed, seconds, work, cpus,
                      None if tracer is None else tracer.start,
                      None if tracer is None else tracer.close)
            results, stream, start, end = (w["results"], w["stream"],
                                           w["start"], w["end"])
            setup_s = start - t_start
            peak = torch.cuda.max_memory_allocated() if cuda else 0
            if stream is not None:
                readback = {n: json.dumps(http_json(
                    daemon.port, "/query/aql", {"queries": [b]}))
                    for n, b in bodies.items()}
            written = disk_bytes(work)
        finally:
            if tracer is not None:
                tracer.spans.remove()
            daemon.stop()
        del daemon
        queries = query_records(results)
        upserts = upsert_records(results)
        if keep is not None:
            keep.update(window=(start, end), upserts=upserts)
        log(summary(queries, upserts, start, end, w["cpu"]))
        attempted = len(queries) + len(upserts)
        failed = sum(1 for r in queries if not r[4]) + \
            sum(1 for u in upserts if not u[5])
        wants = {}
        if trace:
            wants.update((n, E.answer(q["spec"], dep.rows, dep.now))
                         for n, q in cell.queries.items())
            dtrace = tracer.dtrace
            ctx = Context(window=(start, end), records=queries,
                          upserts=upserts, spans=tracer.spans.query,
                          store_spans=tracer.spans.store,
                          cache=tuple(tracer.cache),
                          device=(None if dtrace is None else
                                  S.clip_events(dtrace.events, start, end)),
                          query_bytes=query_bytes(cell, dep),
                          groups={n: len(wants[n]) for n in cell.queries})
            metrics = per_layer(cell, ctx)
        else:
            metrics = end_to_end(cell, queries, upserts, start, end, setup_s)
        checks, compared = judge(cell, dep, results, stream, readback,
                                 upserts, wants)
    correct = all(value <= limit for _, value, limit in checks)
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics}
    if cuda:
        out["device"] = {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "count": 1, "memory_peak_bytes": int(peak)}
    else:
        out["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                         "memory_peak_bytes": 0}
    if trace and tracer.dtrace is not None:
        busy = S.covered([(s, e) for _, s, e in ctx.device])
        out["device"].update(busy_s=busy, window_s=end - start)
        out["breakdown"] = breakdown(ctx)
        log(f"trace: the profiler's clock {tracer.dtrace.clock}, "
            f"{len(tracer.dtrace.events)} device events, "
            f"{len(ctx.device)} in the window")
    log(f"run: {compared} answers compared; the store's files hold "
        f"{written} bytes at the close (redo log and archive)")
    out["checks"] = {name: {"value": value, "limit": limit}
                     for name, value, limit in checks}
    return out


def summary(queries, upserts, start, end, cpu) -> str:
    """A line on the window: each query's count, median and p95 ms from
    its due time, the upserts', and the CPU seconds this process took in
    it."""
    parts = []
    for name in sorted({r[0] for r in queries}):
        ms = [(r[3] - r[1]) * 1e3 for r in queries
              if r[0] == name and r[4]]
        if ms:
            parts.append(f"{name} {len(ms)} x {S.percentile(ms, 50):.1f}/"
                         f"{S.percentile(ms, 95):.1f} ms")
    acked = [(u[4] - u[2]) * 1e3 for u in upserts if u[5]]
    if acked:
        parts.append(f"upserts {len(acked)} x {S.percentile(acked, 50):.1f}/"
                     f"{S.percentile(acked, 95):.1f} ms from due")
    return (f"window: {'; '.join(parts)} (median/p95 from due); this "
            f"process {cpu:.1f} CPU s in {end - start:.1f} s")


def disk_bytes(path: str) -> int:
    """The bytes the files under path hold."""
    total = 0
    for d, _, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(d, f))
            except OSError:
                pass
    return total


def forbidden_modules() -> list:
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)
