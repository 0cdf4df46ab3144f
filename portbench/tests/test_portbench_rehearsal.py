"""Rehearsals of each cell on the CPU at a tiny size: set-up, a short
window of requests from the client processes, and the comparison. They
print no device metric. With the timed path broken underneath,
`correct` comes out false; the measuring command itself fails without a
card; a traffic file dropped into traffic/ is a cell with no code edit."""

import json
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, TINY, TINY_LOAD
from portbench import bench

DEVICE_METRICS = {"scan_roofline", "device_idle_pct"}
SEED = 2 ** 31 + 11


def bench_json():
    return bench.load_json(ROOT / "BENCHMARK.json")


def with_ingest(b):
    """BENCHMARK.json with the ingest cell in it, where it is not."""
    b = json.loads(json.dumps(b))
    if not any(w["name"] == "uber_trips.ingest" for w in b["workloads"]):
        b["workloads"].append({"name": "uber_trips.ingest",
                               "config": "uber_trips", "traffic": "ingest",
                               "chips": 1, "why": "rehearsal"})
        b["end_to_end"].append({"name": "upsert_p95_ms", "unit": "ms",
                                "better": "lower", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["uber_trips.ingest"]})
    return b


TINY_INGEST = {"rate_rows_per_s": 2000, "rows_per_upsert": 100,
               "senders": 2, "new_share": 0.5, "window_s": 3600,
               "checked_in_window": ["D3", "D4"]}


def rehearse(name, trace=False, b=None, traffic=None, root=ROOT):
    cell = bench.Cell(name, bench=b or bench_json(), root=root,
                      scale=TINY[name.split(".")[0]],
                      traffic=dict(TINY_LOAD, **(traffic or {})))
    return bench.run_cell(cell, SEED, 1.5, trace, device="cpu",
                          log=lambda s: None)


@pytest.mark.parametrize("name,trace", [
    ("uber_trips.dash", False), ("uber_trips.dash", True)])
def test_a_cell_rehearses_correct_on_the_cpu(name, trace):
    out = rehearse(name, trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out["checks"]) == [
        "no_answer_compared", "group_mismatches", "count_mismatches",
        "sum_rel_err", "answers_failed"]
    assert list(out)[-1] == "checks"
    assert not DEVICE_METRICS & set(out["metrics"])
    assert "busy_s" not in out["device"]
    if trace:
        assert {"http_ms", "batch_exec_ms", "cache_hit_pct"} <= \
            set(out["metrics"])
    else:
        assert {"query_p95_ms", "queries_per_s", "setup_s"} == \
            set(out["metrics"])


def test_the_ingest_cell_rehearses_correct_and_reads_back():
    out = rehearse("uber_trips.ingest", b=with_ingest(bench_json()),
                   traffic={"ingest": TINY_INGEST})
    assert out["correct"], out["checks"]
    assert out["checks"]["upserts_unacknowledged"]["value"] == 0
    assert "upsert_p95_ms" in out["metrics"]


def halve_batches(monkeypatch):
    from aresdb_tpu_torch.query import executor as X

    real = X.ShardExecutor._iter_batches

    def every_other(self, *a, **kw):
        for i, item in enumerate(real(self, *a, **kw)):
            if i % 2 == 0:
                yield item

    monkeypatch.setattr(X.ShardExecutor, "_iter_batches", every_other)


def alter_answers(monkeypatch):
    from aresdb_tpu_torch.query import service

    real = service.build_agg_result

    def altered(plan, table):
        out = real(plan, table)
        d = out
        while isinstance(d, dict) and d:
            k = next(iter(d))
            if not isinstance(d[k], dict):
                d[k] = d[k] * 1.001 + 1
                break
            d = d[k]
        return out

    monkeypatch.setattr(service, "build_agg_result", altered)


def drop_upserts(monkeypatch):
    from aresdb_tpu_torch.memstore.table_shard import (IngestionStats,
                                                       TableShard)

    real = TableShard.save_upsert_batch

    def unchanged(self, batch, *a, **kw):
        if batch.num_rows == TINY_INGEST["rows_per_upsert"]:  # a sender's
            return IngestionStats()
        return real(self, batch, *a, **kw)

    monkeypatch.setattr(TableShard, "save_upsert_batch", unchanged)


@pytest.mark.parametrize("name,fault", [
    ("uber_trips.dash", halve_batches), ("uber_trips.dash", alter_answers),
    ("uber_trips.ingest", halve_batches), ("uber_trips.ingest", alter_answers),
    ("uber_trips.ingest", drop_upserts)])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    """Half of the batches left out; an answer altered where it is
    produced; an upsert acknowledged and its state left unchanged."""
    fault(monkeypatch)
    ingest = name.endswith("ingest")
    out = rehearse(name, b=with_ingest(bench_json()) if ingest else None,
                   traffic={"ingest": TINY_INGEST} if ingest else None)
    assert not out["correct"], out["checks"]


def test_the_measuring_command_fails_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    run = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "uber_trips.dash", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert run.returncode != 0
    assert run.stdout.strip() == ""
    assert "CUDA" in run.stderr


def test_the_command_fails_beside_no_port(tmp_path):
    """In a folder that holds only BENCHMARK.json and portbench/."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    run = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "uber_trips.dash",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert run.returncode != 0 and run.stdout.strip() == ""


def test_a_dropped_in_traffic_file_is_a_cell(tmp_path):
    """A traffic file of its own and a workload entry: no code edit."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "portbench" / "traffic" / "uber_trips.one_client.json"
     ).write_text(json.dumps({"queries": ["D4", "D1"], "dashboards": 1,
                              "refresh_s": 1.0, "connections": 1,
                              "warm_query": "D4", "answers_checked": 4,
                              "limits": {"group_mismatches": 0,
                                         "count_mismatches": 0,
                                         "sum_rel_err": 1e-5,
                                         "answers_failed": 0}}))
    b = bench_json()
    b["workloads"].append({"name": "uber_trips.one_client",
                           "config": "uber_trips", "traffic": "one_client",
                           "chips": 1, "why": "one client"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = bench.Cell("uber_trips.one_client", root=tmp_path,
                      scale=TINY["uber_trips"])
    assert list(cell.queries) == ["D4", "D1"]
    out = bench.run_cell(cell, SEED, 1.0, False, device="cpu",
                         log=lambda s: None)
    assert out["correct"], out["checks"]
