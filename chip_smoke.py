"""Smoke run of the PyTorch/CUDA port (`aresdb_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--rows N] [--atrips-rows M] [--events-rows E]
                          [--server-rows R] [--cluster-rows C] [--seed S]
                          [--hundredm-rows H] [--hundredm-cache-bytes B]
                          [--only hundredm,crash,rf2,migrate,soak,
                                  controller_ha]

First `phase_build`, on a fresh temporary build directory: K1's launcher
library (`csrc/fused_dense_launch.cu`, host code, built once by nvcc),
then for each of the K1 plan structures below, one at a time, its cubin
(NVRTC in this process, on the structure's device code) and its first
launch split into the image's load, the launch's sizing (the occupancy
query) and the run, against the plain version; each one's seconds go to
the `{"build": ...}` line.
Then builds the port's hand-written CUDA kernels from
`aresdb_tpu_torch/csrc/` (K2's and K3's libraries and K1's launcher by
nvcc, K1's cubins by NVRTC, all at once), holds each against its plain
PyTorch version on
the card at the main path's shapes (K2 also on the engine's skewed
traffic, a NaN measure, the run-length path's weighted per-run rows, the
sort path's sorted runs under ARES_PREFIX=0 (6,321 and 301 slots, C = 2)
and, through its global-atomic kernel, nine channels; K3 also on one real Q5
batch's slots and values, and on that batch with a NaN and an inf), and
asserts which `__global__` function each K2 and K3 case ran,
then drives the main paths end to end: N rows (default 8M, 4 live
batches of 2,097,152; cut from 32M to 16M to keep the whole run near
650 s beside the stream phase, and to 8M beside the drive phases) of the
demo trips table are ingested through
the upsert wire format into a `TableShard`, and these queries run through
`QueryService.handle_aql` on `cuda`, each checked against the same
service on the CPU (the kernels' plain versions):
  Q1  the headline dense group-by (hour x city), through K1
  Q2  Q1 by day of month, unfused, through K2
  Q3  sum(fare) by minute x city over 24 hours: no dense plan; the keyed
      sort path, its capacity ladder and the device-side merge
  Q4  count(*) by minute x city for cities <= 20 over 3 hours: no dense
      plan; every batch takes the runtime-dense branch through K2
  Q5  sum(fare) by day of month x status under ARES_FACTORED=0, through K3
  Q1 with an understated city domain: every batch overflows its dense
      plan and reruns on the sort path
  Q1 once more under ARES_FUSED=0, through a new service: K1 off, every
      batch through the unfused dense kernel and K2, equal to the CPU run
  J1  Q1 joined to a 300-row cities table, filtered on the joined
      population: K1 with one joined lane
  J2  Q2 with the same join: unfused, through K2
  N1  the first 50 rejected trips (fare, city): a listing, no kernel;
      the scan stops after the first batch
  N2  N1 ordered by fare, descending, limit 20
  H1  countdistincthll(request_at) by city: the HLL capacity ladder
      climbs from 256 to 512 groups on the cold run
  H2  countdistincthll(uuid), also as the binary application/hll frame
The listings and HLL answers must equal the CPU run's exactly, and a
numpy oracle over the ingested rows: N1's rows are the first 50 matching
rows in order; H1's and H2's estimates are hll.compute_estimate of
registers built with np.maximum.at, and H1's are within 5% of the exact
distinct counts.
Then `phase_prefix`, over the same store: Q1 overflow (its rerun on the
sort path, ARES_RTDENSE=0), M1 (Q4 with max(fare), the sort path), H1,
H2 and Q3 under ARES_PREFIX=0 through a QueryService of its own, one
cold and one warm run each: every sorted reduce and HLL batch of at most
65,536 groups launches K2 once and one past that (Q3's) none; each
answer equals the default route's and its numpy oracle.

The archive half: M rows (default 8M, 4 upserts of 2,097,152; cut from
16M beside the drive phases) of the TPU battery's atrips table, timed
over three days in time order, are ingested, then the port's Archiver
archives the first two days (the cutoff falls inside one live batch)
through a DiskMetaStore and a LocalDiskStore in a temporary directory:
two days of about 2.8M rows, each staged as one chunk
(ARCHIVE_CHUNK_ROWS = 4,194,304; at 16M rows two), one live batch
straddling the cutoff and one above it. Each query runs
on the card against the CPU run and a numpy oracle over the rows; its
K1 row functions are built first, all at once, from the CPU run's plans:
  A1  sum(fare) by city_id, no time filter: K1 on every batch and chunk
  A2  A1 under ARES_RUNLEN=1: archive chunks through the run-length
      kernel and K2 (runlenBatches = the chunks, every run), equal to A1
      within rel 1e-5
  A3  count(*) by city_id x status, through K1; exact
  A4  A3 under ARES_RUNLEN=1; equal to A3
  A5  sum(fare) where city_id = 7, no dimensions: prefilterRowsSkipped
      > 0; one slot, reduced with masked sums, no kernel
  A6  sum(fare) by hour x city_id over the last 36 hours: the first
      archived day is not scanned
  S1  SELECT count(*) ... WHERE fare > 25, through handle_sql
  S2  SELECT sum(fare), through handle_sql
  C1  Requested, Completed and Completed/Requested by city_id: a
      composite query, two engine runs (K1)
atrips carries the battery's `pickup` GeoPoint (lat and lng uniform in
[0, 50)), so most points are archived, beside two geo tables: `zones`,
the battery's two squares (ids 1, 2), and `zones128`, 128 regular 16-gons
(ids 1-128; neighbours overlap in lng, so first-match order matters):
  G1  the battery's `geo join archived points`: count(*) by z.id over
      zones, z.id IN (1, 2); the keyed path's runtime-dense K2
  G2  sum(fare) by z.id over zones128, all 128 ids in the IN list: the
      bbox walk (geo.matched_shape_pruned), K2
  G3  count(*) over zones128, z.id NOT IN (1..64): the exclude mode, no
      dimensions, no kernel
  G2 dense  G2 under ARES_GEO2=0, the dense sweep of 4,096 edges, on
      the card only, one cold and one warm run: equal to G2's answer
      (keys exactly, sums within the float tolerance: K2 adds floats
      with atomics)
each against a numpy crossing-test oracle (counts exactly, sums within
rel 1e-5); and the geo sweep itself: both routes on the card against the
oracle point by point over every atrips point, and their device ms per
batch.

The durable store: E rows (default 1M, batches of 65,536) of the
battery's `events` table (ArrayInt32 tags of 0-4 items from 0-19, scores
in steps of 1/8 below 10, so that every float32 partial sum is exact) over
two days go through a `MemStore` (`handle_ingestion`, one redo-log append
an upsert) in a temporary directory, and the first day is archived:
  E1  the battery's `array contains by length`: sum(score) where
      contains(tags, 7), by length(tags); K2
  E2  count(*) by element_at(tags, -1); K2
Then the store is closed and a new `MemStore` recovers from the same
directory (archive metadata, then the redo log), timed, and E1 and E2 run
again: equal to the first answers exactly, to the CPU run and to the
oracle.

The daemon (`phase_server`): `cmd.aresd.build_server` over a temporary
root on `cuda`, its scheduler on and the port's clock frozen at the TPU
battery's NOW, fed through the port's `Connector` as
tools/drive_tpu_server.py:11-67 feeds the JAX package's server: R rows
(default 4,194,304, cut from 8,388,608 beside the drive phases; two
`insert_columns` upserts of 2,097,152 by two producer threads) of the battery's trips table and its 300 cities. The battery's 14 trips shapes (B1-B14: sum by hour x
city, avg by status, HLL of id overall and by city, the join count, the
listing, the two SQL forms, the sums with no dimensions, count by city,
the numeric bucket, case and IN, calendar dimensions and the 200k-group
sort path) run over HTTP, one cold and five warm runs each with K1's and
K2's launches asserted, each against a numpy oracle (counts and HLL
estimates exactly, sums within the battery's 1e-4) and the CPU service
(the HLL shapes also as application/hll frames, byte for byte), timed
beside QueryService.handle_aql; then 8 client threads x 20 requests, each
answer equal to its serial one; the admission gate's budget (0.95 x the
card's memory) and the deadline; the clock moved 14 hours on and the
archiving job run through /dbg/trips/0/archiving (about half the rows),
the 14 shapes again; then the daemon stopped, a new one recovered from
the root (timed), and B1 and B14 equal their first answers.

The cluster (`phase_cluster`): the port's controller, two datanodes on
`cuda` in this process and a broker, 4 shards at replica factor 1; C
rows (default R, the same rows) of the battery's trips, one upsert a
shard, sent to the shards' owners by two producers through the
`Connector`, and the cities to shard 0's owner. The 14 shapes through the broker, one cold and five
warm runs each, against the oracle and phase_server's answers, with K1's
and K2's launches on the datanodes asserted (B5, the join, fails on the
node without shard 0 of cities, as in the JAX cluster); archiving on each
owner with the clock 14 hours on; a third datanode started as a process
of its own (`cmd.aresd --controller`) replaces one of them and
bootstraps its shards from it (timed, with the bytes it copied), each
of those shards holding on the new node the rows below and above the
cutoff that it held on the old one, and no copy attempt failing; the 14
shapes again, equal to their first answers.

The deployment fed and queried as its users do (`phase_stream`): the
port's controller and one daemon on `cuda`; R rows of the
battery's trips bulk-loaded through `Connector.insert_columns` (two
producers, upserts of 2,097,152) and the cities through
`Connector.insert`; then a JSON-lines file of 393,216 new trips, 131,072
updates of distinct loaded trips (a new status and fare) and 16
malformed lines, request_at as epoch milliseconds or ISO-8601 strings,
posted as a subscriber job to the controller and streamed by `python -m
aresdb_tpu_torch.cmd.subscriber`, a process of its own, through its
`AresSink` (batches of 1,000) while a reader polls count(*) through
`QueryClient` (monotone, within bounds, to exactly R + 393,216); the 14
shapes through `QueryClient` (B3 and B4 also as `query_hll` frames), one
cold and five warm runs each with K1's and K2's launches asserted,
against a numpy oracle of the final rows (last write wins, the malformed
lines dropped) and the CPU service; `arescli`'s `Shell` (show tables,
describe, B1, B10 and B7 in JSON and table form, against QueryClient's
answers); and `cmd.examples` tables, data and query over a dataset in its
documented layout (ex_trips with time placeholders, the generated
arraytest rows; B2, B8 and B7 against numpy, the array length, contains
and element_at queries against the aligned oracles).

Mesh batches and the device pool, over the stores of the first phases
(no new ingest): Q1-Q4, J1, H1 and H2 over the trips, G1 over atrips and
E1 over the events store run under ARES_MESH=1 with
`QueryService(mesh_devices=[cuda:0] * 4)` (`phase_mesh`), one cold and
two warm runs each: equal to the phase's single-device answer (keys,
counts and HLL estimates exactly, sums within rtol 2e-4, atol 1e-3),
every batch counted in query.mesh_batches (HLL ladder reruns too) and
none in mesh_ineligible_batches or mesh_fallback_batches, K2's launches
3 x those of a CPU rehearsal of the query on a mesh of 4 `cpu` entries,
K1 and K3 none; the mesh's warm ms is printed beside the single
device's, the cost of the per-device loop on one card, not a multi-card
speedup. Then `phase_pool`: a QueryService with DevicePool([cuda:0,
cuda:0]) and 8 client threads x 4 requests drawn from Q1, Q2, J1 and H1,
every answer equal to the single-device one, both entries serving, none
running or waiting at the end, K1's and K2's launches asserted. Each
phase's seconds are printed.

Then the JAX package's deployments of tools/drive_*.py, each a phase of
its own (`--only` runs just the ones it names, without the kernel phases
and the kernels line):
  phase_hundredm (drive_100m.py): H rows (default 100,000,000, never
      cut) of its trips through a MemStore with its redo log on, in
      upserts of 4,194,304 from seed 3, under a host budget of 0.9 GB;
      its seven shapes (live sum by city, live completed hour x city, the
      Archiver over every row, archive count by city x status, archive
      sum by city, the count under ARES_RUNLEN=1, the id % 200000 sum,
      then the budget tightened to 0.7 x the bytes held and archive sum
      by city again) on the card through a column cache of its own (B
      bytes, else the card's share): one cold and three warm runs each,
      every answer against a numpy oracle of np.bincount over every group
      (counts exactly, sums within rel 1e-5), K1's launches asserted on
      the live and archive shapes and K2's on the run-length shape, each
      shape's stages, host fetches, device busy share and cache stats;
      at least one column evicted and the bytes held within 1.2 x the
      tightened budget, or the phase fails.
  phase_crash (drive_crash.py): `cmd.aresd` on `cuda` as a process of
      its own, 16 acked upserts of 131,072 rows through
      Connector.insert_columns, a 17th in flight when it is SIGKILLed; a
      new daemon on the root holds every acked row (count and sum) and
      takes 1,000 more.
  phase_rf2 (drive_rf2.py): two `cmd.aresd` datanode processes on
      `cuda` holding 2 shards of 1,048,576 rows at replica factor 2;
      count(*) and sum(v) by id % 16 through the broker equal the oracle,
      and again within 30 s after dn0 is SIGKILLed.
  phase_migrate_live (drive_migrate_live.py): datanodes in this process
      on `cuda`; a shard moves three times (dn0 -> dn1 by a rebalance,
      back by a replace, out again) while a writer upserts to every owner
      and archiving runs every 300 ms; after each move each shard is
      counted below and at or above its cutoff on its old and its new
      owner (K1 asserted), and the broker's count and sum equal the acks.
  phase_soak (drive_soak.py): the ApiServer on `cuda` for 60 s under a
      writer (new ids and re-upserts of old ones), a count and a join
      thread and the archiving, backfill and snapshot jobs through /dbg;
      the drive's final oracle checks, the join's K1 launches asserted.
  phase_controller_ha (drive_controller_ha.py): two `cmd.controller
      --elect --lease-ttl 1.5` processes on one root, dn0 and dn1 in this
      process on `cuda`, a broker, each given both controllers'
      addresses; 2 shards of 1,048,576 rows of the drive's trips; a
      querier thread sends count(*) and sum(v) by id % 16 through the
      broker, each answer held to the oracle of the acked rows, while
      the leader is SIGKILLed, the cities table is created, 131,072 rows
      go to each shard, the killed controller restarts as a follower,
      the other is SIGSTOPped for 6 s and the restarted one takes over,
      during_pause is created, and the paused controller, SIGCONTed,
      must answer a write 503; no querier error and no wrong answer,
      K1's launches asserted before and after; both failover times and
      the querier's p50, p99 and longest gap printed.

The moving window (`phase_window`), inside the phases that hold its
stores: Q1 again at DEMO_NOW + 900 s (its window ends at "this
quarter-hour"), A6 at ATRIPS_NOW + 1 s and + 2 s (its window ends at
"now"), and, at the end of phase_server, B1 after 65,536 trips in cities
300-599 land in a batch of their own (its city domain doubles). K1's
source holds the plan's structure only, so each of these runs must build
nothing (cuda_build.built), must launch K1, and must equal the CPU
run and the numpy oracle at its own `now`; each run's ms stands beside
its query's warm median in a `{"window": ...}` line. A cold query of a
new plan structure compiles its K1 cubin with NVRTC (the launcher is
built once).

Kernels and what they replace:
  K1 fused_dense  (csrc/fused_dense_template.cuh, one row function emitted
                   per plan structure and compiled to a cubin by NVRTC,
                   launched by
                   csrc/fused_dense_launch.cu)
                   <- aresdb_tpu/query/fused_dense.py _make_kernel
  K2 segment_sum  (csrc/segment_sum.cu)
                   <- aresdb_tpu/query/pallas_ops.py _make_factored_pallas_kernel
  K3 dense_segment_sum  (csrc/dense_segment_sum.cu)
                   <- aresdb_tpu/query/pallas_ops.py _make_kernel

Prints the card's name and power limit, per-phase results, one
`{"window": ...}` line, one `{"drives": ...}` line (the drive phases'
figures: the restart's and the failover's seconds, each move's
seconds, the soak's rows, backfilled rows and cache stats, the two
controller failovers' seconds and the querier's figures), one
`{"build": ...}` line (phase_build's seconds,
the all-at-once build's, and the builds and seconds of the whole run),
one `{"kernels": [...]}` line (each kernel's registers and local memory:
K1's for each plan from its loaded image, its local bytes 0 or the run
fails; K2's and K3's registers, stack frame and spill bytes from ptxas for
each `__global__` function) and, last,
`{"ok": true, "device": {...}}`. A kernel's `ms` is the device time of
one wrapper call (its output memset included), `kernel_ms` that of the
kernel's own `__global__` functions,
and `in_situ_ms_per_launch` its device time per launch inside each query
of the end-to-end phases, from one profiled warm run; K2's row also
holds its run-length cases under `runlen_a2` and `runlen_a4` and its
sorted runs under `sorted_6321` and `sorted_301`, K3's its case on Q5's
batch under `q5_traffic`.
Exits non-zero, with no result line, when there is no CUDA device or any
check fails. Needs one card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

BATCH_ROWS = 1 << 21          # the default live batch size (batchSize)
N_CITIES = 300
# the dimension table of the TPU battery, tools/drive_tpu_server.py:28-32
CITIES_SCHEMA_JSON = {
    "name": "cities",
    "columns": [{"name": "id", "type": "Uint16"},
                {"name": "population", "type": "Uint32"}],
    "primaryKeyColumns": [0], "isFactTable": False,
    "config": {"batchSize": 1024}}
CITY_JOIN = [{"table": "cities", "alias": "c",
              "conditions": ["c.id = city_id"]}]
LISTINGS = ("N1", "N2")
# the storage table of the TPU battery, tools/drive_tpu_server.py:216-259
ATRIPS_SCHEMA_JSON = {
    "name": "atrips",
    "columns": [{"name": "request_at", "type": "Uint32"},
                {"name": "id", "type": "Uint32"},
                {"name": "city_id", "type": "Uint16"},
                {"name": "status", "type": "SmallEnum"},
                {"name": "fare", "type": "Float32"},
                {"name": "pickup", "type": "GeoPoint"}],
    "primaryKeyColumns": [1], "archivingSortColumns": [2, 3],
    "isFactTable": True,
    "config": {"batchSize": BATCH_ROWS, "recordRetentionInDays": 0}}
STATUSES = ["completed", "canceled", "rejected"]
DAY = 86400
ATRIPS_ROWS = 4 * BATCH_ROWS
ATRIPS_NOW = 1_600_000_000 // DAY * DAY
ATRIPS_BASE = ATRIPS_NOW - 3 * DAY     # rows over the three days before
ATRIPS_CUTOFF = ATRIPS_BASE + 2 * DAY  # two days archived
# the battery's geo table and its two squares (tools/drive_tpu_server.py:
# 230-238), and a table of 128 regular 16-gons of the same schema
ZONES_SCHEMA_JSON = {
    "name": "zones",
    "columns": [{"name": "id", "type": "Uint16"},
                {"name": "shape", "type": "GeoShape"}],
    "primaryKeyColumns": [0], "isFactTable": False,
    "config": {"batchSize": 64}}
ZONES128_SCHEMA_JSON = dict(ZONES_SCHEMA_JSON, name="zones128",
                            config={"batchSize": 256})
BATTERY_ZONES = ((1, "POLYGON((0 0, 0 10, 10 10, 10 0, 0 0))"),
                 (2, "POLYGON((20 20, 20 30, 30 30, 30 20, 20 20))"))
# the battery's array table (tools/drive_tpu_server.py:315-330), 16 times
# its 65,536 rows, over the two days before EVENTS_NOW; the first archived
EVENTS_SCHEMA_JSON = {
    "name": "events",
    "columns": [{"name": "ts", "type": "Uint32"},
                {"name": "id", "type": "Uint32"},
                {"name": "tags", "type": "ArrayInt32"},
                {"name": "score", "type": "Float32"}],
    "primaryKeyColumns": [1], "isFactTable": True,
    "config": {"batchSize": 1 << 16, "recordRetentionInDays": 0}}
EVENTS_ROWS = 1 << 20
EVENTS_NOW = ATRIPS_NOW
EVENTS_CUTOFF = EVENTS_NOW - DAY
HLL_QUERIES = ("H1", "H2")
GEO_QUERIES = ("G1", "G2", "G3", "G2 dense")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
F32_OPS_PER_S = 67e12         # H100 SXM float32 rate outside the tensor cores
# float sums: atomics add in another order than the plain version (and
# the JAX package's own tolerance, tests/test_fused_dense.py); counts exact
RTOL, ATOL = 2e-4, 1e-3
# K2: (name, n_slots, channels, live slots or None for uniform, share of
# rows dropped): uniform slots at Q1's, Q2's and the widest dense table;
# then the engine's traffic: Q2's batches fall on 602 of its slots, Q4's
# runtime-dense call keeps about 1% of a batch's rows, the overflow rerun
# of Q1 about a third; one NaN measure, which poisons its slot only; and
# nine channels of arbitrary floats, more than the cluster kernel takes,
# through the global-atomic kernel. The engine's calls have C = 3.
K2_CASES = (("uniform 13,338", 13_338, 3, None, 0.0),
            ("uniform 16,416", 16_416, 3, None, 0.0),
            ("uniform 65,536", 65_536, 3, None, 0.0),
            ("Q2: 602 of 16,416 slots", 16_416, 3, 602, 0.0),
            ("Q4: 16,384 slots, 99% dropped", 16_384, 3, 4_140, 0.99),
            ("Q1 overflow: 16,384 slots, 2/3 dropped", 16_384, 3, 6_321,
             2 / 3),
            ("one NaN measure, 16,416 slots", 16_416, 3, None, 0.0),
            ("9 channels, 16,416 slots", 16_416, 9, None, 0.0))
K2_ROW_CASE = "uniform 16,416"
# K2 on the sort path's slots under ARES_PREFIX=0 (kernels._k2_runs): one
# batch sorted by key, each group one run of rows and the rows past the
# table (sentinel and overflow rows) a tail of -1; two channels, measure
# and valid count. (name, slots, traffic key): Q1 overflow's 6,321 groups
# and H1's 301 cities.
K2_SORTED_CASES = (("sorted runs: 6,321 slots", 6_321, "sorted_6321"),
                   ("sorted runs: 301 slots", 301, "sorted_301"))
K2_SORTED_TAIL = 0.1      # the share of a batch's rows past the table
# K2 at the run-length path's shape: one row a run (n_runs_pad rows), the
# runtime-dense table of 16,384 slots, three weighted channels (each
# run's fare sum, valid rows and rows; counts up to thousands, not 0/1).
# A run is one group of its chunk, so the live runs fall on distinct
# slots; padded runs are dropped. (name, n_runs_pad, live runs): A2's
# chunks hold about 225 runs (one a city), A4's about 675 (city x status).
K2_RUNLEN_CASES = (("run-length A2: 225 of 256 runs", 256, 225),
                   ("run-length A4: 675 of 1,024 runs", 1024, 675))
WIDE_K1_CASE = "Q1 over 1,000 cities (26,650 slots)"
J1_K1_CASE = "J1: Q1 with a joined population lane"
# each kernel's __global__ functions, as the profiler names them
KERNEL_FUNCS = {"K1": r"fused_dense_kernel",
                "K2": r"(?<!dense_)segment_sum_(cluster|global)",
                "K3": r"dense_segment_sum_(warp|cluster|global)"}
# K3: (name, n_slots, channels, traffic, the __global__ function it runs).
# Traffic "dense": uniform slots (a few out of range) with the dense
# path's channels (measure, 0/1 count, 1 presence); "floats": uniform
# slots, arbitrary floats in every channel; "Q5": the slots and channels
# of K3's call on one real Q5 batch (q5_batch: 8 of 128 slots, no row
# dropped); "Q5 nan inf": that batch with one NaN and one inf measure,
# each in a slot of its own. Q5's 128 slots fit a copy of the table for
# each warp; wider tables take one a block, 8 x 8,192 floats a cluster of
# 2; 8 x 65,536 floats, more than a cluster of 8 holds and more than any
# engine call has, the global-atomic kernel.
K3_Q5_CASE = "Q5 batch: 8 of 128 slots"
RT_DENSE_SLOTS = 16_384   # the runtime-dense slot table (kernels.RT_DENSE_CAP)
K3_CASES = (("uniform 128", 128, 3, "dense", "dense_segment_sum_warp"),
            ("uniform 4,104", 4_104, 3, "dense", "dense_segment_sum_cluster"),
            ("uniform 8,192", 8_192, 3, "dense", "dense_segment_sum_cluster"),
            ("4,104 slots, 1 channel", 4_104, 1, "floats",
             "dense_segment_sum_cluster"),
            ("4,104 slots, arbitrary floats", 4_104, 3, "floats",
             "dense_segment_sum_cluster"),
            ("8,192 slots, 8 channels", 8_192, 8, "floats",
             "dense_segment_sum_cluster"),
            ("65,536 slots, 8 channels", 65_536, 8, "floats",
             "dense_segment_sum_global"),
            (K3_Q5_CASE, 128, 3, "Q5", "dense_segment_sum_warp"),
            ("Q5 batch, one NaN and one inf measure", 128, 3, "Q5 nan inf",
             "dense_segment_sum_warp"))
# mesh batches (ARES_MESH=1) over MESH_WIDTH entries of the one card, and
# a device pool of two entries of it, over stores the phases ingest
MESH_WIDTH = 4
MESH_RUNS = 3                 # one cold run, two warm
MESH_E2E = ("Q1", "Q2", "Q3", "Q4", "J1", "H1", "H2")
MESH_COUNTERS = ("mesh_batches", "mesh_ineligible_batches",
                 "mesh_fallback_batches")
POOL_QUERIES = ("Q1", "Q2", "J1", "H1")
POOL_THREADS, POOL_REQUESTS = 8, 4
Q3_CAPACITY = 1 << 19    # the ladder's rung for about 300k groups a batch
# phase_prefix: queries of the sort and HLL paths under ARES_PREFIX=0, one
# cold and one warm run each
PREFIX_QUERIES = ("Q1 overflow", "M1", "H1", "H2", "Q3")
PREFIX_RUNS = 2
H1_CAPACITY = 512        # the HLL ladder's rung for 301 groups a batch
# phase_window: each query again with its `now` moved by these seconds
# (A6's window ends at "now" and moves every second, Q1's at "this
# quarter-hour"), and B1 after rows that raise its city range
WINDOW_MOVES = {"Q1": (0, 900), "A6": (0, 1, 2)}
WINDOW_RANGE_ROWS = 1 << 16   # B1's raised range: a batch K1 takes
WINDOW = {}   # the {"window": ...} line: phase_window's runs by query


def demo_variant(demo, measure, dims, filters=(), since="24 hours ago"):
    """The headline query with another measure, filters, dims or window."""
    q = json.loads(json.dumps(demo.DEMO_QUERY))
    q["measures"] = [{"sqlExpression": measure, "rowFilters": list(filters)}]
    q["dimensions"] = [{"sqlExpression": e, "timeBucketizer": b} if b
                       else {"sqlExpression": e} for e, b in dims]
    q["timeFilter"]["from"] = since
    return q


def q2_query(demo) -> dict:
    """Q2: the headline query bucketed by day of month, which the fused
    kernel does not take (calendar math needs int64 lanes)."""
    q = json.loads(json.dumps(demo.DEMO_QUERY))
    q["dimensions"][0]["timeBucketizer"] = "day of month"
    return q


def city_populations(seed: int) -> np.ndarray:
    """The populations of cities 1..N_CITIES, drawn from the seed."""
    return np.random.RandomState(seed + 1).randint(
        1_000, 1_000_000, N_CITIES).astype(np.uint32)


def joined(q: dict, seed: int) -> dict:
    """q joined to the cities table, keeping the trips of the cities above
    the median population."""
    q = json.loads(json.dumps(q))
    q["joins"] = CITY_JOIN
    median = int(np.median(city_populations(seed)))
    q["measures"][0].setdefault("rowFilters", []).append(
        f"c.population > {median}")
    return q


def listing(demo, limit: int, sorts=()) -> dict:
    """The first `limit` rejected trips' fare and city (the TPU battery's
    non-agg query), ordered by `sorts` where given."""
    q = {"table": "trips", "now": demo.DEMO_NOW,
         "measures": [{"sqlExpression": "1"}],
         "dimensions": [{"sqlExpression": "fare"},
                        {"sqlExpression": "city_id"}],
         "rowFilters": ["status='rejected'"], "limit": limit}
    if sorts:
        q["sorts"] = [{"name": n, "order": o} for n, o in sorts]
    return q


def hll_query(demo, measure: str, dims) -> dict:
    return {"table": "trips", "now": demo.DEMO_NOW,
            "measures": [{"sqlExpression": measure}],
            "dimensions": [{"sqlExpression": d} for d in dims]}


def e2e_queries(demo, seed: int = 0) -> dict:
    """name -> (query, environment, understate the city domain)."""
    minute_city = [("request_at", "minute"), ("city_id", None)]
    return {
        "Q1": (demo.DEMO_QUERY, {}, False),
        "Q2": (q2_query(demo), {}, False),
        "Q3": (demo_variant(demo, "sum(fare)", minute_city,
                            ["status='completed'"]), {}, False),
        "Q4": (demo_variant(demo, "count(*)", minute_city,
                            ["city_id <= 20"], "3 hours ago"), {}, False),
        "Q5": (demo_variant(demo, "sum(fare)", [("request_at",
                                                 "day of month"),
                                                ("status", None)]),
               {"ARES_FACTORED": "0"}, False),
        "Q1 overflow": (demo.DEMO_QUERY, {}, True),
        "J1": (joined(demo.DEMO_QUERY, seed), {}, False),
        "J2": (joined(q2_query(demo), seed), {}, False),
        "N1": (listing(demo, 50), {}, False),
        "N2": (listing(demo, 20, [("fare", "desc")]), {}, False),
        "H1": (hll_query(demo, "countdistincthll(request_at)",
                         ["city_id"]), {}, False),
        "H2": (hll_query(demo, "countdistincthll(uuid)", []), {}, False),
    }


def expected_launches(name, runs, batches, fused) -> dict:
    """Each kernel's launches over `runs` runs of a query on `batches`
    batches, of which `fused` take K1 where the plan is K1's."""
    unfused = runs * (batches - fused)
    return {
        "Q1": {"K1": runs * fused, "K2": unfused, "K3": 0},
        "Q2": {"K1": 0, "K2": runs * batches, "K3": 0},
        "Q3": {"K1": 0, "K2": 0, "K3": 0},
        # about 207 live minutes x 20 cities: over 4,096 groups, so the
        # cold run reduces each batch through K2 twice (K = 4,096, 8,192)
        "Q4": {"K1": 0, "K2": runs * batches + batches, "K3": 0},
        "Q5": {"K1": 0, "K2": 0, "K3": runs * batches},
        # the dense kernel, then one runtime-dense K2 per rerun, and one
        # more per batch where the cold run climbs from K = 4,096 to 8,192
        "Q1 overflow": {"K1": runs * fused,
                        "K2": unfused + runs * batches + batches, "K3": 0},
        # K1 takes the joined lane as it takes Q1's columns
        "J1": {"K1": runs * fused, "K2": unfused, "K3": 0},
        "J2": {"K1": 0, "K2": runs * batches, "K3": 0},
        # listings and HLL run no kernel of the TPU's
        "N1": {"K1": 0, "K2": 0, "K3": 0},
        "N2": {"K1": 0, "K2": 0, "K3": 0},
        "H1": {"K1": 0, "K2": 0, "K3": 0},
        "H2": {"K1": 0, "K2": 0, "K3": 0},
    }[name]


def k1_cases(demo, seed: int = 0) -> dict:
    """The plans K1 is checked on, each with the largest city id its dense
    plan assumes: the main path's Q1, then the other forms the emitter
    writes (avg with a post-division slot, count, CASE and IN, a numeric
    bucket, arithmetic with % and NOT), Q1 over a city domain that the
    data overflows, Q1 over 1,000 cities, whose 26,650 slots (320 KB)
    no single block's shared memory holds, and J1, Q1 with a joined
    lane."""
    def q(measure, filters=(), dims=None):
        out = json.loads(json.dumps(demo.DEMO_QUERY))
        out["measures"] = [{"sqlExpression": measure,
                            "rowFilters": list(filters)}]
        if dims is not None:
            out["dimensions"] = dims
        return out

    dow = [{"sqlExpression": "request_at", "timeBucketizer": "day of week"},
           {"sqlExpression": "city_id"}]
    bucket = [{"sqlExpression": "fare",
               "numericBucketizer": {"bucketWidth": 5.0}}]
    return {
        "Q1 sum(fare) hour x city": (demo.DEMO_QUERY, 300),
        "avg(fare) day-of-week x city": (q("avg(fare)", dims=dow), 300),
        "count(*) hour x city": (q("count(*)"), 300),
        "case and in": (q("sum(case when status='completed' then fare "
                          "else 0 end)",
                          ["status in ('completed', 'canceled')"]), 300),
        "numeric bucket": (q("count(*)", dims=bucket), 300),
        "arithmetic, % and NOT": (q("sum(fare * 2 - 7)",
                                    ["city_id % 7 != 3",
                                     "NOT (status = 'rejected')"]), 300),
        "Q1 overflowing city domain": (demo.DEMO_QUERY, 100),
        WIDE_K1_CASE: (demo.DEMO_QUERY, 1000),
        J1_K1_CASE: (joined(demo.DEMO_QUERY, seed), 300),
    }


def compile_plan(demo, query):
    """The plan of a query over the demo trips and the cities table."""
    from aresdb_tpu_torch.common.schema import Table, TableSchema
    from aresdb_tpu_torch.query.aql import AQLQuery
    from aresdb_tpu_torch.query.compiler import Compiler

    cities = TableSchema(Table.from_json(CITIES_SCHEMA_JSON))
    return Compiler({"trips": demo.demo_schema(), "cities": cities}).compile(
        AQLQuery.from_json(query))


def city_columns(plan, seed: int, device) -> tuple:
    """The cities table staged as the executor stages it, for a plan that
    joins it: ({(table_id, column_id): (values, validity)}, the probes:
    one dense id -> row table)."""
    (ft,) = plan.foreign_tables
    ids = np.arange(1, N_CITIES + 1)
    lut = np.full(N_CITIES + 2, -1, np.int32)
    lut[ids] = np.arange(N_CITIES, dtype=np.int32)
    ones = torch.ones(N_CITIES, dtype=torch.bool, device=device)
    cols = {(ft.table_id, 0): (torch.from_numpy(ids.astype(np.int16))
                               .to(device), ones),
            (ft.table_id, 1): (torch.from_numpy(
                city_populations(seed).view(np.int32)).to(device), ones)}
    return cols, ((torch.from_numpy(lut).to(device),),)


def k1_spec(demo, FD, plan_dense, query, city_max):
    """(plan, dense plan, fused spec) of one K1 case."""
    plan = compile_plan(demo, query)
    stats = {(0, plan.main_schema.column_id("city_id")): (1, city_max),
             (0, plan.main_schema.column_id("fare")): (0.0, 50.0)}
    dp = plan_dense(plan, stats)
    spec = FD.plan_fused(plan, dp)
    if spec is None:
        raise AssertionError(f"{query}: plan does not take K1")
    return plan, dp, spec


def wall_ms(fn, iters: int = 20) -> float:
    """Mean milliseconds per call of fn() between CUDA events around iters
    back-to-back calls, after a warm-up: the device time, or the host's
    launch cost where that is larger."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_events(fn, iters: int, attempts: int = 3):
    """The CUDA activity (kernels, memsets, copies) of iters calls of fn(),
    from a torch.profiler trace: a list of (name, microseconds). A trace
    that holds no CUDA activity at all is taken again, up to `attempts`
    times: on the card's machine a profiler session now and then records
    none."""
    for _ in range(attempts):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return events
        print("profiler: a session recorded no CUDA activity; taken again",
              flush=True)
    return []


def kernel_events(events, kernel: str) -> list:
    """Microseconds of each launch of `kernel`'s __global__ functions among
    events."""
    pat = re.compile(KERNEL_FUNCS[kernel])
    return [us for name, us in events if pat.search(name)]


def counted_events(fn, iters: int, kernel: str, launches: int,
                   attempts: int = 3):
    """device_events(fn, iters), taken again (up to `attempts` times) while
    the session holds other than `launches` launches of `kernel`: on the
    card's machine a session now and then records only part of them."""
    for _ in range(attempts):
        events = device_events(fn, iters)
        got = len(kernel_events(events, kernel))
        if got == launches:
            break
        print(f"profiler: {got} of {launches} {kernel} launches recorded; "
              "taken again", flush=True)
    return events


def device_ms(fn, iters: int = 20, kernel=None):
    """Mean device milliseconds per call of fn(): the summed time of the
    device work it ran, from the profiler; with `kernel` ("K1".."K3"),
    whose wrapper fn() calls once, (that, the time of the kernel's own
    functions alone, without the wrapper's output memset). Raises where
    the profiler records no device activity, or none of the kernel's, so
    that both are device time."""
    for _ in range(3):
        fn()
    events = device_events(fn, iters) if kernel is None else \
        counted_events(fn, iters, kernel, iters)
    total_us = sum(us for _, us in events)
    if total_us <= 0:
        raise RuntimeError("the profiler saw no device activity")
    if kernel is None:
        return total_us / iters / 1e3
    own_us = sum(kernel_events(events, kernel))
    if own_us <= 0:
        raise RuntimeError(f"the profiler saw no {kernel} kernel")
    return total_us / iters / 1e3, own_us / iters / 1e3


def bound_ms(nbytes: int, flops: int) -> tuple:
    """(least time in ms, what bounds it) for moving nbytes and doing flops
    float32 operations on the card."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                exact_rows=(), nonfinite=()) -> float:
    """Raise unless got matches want: rows listed in exact_rows exactly,
    the others within RTOL/ATOL. Every value is finite but at the indices
    listed in nonfinite, where both hold the same NaN or infinity.
    Returns the largest absolute error over the finite values."""
    g = got.double().cpu().numpy()
    w = want.double().cpu().numpy()
    bad = np.zeros(g.shape, bool)
    for at in nonfinite:
        bad[at] = True
    if g.shape != w.shape or not np.array_equal(~np.isfinite(g), bad) or \
            not np.array_equal(~np.isfinite(w), bad) or \
            not np.array_equal(g[bad], w[bad], equal_nan=True):
        raise AssertionError(f"{name}: shape {g.shape} vs {w.shape}, or "
                             "non-finite values other than the expected "
                             f"ones at {list(nonfinite)}")
    g, w = np.where(bad, 0.0, g), np.where(bad, 0.0, w)
    for r in exact_rows:
        if not np.array_equal(g[r], w[r]):
            raise AssertionError(f"{name}: channel {r} differs")
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)
    return float(np.max(np.abs(g - w))) if g.size else 0.0


def k2_inputs(n_slots: int, c: int, live, dropped: float, rng,
              n: int = BATCH_ROWS):
    """numpy slots int32 [n] (-1 dropped) and values float32 [n, c] of one
    K2 case: at c = 3 the dense path's channels (measure, 0/1 count, 1),
    else arbitrary floats; on uniform slots where `live` is None, else on
    `live` slots picked at random, with a `dropped` share of the rows
    dropped."""
    if live is None:
        slots = rng.randint(-1, n_slots, n)
    else:
        pick = np.sort(rng.choice(n_slots, live, replace=False))
        slots = pick[rng.randint(0, live, n)]
        slots[rng.rand(n) < dropped] = -1
    if c == 3:
        vals = np.stack([(rng.rand(n) * 50).astype(np.float32),
                         (rng.rand(n) > 0.02).astype(np.float32),
                         np.ones(n, np.float32)], axis=1)
    else:
        vals = ((rng.rand(n, c) - 0.3) * 100).astype(np.float32)
    return slots.astype(np.int32), vals


def kernel_function(call, kernel: str) -> str:
    """The name of the `kernel` ("K2", "K3") __global__ function that one
    call() launched."""
    pat = re.compile(KERNEL_FUNCS[kernel])
    names = {m.group(0) for name, _ in counted_events(call, 1, kernel, 1)
             for m in [pat.search(name)] if m}
    if len(names) != 1:
        raise AssertionError(f"{kernel}: one call launched {sorted(names)}")
    return names.pop()


def runlen_k2_inputs(n: int, live: int, rng) -> tuple:
    """numpy slots int32 [n] (-1 for padded runs) and weighted values
    float32 [n, 3] of K2's call on a run-length chunk (K2_RUNLEN_CASES):
    the live runs on distinct slots in key order, each with its rows,
    valid rows and fare sum."""
    slots = np.full(n, -1, np.int32)
    slots[:live] = np.sort(rng.choice(RT_DENSE_SLOTS, live, replace=False))
    rows = np.zeros(n, np.float32)
    rows[:live] = rng.randint(1, 20_000, live)
    valid = np.floor(rows * rng.uniform(0.9, 1.0, n)).astype(np.float32)
    fare = (valid * rng.uniform(0, 50, n)).astype(np.float32)
    return slots, np.stack([fare, valid, rows], axis=1)


def sorted_k2_inputs(n: int, n_slots: int, rng) -> tuple:
    """numpy slots int32 [n] and values float32 [n, 2] of K2's call on a
    sorted batch under ARES_PREFIX=0 (K2_SORTED_CASES): ascending slots,
    each a run of uniform random length, then a K2_SORTED_TAIL of -1; the
    channels a fare (5% invalid, so 0) and its valid count."""
    kept = n - int(n * K2_SORTED_TAIL)
    slots = np.full(n, -1, np.int32)
    slots[:kept] = np.sort(rng.randint(0, n_slots, kept))
    valid = (rng.rand(n) > 0.05).astype(np.float32)
    fare = (rng.rand(n) * 50).astype(np.float32) * valid
    return slots, np.stack([fare, valid], axis=1)


def phase_k2(P, device, rng) -> dict:
    """K2 against its plain version for each of K2_CASES and
    K2_SORTED_CASES at n = one batch, and K2_RUNLEN_CASES at n =
    n_runs_pad; at C <= 8 through the cluster kernel, above 8 channels
    through the global-atomic one."""
    results = {}
    cases = [(name, n_slots, c, live, dropped, BATCH_ROWS)
             for name, n_slots, c, live, dropped in K2_CASES] + \
        [(name, n_slots, 2, None, "sorted", BATCH_ROWS)
         for name, n_slots, _ in K2_SORTED_CASES] + \
        [(name, RT_DENSE_SLOTS, 3, live, None, n)
         for name, n, live in K2_RUNLEN_CASES]
    for name, n_slots, c, live, dropped, n in cases:
        if dropped == "sorted":
            slots_np, vals_np = sorted_k2_inputs(n, n_slots, rng)
        elif dropped is None:
            slots_np, vals_np = runlen_k2_inputs(n, live, rng)
        else:
            slots_np, vals_np = k2_inputs(n_slots, c, live, dropped, rng)
        nonfinite = []
        if "NaN" in name:
            row = int(np.flatnonzero(slots_np >= 0)[n // 2])
            vals_np[row, 0] = np.nan
            nonfinite = [(0, int(slots_np[row]))]   # channel 0 of its slot
        slots = torch.from_numpy(slots_np).to(device)
        vals = torch.from_numpy(vals_np).to(device)
        got = P.segment_sum(slots, vals, n_slots)
        want = P.segment_sum_plain(slots, vals, n_slots)
        torch.cuda.synchronize()
        err = check_close(f"K2 {name}", got.t(), want.t(),
                          exact_rows=(1, 2) if c == 3 else
                          (1,) if dropped == "sorted" else (),
                          nonfinite=nonfinite)
        call = lambda: P.segment_sum(slots, vals, n_slots)  # noqa: E731
        func = kernel_function(call, "K2")
        want_func = "segment_sum_cluster" if c <= 8 else "segment_sum_global"
        if func != want_func:
            raise AssertionError(f"K2 {name}: ran {func}, not {want_func}")
        (ms, kernel_ms), call_ms = device_ms(call, kernel="K2"), wall_ms(call)
        plain_ms = device_ms(lambda: P.segment_sum_plain(slots, vals,
                                                         n_slots))
        idx = torch.where(slots < 0, torch.full_like(slots, n_slots),
                          slots).long()
        lib_out = torch.zeros((n_slots + 1, c), device=device)
        library_ms = device_ms(lambda: lib_out.index_add_(0, idx, vals))
        # every slot is read; the values of the rows that are kept
        kept = int((slots_np >= 0).sum())
        b_ms, b_by = bound_ms(n * 4 + kept * 4 * c + n_slots * c * 4,
                              kept * c)
        results[name] = dict(max_abs_err=err, ms=ms, kernel_ms=kernel_ms,
                             wall_ms=call_ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=b_ms,
                             bound_by=b_by)
        print(f"K2 segment_sum {name}, n={n} C={c}: ok through {func}, "
              f"max_abs_err={err:.3g} device ms={ms:.4f} kernel-only "
              f"ms={kernel_ms:.4f} (per call {call_ms:.4f}) "
              f"plain_ms={plain_ms:.4f} index_add_ms={library_ms:.4f} "
              f"bound_ms={b_ms:.4f}", flush=True)
    return results


def q5_batch(seed: int) -> tuple:
    """numpy slots int32 [n] and values float32 [n, 3] of K3's call on one
    real Q5 batch: the first batch of phase_e2e's data, ingested alike,
    through Q5 on the CPU service (K3's plain version) with K3's wrapper
    watched."""
    from aresdb_tpu_torch import demo
    from aresdb_tpu_torch.query import executor as X
    from aresdb_tpu_torch.query import pallas_ops as P
    from aresdb_tpu_torch.query.service import QueryService

    store, _, _ = ingest_trips(BATCH_ROWS, seed)
    q, env, understate = e2e_queries(demo, seed)["Q5"]
    seen = []
    real = P.dense_segment_sum

    def watch(slots, values, n_slots):
        seen.append((slots.numpy().copy(), values.numpy().copy(), n_slots))
        return real(slots, values, n_slots)

    P.dense_segment_sum = watch
    try:
        # ARES_PALLAS=1: K3's route on the CPU as on the card
        with query_setting(X, dict(env, ARES_PALLAS="1"), understate):
            ask(QueryService(store, device="cpu"), "Q5", q)
    finally:
        P.dense_segment_sum = real
    if [(s.shape, v.shape, k) for s, v, k in seen] != \
            [((BATCH_ROWS,), (BATCH_ROWS, 3), 128)]:
        raise AssertionError(f"Q5 batch: K3 calls {len(seen)}")
    return seen[0][0], seen[0][1]


def k3_inputs(n_slots: int, c: int, traffic: str, rng, q5) -> tuple:
    """(slots, values, nonfinite indices of the result) in numpy of one
    K3 case (K3_CASES); q5 is q5_batch()'s pair."""
    n = BATCH_ROWS
    if traffic.startswith("Q5"):
        slots, vals = q5[0], q5[1].copy()
    else:
        slots = rng.randint(-1, n_slots + 1, n).astype(np.int32)
        if traffic == "dense":
            vals = np.stack([(rng.rand(n) * 50).astype(np.float32),
                             (rng.rand(n) > 0.02).astype(np.float32),
                             np.ones(n, np.float32)], axis=1)
        else:
            vals = ((rng.rand(n, c) - 0.3) * 100).astype(np.float32)
    nonfinite = []
    if traffic == "Q5 nan inf":
        # one row of the rarest live slot gets NaN, one of another inf
        live, counts = np.unique(slots[slots >= 0], return_counts=True)
        order = live[np.argsort(counts)]
        for special, slot in ((np.nan, order[0]), (np.inf, order[1])):
            vals[int(np.flatnonzero(slots == slot)[0]), 0] = special
            nonfinite.append((0, int(slot)))   # channel 0 of its slot
    return slots, vals, nonfinite


def phase_k3(P, device, rng, q5) -> dict:
    """K3 against its plain version at n = one batch for each of K3_CASES,
    each through the __global__ function the case names. Where the
    channels are the dense path's, the counts must match exactly."""
    n = BATCH_ROWS
    results = {}
    for name, n_slots, c, traffic, want_func in K3_CASES:
        slots_np, vals_np, nonfinite = k3_inputs(n_slots, c, traffic, rng, q5)
        slots = torch.from_numpy(slots_np).to(device)
        vals = torch.from_numpy(vals_np).to(device)
        got = P.dense_segment_sum(slots, vals, n_slots)
        want = P.dense_segment_sum_plain(slots, vals, n_slots)
        torch.cuda.synchronize()
        err = check_close(f"K3 {name}", got.t(), want.t(),
                          exact_rows=() if traffic == "floats" else (1, 2),
                          nonfinite=nonfinite)
        call = lambda: P.dense_segment_sum(slots, vals, n_slots)  # noqa: E731
        func = kernel_function(call, "K3")
        if func != want_func:
            raise AssertionError(f"K3 {name}: ran {func}, not {want_func}")
        (ms, kernel_ms), call_ms = device_ms(call, kernel="K3"), wall_ms(call)
        plain_ms = device_ms(lambda: P.dense_segment_sum_plain(
            slots, vals, n_slots))
        idx = torch.where((slots < 0) | (slots >= n_slots),
                          torch.full_like(slots, n_slots), slots).long()
        lib_out = torch.zeros((n_slots + 1, c), device=device)
        library_ms = device_ms(lambda: lib_out.index_add_(0, idx, vals))
        # every slot is read; the values of the rows that are kept
        kept = int(((slots_np >= 0) & (slots_np < n_slots)).sum())
        b_ms, b_by = bound_ms(n * 4 + kept * 4 * c + n_slots * c * 4,
                              kept * c)
        results[name] = dict(max_abs_err=err, ms=ms, kernel_ms=kernel_ms,
                             wall_ms=call_ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=b_ms,
                             bound_by=b_by)
        print(f"K3 dense_segment_sum {name}, n={n} n_slots={n_slots} C={c}: "
              f"ok through {func}, max_abs_err={err:.3g} device "
              f"ms={ms:.4f} kernel-only ms={kernel_ms:.4f} (per call "
              f"{call_ms:.4f}) plain_ms={plain_ms:.4f} "
              f"index_add_ms={library_ms:.4f} bound_ms={b_ms:.4f}",
              flush=True)
    return results


def ptxas_functions(log: str) -> dict:
    """Each function's registers, stack frame and spill bytes from a
    `ptxas -v` log, by its (mangled) name."""
    out = {}
    frame = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                       r"(\d+) bytes spill loads")
    used = re.compile(r"Used (\d+) registers")
    for m in re.finditer(r"Function properties for (\S+)", log):
        end = log.find("Function properties for", m.end())
        part = log[m.end():end if end >= 0 else len(log)]
        f, u = frame.search(part), used.search(part)
        if f is None or u is None:
            continue
        stack, stores, loads = map(int, f.groups())
        out[m.group(1)] = {"registers": int(u.group(1)),
                           "stack_bytes": stack,
                           "spill_bytes": stores + loads}
    return out


def k1_setup(demo, FD, columns_from_numpy, plan_dense, query, city_max,
             seed, device) -> tuple:
    """One K1 case at n = one batch: (plan, dense plan, fused spec, its
    FusedDenseKernel, the staged columns, the joined tables' probes)."""
    n = BATCH_ROWS
    plan, dp, spec = k1_spec(demo, FD, plan_dense, query, city_max)
    cols_np, _ = demo.demo_columns(plan, n, seed=3,
                                   n_cities=max(city_max, 300))
    kern = FD.FusedDenseKernel(plan, n, dp, spec, device)
    columns = columns_from_numpy(cols_np, n, device)
    foreign = ()
    if spec.fkeys:
        fcols, foreign = city_columns(plan, seed, device)
        columns.update(fcols)
    return plan, dp, spec, kern, columns, foreign


def k1_check(name, kern, columns, n_valid, cutoff, foreign, city_max, got,
             got_ovf) -> tuple:
    """K1's (out, overflow) of one case against its plain version: the
    overflow exact and present only where the city domain is understated,
    the counts exact, the sums within check_close's tolerance. Returns
    (the largest error, the rows kept)."""
    want, want_ovf = kern.reduce_plain(columns, n_valid, cutoff, foreign)
    torch.cuda.synchronize()
    if int(got_ovf) != int(want_ovf) or \
            (city_max < 300) != (int(want_ovf) > 0):
        raise AssertionError(f"{name}: overflow {int(got_ovf)} vs "
                             f"{int(want_ovf)}")
    return (check_close(f"K1 {name}", got, want, exact_rows=(1, 2)),
            int(want[2].sum().item()))


def phase_build(demo, FD, columns_from_numpy, plan_dense, cuda_build,
                device, seed: int = 0) -> dict:
    """K1's build on a fresh temporary build directory: the launcher
    library's one-off build (nvcc) and libnvrtc's load, then for each of
    phase_k1's plans, one
    at a time, its structure's cubin (NVRTC in this process; none where an
    earlier plan has its structure: the overflowing and the 1,000-city Q1
    are Q1's) and its first launch, split: the image's load (read, loaded
    with cudaLibraryLoadData, its parameters checked), the launch's sizing
    (the card's limits and the occupancy query, then cached) and the run,
    held against the plain version. Returns the seconds of each."""
    n = BATCH_ROWS
    out = {"structures": {}}
    saved = cuda_build.BUILD_DIR
    with tempfile.TemporaryDirectory() as tmp:
        cuda_build.BUILD_DIR = Path(tmp)
        try:
            built = cuda_build.built
            out["launcher_s"] = cuda_build.build_all([FD.launcher_item()])
            print(f"build: K1's launcher library in {out['launcher_s']:.3f} s"
                  f" (nvcc -x c++)", flush=True)
            t0 = time.perf_counter()
            cuda_build.nvrtc()
            out["nvrtc_load_s"] = time.perf_counter() - t0
            print(f"build: libnvrtc loaded in {out['nvrtc_load_s']:.3f} s",
                  flush=True)
            sources = set()
            for name, (query, city_max) in k1_cases(demo, seed).items():
                *_, spec, kern, columns, foreign = k1_setup(
                    demo, FD, columns_from_numpy, plan_dense, query,
                    city_max, seed, device)
                new = spec.source not in sources
                sources.add(spec.source)
                build_s = cuda_build.build_all([FD.build_item(spec.source)])
                n_valid, cutoff = n - 777, demo.DEMO_NOW - 15 * 3600
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                handle = FD.structure_kernel(spec, device)
                t1 = time.perf_counter()
                FD.launch_plan(handle, spec.n_slots, n, device)
                t2 = time.perf_counter()
                got, got_ovf = kern.reduce(columns, n_valid, cutoff, foreign)
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                k1_check(f"{name} first launch", kern, columns, n_valid,
                         cutoff, foreign, city_max, got, got_ovf)
                first = {"load_ms": 1e3 * (t1 - t0),
                         "plan_ms": 1e3 * (t2 - t1),
                         "run_ms": 1e3 * (t3 - t2)}
                out["structures"][name] = {"new": new, "nvrtc_s": build_s,
                                           "first_launch_ms": first}
                print(f"build: K1 {name}: "
                      + (f"NVRTC in {build_s:.3f} s" if new else
                         "an earlier plan's structure")
                      + ", first launch: load {load_ms:.3f} ms, sizing "
                      "{plan_ms:.3f} ms, run {run_ms:.3f} ms".format(**first),
                      flush=True)
            if cuda_build.built - built != 1 + len(sources):
                raise AssertionError(f"build: {cuda_build.built - built} "
                                     "builds, not the launcher and one "
                                     "cubin a structure")
        finally:
            cuda_build.BUILD_DIR = saved
    return out


def phase_k1(demo, FD, columns_from_numpy, plan_dense, cuda_build,
             device, seed: int = 0) -> dict:
    """K1 against its plain version at n = one batch for each plan; every
    plan, the 26,650-slot one included, reduces through the cluster
    histogram. J1's joined lane is gathered through the cities table's
    probe, as the executor's batches gather it. Each plan's kernel has
    no local memory, so no stack frame and no spill (FD.kernel_usage of
    its loaded image). Then A1's live and archive shapes in a query's
    launcher calls against one call a batch, without and with J1's
    joined lane (k1_batches)."""
    n = BATCH_ROWS
    results = {}
    for name, (query, city_max) in k1_cases(demo, seed).items():
        plan, dp, spec, kern, columns, foreign = k1_setup(
            demo, FD, columns_from_numpy, plan_dense, query, city_max, seed,
            device)
        ranks = FD.cluster_size(spec.n_slots, device)
        # the loaded image's registers and local bytes: NVRTC's log holds
        # ptxas's report only where its ptxas ran
        usage = FD.kernel_usage(FD.structure_kernel(spec, device), device)
        if usage["local_bytes"]:
            raise AssertionError(f"K1 {name}: a stack frame or spills: "
                                 f"{usage}")
        if ranks <= 0:
            raise AssertionError(f"K1 {name}: no cluster holds its "
                                 f"{spec.n_slots} slots")
        n_valid, cutoff = n - 777, demo.DEMO_NOW - 15 * 3600
        got, got_ovf = kern.reduce(columns, n_valid, cutoff, foreign)
        err, rows_in = k1_check(name, kern, columns, n_valid, cutoff,
                                foreign, city_max, got, got_ovf)
        call = lambda: kern.reduce(columns, n_valid, cutoff,  # noqa: E731
                                   foreign)
        (ms, kernel_ms), call_ms = device_ms(call, kernel="K1"), wall_ms(call)
        plain_ms = device_ms(lambda: kern.reduce_plain(columns, n_valid,
                                                       cutoff, foreign))
        nbytes = sum(columns[(0, cid)][0].element_size() * n + n
                     for cid in spec.col_ids)
        if 0 not in spec.col_ids:
            nbytes += 4 * n      # the time column read for the cutoff
        # a joined table's columns and probe, each read once
        nbytes += sum(t.numel() * t.element_size() for probe in foreign
                      for t in probe)
        nbytes += sum(t.numel() * t.element_size()
                      for key, pair in columns.items() if key[0] > 0
                      for t in pair)
        nbytes += 3 * spec.n_slots * 4
        b_ms, b_by = bound_ms(nbytes, 3 * n)
        results[name] = dict(n_slots=spec.n_slots, max_abs_err=err, ms=ms,
                             kernel_ms=kernel_ms, wall_ms=call_ms,
                             plain_ms=plain_ms, library_ms=None,
                             bound_ms=b_ms, bound_by=b_by, usage=usage)
        print(f"K1 fused_dense {name}: n={n} n_slots={spec.n_slots} "
              f"cluster of {ranks} ok, {usage}, literal block "
              f"{len(spec.lits_i)} ints {len(spec.lits_f)} floats, "
              f"rows kept={rows_in} overflow={int(got_ovf)} "
              f"max_abs_err={err:.3g} device ms={ms:.4f} kernel-only "
              f"ms={kernel_ms:.4f} (per call "
              f"{call_ms:.4f}) plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.4f}", flush=True)
    k1_batches(demo, FD, columns_from_numpy, plan_dense, device)
    k1_batches(demo, FD, columns_from_numpy, plan_dense, device, join=True,
               seed=seed)
    return results


def k1_batch_shapes(demo, n: int = BATCH_ROWS,
                    chunk: int = 1 << 22) -> list:
    """A1's batches, as (padded rows, valid rows, cutoff): a live batch of
    n rows (777 of them padding; the cutoff 15 h back), an archive chunk
    of `chunk` rows (ShardExecutor.ARCHIVE_CHUNK_ROWS) and one of
    3/4 of it padded to `chunk` (no cutoff: 0), and another live batch."""
    cutoff = demo.DEMO_NOW - 15 * 3600
    return [(n, n - 777, cutoff), (chunk, chunk, 0),
            (chunk, 3 * chunk // 4, 0), (n, n - 777, cutoff)]


def host_ms(fn, iters: int = 20) -> float:
    """Mean host milliseconds to enqueue fn() over iters calls, after a
    warm-up: the caller's own cost, not the card's."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / iters


def k1_batches(demo, FD, columns_from_numpy, plan_dense, device,
               shapes=None, join: bool = False, seed: int = 0) -> dict:
    """A query's launcher calls over A1's live and archive shapes against
    one call a batch: sum(fare) by city, or with join J1's shape (Q1
    joined to the cities table, filtered on the population), a kernel a
    padded size, one structure and literal block. FD.reduce_batches over
    each of FD.launch_calls' calls (ares_fused_dense_batches; one call
    for the four batches, or with a joined lane, which each call gathers,
    two) against each batch's `reduce` (ares_fused_dense): the overflow
    counts, the valid-measure and row counts exact, the sums within
    check_close's tolerance (the atomics add in another order); one
    launch a batch either way. On the card, the host ms of each way."""
    if join:
        query = joined(demo.DEMO_QUERY, seed)
    else:
        query = json.loads(json.dumps(demo.DEMO_QUERY))
        query["measures"] = [{"sqlExpression": "sum(fare)"}]
        query["dimensions"] = [{"sqlExpression": "city_id"}]
    plan, dp, spec = k1_spec(demo, FD, plan_dense, query, 300)
    if bool(spec.fkeys) != join:
        raise AssertionError(f"K1 batches: joined lanes {spec.fkeys}")
    shapes = shapes or k1_batch_shapes(demo)
    batches = []
    for i, (n, n_valid, cutoff) in enumerate(shapes):
        cols_np, _ = demo.demo_columns(plan, n, seed=20 + i)
        columns, foreign = columns_from_numpy(cols_np, n, device), ()
        if join:
            fcols, foreign = city_columns(plan, seed, device)
            columns.update(fcols)
        batches.append((FD.FusedDenseKernel(plan, n, dp, spec, device),
                        columns, n_valid, cutoff, foreign))
    if len({kern.group_key for kern, *_ in batches}) != 1:
        raise AssertionError("K1 batches: the kernels' structures differ")

    def one_by_one():
        return [kern.reduce(cols, n_valid, cutoff, foreign)
                for kern, cols, n_valid, cutoff, foreign in batches]

    def grouped():
        calls = FD.launch_calls([kern.record(cols, n_valid, cutoff, foreign)
                                 for kern, cols, n_valid, cutoff, foreign
                                 in batches])
        outs = [FD.reduce_batches(call) for call in calls]
        return (torch.cat([o for o, _ in outs]),
                torch.cat([v for _, v in outs]), len(calls))

    launches = FD.FusedDenseKernel.launches
    want = one_by_one()
    got, got_ovf, n_calls = grouped()
    launches = FD.FusedDenseKernel.launches - launches
    if launches != 2 * len(batches):
        raise AssertionError(f"K1 batches: {launches} launches, not 2 x "
                             f"{len(batches)}")
    want_calls = -(-len(batches) // FD.PIPELINE_FACTOR) if join else 1
    if n_calls != want_calls:
        raise AssertionError(f"K1 batches: {n_calls} launcher calls, not "
                             f"{want_calls}")
    err = 0.0
    for b, (out, ovf) in enumerate(want):
        if int(got_ovf[b]) != int(ovf):
            raise AssertionError(f"K1 batches: batch {b} overflow "
                                 f"{int(got_ovf[b])} vs {int(ovf)}")
        err = max(err, check_close(f"K1 batches: batch {b}", got[b], out,
                                   exact_rows=(1, 2)))
    out = {"batches": len(batches), "calls": n_calls, "shapes": shapes,
           "max_abs_err": err}
    if device.type == "cuda":
        out["one_by_one_host_ms"] = host_ms(one_by_one)
        out["grouped_host_ms"] = host_ms(grouped)
    print(f"K1 batches{' (J1, a joined lane)' if join else ''}: "
          f"{len(batches)} batches of A1's shapes {shapes} in {n_calls} "
          f"launcher call{'s' if n_calls > 1 else ''} match one call a "
          f"batch, max_abs_err={err:.3g}; host ms a query: "
          f"{out.get('grouped_host_ms', float('nan')):.4f} grouped, "
          f"{out.get('one_by_one_host_ms', float('nan')):.4f} one by one",
          flush=True)
    return out


class Store:
    """The store protocol ShardExecutor uses: schemas and table shards."""

    def __init__(self, schemas, shards):
        self.schemas = schemas
        self.shards = shards

    def get_schemas(self):
        return dict(self.schemas)

    def get_table_shard(self, name, shard_id=0):
        return self.shards[(name, shard_id)]


def ingest_trips(n_rows: int, seed: int, batch_rows: int = BATCH_ROWS
                 ) -> tuple:
    """A trips TableShard holding n_rows demo rows, ingested through the
    upsert wire format in batch-sized upserts, and the cities table
    (N_CITIES rows, populations from the seed) beside it. Returns (store,
    seconds of the trips' ingest, each batch's columns as numpy arrays
    by name, for the oracles)."""
    from aresdb_tpu_torch import demo
    from aresdb_tpu_torch.common import data_types as mdt
    from aresdb_tpu_torch.common.schema import Table, TableSchema
    from aresdb_tpu_torch.common.upsert_batch import (UpsertBatch,
                                                      build_columnar_upsert)
    from aresdb_tpu_torch.memstore.table_shard import TableShard

    schema_json = dict(demo.TRIPS_SCHEMA_JSON)
    # rows are timed at DEMO_NOW (2020): the default 90-day retention
    # would drop every one of them
    schema_json["config"] = {"batchSize": batch_rows,
                             "recordRetentionInDays": 0}
    ts = TableSchema(Table.from_json(schema_json))
    ts.extend_enum("status", STATUSES)
    shard = TableShard(ts)
    rng = np.random.RandomState(seed)
    data = []
    t0 = time.perf_counter()
    for lo in range(0, n_rows, batch_rows):
        n = min(batch_rows, n_rows - lo)
        keys = np.arange(lo + 1, lo + n + 1, dtype=np.uint64)
        b = {"request_at": (demo.DEMO_NOW - rng.randint(0, 20 * 3600, n))
             .astype(np.uint32),
             "uuid": np.stack([keys, keys * np.uint64(2654435761)], 1),
             "city_id": rng.randint(1, N_CITIES + 1, n).astype(np.uint16),
             "city_valid": rng.rand(n) > 0.02,
             "status": rng.randint(0, 3, n).astype(np.uint8),
             "status_valid": rng.rand(n) > 0.02,
             "fare": (rng.rand(n) * 50).astype(np.float32),
             "fare_valid": rng.rand(n) > 0.02}
        cols = [(0, mdt.Uint32, b["request_at"], None, 0),
                (1, mdt.UUID, b["uuid"], None, 0),
                (2, mdt.Uint16, b["city_id"], b["city_valid"], 0),
                (3, mdt.SmallEnum, b["status"], b["status_valid"], 0),
                (4, mdt.Float32, b["fare"], b["fare_valid"], 0)]
        shard.save_upsert_batch(UpsertBatch(build_columnar_upsert(cols, n)))
        data.append(b)
    secs = time.perf_counter() - t0
    cities_ts = TableSchema(Table.from_json(CITIES_SCHEMA_JSON))
    cities = TableShard(cities_ts)
    cities.save_upsert_batch(UpsertBatch(build_columnar_upsert(
        [(0, mdt.Uint16, np.arange(1, N_CITIES + 1, dtype=np.uint16), None,
          0),
         (1, mdt.Uint32, city_populations(seed), None, 0)], N_CITIES)))
    return (Store({"trips": ts, "cities": cities_ts},
                  {("trips", 0): shard, ("cities", 0): cities}), secs, data)


def flatten(result, prefix=()) -> dict:
    """{(dim values...): measure} of one AQL result."""
    out = {}
    for k, v in result.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def same_result(name: str, got: dict, want: dict) -> None:
    """Keys exact, measures within RTOL/ATOL."""
    g, w = flatten(got), flatten(want)
    if set(g) != set(w):
        raise AssertionError(f"{name}: group keys differ "
                             f"({len(g)} vs {len(w)} groups)")
    keys = sorted(w)
    gv = np.array([np.nan if g[k] is None else g[k] for k in keys], float)
    wv = np.array([np.nan if w[k] is None else w[k] for k in keys], float)
    np.testing.assert_allclose(gv, wv, rtol=RTOL, atol=ATOL, err_msg=name)


@contextlib.contextmanager
def query_setting(X, env: dict, understate: bool):
    """Apply a query's environment and, where asked, a dense planner that
    understates the city domain as 1..100 (the data holds 1..300), as in
    k1_cases' overflowing case; restore both after."""
    saved = {k: os.environ.get(k) for k in env}
    real = X.plan_dense

    def plan_understated(plan, stats):
        stats = dict(stats or {})
        key = (0, plan.main_schema.column_id("city_id"))
        if key in stats:
            stats[key] = (1, 100)
        return real(plan, stats)

    os.environ.update(env)
    if understate:
        X.plan_dense = plan_understated
    try:
        yield
    finally:
        X.plan_dense = real
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def ask(svc, name: str, q) -> tuple:
    """(result, verbose context) of one AQL query, or of one SQL
    statement where q is a string; raises on an error."""
    request = {"queries": [q], "verbose": True}
    resp = svc.handle_sql(request) if isinstance(q, str) \
        else svc.handle_aql(request)
    if "errors" in resp:
        raise AssertionError(f"{name} on {svc.device}: {resp['errors']}")
    return resp["results"][0], resp["context"][0]


def listing_oracle(data, limit: int) -> list:
    """N1's rows from the ingested data: the first `limit` rejected trips
    in ingest order, as the service formats fare and city."""
    from aresdb_tpu_torch.query.postprocess import format_float32

    rows = []
    for b in data:
        hit = np.flatnonzero(b["status_valid"] & (b["status"] == 2))
        for i in hit[:limit - len(rows)]:
            rows.append([format_float32(b["fare"][i]) if b["fare_valid"][i]
                         else "NULL",
                         str(b["city_id"][i]) if b["city_valid"][i]
                         else "NULL"])
        if len(rows) == limit:
            break
    return rows


def hll_estimates(hashed: np.ndarray, groups: np.ndarray, keys) -> dict:
    """{key(g): hll.compute_estimate} of each group's registers, built
    from the rows' 64-bit hashes with np.maximum.at."""
    from aresdb_tpu_torch.query import hll as H

    n_groups = int(groups.max()) + 1
    regs = np.zeros(n_groups * H.HLL_M, np.uint8)
    hv = H.hll_value_from_hash(hashed)
    rho = np.minimum(hv >> 16, 254).astype(np.uint8) + 1
    np.maximum.at(regs, groups * H.HLL_M + (hv & (H.HLL_M - 1)), rho)
    regs = regs.reshape(n_groups, H.HLL_M)
    return {keys(g): H.compute_estimate(regs[g])
            for g in np.unique(groups).tolist()}


def hll_oracle(data, name: str) -> tuple:
    """H1's or H2's answer from the ingested data with numpy: each row's
    hash (hll.murmur3_64 of request_at, or the XOR of the UUID's lanes)
    through hll_estimates; and each group's exact distinct count. Returns
    ({group: estimate}, {group: exact count})."""
    from aresdb_tpu_torch.query import hll as H

    by_city = name == "H1"
    hashed, groups, distinct = [], [], []
    for b in data:
        if by_city:
            hashed.append(H.murmur3_64(b["request_at"], 4))
            g = np.where(b["city_valid"], b["city_id"], 0).astype(np.int64)
            distinct.append((g << 32) | b["request_at"].astype(np.int64))
        else:   # every trip's key is distinct
            hashed.append(b["uuid"][:, 0] ^ b["uuid"][:, 1])
            g = np.zeros(len(b["uuid"]), np.int64)
        groups.append(g)
    if by_city:
        uniq = np.unique(np.concatenate(distinct))
        gs, counts = np.unique(uniq >> 32, return_counts=True)
    else:
        gs = np.zeros(1, np.int64)
        counts = np.array([sum(len(b["uuid"]) for b in data)])
    key = (lambda g: "NULL" if g == 0 else str(g)) if by_city \
        else (lambda g: "")
    estimates = hll_estimates(np.concatenate(hashed), np.concatenate(groups),
                              key)
    return estimates, {key(g): int(c) for g, c in zip(gs.tolist(), counts)}


def check_answer(name, answer, cpu_answer, contexts, data, gpu, cpu, q):
    """A query's cuda answer against the CPU run's (listings and HLL
    exactly, sums within RTOL/ATOL) and, for N1, H1 and H2, against the
    ingested data."""
    if name not in LISTINGS + HLL_QUERIES:
        same_result(name, answer, cpu_answer)
        return
    if answer != cpu_answer:
        raise AssertionError(f"{name}: the cuda answer differs from the cpu "
                             "run's")
    if name == "N1":
        if [c["batches"] for c in contexts] != [1] * len(contexts):
            raise AssertionError(f"N1: batches scanned "
                                 f"{[c['batches'] for c in contexts]}")
        if answer["matrixData"] != listing_oracle(data, 50):
            raise AssertionError("N1: rows differ from the first 50 "
                                 "rejected trips")
    if name in HLL_QUERIES:
        estimates, exact = hll_oracle(data, name)
        if answer != estimates:
            raise AssertionError(f"{name}: estimates differ from the numpy "
                                 "oracle's")
        ratio = {g: answer[g] / exact[g] for g in exact}
        worst = max(abs(r - 1) for r in ratio.values())
        print(f"{name}: {len(answer)} estimates equal the oracle's; "
              f"estimate / exact distinct count from {min(ratio.values())}"
              f" to {max(ratio.values())}", flush=True)
        if name == "H1" and worst > 0.05:
            raise AssertionError(f"H1: an estimate {worst:.3%} off its "
                                 "exact distinct count")
        if name == "H2":
            wire = [svc.handle_aql_hll({"queries": [q]}) for svc in (gpu, cpu)]
            if wire[0] != wire[1]:
                raise AssertionError("H2: application/hll bytes differ")
            print(f"H2: application/hll frame of {len(wire[0])} bytes, "
                  "identical on cuda and cpu", flush=True)


def run_query(gpu, cpu, name: str, q, env: dict, understate: bool,
              runs: int, counters: dict, want: dict, cpu_answer=None) -> dict:
    """One query `runs` times on the card (each kernel's launch count set
    to 0 just before and read just after; raises unless they equal
    `want`), once more under the profiler, and once on the CPU service
    unless its answer is given. Returns the answers, the contexts and
    wall seconds of the runs, the launches, the mesh counters' growth
    over the runs, the profiled run's device events and each kernel's
    device ms per launch in it, and the CPU run's seconds."""
    from aresdb_tpu_torch.query import executor as X

    with query_setting(X, env, understate):
        for c in counters.values():
            c.launches = 0
        times, contexts = [], []
        mesh0 = mesh_counts()
        for _ in range(runs):
            t0 = time.perf_counter()
            answer, ctx = ask(gpu, name, q)
            if gpu.device.type == "cuda":
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            contexts.append(ctx)
        mesh = {k: v - mesh0[k] for k, v in mesh_counts().items()}
        got = {k: c.launches for k, c in counters.items()}
        if got != want:
            raise AssertionError(f"{name}: launches {got}, expected {want}")

        def profiled_run():
            # a retaken session's launches are counted afresh
            for c in counters.values():
                c.launches = 0
            ask(gpu, name, q)

        events = device_events(profiled_run, 1) \
            if gpu.device.type == "cuda" else []
        for k, c in counters.items():
            if events and c.launches and \
                    len(kernel_events(events, k)) != c.launches:
                events = counted_events(profiled_run, 1, k, c.launches)
        in_situ = {}
        for k, c in counters.items():
            if c.launches and events:
                in_situ[k] = sum(kernel_events(events, k)) / 1e3 / c.launches
                print(f"{name} in situ: {k} {in_situ[k]:.4f} ms per launch "
                      f"over {c.launches} launches", flush=True)
        t0 = time.perf_counter()
        if cpu_answer is None:
            cpu_answer, _ = ask(cpu, name, q)
        cpu_s = time.perf_counter() - t0
    return dict(answer=answer, cpu_answer=cpu_answer, contexts=contexts,
                times=times, launches=got, events=events, in_situ=in_situ,
                cpu_s=cpu_s, mesh=mesh)


def report(name: str, rec: dict, n_rows: int, listing_rows: bool = False):
    """Print one query's latencies, launches, stages and device time."""
    answer, contexts, times = rec["answer"], rec["contexts"], rec["times"]
    events = rec["events"]
    warm_ms = 1e3 * float(np.median(times[1:]))
    busy = sum(us for _, us in events) / 1e3
    by_name = {}
    for ev_name, us in events:
        by_name[ev_name] = by_name.get(ev_name, 0.0) + us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    last = contexts[-1] or {}
    size = f"{len(answer['matrixData'])} rows" if listing_rows \
        else f"{len(flatten(answer))} groups"
    reruns = [(c["ladderReruns"], c["overflowReruns"]) for c in contexts
              if c is not None]
    print(f"{name}: cold {1e3 * times[0]:.3f} ms, warm median "
          f"{warm_ms:.3f} ms ({n_rows / warm_ms * 1e3:.0f} rows/s), "
          f"{size}, launches "
          + " ".join(f"{k}={v}" for k, v in rec["launches"].items())
          + f", (ladder, overflow) reruns by run {reruns}, host fetches "
          f"cold {(contexts[0] or {}).get('hostFetches')} warm "
          f"{last.get('hostFetches')}, batches scanned "
          f"{last.get('batches')}", flush=True)
    print(f"{name} last warm run, seconds by stage: "
          + ", ".join(f"{k}={v:.6f}" for k, v in last.items()
                      if isinstance(v, float)), flush=True)
    print(f"{name} warm run under the profiler: device busy "
          f"{busy:.3f} ms = {100 * busy / warm_ms:.1f}% of the "
          f"unprofiled warm median, {len(events)} device ops; top: "
          + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top), flush=True)
    print(f"{name}: cuda result matches the cpu run ({rec['cpu_s']:.1f} s "
          f"on the cpu)", flush=True)


def kernel_counters() -> dict:
    from aresdb_tpu_torch.query import fused_dense as FD
    from aresdb_tpu_torch.query import pallas_ops as P

    return {"K1": FD.FusedDenseKernel, "K2": P.segment_sum,
            "K3": P.dense_segment_sum}


def mesh_counts() -> dict:
    """The port's mesh counters (query.mesh_batches, ...) by short name."""
    from aresdb_tpu_torch.utils import metrics as M

    snap = M.root().snapshot().get("counters", {})
    return {k: snap.get("query." + k, 0) for k in MESH_COUNTERS}


@contextlib.contextmanager
def counting_k2():
    """K2's wrapper replaced, for a CPU rehearsal, by one that counts its
    calls on a non-empty batch, as the card's wrapper counts its
    launches; put back after. Yields the counter (its `calls`)."""
    from aresdb_tpu_torch.query import pallas_ops as P

    real = P.segment_sum

    def counted(slots, values, n_slots, ones_channels=()):
        if slots.shape[0]:
            counted.calls += 1
        return real(slots, values, n_slots, ones_channels)

    counted.calls = 0
    P.segment_sum = counted
    try:
        yield counted
    finally:
        P.segment_sum = real


def warm_ms(rec: dict) -> float:
    return 1e3 * float(np.median(rec["times"][1:]))


def window_run(name: str, send, check) -> dict:
    """One run of a query whose window or column range moved: its ms, the
    builds it made (cuda_build.built) and K1's launches in it (set to
    0 just before, read just after); check(answer) holds the answer to
    the CPU run and the numpy oracle. Raises if the run built anything
    or did not launch K1."""
    from aresdb_tpu_torch.query import fused_dense as FD
    from aresdb_tpu_torch.utils import cuda_build

    built = cuda_build.built
    FD.FusedDenseKernel.launches = 0
    t0 = time.perf_counter()
    answer = send()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    run = {"ms": ms, "builds": cuda_build.built - built,
           "k1_launches": FD.FusedDenseKernel.launches}
    check(answer)
    if run["builds"] or not run["k1_launches"]:
        raise AssertionError(f"{name}: built {run['builds']} times, "
                             f"launched K1 {run['k1_launches']} times")
    return run


def phase_window(name: str, gpu, cpu, q: dict, warm: float, oracle) -> None:
    """`name` on the card once at each of its WINDOW_MOVES (the query's
    `now` moved by that many seconds; 0 is the phase's warm query): each
    run through window_run, its answer against the CPU service's at the
    same `now` and oracle(answer, now). Records the runs, beside the
    phase's warm median `warm` in ms, in WINDOW[name]."""
    runs = []
    for move in WINDOW_MOVES[name]:
        moved = dict(q, now=q["now"] + move)

        def check(answer, moved=moved, move=move):
            same_result(f"{name} at now + {move} s", answer,
                        ask(cpu, name, moved)[0])
            oracle(answer, moved)

        runs.append(dict(move_s=move, **window_run(
            f"{name} at now + {move} s", lambda: ask(gpu, name, moved)[0],
            check)))
    WINDOW[name] = {"warm_ms": warm, "runs": runs}
    print(f"window {name}: " + "; ".join(
        f"now + {r['move_s']} s {r['ms']:.3f} ms ({r['ms'] / warm:.2f} x "
        f"the warm median {warm:.3f}), {r['builds']} builds, K1 launches "
        f"{r['k1_launches']}" for r in runs)
        + "; each equals the cpu run and the numpy oracle", flush=True)


def prefix_queries(demo) -> dict:
    """phase_prefix's queries: name -> (query, environment, understate the
    city domain). Q1 overflow's rerun takes the sort path, not the
    runtime-dense branch (ARES_RTDENSE=0); M1 is Q4 with max(fare), which
    the runtime-dense branch never takes; H1, H2 and Q3 as phase_e2e's."""
    e2e = e2e_queries(demo)
    minute_city = [("request_at", "minute"), ("city_id", None)]
    return {
        "Q1 overflow": (e2e["Q1 overflow"][0], {"ARES_RTDENSE": "0"}, True),
        "M1": (demo_variant(demo, "max(fare)", minute_city,
                            ["city_id <= 20"], "3 hours ago"), {}, False),
        "H1": e2e["H1"], "H2": e2e["H2"], "Q3": e2e["Q3"]}


def minute_oracle(data, demo):
    """oracle(name, answer, query) of Q3's and M1's form by minute x city
    over the query's window, from the ingested batches: Q3 sum(fare) of
    the completed trips (NULL where the city is), M1 max(fare) over the
    cities <= 20 (the identity, -FLT_MAX, where no fare of the group is
    valid, as both packages answer)."""
    from aresdb_tpu_torch.query.time_util import format_time_dimension

    col = {k: np.concatenate([b[k] for b in data])
           for k in ("request_at", "city_id", "city_valid", "status",
                     "status_valid", "fare", "fare_valid")}
    t = col["request_at"].astype(np.int64)
    city = np.where(col["city_valid"], col["city_id"], 0).astype(np.int64)
    fare, fare_valid = col["fare"].astype(np.float64), col["fare_valid"]

    def check(name, answer, q):
        plan = demo.demo_plan(q)
        sel = (t >= plan.from_ts) & (t < plan.to_ts)
        if name == "Q3":
            sel &= col["status_valid"] & (col["status"] == 0)
        else:
            sel &= col["city_valid"] & (col["city_id"] <= 20)
        keys, inv = np.unique(((t // 60) * 65536 + city)[sel],
                              return_inverse=True)
        ok = fare_valid[sel]
        if name == "Q3":
            vals = np.bincount(inv, weights=np.where(ok, fare[sel], 0.0),
                               minlength=len(keys)).tolist()
        else:
            top = np.full(len(keys), -float(np.finfo(np.float32).max))
            np.maximum.at(top, inv[ok], fare[sel][ok])
            vals = top.tolist()
        want = {(format_time_dimension(k // 65536 * 60, "minute"),
                 "NULL" if k % 65536 == 0 else str(k % 65536)): v
                for k, v in zip(keys.tolist(), vals)}
        got = flatten(answer)
        if set(got) != set(want):
            raise AssertionError(f"{name}: {len(got)} groups, the oracle "
                                 f"{len(want)}")
        for k, v in want.items():
            if abs((got[k] or 0.0) - v) > max(ATOL, abs(v) * RTOL):
                raise AssertionError(f"{name}: {k} {got[k]} against {v}")
    return check


def phase_prefix(store, gpu, single: dict, data, demo, device,
                 n_batches: int, fused: int, names=PREFIX_QUERIES) -> tuple:
    """The sort path's sums and counts through K2 (ARES_PREFIX=0), through
    a new QueryService with a kernel cache of its own (the cache's key, as
    the JAX package's, holds no environment): each of prefix_queries (or
    those in `names`) one cold and one warm run, the launches set to 0
    just before and read just after, then one profiled warm run. Each
    answer equals the default route's (phase_e2e's answer, or `gpu`'s for
    M1; HLL exactly, sums within RTOL/ATOL) and, the sums, their numpy
    oracle (phase_e2e held H1's and H2's to theirs exactly). Every
    sorted reduce and HLL batch of a table of at most K2_MAX_SLOTS groups
    launches K2 once, and one past the cap (Q3's 524,288) none; K2's
    launches are those plus the unfused dense kernel's (Q1 overflow's
    batches below FD_MIN_ROWS), K1's those of phase_e2e. Returns each
    kernel's launches over the runs and {kernel: {query: device ms per
    launch}} from the profiled runs."""
    from aresdb_tpu_torch.query import executor as X
    from aresdb_tpu_torch.query import kernels as K
    from aresdb_tpu_torch.query import pallas_ops as P
    from aresdb_tpu_torch.query.kernels import KernelCache
    from aresdb_tpu_torch.query.service import QueryService

    counters = kernel_counters()
    totals = dict.fromkeys(counters, 0)
    in_situ = {k: {} for k in counters}
    svc = QueryService(store, device=device)
    svc.executor.kernel_cache = KernelCache()
    queries = prefix_queries(demo)
    oracle_q1, oracle_min = q1_oracle(data, demo), minute_oracle(data, demo)
    calls = []   # (k_groups, K2 launches inside) of each sorted reduce

    def spied(fn, k_at):
        def run(*a, **kw):
            k, before = a[k_at], P.segment_sum.launches
            out = fn(*a, **kw)
            calls.append((k, P.segment_sum.launches - before))
            return out
        return run

    real = K._reduce_by_key_sorted, K.hll_batch_body
    K._reduce_by_key_sorted = spied(real[0], 5)
    K.hll_batch_body = spied(real[1], 2)
    try:
        for name in names:
            q, env, understate = queries[name]
            label = f"{name} ARES_PREFIX=0"
            with query_setting(X, env, understate):
                default = single[name][0] if name in single else \
                    ask(gpu, name, q)[0]
            with query_setting(X, {**env, "ARES_PREFIX": "0"}, understate):
                for c in counters.values():
                    c.launches = 0
                calls.clear()
                times = []
                for _ in range(PREFIX_RUNS):
                    t0 = time.perf_counter()
                    answer, _ = ask(svc, label, q)
                    if svc.device.type == "cuda":
                        torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                got = {k: c.launches for k, c in counters.items()}
                sorted_calls = list(calls)
                events = device_events(lambda: ask(svc, label, q), 1) \
                    if svc.device.type == "cuda" else []
            # each reduce within K2's cap launched it once, each past the
            # cap none; Q3's batches end past it (its cold run's first
            # rung, 4,096 slots, is within), the others' within
            eligible = sum(k <= P.K2_MAX_SLOTS for k, _ in sorted_calls)
            past = len(sorted_calls) - eligible
            wrong = [(k, d) for k, d in sorted_calls
                     if d != int(k <= P.K2_MAX_SLOTS)]
            if wrong or len(sorted_calls) < PREFIX_RUNS * n_batches:
                raise AssertionError(f"{label}: sorted reduces (k_groups, "
                                     f"K2 launches) {sorted_calls}")
            if (past >= PREFIX_RUNS * n_batches) != (name == "Q3") or \
                    (name != "Q3" and past):
                raise AssertionError(f"{label}: {past} of "
                                     f"{len(sorted_calls)} sorted reduces "
                                     "past K2's cap")
            unfused = PREFIX_RUNS * (n_batches - fused) \
                if name == "Q1 overflow" else 0
            want = {"K1": PREFIX_RUNS * fused if name == "Q1 overflow"
                    else 0, "K2": unfused + eligible, "K3": 0}
            if got != want:
                raise AssertionError(f"{label}: launches {got}, expected "
                                     f"{want}")
            if name in HLL_QUERIES:
                # phase_e2e held the default route's estimates to the
                # numpy oracle's exactly
                if answer != default:
                    raise AssertionError(f"{label}: estimates differ from "
                                         "the default route's")
            else:
                same_result(label, answer, default)
                if name == "Q1 overflow":
                    oracle_q1(answer, q)
                else:
                    oracle_min(name, answer, q)
            per_launch = kernel_events(events, "K2")
            if per_launch:
                in_situ["K2"][label] = sum(per_launch) / 1e3 / len(
                    per_launch)
            for k in totals:
                totals[k] += got[k]
            print(f"{label}: cold {1e3 * times[0]:.3f} ms, warm "
                  f"{1e3 * times[1]:.3f} ms, {len(flatten(answer))} groups,"
                  f" sorted reduces {len(sorted_calls)} (k_groups "
                  f"{sorted({k for k, _ in sorted_calls})}, {eligible} "
                  "through K2), launches "
                  + " ".join(f"{k}={v}" for k, v in got.items())
                  + (f", K2 {in_situ['K2'][label]:.4f} ms per launch in "
                     f"situ over {len(per_launch)}" if per_launch else "")
                  + "; equal to the default route's answer and the oracle",
                  flush=True)
    finally:
        K._reduce_by_key_sorted, K.hll_batch_body = real
    return totals, in_situ


def q1_oracle(data, demo):
    """oracle(answer, query) of Q1's form at any `now`: sum(fare) of the
    completed trips by hour x city (NULL where the city is) over the
    query's resolved window, from the ingested batches."""
    col = {k: np.concatenate([b[k] for b in data])
           for k in ("request_at", "city_id", "city_valid", "status",
                     "status_valid", "fare", "fare_valid")}
    t = col["request_at"].astype(np.int64)
    city = np.where(col["city_valid"], col["city_id"], 0).astype(np.int64)
    fare = np.where(col["fare_valid"], col["fare"], 0).astype(np.float64)
    completed = col["status_valid"] & (col["status"] == 0)

    def check(answer, q):
        plan = demo.demo_plan(q)
        sel = completed & (t >= plan.from_ts) & (t < plan.to_ts)
        keys, inv = np.unique(((t // 3600) * 65536 + city)[sel],
                              return_inverse=True)
        sums = np.bincount(inv, weights=fare[sel], minlength=len(keys))
        want = {(time.strftime("%Y-%m-%d %H:00",
                               time.gmtime(k // 65536 * 3600)),
                 "NULL" if k % 65536 == 0 else str(k % 65536)): v
                for k, v in zip(keys.tolist(), sums.tolist())}
        got = flatten(answer)
        if set(got) != set(want):
            raise AssertionError(f"Q1 at {q['now']}: {len(got)} groups, "
                                 f"the oracle {len(want)}")
        for k, v in want.items():
            if abs((got[k] or 0.0) - v) > max(ATOL, abs(v) * RTOL):
                raise AssertionError(f"Q1 at {q['now']}: {k} {got[k]} "
                                     f"against {v}")
    return check


def phase_mesh(label: str, store, queries: dict, single: dict, device,
               n_rows: int) -> tuple:
    """Mesh batches (ARES_MESH=1) over MESH_WIDTH entries of the one
    device, on a store a phase has ingested: each query of `queries`
    ({name: (query, environment)}) once on a CPU service with a mesh of
    as many `cpu` entries, with K2's calls counted (the rehearsal), then
    MESH_RUNS times on the card as run_query runs it, its K2 launches
    MESH_RUNS times the rehearsal's and K1 and K3 none (the mesh's gate
    comes before the dense path). Each answer must equal the phase's
    single-device answer in `single` ({name: (answer, warm ms)}): keys,
    counts and HLL estimates exactly, sums within RTOL/ATOL; the mesh
    counters must show every batch on the mesh (HLL ladder reruns too)
    and none ineligible or fallen back. Returns each kernel's launches
    and {kernel: {query + " mesh": device ms per launch}}."""
    from aresdb_tpu_torch.query import executor as X
    from aresdb_tpu_torch.query.service import QueryService
    from aresdb_tpu_torch.utils.torch_env import resolve_device

    dev = resolve_device(device)
    gpu = QueryService(store, device=dev, mesh_devices=[dev] * MESH_WIDTH)
    cpu = QueryService(store, device="cpu",
                       mesh_devices=["cpu"] * MESH_WIDTH)
    counters = kernel_counters()
    totals = dict.fromkeys(counters, 0)
    in_situ = {k: {} for k in counters}
    print(f"{label} mesh: ARES_MESH=1 over {MESH_WIDTH} entries of {dev}; "
          "one card runs the entries' bodies in turn, so a mesh time here "
          "is the cost of the per-device loop, not a multi-card speedup",
          flush=True)
    for name, (q, env) in queries.items():
        env = dict(env, ARES_MESH="1")
        t0 = time.perf_counter()
        with query_setting(X, env, False), counting_k2() as rehearsal:
            ask(cpu, name, q)
        rehearsal_s = time.perf_counter() - t0
        want_answer, single_ms = single[name]
        rec = run_query(gpu, cpu, name + " mesh", q, env, False, MESH_RUNS,
                        counters, {"K1": 0, "K2": MESH_RUNS * rehearsal.calls,
                                   "K3": 0}, cpu_answer=want_answer)
        measure = q["measures"][0]["sqlExpression"]
        hll = measure.startswith("countdistincthll(")
        if hll or measure.startswith("count("):
            if rec["answer"] != want_answer:
                raise AssertionError(f"{name} mesh: the answer differs from "
                                     "the single-device one")
        else:
            same_result(name + " mesh", rec["answer"], want_answer)
        batches = sum(c["batches"] + (c["ladderReruns"] if hll else 0)
                      for c in rec["contexts"])
        want_counts = {"mesh_batches": batches, "mesh_ineligible_batches": 0,
                       "mesh_fallback_batches": 0}
        if rec["mesh"] != want_counts:
            raise AssertionError(f"{name} mesh: counters {rec['mesh']}, "
                                 f"expected {want_counts}")
        for k in totals:
            totals[k] += rec["launches"][k]
        for k, ms in rec["in_situ"].items():
            in_situ[k][name + " mesh"] = ms
        print(f"{name} mesh: warm {warm_ms(rec):.3f} ms over {MESH_WIDTH} "
              f"entries of one card, against {single_ms:.3f} ms on the one "
              "device (the per-device loop's cost, not a speedup); "
              f"{batches} mesh batches in {MESH_RUNS} runs; K2 "
              f"{rec['launches']['K2']} launches = {MESH_RUNS} x the CPU "
              f"rehearsal's {rehearsal.calls} ({rehearsal_s:.1f} s on the "
              "cpu); equal to the single-device answer", flush=True)
        report(name + " mesh", rec, n_rows)
    return totals, in_situ


def phase_pool(store, queries: dict, single: dict, device, n_batches: int,
               fused: int) -> dict:
    """A QueryService with a DevicePool of two entries of the one device
    over a store phase_e2e has ingested: POOL_THREADS client threads,
    each POOL_REQUESTS requests drawn in turn from POOL_QUERIES
    (`queries` holds them as e2e_queries does), all started together.
    Every answer must equal the single-device one in `single`, both
    entries must have served, none may be running or waiting at the end,
    and the launches must be expected_launches' for the requests made (K1
    on `fused` of the `n_batches` batches). Returns the launches."""
    from aresdb_tpu_torch.query.admission import DevicePool
    from aresdb_tpu_torch.query.service import QueryService
    from aresdb_tpu_torch.utils.torch_env import resolve_device

    dev = resolve_device(device)
    pool = DevicePool([dev, dev])
    svc = QueryService(store, device=dev, device_pool=pool)
    counters = kernel_counters()
    done, errors = [], []
    barrier = threading.Barrier(POOL_THREADS)

    def client(i):
        try:
            barrier.wait(timeout=60)
            for j in range(POOL_REQUESTS):
                name = POOL_QUERIES[(i + j) % len(POOL_QUERIES)]
                t0 = time.perf_counter()
                answer, ctx = ask(svc, name, queries[name][0])
                done.append((name, answer, ctx["device"],
                             time.perf_counter() - t0))
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)

    for c in counters.values():
        c.launches = 0
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(POOL_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.synchronize()
    got = {k: c.launches for k, c in counters.items()}
    if errors:
        raise errors[0]
    made = {n: sum(d[0] == n for d in done) for n in POOL_QUERIES}
    want = dict.fromkeys(counters, 0)
    for name, n in made.items():
        for k, v in expected_launches(name, n, n_batches, fused).items():
            want[k] += v
    if got != want:
        raise AssertionError(f"pool: launches {got}, expected {want}")
    for name, answer, _, _ in done:
        if name in HLL_QUERIES:
            if answer != single[name][0]:
                raise AssertionError(f"pool {name}: the answer differs from "
                                     "the single-device one")
        else:
            same_result("pool " + name, answer, single[name][0])
    st = pool.stats()
    served = [d["served"] for d in st["devices"]]
    idle = all(d["running"] == 0 and d["inUseBytes"] == 0
               for d in st["devices"]) and st["waiting"] == 0
    if len(done) != POOL_THREADS * POOL_REQUESTS or min(served) == 0 or \
            sum(served) != len(done) or not idle:
        raise AssertionError(f"pool: {len(done)} answers, stats {st}")
    by_entry = [sum(d[2] == i for d in done) for i in range(2)]
    secs = sorted(d[3] for d in done)
    print(f"pool: DevicePool([{dev}, {dev}]), {POOL_THREADS} threads x "
          f"{POOL_REQUESTS} requests of {', '.join(POOL_QUERIES)}: served "
          f"{served} (contexts' devices {by_entry}), "
          f"{len(done) / wall:.3f} queries/s, p50 "
          f"{1e3 * secs[len(secs) // 2]:.3f} ms, p99 "
          f"{1e3 * secs[int(0.99 * (len(secs) - 1))]:.3f} ms, launches "
          + " ".join(f"{k}={v}" for k, v in got.items())
          + "; every answer equals the single-device one; none running "
          "or waiting after. One card: what a second card does (peer "
          "copies, a lease on cuda:1 passing index 1 to the kernels, a "
          "budget from that card's memory) is not verified", flush=True)
    return got


def phase_e2e(n_rows: int, seed: int, warm: int = 5, device=None,
              batch_rows: int = BATCH_ROWS, names=None, mesh=(),
              pool: bool = False) -> tuple:
    """Ingest, then every query of e2e_queries (or those in `names`)
    through QueryService on the card (one cold and `warm` warm runs, each
    kernel's launch count set to 0 just before and read just after)
    against the CPU service; then, over the same store, the queries in
    `mesh` as mesh batches (phase_mesh) and, where `pool`, concurrent
    requests through a device pool (phase_pool), each against those
    answers. Returns each kernel's launches over those runs, and
    {kernel: {query: device ms per launch}} from one more warm run under
    the profiler."""
    from aresdb_tpu_torch import demo
    from aresdb_tpu_torch.query import executor as X
    from aresdb_tpu_torch.query import fused_dense as FD
    from aresdb_tpu_torch.query.kernels import plan_signature, round_up_pow2
    from aresdb_tpu_torch.query.service import QueryService

    store, ingest_s, data = ingest_trips(n_rows, seed, batch_rows)
    batch_sizes = [len(b["fare"]) for b in data]
    n_batches = len(batch_sizes)
    # K1 takes Q1's batches of at least FD_MIN_ROWS padded rows, K2 the rest
    q1_k1 = sum(round_up_pow2(r) >= FD.FD_MIN_ROWS for r in batch_sizes)
    print(f"ingest: {n_rows} rows in {n_batches} batches, "
          f"{ingest_s:.3f} s, {n_rows / ingest_s:.0f} rows/s", flush=True)

    gpu = QueryService(store, device=device)
    cpu = QueryService(store, device="cpu")
    counters = kernel_counters()
    totals = dict.fromkeys(counters, 0)
    in_situ = {k: {} for k in counters}
    cpu_answers = {}
    single = {}
    runs = 1 + warm
    queries = e2e_queries(demo, seed)
    for name, (q, env, understate) in queries.items():
        if names is not None and name not in names:
            continue
        rec = run_query(gpu, cpu, name, q, env, understate, runs, counters,
                        expected_launches(name, runs, n_batches, q1_k1))
        for k in totals:
            totals[k] += rec["launches"][k]
        for k, ms in rec["in_situ"].items():
            in_situ[k][name] = ms
        contexts = rec["contexts"]
        reruns = [(c["ladderReruns"], c["overflowReruns"])
                  for c in contexts]
        want_reruns = [(0, 0)] * runs
        if name in ("Q3", "Q4", "H1"):
            want_reruns[0] = (n_batches, 0)
        if name == "Q3":
            hint = gpu.executor._k_hints.get(
                plan_signature(demo.demo_plan(q)))
            if hint != Q3_CAPACITY:
                raise AssertionError(f"Q3: capacity hint {hint}")
        elif name == "H1":
            hint = gpu.executor._k_hints.get(
                "hll:" + plan_signature(demo.demo_plan(q)))
            if hint != H1_CAPACITY:
                raise AssertionError(f"H1: capacity hint {hint}")
        elif name == "Q1 overflow":
            want_reruns = [(0, n_batches)] * runs
            want_reruns[0] = (n_batches, n_batches)
        if reruns != want_reruns:
            raise AssertionError(f"{name}: (ladder, overflow) reruns "
                                 f"{reruns}, expected {want_reruns}")
        answer, cpu_answer = rec["answer"], rec["cpu_answer"]
        check_answer(name, answer, cpu_answer, contexts, data, gpu, cpu, q)
        if name == "Q1 overflow":
            same_result(name + " against the dense path", answer,
                        cpu_answers["Q1"])
        cpu_answers[name] = cpu_answer
        single[name] = (answer, warm_ms(rec))
        report(name, rec, n_rows, listing_rows=name in LISTINGS)
    if "Q1" in single:
        phase_window("Q1", gpu, cpu, queries["Q1"][0], single["Q1"][1],
                     q1_oracle(data, demo))
        launches = phase_unfused(store, queries["Q1"][0], cpu_answers["Q1"],
                                 device, n_batches)
        for k in totals:
            totals[k] += launches[k]
    prefix = [n for n in PREFIX_QUERIES if n in single or n == "M1"]
    if "Q1 overflow" in single:
        t0 = time.perf_counter()
        launches, prefix_in_situ = phase_prefix(
            store, gpu, single, data, demo, device, n_batches, q1_k1,
            prefix)
        print(f"phase_prefix took {time.perf_counter() - t0:.3f} s",
              flush=True)
        for k in totals:
            totals[k] += launches[k]
            in_situ[k].update(prefix_in_situ[k])
    if mesh:
        launches, mesh_in_situ = phase_mesh(
            "trips", store, {n: queries[n][:2] for n in mesh}, single,
            device, n_rows)
        for k in totals:
            totals[k] += launches[k]
            in_situ[k].update(mesh_in_situ[k])
    if pool:
        launches = phase_pool(store, queries, single, device, n_batches,
                              q1_k1)
        for k in totals:
            totals[k] += launches[k]
    print(f"device column cache: {X.GLOBAL_DEVICE_CACHE.stats()}",
          flush=True)
    return totals, in_situ


def phase_unfused(store, q, cpu_answer, device, n_batches: int) -> dict:
    """Q1 once under ARES_FUSED=0, through a new QueryService with a
    kernel cache of its own (the cache's key, as the JAX package's, holds
    no environment): K1 off, every batch through the unfused dense kernel
    and K2, the answer equal to the CPU run's. Returns the launches (set
    to 0 just before, read just after)."""
    from aresdb_tpu_torch.query import executor as X
    from aresdb_tpu_torch.query.kernels import KernelCache
    from aresdb_tpu_torch.query.service import QueryService

    counters = kernel_counters()
    svc = QueryService(store, device=device)
    svc.executor.kernel_cache = KernelCache()
    with query_setting(X, {"ARES_FUSED": "0"}, False):
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        answer, _ = ask(svc, "Q1 ARES_FUSED=0", q)
        if svc.device.type == "cuda":
            torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        got = {k: c.launches for k, c in counters.items()}
    want = {"K1": 0, "K2": n_batches, "K3": 0}
    if got != want:
        raise AssertionError(f"Q1 ARES_FUSED=0: launches {got}, expected "
                             f"{want}")
    same_result("Q1 ARES_FUSED=0", answer, cpu_answer)
    print(f"Q1 ARES_FUSED=0: {ms:.3f} ms, launches "
          + " ".join(f"{k}={v}" for k, v in got.items())
          + ", equal to the cpu run's Q1", flush=True)
    return got


def zones128_wkt() -> list:
    """(id, WKT) of zones128's 128 regular 16-gons of radius 2.0: ids
    1-128 in row order, centred at lat 3.125 + 6.25 i (i < 8) and lng
    1.5625 + 3.125 j (j < 16), so that lng neighbours overlap."""
    ang = 2 * np.pi * np.arange(16) / 16
    out = []
    for i in range(8):
        for j in range(16):
            lat, lng = 3.125 + 6.25 * i, 1.5625 + 3.125 * j
            pts = [(float(lng + 2.0 * np.cos(a)), float(lat + 2.0 * np.sin(a)))
                   for a in ang]
            pts.append(pts[0])
            out.append((1 + 16 * i + j, "POLYGON((" + ", ".join(
                f"{x!r} {y!r}" for x, y in pts) + "))"))
    return out


def zones_shard(schema_json, zones):
    """A geo table's (schema, TableShard) holding zones [(id, WKT)]."""
    from aresdb_tpu_torch.common import data_types as mdt
    from aresdb_tpu_torch.common.schema import Table, TableSchema
    from aresdb_tpu_torch.common.upsert_batch import (UpsertBatch,
                                                      UpsertBatchBuilder)
    from aresdb_tpu_torch.memstore.table_shard import TableShard

    ts = TableSchema(Table.from_json(schema_json))
    b = UpsertBatchBuilder()
    b.add_column(0, mdt.Uint16)
    b.add_column(1, mdt.GeoShape)
    for r, (key, wkt) in enumerate(zones):
        b.add_row()
        b.set_value(r, 0, key)
        b.set_value(r, 1, mdt.parse_geoshape(wkt))
    shard = TableShard(ts)
    shard.save_upsert_batch(UpsertBatch(b.to_bytes()))
    return ts, shard


def ingest_atrips(n_rows: int, seed: int, batch_rows: int, root: str
                  ) -> tuple:
    """The atrips fact table: n_rows trips from the seed, timed uniformly
    over [ATRIPS_BASE, ATRIPS_BASE + 3 days) and ingested in time order
    through the upsert wire format in batch-sized upserts, then archived
    to ATRIPS_CUTOFF by the port's Archiver through a DiskMetaStore and a
    LocalDiskStore under root; beside it the zones and zones128 geo
    tables. Returns (store, shard, the rows as numpy arrays by column,
    ingest seconds, archiving seconds)."""
    from aresdb_tpu_torch.common import data_types as mdt
    from aresdb_tpu_torch.common.schema import Table, TableSchema
    from aresdb_tpu_torch.common.upsert_batch import (UpsertBatch,
                                                      build_columnar_upsert)
    from aresdb_tpu_torch.diskstore.local_diskstore import LocalDiskStore
    from aresdb_tpu_torch.memstore.archiving import Archiver
    from aresdb_tpu_torch.memstore.table_shard import TableShard
    from aresdb_tpu_torch.metastore.disk_metastore import DiskMetaStore

    ts = TableSchema(Table.from_json(dict(
        ATRIPS_SCHEMA_JSON, config={"batchSize": batch_rows,
                                    "recordRetentionInDays": 0})))
    ts.extend_enum("status", STATUSES)
    meta, disk = DiskMetaStore(root), LocalDiskStore(root)
    shard = TableShard(ts, diskstore=disk, metastore=meta)
    rng = np.random.RandomState(seed + 2)
    data = {"request_at": np.sort(ATRIPS_BASE + rng.randint(
                0, 3 * DAY, n_rows)).astype(np.uint32),
            "city_id": rng.randint(0, N_CITIES, n_rows).astype(np.uint16),
            "status": rng.randint(0, 3, n_rows).astype(np.uint8),
            "fare": (rng.rand(n_rows) * 50).astype(np.float32)}
    # drawn after the other columns, which keep their values
    data["pickup"] = np.stack([(rng.rand(n_rows) * 50).astype(np.float32),
                               (rng.rand(n_rows) * 50).astype(np.float32)],
                              axis=1)
    t0 = time.perf_counter()
    for lo in range(0, n_rows, batch_rows):
        s = slice(lo, lo + batch_rows)
        n = len(data["fare"][s])
        cols = [(0, mdt.Uint32, data["request_at"][s], None, 0),
                (1, mdt.Uint32, np.arange(lo, lo + n, dtype=np.uint32),
                 None, 0),
                (2, mdt.Uint16, data["city_id"][s], None, 0),
                (3, mdt.SmallEnum, data["status"][s], None, 0),
                (4, mdt.Float32, data["fare"][s], None, 0),
                (5, mdt.GeoPoint, data["pickup"][s], None, 0)]
        shard.save_upsert_batch(UpsertBatch(build_columnar_upsert(cols, n)))
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    Archiver(shard, meta, disk).archive(ATRIPS_CUTOFF)
    archive_s = time.perf_counter() - t0
    schemas, shards = {"atrips": ts}, {("atrips", 0): shard}
    for js, zones in ((ZONES_SCHEMA_JSON, BATTERY_ZONES),
                      (ZONES128_SCHEMA_JSON, zones128_wkt())):
        schemas[js["name"]], shards[(js["name"], 0)] = zones_shard(js, zones)
    return Store(schemas, shards), shard, data, ingest_s, archive_s


def atrips_queries() -> dict:
    """name -> (AQL query, or SQL statement, and its environment)."""
    def aql(measure, dims=(), **extra):
        return {"table": "atrips", "now": ATRIPS_NOW,
                "measures": [{"sqlExpression": measure}],
                "dimensions": [{"sqlExpression": e, "timeBucketizer": b}
                               if b else {"sqlExpression": e}
                               for e, b in dims], **extra}

    by_city = aql("sum(fare)", [("city_id", None)])
    city_status = aql("count(*)", [("city_id", None), ("status", None)])
    runlen = {"ARES_RUNLEN": "1"}
    composite = aql("count(*)", [("city_id", None)])
    composite["measures"] = [
        {"sqlExpression": "count(*)", "alias": "Requested"},
        {"sqlExpression": "count(*)", "alias": "Completed",
         "rowFilters": ["status='completed'"]},
        {"sqlExpression": "Completed/Requested", "alias": "rate"}]
    return {
        "A1": (by_city, {}),
        "A2": (by_city, runlen),
        "A3": (city_status, {}),
        "A4": (city_status, runlen),
        "A5": (aql("sum(fare)", rowFilters=["city_id = 7"]), {}),
        "A6": (aql("sum(fare)", [("request_at", "hour"), ("city_id", None)],
                   timeFilter={"column": "request_at",
                               "from": "36 hours ago", "to": "now"}), {}),
        "S1": ("SELECT count(*) FROM atrips WHERE fare > 25 AND "
               f"aql_now(request_at, {ATRIPS_NOW})", {}),
        "S2": ("SELECT sum(fare) FROM atrips WHERE "
               f"aql_now(request_at, {ATRIPS_NOW})", {}),
        "C1": (composite, {}),
    }


def geo_queries() -> dict:
    """name -> (AQL query over atrips joined to a geo table, environment)."""
    def geo(table, measure, filters, dims=()):
        return {"table": "atrips", "now": ATRIPS_NOW,
                "joins": [{"table": table, "alias": "z", "conditions": [
                    "geography_intersects(z.shape, pickup)"]}],
                "measures": [{"sqlExpression": measure}],
                "dimensions": [{"sqlExpression": d} for d in dims],
                "rowFilters": list(filters)}

    ids = [str(k) for k, _ in zones128_wkt()]
    g2 = geo("zones128", "sum(fare)", [f"z.id IN ({', '.join(ids)})"],
             ["z.id"])
    return {
        "G1": (geo("zones", "count(*)", ["z.id IN (1, 2)"], ["z.id"]), {}),
        "G2": (g2, {}),
        "G3": (geo("zones128", "count(*)",
                   [f"z.id NOT IN ({', '.join(ids[:64])})"]), {}),
        "G2 dense": (g2, {"ARES_GEO2": "0"}),
    }


def geo_oracle(shapes, lat: np.ndarray, lng: np.ndarray) -> np.ndarray:
    """Each point's first matching shape (index into shapes, -1 for none):
    for each shape, the points inside its bbox widened by 1e-3 (sorted by
    lng once) put to the reference's crossing test in numpy float32, every
    operation rounded on its own, the lowest index winning. A point
    outside the widened box crosses the shape's closed rings an even
    number of times."""
    order = np.argsort(lng, kind="stable")
    slng = lng[order]
    out = np.full(len(lat), -1, np.int32)
    for s in range(len(shapes) - 1, -1, -1):
        edges = [(a, b) for ring in shapes[s] for a, b in zip(ring, ring[1:])]
        a1 = np.array([a[0] for a, _ in edges], np.float32)
        a2 = np.array([b[0] for _, b in edges], np.float32)
        g1 = np.array([a[1] for a, _ in edges], np.float32)
        g2 = np.array([b[1] for _, b in edges], np.float32)
        denom = g2 - g1
        slope = np.where(denom == 0, np.float32(0),
                         (a2 - a1) / np.where(denom == 0, 1, denom)
                         ).astype(np.float32)
        lo = np.searchsorted(slng, min(g1.min(), g2.min()) - 1e-3)
        hi = np.searchsorted(slng, max(g1.max(), g2.max()) + 1e-3, "right")
        idx = order[lo:hi]
        idx = idx[(lat[idx] > min(a1.min(), a2.min()) - 1e-3)
                  & (lat[idx] < max(a1.max(), a2.max()) + 1e-3)]
        p, q = lng[idx, None], lat[idx, None]
        cond1 = (g1 > p) != (g2 > p)
        line = (slope * (p - g1)).astype(np.float32)
        line = (line + a1).astype(np.float32)
        odd = (cond1 & (q < line)).sum(1) % 2 == 1
        out[idx[odd]] = s
    return out


def geo_matches(data: dict) -> dict:
    """The geo oracle's matched shapes of every atrips point, by table
    (zones, zones128, and zones128's first 64 shapes, G3's), computed once
    and kept in data."""
    from aresdb_tpu_torch.common import data_types as mdt

    if "geo" not in data:
        lat, lng = data["pickup"][:, 0], data["pickup"][:, 1]
        zones128 = [mdt.parse_geoshape(w) for _, w in zones128_wkt()]
        data["geo"] = {
            "zones": geo_oracle([mdt.parse_geoshape(w)
                                 for _, w in BATTERY_ZONES], lat, lng),
            "zones128": geo_oracle(zones128, lat, lng),
            "zones128[:64]": geo_oracle(zones128[:64], lat, lng)}
    return data["geo"]


def check_geo(name: str, answer: dict, data: dict) -> None:
    """A geo answer against the oracle: counts exactly, sums within rel
    1e-5; every point is valid, and a shape's index is its id - 1."""
    m = geo_matches(data)
    if name == "G1":
        ids, counts = np.unique(m["zones"][m["zones"] >= 0] + 1,
                                return_counts=True)
        want = {str(i): float(c) for i, c in zip(ids, counts)}
        if answer != want:
            raise AssertionError(f"G1: {answer} against the oracle's {want}")
    elif name in ("G2", "G2 dense"):
        hit = m["zones128"] >= 0
        sums = np.bincount(m["zones128"][hit],
                           weights=data["fare"][hit].astype(np.float64),
                           minlength=128)
        want = {str(i + 1): sums[i] for i in np.unique(m["zones128"][hit])}
        if set(answer) != set(want):
            raise AssertionError(f"{name}: {len(answer)} zones, the oracle "
                                 f"{len(want)}")
        for k, v in want.items():
            if abs(answer[k] - v) > max(1e-3, abs(v) * 1e-5):
                raise AssertionError(f"{name}: zone {k} {answer[k]} "
                                     f"against {v}")
    elif name == "G3":
        want = float((m["zones128[:64]"] < 0).sum())
        if answer != {"": want}:
            raise AssertionError(f"G3: {answer} against {want}")


def atrips_layout(shard, chunk_rows: int) -> dict:
    """The padded row counts of the batches each atrips query scans: the
    live batches, and the archive chunks of every day and of the last
    archived day (A6's 36 hours start inside it)."""
    from aresdb_tpu_torch.query.kernels import round_up_pow2

    live = [round_up_pow2(n)
            for _, n, _ in shard.live_store.snapshot_columns([0])]
    days = shard.archive_store.get_current_version().batches
    chunks = {day: [round_up_pow2(min(chunk_rows, b.size - lo))
                    for lo in range(0, b.size, chunk_rows)]
              for day, b in sorted(days.items())}
    return {"live": live, "chunks": [n for c in chunks.values() for n in c],
            "last_day": chunks[max(chunks)] if chunks else []}


def atrips_launches(name: str, runs: int, layout: dict) -> dict:
    """Each kernel's launches over `runs` runs of an atrips query: a
    dense batch of at least FD_MIN_ROWS padded rows takes K1, a smaller
    one the unfused kernel and K2; a run-length chunk reduces through K2
    (the runtime-dense branch); a plan with no dimensions reduces its one
    slot with masked sums, through no kernel of the TPU's."""
    from aresdb_tpu_torch.query import fused_dense as FD

    def dense(batches, times=1):
        k1 = sum(n >= FD.FD_MIN_ROWS for n in batches)
        return {"K1": runs * times * k1,
                "K2": runs * times * (len(batches) - k1), "K3": 0}

    every = layout["live"] + layout["chunks"]
    if name in ("G1", "G2", "G2 dense"):
        # a geo dimension has no bounded domain: the keyed path, whose
        # runtime-dense branch reduces every batch and chunk through K2
        return {"K1": 0, "K2": runs * len(every), "K3": 0}
    if name in ("A1", "A3"):
        return dense(every)
    if name in ("A2", "A4"):
        out = dense(layout["live"])
        out["K2"] += runs * len(layout["chunks"])
        return out
    if name == "A6":
        return dense(layout["live"] + layout["last_day"])
    if name == "C1":   # one engine run for each of its two counts
        return dense(every, times=2)
    return {"K1": 0, "K2": 0, "K3": 0}   # A5, S1, S2, G3


def check_atrips(name: str, answer: dict, contexts, data: dict,
                 answers: dict, n_chunks: int, now: int = ATRIPS_NOW
                 ) -> None:
    """An atrips answer against the numpy oracle over the ingested rows
    (sums within rel 1e-5, counts exactly), the run-length answers
    against their expanded twins, and the stats that show the path
    ran: runlenBatches on every run of A2 and A4, prefilterRowsSkipped
    on A5. `now`: the query's (A6's window ends there)."""
    city, status = data["city_id"], data["status"]
    fare = data["fare"].astype(np.float64)

    def close(got, want, what):
        if abs(got - want) > max(1e-3, abs(want) * 1e-5):
            raise AssertionError(f"{name}: {what} {got} against {want}")

    def sums_by_city(sel):
        return np.bincount(city[sel], weights=fare[sel], minlength=N_CITIES)

    if name in ("A2", "A4"):
        got = [c.get("runlenBatches") for c in contexts]
        if got != [n_chunks] * len(contexts):
            raise AssertionError(f"{name}: runlenBatches {got}, expected "
                                 f"{n_chunks} a run")
        twin = answers["A1" if name == "A2" else "A3"]
        if name == "A4" and answer != twin:
            raise AssertionError("A4: counts differ from A3's")
        g, w = flatten(answer), flatten(twin)
        if set(g) != set(w):
            raise AssertionError(f"{name}: groups differ from the expanded")
        for k in w:
            if abs(g[k] - w[k]) > abs(w[k]) * 1e-5:
                raise AssertionError(f"{name}: {k} {g[k]} against {w[k]}")
    if name in ("A1", "A2"):
        want = sums_by_city(np.ones(len(city), bool))
        if set(answer) != {str(c) for c in range(N_CITIES)}:
            raise AssertionError(f"{name}: cities {len(answer)}")
        for c in range(N_CITIES):
            close(answer[str(c)], want[c], f"city {c}")
    elif name in ("A3", "A4"):
        want = np.bincount(city.astype(np.int64) * 3 + status,
                           minlength=3 * N_CITIES)
        got = {(int(c), STATUSES.index(s)): v
               for c, by in answer.items() for s, v in by.items()}
        if got != {divmod(i, 3): float(v) for i, v in enumerate(want) if v}:
            raise AssertionError(f"{name}: counts differ from the oracle's")
    elif name == "A5":
        close(answer[""], fare[city == 7].sum(), "sum")
        skipped = [c.get("prefilterRowsSkipped", 0) for c in contexts]
        if min(skipped) <= 0:
            raise AssertionError(f"A5: prefilterRowsSkipped {skipped}")
    elif name == "A6":
        # "36 hours ago" resolves to the start of its hour, "now" to now
        since = (now - 36 * 3600) // 3600 * 3600
        sel = (data["request_at"] >= since) & (data["request_at"] < now)
        hour = (data["request_at"][sel] // 3600).astype(np.int64)
        n_groups = len(np.unique(hour * N_CITIES + city[sel]))
        got = flatten(answer)
        if len(got) != n_groups:
            raise AssertionError(f"A6: {len(got)} groups, the oracle "
                                 f"{n_groups}")
        by_city = np.zeros(N_CITIES)
        for (_, c), v in got.items():
            by_city[int(c)] += v
        want = sums_by_city(sel)
        for c in range(N_CITIES):
            close(by_city[c], want[c], f"city {c}")
    elif name == "S1":
        if answer != {"": float((data["fare"] > 25).sum())}:
            raise AssertionError(f"S1: {answer}")
    elif name == "S2":
        close(answer[""], fare.sum(), "sum")
    elif name == "C1":
        total = np.bincount(city, minlength=N_CITIES)
        done = np.bincount(city[status == 0], minlength=N_CITIES)
        for c in range(N_CITIES):
            got = answer[str(c)]
            if (got["Requested"], got["Completed"]) != (total[c], done[c]):
                raise AssertionError(f"C1: city {c} {got}")
            close(got["rate"], done[c] / total[c], f"city {c} rate")


def phase_atrips(n_rows: int, seed: int, warm: int = 5, device=None,
                 batch_rows: int = BATCH_ROWS, names=None,
                 mesh=()) -> tuple:
    """The archive half: ingest and archive atrips (ingest_atrips), answer
    every query of atrips_queries and geo_queries (or those in `names`)
    on the CPU service, but G2 dense (the card's only: its CPU answer is
    G2's), build the K1 cubins those answers planned (all NVRTC's at
    once), then run each on the card as phase_e2e does, with its
    launches asserted, against the CPU answer and the numpy oracle; the
    queries in `mesh` as mesh batches (phase_mesh); on the card, then the
    geo sweep (phase_geo_sweep). Returns each kernel's launches and
    {kernel: {query: device ms per launch}}."""
    from aresdb_tpu_torch.query import executor as X
    from aresdb_tpu_torch.query import fused_dense as FD
    from aresdb_tpu_torch.query.service import QueryService
    from aresdb_tpu_torch.utils import cuda_build

    with tempfile.TemporaryDirectory() as root:
        store, shard, data, ingest_s, archive_s = ingest_atrips(
            n_rows, seed, batch_rows, root)
        layout = atrips_layout(shard, X.ShardExecutor.ARCHIVE_CHUNK_ROWS)
        version = shard.archive_store.get_current_version()
        print(f"atrips: {n_rows} rows ingested in {ingest_s:.3f} s, "
              f"archived to {ATRIPS_CUTOFF} in {archive_s:.3f} s: days "
              f"{ {d: b.size for d, b in sorted(version.batches.items())} }"
              f", live batches {len(layout['live'])}, archive chunks "
              f"{len(layout['chunks'])} of padded rows {layout['chunks']}",
              flush=True)
        gpu = QueryService(store, device=device)
        cpu = QueryService(store, device="cpu")
        queries = {k: v for k, v in {**atrips_queries(),
                                     **geo_queries()}.items()
                   if names is None or k in names}
        cpu_answers = {}
        for name, (q, env) in queries.items():
            if name == "G2 dense":
                continue
            with query_setting(X, env, False):
                cpu_answers[name] = ask(cpu, name, q)[0]
        if gpu.device.type == "cuda":
            sources = {FD.build_item(fn.spec.source)
                       for fn in cpu.executor.kernel_cache._cache.values()
                       if isinstance(fn, FD.FusedDenseKernel)}
            build_s = cuda_build.build_all(sorted(sources))
            print(f"atrips: built {len(sources)} K1 cubins in "
                  f"{build_s:.1f} s", flush=True)
        counters = kernel_counters()
        totals = dict.fromkeys(counters, 0)
        in_situ = {k: {} for k in counters}
        runs = 1 + warm
        answers, single = {}, {}
        for name, (q, env) in queries.items():
            # G2 dense on the card only, against G2's answer there; its
            # 2.2 s runs take one warm run
            want = answers["G2"] if name == "G2 dense" else cpu_answers[name]
            n = min(runs, 2) if name == "G2 dense" else runs
            rec = run_query(gpu, cpu, name, q, env, False, n, counters,
                            atrips_launches(name, n, layout),
                            cpu_answer=want)
            for k in totals:
                totals[k] += rec["launches"][k]
            for k, ms in rec["in_situ"].items():
                in_situ[k][name] = ms
            same_result(name, rec["answer"], rec["cpu_answer"])
            answers[name] = rec["answer"]
            single[name] = (rec["answer"], warm_ms(rec))
            if name in GEO_QUERIES:
                check_geo(name, rec["answer"], data)
            else:
                check_atrips(name, rec["answer"], rec["contexts"], data,
                             answers, len(layout["chunks"]))
            report(name, rec, n_rows)
        if "A6" in single:
            phase_window("A6", gpu, cpu, queries["A6"][0], single["A6"][1],
                         lambda answer, q: check_atrips(
                             "A6", answer, [], data, answers,
                             len(layout["chunks"]), now=q["now"]))
        if mesh:
            launches, mesh_in_situ = phase_mesh(
                "atrips", store, {n: queries[n] for n in mesh}, single,
                device, n_rows)
            for k in totals:
                totals[k] += launches[k]
                in_situ[k].update(mesh_in_situ[k])
        if gpu.device.type == "cuda":
            phase_geo_sweep(data["pickup"], gpu.device, geo_matches(data))
    return totals, in_situ


def phase_geo_sweep(pickup: np.ndarray, device, oracle: dict,
                    batch_rows: int = BATCH_ROWS) -> dict:
    """geo.matched_shape (the dense sweep) and geo.matched_shape_pruned
    (the bbox walk) on `device` over every point, batch by batch, for the
    zones and zones128 tables: equal to each other and to the oracle's
    matched shapes (geo_matches) point by point. On the card, each
    route's device ms and wall ms per batch of batch_rows points. Returns
    {table: {route: (device ms, wall ms)}}."""
    from aresdb_tpu_torch.common import data_types as mdt
    from aresdb_tpu_torch.query import geo as G

    out = {}
    n = len(pickup)
    for table, zones in (("zones", BATTERY_ZONES),
                         ("zones128", zones128_wkt())):
        batch = G.build_shape_batch([mdt.parse_geoshape(w) for _, w in zones],
                                    [k for k, _ in zones])
        if not batch.prune_ok:
            raise AssertionError(f"{table}: not eligible for the bbox walk")
        dense = G.stage_shapes(batch, device, pruned=False)
        pruned = G.stage_shapes(batch, device, pruned=True)
        for lo in range(0, n, batch_rows):
            pts = torch.from_numpy(pickup[lo:lo + batch_rows]).to(device)
            args = (pts[:, 0], pts[:, 1],
                    torch.ones(len(pts), dtype=torch.bool, device=device))
            swept = G.matched_shape(*args, dense)
            walked, overflow = G.matched_shape_pruned(*args, pruned)
            if overflow or not torch.equal(swept, walked) or \
                    not np.array_equal(swept.cpu().numpy(),
                                       oracle[table][lo:lo + batch_rows]):
                raise AssertionError(f"{table}: the routes or the oracle "
                                     f"differ in rows {lo}..")
        if device.type != "cuda":
            continue
        pts = torch.from_numpy(pickup[:batch_rows]).to(device)
        args = (pts[:, 0], pts[:, 1],
                torch.ones(len(pts), dtype=torch.bool, device=device))
        out[table] = {
            "dense": (device_ms(lambda: G.matched_shape(*args, dense), 3),
                      wall_ms(lambda: G.matched_shape(*args, dense), 3)),
            "pruned": (device_ms(lambda: G.matched_shape_pruned(*args,
                                                                pruned), 10),
                       wall_ms(lambda: G.matched_shape_pruned(*args,
                                                              pruned), 10))}
        print(f"geo sweep {table}: {batch.n_shapes} shapes, "
              f"{len(batch.slope)} edges; both routes equal the oracle on "
              f"all {n} points; per batch of {len(pts)} points: dense "
              f"device ms={out[table]['dense'][0]:.4f} (wall "
              f"{out[table]['dense'][1]:.4f}), bbox walk device "
              f"ms={out[table]['pruned'][0]:.4f} (wall "
              f"{out[table]['pruned'][1]:.4f}, one host copy)", flush=True)
    return out


def build_events(n_rows: int, seed: int, batch_rows: int) -> tuple:
    """The events rows from the seed: times uniform over the two days
    before EVENTS_NOW in time order, tags of 0-4 items from 0-19 (the
    battery's), scores in steps of 1/8 in [0, 10). Returns (each upsert
    of batch_rows rows as wire bytes, the rows: ts, tags, score)."""
    from aresdb_tpu_torch.common import data_types as mdt
    from aresdb_tpu_torch.common.upsert_batch import UpsertBatchBuilder

    rng = np.random.RandomState(seed + 5)
    ts = np.sort(EVENTS_NOW - 2 * DAY + rng.randint(0, 2 * DAY, n_rows))
    tags = [rng.randint(0, 20, k).tolist()
            for k in rng.randint(0, 5, n_rows)]
    score = rng.randint(0, 80, n_rows) / 8
    bufs = []
    for lo in range(0, n_rows, batch_rows):
        b = UpsertBatchBuilder()
        for cid, t in enumerate((mdt.Uint32, mdt.Uint32, mdt.ArrayInt32,
                                 mdt.Float32)):
            b.add_column(cid, t)
        for r, i in enumerate(range(lo, min(lo + batch_rows, n_rows))):
            b.add_row()
            b.set_value(r, 0, int(ts[i]))
            b.set_value(r, 1, i)
            b.set_value(r, 2, tags[i])
            b.set_value(r, 3, float(score[i]))
        bufs.append(b.to_bytes())
    return bufs, {"ts": ts, "tags": tags, "score": score}


def events_queries() -> dict:
    def q(measure, dim, filters=()):
        return {"table": "events", "now": EVENTS_NOW,
                "measures": [{"sqlExpression": measure,
                              "rowFilters": list(filters)}],
                "dimensions": [{"sqlExpression": dim}]}

    return {"E1": q("sum(score)", "length(tags)", ["contains(tags, 7)"]),
            "E2": q("count(*)", "element_at(tags, -1)")}


def events_oracle(data: dict, name: str) -> dict:
    """E1's or E2's answer from the rows: the scores' sums are exact."""
    out = {}
    for tags, score in zip(data["tags"], data["score"].tolist()):
        if name == "E1":
            if 7 in tags:
                out[str(len(tags))] = out.get(str(len(tags)), 0.0) + score
        else:
            key = str(tags[-1]) if tags else "NULL"
            out[key] = out.get(key, 0.0) + 1.0
    return out


def close_memstore(ms) -> None:
    """Stop a MemStore's host-memory workers and redo-log managers."""
    ms.host_memory_manager.stop()
    ms.redolog_master.stop_all()


def phase_events(n_rows: int, seed: int, warm: int = 5, device=None,
                 batch_rows: int = 1 << 16, mesh=()) -> tuple:
    """The durable store: events (build_events) through a MemStore's
    handle_ingestion (a redo-log append an upsert) in a temporary
    directory, the first day archived, E1 and E2 on the card as phase_e2e
    runs its queries (launches asserted: the keyed path's runtime-dense
    K2 on every live batch and archive chunk), each equal to the CPU run
    and the oracle exactly, and the queries in `mesh` as mesh batches
    (phase_mesh); then the store closed, a new MemStore recovered from
    the directory (timed), and E1 and E2 again, equal to the first
    answers exactly. Returns each kernel's launches and {kernel: {query:
    device ms per launch}}."""
    from aresdb_tpu_torch.common.schema import Table
    from aresdb_tpu_torch.common.upsert_batch import UpsertBatch
    from aresdb_tpu_torch.diskstore.local_diskstore import LocalDiskStore
    from aresdb_tpu_torch.memstore.archiving import Archiver
    from aresdb_tpu_torch.memstore.memstore import MemStore
    from aresdb_tpu_torch.metastore.disk_metastore import DiskMetaStore
    from aresdb_tpu_torch.query import executor as X
    from aresdb_tpu_torch.query.service import QueryService

    t0 = time.perf_counter()
    bufs, data = build_events(n_rows, seed, batch_rows)
    print(f"events: {n_rows} rows built as {len(bufs)} upserts in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    counters = kernel_counters()
    totals = dict.fromkeys(counters, 0)
    in_situ = {k: {} for k in counters}
    runs = 1 + warm
    first, single = {}, {}
    with tempfile.TemporaryDirectory() as root:
        schema = dict(EVENTS_SCHEMA_JSON, config={
            "batchSize": batch_rows, "recordRetentionInDays": 0})
        ms = MemStore(DiskMetaStore(root), LocalDiskStore(root))
        ms.create_table(Table.from_json(schema))
        ms.init_shards()
        t0 = time.perf_counter()
        for buf in bufs:
            ms.handle_ingestion("events", 0, UpsertBatch(buf))
        ingest_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        shard = ms.get_table_shard("events")
        Archiver(shard, ms.metastore, ms.diskstore).archive(EVENTS_CUTOFF)
        print(f"events: ingested through the redo log in {ingest_s:.3f} s "
              f"({n_rows / ingest_s:.0f} rows/s), first day archived in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        for stage in ("", " recovered"):
            if stage:
                close_memstore(ms)
                t0 = time.perf_counter()
                ms = MemStore(DiskMetaStore(root), LocalDiskStore(root))
                ms.fetch_schema()
                ms.init_shards()
                print(f"events: a new MemStore recovered in "
                      f"{time.perf_counter() - t0:.3f} s", flush=True)
                shard = ms.get_table_shard("events")
            layout = atrips_layout(shard, X.ShardExecutor.ARCHIVE_CHUNK_ROWS)
            batches = len(layout["live"]) + len(layout["chunks"])
            print(f"events{stage}: live batches {len(layout['live'])}, "
                  f"archive chunks {len(layout['chunks'])}", flush=True)
            gpu = QueryService(ms, device=device)
            cpu = QueryService(ms, device="cpu")
            for name, q in events_queries().items():
                rec = run_query(gpu, cpu, name + stage, q, {}, False, runs,
                                counters, {"K1": 0, "K2": runs * batches,
                                           "K3": 0})
                for k in totals:
                    totals[k] += rec["launches"][k]
                for k, ms_ in rec["in_situ"].items():
                    in_situ[k][name + stage] = ms_
                answer = rec["answer"]
                if answer != rec["cpu_answer"]:
                    raise AssertionError(f"{name}{stage}: the cuda answer "
                                         "differs from the cpu run's")
                if answer != events_oracle(data, name):
                    raise AssertionError(f"{name}{stage}: the answer differs "
                                         "from the oracle's")
                if stage and answer != first[name]:
                    raise AssertionError(f"{name}: the recovered store "
                                         "answers otherwise")
                first[name] = answer
                single[name] = (answer, warm_ms(rec))
                report(name + stage, rec, n_rows)
            if mesh and not stage:
                launches, mesh_in_situ = phase_mesh(
                    "events", ms, {n: (events_queries()[n], {})
                                   for n in mesh}, single, device, n_rows)
                for k in totals:
                    totals[k] += launches[k]
                    in_situ[k].update(mesh_in_situ[k])
        close_memstore(ms)
    return totals, in_situ


# the daemon's battery: tools/drive_tpu_server.py:11-213, over HTTP
SERVER_NOW = 1_600_000_000
SERVER_ROWS = 2 * BATCH_ROWS
SERVER_TRIPS_JSON = {
    "name": "trips",
    "columns": [{"name": "request_at", "type": "Uint32"},
                {"name": "id", "type": "Uint32"},
                {"name": "city_id", "type": "Uint16"},
                {"name": "status", "type": "SmallEnum"},
                {"name": "fare", "type": "Float32"}],
    "primaryKeyColumns": [1], "archivingSortColumns": [2],
    "isFactTable": True,
    "config": {"batchSize": BATCH_ROWS, "recordRetentionInDays": 0}}
# the battery's 14 trips shapes (drive_tpu_server.py:80-209) in its
# order: name -> (route, AQL query or SQL statement)
SERVER_MODULUS = 200_000
SERVER_FUSED = ("B1", "B2", "B10", "B11", "B12")   # dense plans: K1
SERVER_HLL = ("B3", "B4")
SERVER_SQL_NOW = f"aql_now(request_at, {SERVER_NOW})"
SERVER_CONCURRENT = (8, 20)   # client threads, requests each


def server_queries() -> dict:
    def q(measure, dims=(), filters=(), **extra):
        return {"table": "trips", "now": SERVER_NOW,
                "measures": [{"sqlExpression": measure,
                              "rowFilters": list(filters)}],
                "dimensions": [d if isinstance(d, dict)
                               else {"sqlExpression": d} for d in dims],
                **extra}

    return {
        "B1": ("aql", q("sum(fare)", [{"sqlExpression": "request_at",
                                       "timeBucketizer": "hour"},
                                      "city_id"], ["status='completed'"])),
        "B2": ("aql", q("avg(fare)", ["status"])),
        "B3": ("aql", q("countdistincthll(id)")),
        "B4": ("aql", q("countdistincthll(id)", ["city_id"])),
        "B5": ("aql", q("count(*)", filters=["c.population > 200000"],
                        joins=[{"table": "cities", "alias": "c",
                                "conditions": ["c.id = city_id"]}])),
        "B6": ("aql", {"table": "trips", "now": SERVER_NOW,
                       "measures": [{"sqlExpression": "1"}],
                       "dimensions": [{"sqlExpression": "fare"},
                                      {"sqlExpression": "city_id"}],
                       "rowFilters": ["status='rejected'"], "limit": 50}),
        "B7": ("sql", "SELECT count(*) FROM trips WHERE fare > 25 AND "
                      + SERVER_SQL_NOW),
        "B8": ("aql", q("sum(fare)", filters=["status='completed'"])),
        "B9": ("sql", "SELECT sum(fare) FROM trips WHERE " + SERVER_SQL_NOW),
        "B10": ("aql", q("count(*)", ["city_id"])),
        "B11": ("aql", q("sum(fare)", [{"sqlExpression": "fare",
                                        "numericBucketizer": {
                                            "bucketWidth": 5.0}}])),
        "B12": ("aql", q("sum(case when status='completed' then fare "
                         "else 0 end)", ["city_id"],
                         ["status in ('completed', 'canceled')"])),
        "B13": ("aql", q("sum(fare)", [{"sqlExpression": "request_at",
                                        "timeBucketizer": "month"},
                                       "city_id"])),
        "B14": ("aql", q("sum(fare)", [f"id % {SERVER_MODULUS}"])),
    }


def server_rows(n_rows: int, seed: int) -> dict:
    """The battery's trips draws (its seed 1 is `seed` + 1): times over
    the 20 hours before SERVER_NOW, cities 0-299, 5% null fares."""
    rng = np.random.RandomState(seed + 1)
    n = n_rows
    return {"request_at": (SERVER_NOW - rng.randint(0, 20 * 3600, n))
            .astype(np.uint32),
            "city_id": rng.randint(0, N_CITIES, n).astype(np.uint16),
            "status": rng.randint(0, 3, n).astype(np.uint8),
            "fare": (rng.rand(n) * 50).astype(np.float32),
            "fare_valid": rng.rand(n) > 0.05,
            "id": np.arange(n, dtype=np.uint32)}


def server_upsert(data: dict, lo: int, hi: int) -> bytes:
    """Rows [lo, hi) as upsert-batch bytes built by hand: what
    Connector.insert_columns sends for trips_columns(data, lo, hi)."""
    from aresdb_tpu_torch.common import data_types as mdt
    from aresdb_tpu_torch.common.upsert_batch import build_columnar_upsert

    sl = slice(lo, hi)
    return build_columnar_upsert(
        [(0, mdt.Uint32, data["request_at"][sl], None, 0),
         (1, mdt.Uint32, data["id"][sl], None, 0),
         (2, mdt.Uint16, data["city_id"][sl], None, 0),
         (3, mdt.SmallEnum, data["status"][sl], None, 0),
         (4, mdt.Float32, data["fare"][sl], data["fare_valid"][sl], 0)],
        hi - lo)


def trips_columns(data: dict, lo: int, hi: int) -> tuple:
    """Rows [lo, hi) of the battery's trips as Connector.insert_columns
    takes them (tools/drive_tpu_server.py:44-50): the columns in the
    table's order and the fare's validity. The connector sends the bytes
    of server_upsert."""
    sl = slice(lo, hi)
    return ({name: data[name][sl] for name in
             ("request_at", "id", "city_id", "status", "fare")},
            {"fare": data["fare_valid"][sl]})


def raised_city_rows(data: dict, n: int, seed: int) -> dict:
    """n more battery trips past data's ids, timed in the 8 hours before
    SERVER_NOW (above phase_server's archiving cutoff), in cities
    N_CITIES to 2 * N_CITIES - 1: the batch they land in plans a city
    domain twice as wide."""
    rng = np.random.RandomState(seed + 3)
    first = int(data["id"].max()) + 1
    return {"request_at": (SERVER_NOW - rng.randint(1, 8 * 3600, n))
            .astype(np.uint32),
            "city_id": rng.randint(N_CITIES, 2 * N_CITIES, n)
            .astype(np.uint16),
            "status": rng.randint(0, 3, n).astype(np.uint8),
            "fare": (rng.rand(n) * 50).astype(np.float32),
            "fare_valid": rng.rand(n) > 0.05,
            "id": np.arange(first, first + n, dtype=np.uint32)}


def city_rows() -> list:
    """The 300 cities as Connector.insert takes them
    (tools/drive_tpu_server.py:63-64): population (id + 1) * 1000."""
    return [(i, (i + 1) * 1000) for i in range(N_CITIES)]


def http(port: int, path: str, body=None, headers=None, method=None):
    """The body of one request to the daemon (JSON parsed unless it is an
    application/hll frame or another non-JSON body); raises unless 200."""
    import urllib.request

    data = body if body is None or isinstance(body, bytes) \
        else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/{path}", data=data, method=method,
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=600) as r:
        out = r.read()
        ctype = r.headers.get("Content-Type", "")
    return json.loads(out) if ctype == "application/json" else out


def ask_http(port: int, name: str, route: str, q, verbose: bool = False):
    """(result, context or None) of one battery shape over HTTP."""
    resp = http(port, f"query/{route}{'?verbose=1' if verbose else ''}",
                {"queries": [q]})
    if "errors" in resp:
        raise AssertionError(f"{name} over HTTP: {resp['errors']}")
    return resp["results"][0], (resp.get("context") or [None])[0]


def check_server(name: str, answer, data: dict) -> None:
    """A battery answer against numpy over the ingested rows: counts and
    HLL estimates exactly, sums and averages within the battery's 1e-4
    relative, the listing's rows among the rejected trips."""
    from aresdb_tpu_torch.query import hll as H
    from aresdb_tpu_torch.query.postprocess import format_float32

    city, status = data["city_id"].astype(np.int64), data["status"]
    valid = data["fare_valid"]
    fare = data["fare"].astype(np.float64)

    def close(got, want, what):
        if abs(got - want) > max(1e-3, abs(want) * 1e-4):
            raise AssertionError(f"{name}: {what} {got} against {want}")

    def by_key(got: dict, want: dict):
        if set(got) != set(want):
            raise AssertionError(f"{name}: {len(got)} groups against the "
                                 f"oracle's {len(want)}")
        for k, v in want.items():
            close(got[k], v, k)

    def sums(keys, sel, n):
        return np.bincount(keys[sel], weights=fare[sel], minlength=n)

    ok = valid & (status == 0)
    if name == "B1":
        hour = data["request_at"].astype(np.int64) // 3600
        sel = status == 0
        keys, inv = np.unique((hour * 65536 + city)[sel],
                              return_inverse=True)
        s = np.bincount(inv, weights=np.where(valid[sel], fare[sel], 0.0),
                        minlength=len(keys))
        want = {(time.strftime("%Y-%m-%d %H:00",
                               time.gmtime(k // 65536 * 3600)),
                 str(k % 65536)): v for k, v in zip(keys.tolist(),
                                                    s.tolist())}
        by_key(flatten(answer), want)
    elif name == "B2":
        want = {}
        for i, s in enumerate(STATUSES):
            sel = valid & (status == i)
            want[s] = fare[sel].mean()
        by_key(answer, want)
    elif name in SERVER_HLL:
        ids = data["id"]
        g = city if name == "B4" else np.zeros(len(ids), np.int64)
        want = hll_estimates(H.murmur3_64(ids, 4), g,
                             str if name == "B4" else (lambda _: ""))
        if answer != want:
            raise AssertionError(f"{name}: estimates differ from the numpy "
                                 "oracle's")
        exact = np.bincount(g)
        worst = max(abs(answer[str(c) if name == "B4" else ""] / n - 1)
                    for c, n in enumerate(exact) if n)
        if worst > (0.1 if name == "B4" else 0.05):   # the battery's bounds
            raise AssertionError(f"{name}: an estimate {worst:.3%} off")
    elif name == "B5":
        if answer != {"": float((city >= 200).sum())}:
            raise AssertionError(f"B5: {answer}")
    elif name == "B6":
        rows = answer["matrixData"]
        if answer["headers"] != ["fare", "city_id"] or len(rows) != 50:
            raise AssertionError(f"B6: {answer['headers']}, {len(rows)} rows")
        for f, c in rows:
            hit = np.flatnonzero((status == 2) & (city == int(c)))
            fares = {format_float32(x) if v else "NULL" for x, v in
                     zip(data["fare"][hit].tolist(), valid[hit].tolist())}
            if f not in fares:
                raise AssertionError(f"B6: ({f}, {c}) is no rejected trip")
    elif name == "B7":
        if answer != {"": float((valid & (data["fare"] > 25)).sum())}:
            raise AssertionError(f"B7: {answer}")
    elif name == "B8":
        close(answer[""], fare[ok].sum(), "sum")
    elif name == "B9":
        close(answer[""], fare[valid].sum(), "sum")
    elif name == "B10":
        counts = np.bincount(city, minlength=N_CITIES)
        want = {str(c): float(n) for c, n in enumerate(counts) if n}
        if answer != want:
            raise AssertionError("B10: counts differ from the oracle's")
    elif name == "B11":
        bucket = np.floor(data["fare"][valid] / 5.0).astype(np.int64)
        s = np.bincount(bucket, weights=fare[valid])
        want = {b * 5.0: v for b, v in enumerate(s.tolist())
                if (bucket == b).any()}
        got = {float(k): v for k, v in answer.items() if k != "NULL"}
        by_key(got, want)
        if (~valid).any() and answer.get("NULL") != 0.0:
            raise AssertionError(f"B11: NULL bucket {answer.get('NULL')}")
    elif name == "B12":
        s = sums(city, ok, N_CITIES)
        present = np.unique(city[status <= 1])
        by_key(answer, {str(c): s[c] for c in present.tolist()})
    elif name == "B13":
        if len(answer) != 1:
            raise AssertionError(f"B13: months {sorted(answer)}")
        (by_city,) = answer.values()
        s = sums(city, valid, N_CITIES)
        by_key(by_city, {str(c): s[c] for c in np.unique(city).tolist()})
    elif name == "B14":
        key = data["id"].astype(np.int64) % SERVER_MODULUS
        s = np.bincount(key[valid], weights=fare[valid],
                        minlength=SERVER_MODULUS)
        present = np.unique(key)
        if len(answer) != len(present):
            raise AssertionError(f"B14: {len(answer)} groups against "
                                 f"{len(present)}")
        got = np.array([answer[str(k)] for k in present.tolist()])
        bad = np.abs(got - s[present]) > np.maximum(1e-3,
                                                    np.abs(s[present]) * 1e-4)
        if bad.any():
            raise AssertionError(f"B14: {int(bad.sum())} sums off the "
                                 "oracle's")


def same_server_answer(name: str, got, want) -> None:
    """Counts, listings and HLL answers exactly; sums within RTOL/ATOL."""
    if name in SERVER_HLL + ("B5", "B6", "B7", "B10"):
        if got != want:
            raise AssertionError(f"{name}: answers differ")
    else:
        same_result(name, got, want)


def server_launches(name: str, runs: int, layout: dict) -> dict:
    """Each kernel's launches over `runs` runs of a battery shape: K1 on
    every batch and chunk of at least FD_MIN_ROWS padded rows of a dense
    plan, and on the others the unfused kernel's K2 (B2's four slots, three
    statuses and null, reduce with masked sums instead); K2 on every batch
    and chunk of the calendar shape (unfused); no kernel for HLL, the
    listing, the plans with no dimensions and the 200k groups of the sort
    path."""
    from aresdb_tpu_torch.query import fused_dense as FD

    every = layout["live"] + layout["chunks"]
    k1 = sum(n >= FD.FD_MIN_ROWS for n in every)
    if name in SERVER_FUSED:
        small = 0 if name == "B2" else len(every) - k1
        return {"K1": runs * k1, "K2": runs * small, "K3": 0}
    if name == "B13":
        return {"K1": 0, "K2": runs * len(every), "K3": 0}
    return {"K1": 0, "K2": 0, "K3": 0}


def query_seconds(metrics) -> float:
    """The daemon's query-latency timer so far, summed over its tags: each
    /query/* request's service call, its hop to the query pool included."""
    from aresdb_tpu_torch.utils import metrics as M

    name = M.CATALOG[M.QUERY_LATENCY].name
    return sum(t["sum"] for k, t in metrics.snapshot()["timers"].items()
               if k.split("{")[0] == name)


def run_battery(label: str, names, send, runs: int, counters: dict,
                totals: dict, launches_of, layout: dict, rows=None,
                alike=None):
    """Each shape of `names` in turn: every kernel's launches set to 0
    just before its `runs` requests (one cold, the rest warm) and read just
    after, held to launches_of(name, runs, layout) and added to totals.
    send(name, i) makes the i-th request and gives its answer; each request
    is timed at the client. The last answer is held to the numpy oracle
    over `rows` and to alike[name], where given. Yields (name, answer,
    seconds by request, launches) shape by shape."""
    for name in names:
        for c in counters.values():
            c.launches = 0
        times = []
        for i in range(runs):
            t0 = time.perf_counter()
            answer = send(name, i)
            times.append(time.perf_counter() - t0)
        got = {k: c.launches for k, c in counters.items()}
        want = launches_of(name, runs, layout)
        if got != want:
            raise AssertionError(f"{label} {name}: launches {got}, expected "
                                 f"{want}")
        for k in totals:
            totals[k] += got[k]
        if rows is not None:
            check_server(name, answer, rows)
        if alike and name in alike:
            same_server_answer(name, answer, alike[name])
        yield name, answer, times, got


def load_battery(conn, data: dict, batch_rows: int, what: str) -> float:
    """Create the battery's trips (batches of batch_rows) and cities
    through the Connector, with the statuses' enum cases, then load the
    trips as upserts of batch_rows by two producer threads and the cities
    row by row, as tools/drive_tpu_server.py:17-64 loads the JAX
    package's server. Returns the trips' load in seconds."""
    from concurrent.futures import ThreadPoolExecutor

    n_rows = len(data["id"])
    conn.create_table(dict(SERVER_TRIPS_JSON,
                           config={"batchSize": batch_rows,
                                   "recordRetentionInDays": 0}))
    conn.create_table(CITIES_SCHEMA_JSON)
    conn.schema.extend_enum("trips", "status", STATUSES)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as producers:
        stats = list(producers.map(
            lambda lo: conn.insert_columns("trips", *trips_columns(
                data, lo, min(lo + batch_rows, n_rows))),
            range(0, n_rows, batch_rows)))
    seconds = time.perf_counter() - t0
    if sum(s["inserted"] for s in stats) != n_rows:
        raise AssertionError(f"{what}: inserted {stats}")
    conn.insert("cities", ["id", "population"], city_rows())
    return seconds


def shut_down(server, memstore, scheduler) -> None:
    """Stop a daemon of build_server and close its store."""
    server.stop()
    scheduler.stop()
    close_memstore(memstore)


def phase_server(n_rows: int, seed: int, warm: int = 5, device=None,
                 batch_rows: int = BATCH_ROWS) -> tuple:
    """The daemon (cmd.aresd.build_server over a temporary root, its
    scheduler on, the port's clock frozen at SERVER_NOW) fed through the
    port's Connector as tools/drive_tpu_server.py feeds the JAX
    package's (load_battery): n_rows battery trips as upserts of
    batch_rows by two producer threads, and the 300 cities. Then the battery's 14 trips shapes: each answered once
    by the CPU service over the same store, then one cold and `warm` warm
    runs over HTTP (each kernel's launches set to 0 just before and read
    just after; a K1 row function that a plan needs compiles inside its
    cold run, as a daemon's user meets it), each answer against the numpy
    oracle and the CPU's (the HLL shapes also as application/hll frames,
    byte for byte), each request timed at the client and, from the
    daemon's query-latency timer, in its service call. Then
    8 client threads x 20 requests of the shapes, each answer equal to
    its serial one; the admission gate's state; the deadline; the clock
    moved to SERVER_NOW + 14 h and the archiving job run through
    /dbg/trips/0/archiving (about half the rows archive), the shapes
    again against the oracle; then the daemon stopped and a new one built
    over the root, and B1 and B14 again, equal to their first answers.
    Returns each kernel's launches over the serial runs, {} per kernel
    (no in-situ times), and the first battery's answers and warm medians
    over HTTP in ms ({"answers": ..., "warm_ms": ...}, by shape), which
    phase_cluster holds the cluster against."""
    from concurrent.futures import ThreadPoolExecutor

    from aresdb_tpu_torch.client import Connector
    from aresdb_tpu_torch.cmd import aresd
    from aresdb_tpu_torch.common.config import AresServerConfig
    from aresdb_tpu_torch.query import admission as A
    from aresdb_tpu_torch.query import executor as X
    from aresdb_tpu_torch.query.service import QueryService
    from aresdb_tpu_torch.utils import clock

    counters = kernel_counters()
    totals = dict.fromkeys(counters, 0)
    runs = 1 + warm
    queries = server_queries()
    data = server_rows(n_rows, seed)
    clock.set_current_time(SERVER_NOW)
    try:
        with tempfile.TemporaryDirectory() as root:
            cfg = AresServerConfig.load(None, {"root_path": root, "port": 0})
            server, ms, sched = aresd.build_server(cfg, device=device)
            port = server.start_background()
            dev = server.ctx.device
            ingest_s = load_battery(Connector("localhost", port), data,
                                    batch_rows, "server")
            print(f"server: {n_rows} rows ingested over HTTP by 2 producers "
                  f"in {ingest_s:.3f} s ({n_rows / ingest_s:.0f} rows/s, "
                  f"the upserts' wire build included)", flush=True)

            store = server.ctx.memstore
            shard = store.get_table_shard("trips")
            cpu = QueryService(store, device="cpu")
            metrics = server.ctx.metrics

            warm_ms = {}

            def battery(stage: str) -> dict:
                cpu_answers = {name: json.loads(json.dumps(
                    ask(cpu, name, q)[0])) for name, (_, q) in queries.items()}
                layout = atrips_layout(shard,
                                       X.ShardExecutor.ARCHIVE_CHUNK_ROWS)
                answers, svc, cold = {}, {}, {}

                def send(name, i):
                    s0 = query_seconds(metrics)
                    answer, ctx = ask_http(port, name, *queries[name],
                                           verbose=i == 0)
                    svc.setdefault(name, []).append(
                        query_seconds(metrics) - s0)
                    if i == 0:
                        cold[name] = sorted(((v, k) for k, v
                                             in (ctx or {}).items()
                                             if isinstance(v, float)),
                                            reverse=True)[:3]
                    return answer

                for name, answer, times, got in run_battery(
                        f"server{stage}", queries, send, runs, counters,
                        totals, server_launches, layout, data, cpu_answers):
                    # the HTTP layer of one request: its time at the
                    # client less its service call's, so never negative
                    served = svc[name]
                    layer = [t - v for t, v in zip(times, served)]
                    if min(layer) < 0:
                        raise AssertionError(f"{name}{stage}: a service call "
                                             "outlasted its request")
                    http_ms, svc_ms, layer_ms = (
                        1e3 * float(np.median(x[1:]))
                        for x in (times, served, layer))
                    size = (f"{len(answer['matrixData'])} rows" if name == "B6"
                            else f"{len(flatten(answer))} groups")
                    if not stage:
                        warm_ms[name] = http_ms
                    print(f"server {name}{stage}: cold {1e3 * times[0]:.3f} "
                          f"ms (service call {1e3 * served[0]:.3f} ms), warm "
                          f"median {http_ms:.3f} ms over HTTP, its service "
                          f"call {svc_ms:.3f} ms, HTTP layer {layer_ms:.3f} "
                          f"ms, {size}, "
                          f"launches " + " ".join(
                              f"{k}={v}" for k, v in got.items())
                          + "; the cold run's largest stages "
                          + ", ".join(f"{k} {1e3 * v:.3f} ms"
                                      for v, k in cold[name]), flush=True)
                    answers[name] = answer
                print(f"server{stage}: live batches {len(layout['live'])}, "
                      f"archive chunks {len(layout['chunks'])}; every shape "
                      "equals the numpy oracle", flush=True)
                return answers

            first = battery("")
            for name in SERVER_HLL:
                request = {"queries": [queries[name][1]]}
                wire = [http(port, "query/aql", request,
                             {"Accept": "application/hll"}),
                        cpu.handle_aql_hll(request)]
                if wire[0] != wire[1]:
                    raise AssertionError(f"{name}: application/hll bytes "
                                         "differ from the cpu run's")
                print(f"server {name}: application/hll frame of "
                      f"{len(wire[0])} bytes, identical to the cpu run's",
                      flush=True)

            n_threads, per_thread = SERVER_CONCURRENT
            order = list(queries)
            latencies, errors = [], []

            def client(i):
                for j in range(per_thread):
                    name = order[(i + j) % len(order)]
                    t0 = time.perf_counter()
                    try:
                        answer, _ = ask_http(port, name, *queries[name])
                        same_server_answer(name, answer, first[name])
                    except Exception as e:  # noqa: BLE001 — reported below
                        errors.append(f"{name}: {e}")
                    latencies.append(time.perf_counter() - t0)

            t0 = time.perf_counter()
            with ThreadPoolExecutor(n_threads) as clients:
                list(clients.map(client, range(n_threads)))
            wall = time.perf_counter() - t0
            if errors:
                raise AssertionError(f"concurrent: {errors[:3]}")
            lat = 1e3 * np.array(latencies)
            print(f"server concurrent: {n_threads} threads x {per_thread} "
                  f"requests in {wall:.3f} s, {len(lat) / wall:.3f} "
                  f"queries/s, p50 {np.percentile(lat, 50):.3f} ms, p99 "
                  f"{np.percentile(lat, 99):.3f} ms; every answer equals "
                  "its serial one", flush=True)

            budget = http(port, "dbg/device")
            total = (torch.cuda.mem_get_info(dev)[1] if dev.type == "cuda"
                     else A.CPU_MEMORY_BYTES)
            # on a card, 0.95 of its memory less the column cache's share
            cache_share = (A.device_cache_budget(dev) if dev.type == "cuda"
                           else 0)
            if budget != {"budgetBytes": int(total * 0.95) - cache_share,
                          "inUseBytes": 0, "running": 0, "waiting": 0}:
                raise AssertionError(f"admission: {budget} with {total} "
                                     f"bytes on the device, {cache_share} "
                                     "of them the column cache's")
            name = next(iter(queries))
            _, ctx = ask_http(port, name, *queries[name], verbose=True)
            if not ctx or ctx.get("memoryRequired", 0) <= 0:
                raise AssertionError(f"admission: {name}'s context {ctx}")
            late = QueryService(store, device=dev, query_timeout=1e-9)
            resp = late.handle_aql({"queries": [queries[name][1]]}) \
                if queries[name][0] == "aql" else \
                late.handle_sql({"queries": [queries[name][1]]})
            if resp.get("errors") != ["query timed out"]:
                raise AssertionError(f"deadline: {resp}")
            print(f"server admission: budget {budget['budgetBytes']} bytes "
                  f"(0.95 x {total} less the column cache's "
                  f"{cache_share}), {name} requires "
                  f"{ctx['memoryRequired']} bytes; in use 0, running 0 "
                  "after the runs; a deadline of 1e-9 s answers 'query "
                  "timed out'", flush=True)

            # the scheduler would archive on its own at the next tick once
            # the clock jumps: pause it so that the job runs once, here
            sched.disable()
            clock.set_current_time(SERVER_NOW + 14 * 3600)
            t0 = time.perf_counter()
            for _ in range(10):
                job = http(port, "dbg/trips/0/archiving", {})
                if job["result"] is not None:
                    break
                time.sleep(1.0)   # a scheduler job held the shard's token
            archive_s = time.perf_counter() - t0
            sched.enable()
            archived = job["result"]["rowsArchived"]
            cutoff = SERVER_NOW + 14 * 3600 - DAY
            want = int((data["request_at"] < cutoff).sum())
            if archived != want:
                raise AssertionError(f"archiving: {archived} rows, the "
                                     f"cutoff {cutoff} holds {want}")
            print(f"server: archived {archived} rows to {cutoff} in "
                  f"{archive_s:.3f} s", flush=True)
            battery(" archived")

            shut_down(server, ms, sched)
            t0 = time.perf_counter()
            server, ms, sched = aresd.build_server(cfg, device=device)
            port = server.start_background()
            restart_s = time.perf_counter() - t0
            try:
                print(f"server: a new daemon recovered the root and "
                      f"serves in {restart_s:.3f} s", flush=True)
                for name in ("B1", "B14"):
                    answer, _ = ask_http(port, name, *queries[name])
                    same_server_answer(name + " restarted", answer,
                                       first[name])
                    check_server(name, answer, data)
                print("server restarted: B1 and B14 equal their first "
                      "answers", flush=True)
                range_step(port, server.ctx.query_service, queries, data,
                           seed)
            finally:
                shut_down(server, ms, sched)
    finally:
        clock.reset_clock()
    return totals, {k: {} for k in counters}, {"answers": first,
                                               "warm_ms": warm_ms}


def range_step(port: int, svc, queries: dict, data: dict,
               seed: int) -> None:
    """phase_window's column-range kind: WINDOW_RANGE_ROWS trips in cities
    past the loaded ones (raised_city_rows) through the Connector into a
    batch of their own, then B1 over HTTP once (window_run: no library
    built, K1 launched, equal to the CPU service and the numpy oracle over
    all the rows) and three times more for its warm median; the daemon's
    service `svc` then holds K1 kernels of one source over both city
    domains. Records WINDOW["B1 raised range"]."""
    from aresdb_tpu_torch.client import Connector
    from aresdb_tpu_torch.query import executor as X
    from aresdb_tpu_torch.query import fused_dense as FD
    from aresdb_tpu_torch.query.service import QueryService

    store = svc.memstore

    rows = raised_city_rows(data, WINDOW_RANGE_ROWS, seed)
    stats = Connector("localhost", port).insert_columns(
        "trips", *trips_columns(rows, 0, WINDOW_RANGE_ROWS))
    if stats["inserted"] != WINDOW_RANGE_ROWS:
        raise AssertionError(f"window: inserted {stats}")
    grown = {k: np.concatenate([data[k], rows[k]]) for k in data}
    cpu = QueryService(store, device="cpu")
    route, q = queries["B1"]

    def check(answer):
        same_result("B1 over a raised city range", answer,
                    ask(cpu, "B1", q)[0])
        check_server("B1", answer, grown)

    run = window_run("B1 over a raised city range",
                     lambda: ask_http(port, "B1", route, q)[0], check)
    layout = atrips_layout(store.get_table_shard("trips"),
                           X.ShardExecutor.ARCHIVE_CHUNK_ROWS)
    want = server_launches("B1", 1, layout)["K1"]
    if run["k1_launches"] != want:
        raise AssertionError(f"window B1: K1 launches {run['k1_launches']}"
                             f", expected {want} over {layout}")
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        ask_http(port, "B1", route, q)
        warm.append(1e3 * (time.perf_counter() - t0))
    median = float(np.median(warm))
    run["city_max"] = int(rows["city_id"].max())
    cities = {}   # source -> the city domain sizes of its K1 kernels
    for fn in svc.executor.kernel_cache._cache.values():
        if isinstance(fn, FD.FusedDenseKernel):
            cities.setdefault(fn.spec.source, set()).add(
                fn.dense_plan.domains[-1].size)
    if not any(min(v) < 2 * N_CITIES <= max(v) for v in cities.values()):
        raise AssertionError(f"window: K1's city domains {cities.values()}")
    WINDOW["B1 raised range"] = {"warm_ms": median, "runs": [run]}
    print(f"window B1: {WINDOW_RANGE_ROWS} rows in cities up to "
          f"{run['city_max']} inserted; B1 over HTTP {run['ms']:.3f} ms "
          f"({run['ms'] / median:.2f} x its warm median {median:.3f}), "
          f"{run['builds']} builds, K1 launches {run['k1_launches']} (live "
          f"batches {layout['live']}, archive chunks {layout['chunks']}); "
          "equal to the cpu run and the numpy oracle", flush=True)


# the cluster of README.md:71-92 and tests/test_distributed.py:58-106: a
# controller, datanodes dn0 and dn1 over 4 shards at replica factor 1, a
# broker, then dn2 in dn1's place
CLUSTER_NS = "battery"
CLUSTER_SHARDS = 4
CLUSTER_JOIN = "B5"
# the listing concatenates each node's rows up to its limit: which rows
# come back depends on the nodes, so it is held to the oracle alone
CLUSTER_LISTING = "B6"
# the broker forgets an unhealthy mark after this many seconds (its
# default is 30), so that the shapes after B5's failure run on both nodes
CLUSTER_UNHEALTHY_TTL = 1.0
# B5 through the broker: the node without shard 0 of cities fails it
# (ROADMAP section 3)
CLUSTER_B5_ERROR = re.compile(r"datanode localhost:\d+ failed after 3 "
                              r"tries: \"no shard 0 for table 'cities'\"")


def cluster_launches(name: str, runs: int, layout: dict) -> dict:
    """server_launches over the shards' batches and chunks; the broker
    splits B2's avg into a sum and a count, two dense plans."""
    want = server_launches(name, runs, layout)
    return {k: 2 * v for k, v in want.items()} if name == "B2" else want


def shards_layout(nodes) -> dict:
    """atrips_layout over every shard of trips that the nodes own."""
    from aresdb_tpu_torch.query import executor as X

    out = {"live": [], "chunks": []}
    for node in nodes:
        for sid in sorted(node.owned_shards):
            part = atrips_layout(node.memstore.get_table_shard("trips", sid),
                                 X.ShardExecutor.ARCHIVE_CHUNK_ROWS)
            out["live"] += part["live"]
            out["chunks"] += part["chunks"]
    return out


def wait_for(pred, what: str, timeout: float, proc=None, log=None):
    """Poll pred until it holds; fail on the timeout, or as soon as `proc`
    exits, with its standard error."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"{what}: the process exited with "
                                 f"{proc.returncode}:\n{''.join(log)}")
        if pred():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}"
                         + (f":\n{''.join(log)}" if log else ""))


def bootstrap_metrics(port: int) -> tuple:
    """(seconds, bytes) of a datanode's peer bootstraps, summed over its
    tables and shards, from its /metrics: each copy's total time and its
    rate (datanode/bootstrap.py)."""
    from aresdb_tpu_torch.utils import metrics as M

    snap = http(port, "metrics")
    rate_name = M.CATALOG[M.RAW_VP_FETCH_BYTES_PER_SEC].name
    time_name = M.CATALOG[M.TOTAL_RAW_VP_FETCH_TIME].name
    seconds = nbytes = 0.0
    for key, timer in snap["timers"].items():
        name, _, tags = key.partition("{")
        if name == time_name:
            seconds += timer["sum"]
            nbytes += timer["sum"] * snap["gauges"][f"{rate_name}{{{tags}"]
    return seconds, nbytes


def shard_counts(port: int, sid: int, cutoff: int) -> tuple:
    """(rows below cutoff, rows at or above it) of trips shard sid on the
    datanode at port: a count by `request_at >= cutoff` with shards: [sid]
    sent to that datanode directly."""
    q = {"table": "trips", "shards": [sid], "now": SERVER_NOW,
         "measures": [{"sqlExpression": "count(*)"}],
         "dimensions": [{"sqlExpression": f"request_at >= {cutoff}"}]}
    resp = http(port, "query/aql", {"queries": [q]})
    if "errors" in resp:
        raise AssertionError(f"shard {sid} count: {resp['errors']}")
    got = resp["results"][0]
    return int(got.get("0", 0)), int(got.get("1", 0))


def phase_cluster(n_rows: int, seed: int, single: dict, warm: int = 5,
                  device=None, batch_rows: int = BATCH_ROWS) -> tuple:
    """Distributed mode on the card: the port's controller over a
    temporary root; two datanodes in this process (dn0, dn1, each over a
    root of its own, the scheduler on, the port's clock frozen at
    SERVER_NOW); the broker over a DynamicTopology. The controller gets
    the namespace, the battery's trips and cities and the enum cases; the
    placement puts 4 shards at replica factor 1 over dn0 and dn1. The
    n_rows battery trips of phase_server (the same seed, so the same rows)
    go in as one upsert a shard, each a contiguous quarter, sent to its
    owner by Connector.insert_columns from two producer threads; the cities go to the owner of shard 0,
    where a joined table is read from. Then the 14 shapes through the
    broker: one cold and `warm` warm runs each (B5 once, last: the node
    without shard 0 of cities fails it and the broker marks the node
    unhealthy, ROADMAP section 3, so its answer is held to that error and
    the phase waits out the mark), each answer against the numpy oracle
    and `single` (phase_server's serial answers, unless it is None; the
    listing, B6, against the oracle alone), B3 and B4 also as
    application/hll frames whose estimates equal the single daemon's (or
    the broker's JSON answer), and each kernel's launches on the
    datanodes asserted. Then the clock moves 14 hours and each owner
    archives its shards through /dbg; a third datanode, dn2, starts as a
    process of its own (cmd.aresd --controller, its scheduler off, since
    its clock is the wall's), replaces dn1 through the controller, and
    bootstraps dn1's shards from it (archive batches and redo logs, then
    recovery); the shapes run again, equal to their first answers (B6 to
    the oracle alone), with launches asserted on dn0 (dn2 counts in its
    own process). Returns each kernel's launches over the serial runs on
    this process's datanodes, and {} per kernel."""
    from concurrent.futures import ThreadPoolExecutor

    from aresdb_tpu_torch.broker.server import BrokerServer
    from aresdb_tpu_torch.broker.validator import BrokerSchemaView
    from aresdb_tpu_torch.client import Connector
    from aresdb_tpu_torch.cluster.topology import (DynamicTopology,
                                                   HealthTrackingTopology)
    from aresdb_tpu_torch.controller.server import ControllerServer
    from aresdb_tpu_torch.controller.state import ControllerState
    from aresdb_tpu_torch.datanode.datanode import DataNode
    from aresdb_tpu_torch.diskstore.local_diskstore import LocalDiskStore
    from aresdb_tpu_torch.memstore.memstore import MemStore
    from aresdb_tpu_torch.memstore.scheduler import Scheduler
    from aresdb_tpu_torch.metastore.disk_metastore import DiskMetaStore
    from aresdb_tpu_torch.query import hll_wire as W
    from aresdb_tpu_torch.utils import clock
    from aresdb_tpu_torch.utils.torch_env import resolve_device

    dev = resolve_device(device)
    counters = kernel_counters()
    totals = dict.fromkeys(counters, 0)
    runs = 1 + warm
    queries = server_queries()
    # every shape but B5, which runs after them: the broker's unhealthy
    # mark from its failure then expires before the HLL frames
    order = [n for n in queries if n != CLUSTER_JOIN]
    # the listing is held to the oracle alone
    alike = ({n: a for n, a in single["answers"].items()
              if n != CLUSTER_LISTING} if single is not None else None)
    data = server_rows(n_rows, seed)
    ns = CLUSTER_NS
    stack = []   # what to stop, last first
    clock.set_current_time(SERVER_NOW)
    with tempfile.TemporaryDirectory() as root:
        try:
            ctrl = ControllerServer(ControllerState(f"{root}/ctrl"))
            cport = ctrl.start_background()
            stack.append(ctrl.stop)
            caddr = f"localhost:{cport}"
            trips = dict(SERVER_TRIPS_JSON,
                         config={"batchSize": batch_rows,
                                 "recordRetentionInDays": 0})
            http(cport, "namespaces", {"namespace": ns})
            http(cport, f"schema/{ns}/tables", trips)
            http(cport, f"schema/{ns}/tables", CITIES_SCHEMA_JSON)
            http(cport, f"schema/{ns}/tables/trips/columns/status/"
                        "enum-cases", {"enumCases": STATUSES})
            nodes = {}
            for name in ("dn0", "dn1"):
                ms = MemStore(DiskMetaStore(f"{root}/{name}"),
                              LocalDiskStore(f"{root}/{name}"))
                node = DataNode(ms, Scheduler(ms), controller_address=caddr,
                                namespace=ns, instance_name=name,
                                heartbeat_seconds=1.0, poll_seconds=0.5,
                                device=dev)
                node.open()
                stack.append(lambda n=node: (n.close(),
                                             close_memstore(n.memstore)))
                node.serve()
                nodes[name] = node

            def placement():
                return http(cport, f"placement/{ns}/datanode")["shards"]

            def settled(owners) -> bool:
                return all(set(sd["instances"]) <= owners and
                           set(sd["instances"].values()) == {"Available"}
                           for sd in placement())

            def owner_port(sid: int) -> int:
                (name,) = [n for sd in placement() if sd["shardId"] == sid
                           for n in sd["instances"]]
                return nodes[name].port

            http(cport, f"placement/{ns}/datanode",
                 {"numShards": CLUSTER_SHARDS, "replicaFactor": 1,
                  "instances": ["dn0", "dn1"]})
            wait_for(lambda: settled({"dn0", "dn1"}), "the placement", 120)

            quarter = n_rows // CLUSTER_SHARDS
            t0 = time.perf_counter()
            with ThreadPoolExecutor(2) as producers:
                stats = list(producers.map(
                    lambda sid: Connector("localhost", owner_port(sid))
                    .insert_columns("trips", *trips_columns(
                        data, sid * quarter, (sid + 1) * quarter),
                        shard_id=sid),
                    range(CLUSTER_SHARDS)))
            ingest_s = time.perf_counter() - t0
            if sum(s["inserted"] for s in stats) != n_rows:
                raise AssertionError(f"cluster: inserted {stats}")
            Connector("localhost", owner_port(0)).insert(
                "cities", ["id", "population"], city_rows())
            print(f"cluster: {n_rows} rows ingested over HTTP into "
                  f"{CLUSTER_SHARDS} shards on 2 datanodes by 2 producers in "
                  f"{ingest_s:.3f} s ({n_rows / ingest_s:.0f} rows/s, the "
                  "upserts' wire build included)", flush=True)

            topology = DynamicTopology(caddr, ns, poll_seconds=0.5)
            topology.start()
            stack.append(topology.stop)
            schema_view = BrokerSchemaView(caddr, ns, poll_seconds=1.0)
            schema_view.start()
            stack.append(schema_view.stop)
            broker = BrokerServer(HealthTrackingTopology(
                topology, unhealthy_ttl_seconds=CLUSTER_UNHEALTHY_TTL),
                schema_view=schema_view)
            bport = broker.start_background()
            stack.append(broker.stop)

            def battery(stage: str, local) -> dict:
                """The shapes through the broker; launches asserted on the
                datanodes of this process, `local`."""
                layout = shards_layout(local)
                answers = {}

                def send(name, i):
                    resp = http(bport, f"query/{queries[name][0]}",
                                {"queries": [queries[name][1]]})
                    if name == CLUSTER_JOIN:
                        return resp
                    if "errors" in resp:
                        raise AssertionError(f"cluster {name}{stage}: "
                                             f"{resp['errors']}")
                    return resp["results"][0]

                for name, answer, times, got in run_battery(
                        f"cluster{stage}", order, send, runs, counters,
                        totals, cluster_launches, layout, data, alike):
                    warm_ms = 1e3 * float(np.median(times[1:]))
                    one = ""
                    if single is not None:
                        ms = single["warm_ms"][name]
                        one = (f", one daemon's {ms:.3f} ms (scatter-gather "
                               f"cost {warm_ms - ms:.3f} ms)")
                    size = (f"{len(answer['matrixData'])} rows" if name == "B6"
                            else f"{len(flatten(answer))} groups")
                    print(f"cluster {name}{stage}: cold {1e3 * times[0]:.3f} "
                          f"ms, warm median {warm_ms:.3f} ms through the "
                          f"broker{one}, {size}, launches "
                          + " ".join(f"{k}={v}" for k, v in got.items()),
                          flush=True)
                    answers[name] = answer
                [(_, resp, times, _)] = run_battery(
                    f"cluster{stage}", [CLUSTER_JOIN], send, 1, counters,
                    totals, cluster_launches, layout)
                errors = resp.get("errors") or [""]
                if resp["results"] != [{}] or not \
                        CLUSTER_B5_ERROR.fullmatch(errors[0]):
                    raise AssertionError(f"cluster B5{stage}: {resp}")
                time.sleep(CLUSTER_UNHEALTHY_TTL + 0.2)
                print(f"cluster B5{stage}: {1e3 * times[0]:.3f} ms, the "
                      f"reference cluster's answer: {errors[0]}", flush=True)
                answers[CLUSTER_JOIN] = resp
                for name in SERVER_HLL:
                    frame = http(bport, "query/aql",
                                 {"queries": [queries[name][1]]},
                                 {"Accept": "application/hll"})
                    results, errors = W.parse_hll_query_results(frame)
                    estimate = json.loads(json.dumps(
                        W.compute_hll_result(results[0])))
                    want, whose = (
                        (answers[name], "JSON answer") if single is None
                        else (single["answers"][name], "single daemon's"))
                    if errors != [None] or estimate != want:
                        raise AssertionError(f"cluster {name}{stage}: the "
                                             "frame's estimates differ from "
                                             f"the {whose}")
                    print(f"cluster {name}{stage}: application/hll frame of "
                          f"{len(frame)} bytes, its estimates equal the "
                          f"{whose}", flush=True)
                print(f"cluster{stage}: live batches {len(layout['live'])}, "
                      f"archive chunks {len(layout['chunks'])} on this "
                      "process's datanodes; every shape equals the numpy "
                      "oracle and the single daemon", flush=True)
                return answers

            first = battery("", [nodes["dn0"], nodes["dn1"]])

            # as phase_server: pause the schedulers while the clock jumps,
            # so that archiving runs once, here
            for node in nodes.values():
                node.scheduler.disable()
            clock.set_current_time(SERVER_NOW + 14 * 3600)
            t0 = time.perf_counter()
            archived = 0
            for sid in range(CLUSTER_SHARDS):
                for _ in range(10):
                    job = http(owner_port(sid), f"dbg/trips/{sid}/archiving",
                               {})
                    if job["result"] is not None:
                        break
                    time.sleep(1.0)   # a scheduler job held the token
                archived += job["result"]["rowsArchived"]
            archive_s = time.perf_counter() - t0
            for node in nodes.values():
                node.scheduler.enable()
            cutoff = SERVER_NOW + 14 * 3600 - DAY
            want = int((data["request_at"] < cutoff).sum())
            if archived != want:
                raise AssertionError(f"cluster archiving: {archived} rows, "
                                     f"the cutoff {cutoff} holds {want}")
            print(f"cluster: archived {archived} rows to {cutoff} on "
                  f"{CLUSTER_SHARDS} shards in {archive_s:.3f} s", flush=True)
            # the migration check: dn1's shards counted on dn1 below and
            # above the cutoff (archived and live rows), against the rows
            # sent to each, and after the replace on dn2
            before = {}
            for sid in sorted(nodes["dn1"].owned_shards):
                t = data["request_at"][sid * quarter:(sid + 1) * quarter]
                want = (int((t < cutoff).sum()), int((t >= cutoff).sum()))
                before[sid] = shard_counts(nodes["dn1"].port, sid, cutoff)
                if before[sid] != want:
                    raise AssertionError(f"cluster: dn1's shard {sid} holds "
                                         f"{before[sid]} rows below and "
                                         f"above the cutoff, not {want}")

            proc, port2, log, serving_s = start_daemon(
                ["--controller", caddr, "--namespace", ns, "--instance",
                 "dn2", "--device", dev.type, "--root-path", f"{root}/dn2",
                 "--port", "0", "--scheduler-off"], "dn2 to serve")
            stack.append(lambda: kill(proc))
            t0 = time.perf_counter()
            http(cport, f"placement/{ns}/datanode/replace",
                 {"leaving": "dn1", "joining": "dn2"})
            wait_for(lambda: settled({"dn0", "dn2"})
                     and not nodes["dn1"].owned_shards,
                     "dn2 to take over dn1's shards", 900, proc, log)
            replace_s = time.perf_counter() - t0
            topology.refresh()
            boot_s, boot_bytes = bootstrap_metrics(port2)
            if boot_bytes <= 0:
                raise AssertionError(f"cluster: dn2 copied {boot_bytes} "
                                     "bytes")
            for sid, want in before.items():
                got = shard_counts(port2, sid, cutoff)
                for part, g, w in zip(("below", "at or above"), got, want):
                    if g != w:
                        raise AssertionError(
                            f"cluster: dn2's shard {sid} holds {g} rows "
                            f"{part} the cutoff, dn1's held {w}")
            attempts = [x.rstrip() for x in log if "aresdb.datanode" in x]
            print("cluster: dn2's peer copies: " + " | ".join(attempts),
                  flush=True)
            failed = [x for x in attempts
                      if "starting empty" in x or "failed" in x]
            if failed or len(attempts) < len(before):
                raise AssertionError(f"cluster: dn2's peer copies {attempts}")
            print(f"cluster: dn2 holds dn1's shards whole, rows below and "
                  f"at or above the cutoff {before}", flush=True)
            print(f"cluster: dn2 (a process of its own, device "
                  f"{dev.type}) served {serving_s:.3f} s after its start; "
                  f"replacing dn1 took {replace_s:.3f} s to all shards "
                  f"Available ({serving_s + replace_s:.3f} s from dn2's "
                  f"start); its peer bootstrap copied {boot_bytes / 1e6:.3f} "
                  f"MB in {boot_s:.3f} s ({boot_bytes / 1e6 / boot_s:.3f} "
                  "MB/s)", flush=True)
            again = battery(" migrated", [nodes["dn0"]])
            for name in order:
                if name != CLUSTER_LISTING:
                    same_server_answer(name + " migrated", again[name],
                                       first[name])
            print("cluster migrated: every shape but the listing equals its "
                  "first answer", flush=True)
            if proc.poll() is not None:
                raise AssertionError(f"dn2 exited:\n{''.join(log)}")
        finally:
            for stop in reversed(stack):
                try:
                    stop()
                except Exception as e:  # noqa: BLE001 — stop the rest
                    print(f"cluster: stopping: {e!r}", file=sys.stderr)
            clock.reset_clock()
    return totals, {k: {} for k in counters}


# the deployment fed as its users feed it (phase_stream): the battery's
# daemon table bulk-loaded through the client, then a stream of trip
# events through the subscriber, queried through QueryClient and arescli,
# and an example dataset through cmd.examples
STREAM_NS = "stream"
STREAM_JOB = "trips-stream"
# 524,288 events: the whole smoke stays near 650 s beside the drive phases
STREAM_NEW = 3 * (1 << 17)       # new trips, ids from the loaded rows up
STREAM_UPDATES = 1 << 17         # one update each of distinct loaded trips
STREAM_MALFORMED = 16
STREAM_BATCH = 1000              # the job's batchSize
STREAM_DEADLINE = 600.0          # seconds for the whole stream to land
STREAM_COLUMNS = ["request_at", "id", "city_id", "status", "fare"]
CLI_SHAPES = (("B1", "aql"), ("B10", "aql"), ("B7", "sql"))
# cmd/examples.py's dataset layout (its docstring): the battery's trips
# as ex_trips, and the reference integration suite's arraytest table
EX_TRIPS_ROWS = 3000
EX_QUERIES = {"ex_b2.aql": "B2", "ex_b8.aql": "B8", "ex_b7.sql": "B7"}
ARRAY_TYPES = ("Bool", "Int8", "Uint8", "Int16", "Uint16", "Int32",
               "Uint32", "SmallEnum", "BigEnum", "UUID", "GeoPoint")
ARRAYTEST_SCHEMA_JSON = {
    "name": "arraytest",
    "columns": [{"name": "request_at", "type": "Uint32"},
                {"name": "uuid", "type": "UUID"},
                {"name": "city_id", "type": "Uint16"},
                {"name": "status", "type": "SmallEnum"},
                {"name": "fare", "type": "Float32"}]
    + [{"name": f"array_{t.lower()}", "type": f"Array{t}"}
       for t in ARRAY_TYPES],
    "primaryKeyColumns": [1], "isFactTable": True,
    "config": {"batchSize": 2048, "recordRetentionInDays": 0}}
ARRAY_WINDOW = {"column": "request_at", "from": "24 hours ago",
                "to": "this quarter-hour"}
ARRAY_DAY = {"sqlExpression": "request_at", "timeBucketizer": "day"}
ARRAY_QUERIES = {
    "array_length.aql": {"dimensions": [ARRAY_DAY, {
        "sqlExpression": "length(array_int32)"}]},
    "array_contains.aql": {"dimensions": [ARRAY_DAY],
                           "rowFilters": ["contains(array_int32, 20)"]},
    "array_element_at.aql": {"dimensions": [ARRAY_DAY],
                             "rowFilters": ["element_at(array_int32, 0) "
                                            "= 10"]},
}


def stream_events(data: dict, new_rows: int, update_rows: int,
                  seed: int) -> tuple:
    """(JSON lines, the rows after them) of the stream: new_rows new trips
    with ids from len(data["id"]) up, drawn as server_rows draws (5% with
    no fare); update_rows updates, one each of distinct loaded trips, with
    their time and city and a new status and fare; shuffled, a new trip
    last, so that the count reaches its end only with the last batch;
    STREAM_MALFORMED malformed lines among them. request_at is epoch
    milliseconds in even lines and an ISO-8601 string in odd ones, and
    status one of the table's three names. The rows after: the loaded
    ones updated last-write-wins, then the new ones."""
    import datetime as _dt

    rng = np.random.RandomState(seed + 2)
    n_old = len(data["id"])
    new = server_rows(new_rows, seed + 2)
    new["id"] = np.arange(n_old, n_old + new_rows, dtype=np.uint32)
    upd = np.sort(rng.permutation(n_old)[:update_rows])
    upd_status = rng.randint(0, 3, update_rows).astype(np.uint8)
    upd_fare = (rng.rand(update_rows) * 50).astype(np.float32)

    ids = np.concatenate([upd, new["id"]])
    times = np.concatenate([data["request_at"][upd], new["request_at"]])
    cities = np.concatenate([data["city_id"][upd], new["city_id"]])
    status = np.concatenate([upd_status, new["status"]])
    fare = np.concatenate([upd_fare, new["fare"]])
    fare_valid = np.concatenate([np.ones(update_rows, bool),
                                 new["fare_valid"]])
    order = rng.permutation(len(ids))
    last = int(np.flatnonzero(order >= update_rows)[-1])
    order[[last, -1]] = order[[-1, last]]
    millis = rng.randint(0, 1000, len(ids))
    lines = []
    for k, i in enumerate(order.tolist()):
        t = int(times[i])
        when = (str(t * 1000 + int(millis[k])) if k % 2 == 0 else
                '"' + _dt.datetime.fromtimestamp(
                    t, _dt.timezone.utc).isoformat() + '"')
        f = (f', "fare": {float(fare[i])!r}' if fare_valid[i] else "")
        lines.append(f'{{"request_at": {when}, "id": {int(ids[i])}, '
                     f'"city_id": {int(cities[i])}, "status": '
                     f'"{STATUSES[status[i]]}"{f}}}')
    for pos in sorted(rng.choice(len(lines), STREAM_MALFORMED,
                                 replace=False).tolist(), reverse=True):
        lines.insert(pos, '{"request_at": 1, "id": ')

    final = {k: np.concatenate([data[k], new[k]])
             for k in ("request_at", "city_id", "status", "fare",
                       "fare_valid")}
    final["status"][upd] = upd_status
    final["fare"][upd] = upd_fare
    final["fare_valid"][upd] = True
    final["id"] = np.arange(n_old + new_rows, dtype=np.uint32)
    return lines, final


def stream_job(path: str, port: int) -> dict:
    """The subscriber job of the stream (cmd/subscriber.py's config): a
    file source, the trips columns with the time through the `timestamp`
    transformation, the sink at the daemon."""
    return {"name": STREAM_JOB, "table": "trips", "topic": "trips-events",
            "config": {"source": {"type": "file", "path": path},
                       "columns": STREAM_COLUMNS,
                       "transformations": {"request_at": {
                           "type": "timestamp", "source": "request_at"}},
                       "sink": {"host": "localhost", "port": port,
                                "numShards": 1, "pkPositions": [1]},
                       "batchSize": STREAM_BATCH}}


def table_rows(text: str) -> list:
    """The rows of an arescli table (render_table), as lists of cells."""
    return [[c.strip() for c in line.strip("|").split("|")]
            for line in text.splitlines()[3:-1]]


def arescli_step(port: int, answers: dict, queries: dict) -> dict:
    """arescli's Shell against the daemon: `show tables`, `describe
    trips`, then B1 and B10 as AQL statements and B7 as SQL, in `format
    json` and in `format table`. The JSON output must equal `answers`
    (QueryClient's: counts exactly, sums within RTOL/ATOL), and each
    table row must hold an answer's dims and value. Returns each
    statement's ms."""
    import io

    from aresdb_tpu_torch.cmd import arescli

    out, err = io.StringIO(), io.StringIO()
    shell = arescli.Shell("localhost", port, out=out, err=err)
    ms = {}

    def run(stmt, label):
        start = len(out.getvalue())
        t0 = time.perf_counter()
        if not shell.dispatch(stmt):
            raise AssertionError(f"arescli {label}: the shell exited")
        ms[label] = 1e3 * (time.perf_counter() - t0)
        if err.getvalue():
            raise AssertionError(f"arescli {label}: {err.getvalue()}")
        return out.getvalue()[start:]

    tables = run("show tables", "show tables").split()
    if not {"trips", "cities"} <= set(tables):
        raise AssertionError(f"arescli show tables: {tables}")
    desc = table_rows(run("describe trips", "describe trips").split(
        "\nfactTable=")[0])
    if [(r[1], r[2]) for r in desc] != [
            (c["name"], c["type"]) for c in SERVER_TRIPS_JSON["columns"]]:
        raise AssertionError(f"arescli describe trips: {desc}")
    for fmt in ("json", "table"):
        run(f"format {fmt}", f"format {fmt}")
        for name, route in CLI_SHAPES:
            q = queries[name][1]
            stmt = json.dumps(q) if route == "aql" else q
            text = run(stmt + ";", f"{name} {fmt}")
            want = answers[name]
            if fmt == "json":
                same_server_answer(f"arescli {name}", json.loads(text), want)
                continue
            rows = table_rows(text)
            flat = flatten(want)
            if len(rows) != len(flat):
                raise AssertionError(f"arescli {name} table: {len(rows)} "
                                     f"rows against {len(flat)} groups")
            for *dims, value in rows:
                w = flat[tuple(dims)]
                if abs(float(value) - w) > ATOL + RTOL * abs(w):
                    raise AssertionError(f"arescli {name} table: {dims} "
                                         f"{value} against {w}")
    return ms


def ex_trips_csv(path: str, seed: int) -> dict:
    """data/ex_trips.csv of the example dataset: EX_TRIPS_ROWS battery
    trips, request_at as a {Nd}, {Nh} or {Nm} placeholder, a twentieth of
    the fares empty; returns the rows as server_rows gives them."""
    rows = server_rows(EX_TRIPS_ROWS, seed + 3)
    marks = ("{1d}", "{2h}", "{30m}")
    with open(path, "w") as f:
        f.write(",".join(STREAM_COLUMNS) + "\n")
        for i in range(EX_TRIPS_ROWS):
            fare = repr(float(rows["fare"][i])) if rows["fare_valid"][i] \
                else ""
            f.write(f"{marks[i % 3]},{int(rows['id'][i])},"
                    f"{int(rows['city_id'][i])},"
                    f"{STATUSES[rows['status'][i]]},{fare}\n")
    return rows


def write_examples(root: str, queries: dict, seed: int) -> dict:
    """The example dataset in cmd/examples.py's layout under root:
    schema/ (ex_trips, arraytest), data/ (ex_trips.csv with time
    placeholders; arraytest.csv, a header alone, since cmd_data generates
    that table's rows), queries/ (B2 and B8 over ex_trips as .aql, B7 as
    .sql, and the three array queries). Returns ex_trips' rows."""
    for sub in ("schema", "data", "queries"):
        os.makedirs(os.path.join(root, sub))

    def put(sub, name, doc):
        with open(os.path.join(root, sub, name), "w") as f:
            json.dump(doc, f)

    put("schema", "ex_trips.json", dict(SERVER_TRIPS_JSON, name="ex_trips"))
    put("schema", "arraytest.json", ARRAYTEST_SCHEMA_JSON)
    rows = ex_trips_csv(os.path.join(root, "data", "ex_trips.csv"), seed)
    with open(os.path.join(root, "data", "arraytest.csv"), "w") as f:
        f.write(",".join(c["name"] for c in ARRAYTEST_SCHEMA_JSON["columns"])
                + "\n")
    for name, shape in EX_QUERIES.items():
        q = queries[shape][1]
        q = (q.replace("FROM trips", "FROM ex_trips") if isinstance(q, str)
             else dict(q, table="ex_trips"))
        put("queries", name, {"queries": [q]})
    for name, extra in ARRAY_QUERIES.items():
        put("queries", name, {"queries": [dict(
            {"table": "arraytest", "timeFilter": ARRAY_WINDOW,
             "measures": [{"sqlExpression": "count(*)"}]}, **extra)]})
    return rows


def examples_answers(text: str) -> dict:
    """{query file's name: its response} from `examples query`'s output."""
    out = {}
    for block in text.split("=== ")[1:]:
        name, _, body = block.partition(" ===\n")
        out[name] = json.loads(body)
    return out


def arraytest_oracles(now: int) -> dict:
    """The three array queries' answers over gen_arraytest_batches(now),
    each row's arrays aligned with its own time (the aligned oracle of
    tests/test_integration_goldens.py:84-150): the window from the hour
    of 24 hours ago to the end of this quarter-hour, by day; length
    size - 1 (NULL for no array), contains(.., 20) for sizes 3 and 4,
    element_at(.., 0) = 10 for sizes 2 and up."""
    from collections import Counter

    from aresdb_tpu_torch.cmd.example_data import gen_arraytest_batches

    frm = (now - DAY) // 3600 * 3600
    to = now - now % 900 + 900
    rows = [(r[0], r[2]) for b in gen_arraytest_batches(now) for r in b
            if frm <= r[0] < to]

    def day(t):
        return time.strftime("%Y-%m-%d", time.gmtime(t))

    length = Counter((day(t), "NULL" if s == 0 else str(s - 1))
                     for t, s in rows)
    out = {"array_length": {}}
    for (d, n), c in length.items():
        out["array_length"].setdefault(d, {})[n] = float(c)
    out["array_contains"] = {d: float(c) for d, c in Counter(
        day(t) for t, s in rows if s >= 3).items()}
    out["array_element_at"] = {d: float(c) for d, c in Counter(
        day(t) for t, s in rows if s >= 2).items()}
    return out


def arraytest_now(port: int) -> int:
    """The `now` that `examples data` generated arraytest's rows at
    (cmd/examples.py reads the wall clock): the first row's time less its
    first draw, GoRand(0).int63n(DAY), plus a day."""
    from aresdb_tpu_torch.client.query import QueryClient
    from aresdb_tpu_torch.utils.gorand import GoRand

    resp = QueryClient(f"localhost:{port}").query_aql([{
        "table": "arraytest", "measures": [{"sqlExpression": "1"}],
        "dimensions": [{"sqlExpression": "request_at"}],
        "rowFilters": ["uuid = '00000000-0000-0000-0000-000000000001'"],
        "limit": 1}])
    ((first,),) = resp["results"][0]["matrixData"]
    return int(first) - GoRand(0).int63n(DAY) + DAY


def examples_step(port: int, root: str, queries: dict, seed: int,
                  sched) -> dict:
    """cmd.examples' tables, data and query over a dataset written under
    root (write_examples), against the daemon at port beside its trips:
    the tables created, 3,000 ex_trips rows and arraytest's 4,000
    generated rows inserted, and every query document's answer held: B2,
    B8 and B7 against a numpy oracle over ex_trips, the array queries
    against arraytest_oracles with the port's clock at the data's `now`.
    Returns each subcommand's seconds."""
    import io

    from aresdb_tpu_torch.cmd import examples
    from aresdb_tpu_torch.utils import clock

    rows = write_examples(root, queries, seed)
    seconds, texts = {}, {}
    # cmd_data times its rows by the wall clock, and the daemon skips rows
    # later than its own clock: the port's clock follows the wall until
    # the queries, with the scheduler paused so that nothing archives
    sched.disable()
    clock.reset_clock()
    for cmd in ("tables", "data", "query"):
        if cmd == "query":
            clock.set_current_time(arraytest_now(port))
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            examples.main([cmd, "--dataset", root, "--host", "localhost",
                           "--port", str(port)])
        seconds[cmd] = time.perf_counter() - t0
        texts[cmd] = buf.getvalue()
    if texts["tables"].split() != ["created", "table", "arraytest",
                                   "created", "table", "ex_trips"]:
        raise AssertionError(f"examples tables: {texts['tables']}")
    if "arraytest: 4000 rows" not in texts["data"]:
        raise AssertionError(f"examples data: {texts['data']}")
    got = examples_answers(texts["query"])
    oracles = arraytest_oracles(clock.now())
    for name, want in oracles.items():
        if got[name] != {"results": [want]}:
            raise AssertionError(f"examples {name}: {got[name]} against "
                                 f"the aligned oracle {want}")
    for name, shape in EX_QUERIES.items():
        answer = got[os.path.splitext(name)[0]]
        if "errors" in answer:
            raise AssertionError(f"examples {name}: {answer['errors']}")
        check_server(shape, answer["results"][0], rows)
    return seconds


def phase_stream(n_rows: int, seed: int, warm: int = 5, device=None,
                 batch_rows: int = BATCH_ROWS, new_rows: int = STREAM_NEW,
                 update_rows: int = STREAM_UPDATES,
                 deadline: float = STREAM_DEADLINE) -> tuple:
    """The deployment fed and queried as its users do. The port's
    controller and one daemon (cmd.aresd.build_server on the device, over
    a temporary root, the port's clock frozen at SERVER_NOW) in this
    process. Through the client: the battery's trips and cities created,
    n_rows trips loaded by Connector.insert_columns (two producers,
    upserts of batch_rows; timed in rows/s) and the cities by
    Connector.insert. Then a JSON-lines file of the stream
    (stream_events: new_rows new trips, update_rows updates, malformed
    lines) posted as a subscriber job to the controller, and `python -m
    aresdb_tpu_torch.cmd.subscriber` started as a process of its own: it
    syncs the job and streams the file through AresSink into the daemon,
    while a reader thread polls count(*) through QueryClient (each answer
    monotone and between n_rows and n_rows + new_rows); the phase waits,
    at most `deadline` seconds, for the final count (timed in events/s).
    Then the 14 shapes through QueryClient (AQL, SQL with query_sql, B3
    and B4 also as query_hll frames, their bytes the CPU run's), one cold
    and `warm` warm runs each with each kernel's launches asserted as in
    phase_server, each answer against the numpy oracle of the final rows
    and the CPU service over the same store; arescli (arescli_step); and
    the example tools (examples_step). Returns each kernel's launches
    over the shapes' runs, and {} per kernel."""
    from concurrent.futures import ThreadPoolExecutor

    from aresdb_tpu_torch.client import Connector
    from aresdb_tpu_torch.client.query import QueryClient
    from aresdb_tpu_torch.cmd import aresd
    from aresdb_tpu_torch.common.config import AresServerConfig
    from aresdb_tpu_torch.controller.server import ControllerServer
    from aresdb_tpu_torch.controller.state import ControllerState
    from aresdb_tpu_torch.query import executor as X
    from aresdb_tpu_torch.query import hll_wire as W
    from aresdb_tpu_torch.query.service import QueryService
    from aresdb_tpu_torch.utils import clock

    counters = kernel_counters()
    totals = dict.fromkeys(counters, 0)
    runs = 1 + warm
    queries = server_queries()
    data = server_rows(n_rows, seed)
    final_count = n_rows + new_rows
    stack = []
    t_phase = time.perf_counter()
    clock.set_current_time(SERVER_NOW)
    with tempfile.TemporaryDirectory() as root:
        try:
            ctrl = ControllerServer(ControllerState(f"{root}/ctrl"))
            cport = ctrl.start_background()
            stack.append(ctrl.stop)
            cfg = AresServerConfig.load(None, {"root_path": f"{root}/ares",
                                               "port": 0})
            server, ms, sched = aresd.build_server(cfg, device=device)
            port = server.start_background()
            stack.append(lambda: shut_down(server, ms, sched))
            conn = Connector("localhost", port)
            load_s = load_battery(conn, data, batch_rows, "stream")
            print(f"stream: {n_rows} rows bulk-loaded through "
                  f"Connector.insert_columns by 2 producers in {load_s:.3f} "
                  f"s ({n_rows / load_s:.0f} rows/s)", flush=True)

            t0 = time.perf_counter()
            lines, final = stream_events(data, new_rows, update_rows, seed)
            path = f"{root}/trips-events.jsonl"
            with open(path, "w") as f:
                f.write("\n".join(lines) + "\n")
            print(f"stream: {len(lines)} JSON lines ({new_rows} new trips, "
                  f"{update_rows} updates, {STREAM_MALFORMED} malformed; "
                  f"{os.path.getsize(path)} bytes) written in "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)
            http(cport, "namespaces", {"namespace": STREAM_NS})
            http(cport, f"config/{STREAM_NS}/jobs", stream_job(path, port))

            client = QueryClient(f"localhost:{port}")
            count_q = {"table": "trips", "now": SERVER_NOW,
                       "measures": [{"sqlExpression": "count(*)"}]}
            seen, polls, reader_errors = [], [], []
            done = threading.Event()

            def count() -> int:
                t = time.perf_counter()
                resp = client.query_aql([count_q])
                polls.append(time.perf_counter() - t)
                if "errors" in resp:
                    raise AssertionError(f"stream count: {resp['errors']}")
                return int(resp["results"][0][""])

            def reader():
                try:
                    while not done.is_set():
                        n = count()
                        if not n_rows <= n <= final_count or \
                                (seen and n < seen[-1]):
                            raise AssertionError(f"stream: count {n} after "
                                                 f"{seen[-3:]}")
                        seen.append(n)
                        if n == final_count:
                            return
                        done.wait(0.1)
                except Exception as e:  # noqa: BLE001 — reported below
                    reader_errors.append(e)

            log = []
            t_start = time.perf_counter()
            proc = subprocess.Popen(
                [sys.executable, "-m", "aresdb_tpu_torch.cmd.subscriber",
                 "--controller", f"localhost:{cport}", "--namespace",
                 STREAM_NS, "--name", "sub1", "--sink-port", str(port)],
                cwd=str(Path(__file__).resolve().parent),
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
            stack.append(lambda: (proc.terminate(), proc.wait(timeout=60)))
            threading.Thread(target=lambda: log.extend(proc.stderr),
                             daemon=True).start()
            state = ctrl.state
            wait_for(lambda: STREAM_JOB in state.ns(STREAM_NS)
                     .assignments.get("sub1", []),
                     "the controller to assign the job", 60, proc, log)
            assigned_s = time.perf_counter() - t_start
            watcher = threading.Thread(target=reader, daemon=True)
            watcher.start()
            try:
                wait_for(lambda: not watcher.is_alive(),
                         "the stream's final count", deadline, proc, log)
            except AssertionError as e:
                raise AssertionError(f"{e}\n(counts reached {seen[-3:]} "
                                     f"of {final_count})") from None
            finally:
                done.set()
            stream_s = time.perf_counter() - t_start
            if reader_errors:
                raise AssertionError(f"stream: {reader_errors[0]} (counts "
                                     f"reached {seen[-3:]})")
            if seen[-1] != final_count or count() != final_count:
                raise AssertionError(f"stream: count {seen[-1]}, expected "
                                     f"{final_count}")
            events = new_rows + update_rows
            rate = events / stream_s
            upserts = -(-len(lines) // STREAM_BATCH)
            print(f"stream: the subscriber (a process of its own) had the "
                  f"job {assigned_s:.3f} s after its start; {events} events "
                  f"landed {stream_s:.3f} s after its start ({rate:.0f} "
                  f"events/s, {upserts} upserts of up to {STREAM_BATCH} "
                  "rows); "
                  f"{len(seen)} reader polls through QueryClient, each "
                  f"monotone within [{n_rows}, {final_count}], median "
                  f"{1e3 * float(np.median(polls)):.3f} ms", flush=True)

            store = server.ctx.memstore
            shard = store.get_table_shard("trips")
            cpu = QueryService(store, device="cpu")
            cpu_answers = {name: json.loads(json.dumps(ask(cpu, name, q)[0]))
                           for name, (_, q) in queries.items()}
            layout = atrips_layout(shard, X.ShardExecutor.ARCHIVE_CHUNK_ROWS)
            answers = {}

            def send(name, i):
                route, q = queries[name]
                resp = (client.query_aql([q]) if route == "aql"
                        else client.query_sql([q]))
                if "errors" in resp:
                    raise AssertionError(f"stream {name}: {resp['errors']}")
                return resp["results"][0]

            for name, answer, times, got in run_battery(
                    "stream", queries, send, runs, counters, totals,
                    server_launches, layout, final, cpu_answers):
                answers[name] = answer
                print(f"stream {name}: cold {1e3 * times[0]:.3f} ms, warm "
                      f"median {1e3 * float(np.median(times[1:])):.3f} ms "
                      "through QueryClient, launches "
                      + " ".join(f"{k}={v}" for k, v in got.items()),
                      flush=True)
            for name in SERVER_HLL:
                q = queries[name][1]
                results, errors = client.query_hll([q])
                estimate = json.loads(json.dumps(results[0]))
                frame = client.session.post(
                    f"{client.base}/query/aql", json={"queries": [q]},
                    headers={"Accept": W.CONTENT_TYPE}).content
                if errors != [None] or estimate != answers[name] or \
                        frame != cpu.handle_aql_hll({"queries": [q]}):
                    raise AssertionError(f"stream {name}: the query_hll "
                                         "frame differs")
                print(f"stream {name}: query_hll's estimates equal the JSON "
                      f"answer; its frame of {len(frame)} bytes is the cpu "
                      "run's", flush=True)
            print(f"stream: live batches {len(layout['live'])}; every shape "
                  "equals the numpy oracle of the final rows and the cpu "
                  "run", flush=True)

            cli_ms = arescli_step(port, answers, queries)
            print("stream arescli: every statement's output equals "
                  "QueryClient's answers; ms a statement: " + ", ".join(
                      f"{k} {v:.3f}" for k, v in cli_ms.items()), flush=True)
            ex_s = examples_step(port, f"{root}/examples", queries, seed,
                                 sched)
            print("stream examples: tables, data and query against the "
                  "daemon; B2, B8 and B7 equal the numpy oracle, the array "
                  "length, contains and element_at queries the aligned "
                  "oracles; seconds " + ", ".join(
                      f"{k} {v:.3f}" for k, v in ex_s.items()), flush=True)
            if proc.poll() is not None:
                raise AssertionError(f"the subscriber exited:\n"
                                     f"{''.join(log)}")
            print(f"stream: the phase took {time.perf_counter() - t_phase:.3f}"
                  " s", flush=True)
        finally:
            for stop in reversed(stack):
                try:
                    stop()
                except Exception as e:  # noqa: BLE001 — stop the rest
                    print(f"stream: stopping: {e!r}", file=sys.stderr)
            clock.reset_clock()
    return totals, {k: {} for k in counters}


# the 100M-row deployment of tools/drive_100m.py (phase_hundredm): its
# trips schema (:41-51), 100M rows in upserts of 1 << 22 from seed 3 over
# four days before NOW, WAL on, under a 0.9 GB host budget
HUNDREDM_ROWS = 100_000_000
HUNDREDM_BATCH = 1 << 22
HUNDREDM_SEED = 3
HUNDREDM_BUDGET = 900_000_000
HUNDREDM_NOW = 1_600_000_000
HUNDREDM_BASE = HUNDREDM_NOW - HUNDREDM_NOW % DAY - 4 * DAY
HUNDREDM_CITIES = 300
HUNDREDM_HOURS = 4 * 24
HUNDREDM_MODULUS = 200_000
HUNDREDM_TIGHTEN = 0.7        # the budget's share of the managed bytes
HUNDREDM_WARM = 3
HUNDREDM_RTOL = 1e-5          # sums; counts exactly
HUNDREDM_SCHEMA_JSON = {
    "name": "trips",
    "columns": [{"name": "request_at", "type": "Uint32"},
                {"name": "id", "type": "Uint32"},
                {"name": "city_id", "type": "Uint16"},
                {"name": "status", "type": "SmallEnum"},
                {"name": "fare", "type": "Float32"}],
    "primaryKeyColumns": [1], "archivingSortColumns": [2, 3],
    "isFactTable": True,
    "config": {"batchSize": HUNDREDM_BATCH, "recordRetentionInDays": 0}}


def hundredm_queries() -> dict:
    """The drive's seven shapes in its order (tools/drive_100m.py:125-217):
    name -> (query, environment, its kind for the launches and the
    oracle). The Archiver runs between the second and the third; the
    budget is tightened before the seventh."""
    def q(measure, *dims, filters=()):
        return {"table": "trips", "now": HUNDREDM_NOW,
                "measures": [{"sqlExpression": measure,
                              "rowFilters": list(filters)}],
                "dimensions": [d if isinstance(d, dict)
                               else {"sqlExpression": d} for d in dims]}

    by_city = q("sum(fare)", "city_id")
    city_status = q("count(*)", "city_id", "status")
    return {
        "live sum by city": (by_city, {}, "city"),
        "live completed hour x city": (
            q("sum(fare)", {"sqlExpression": "request_at",
                            "timeBucketizer": "hour"}, "city_id",
              filters=["status='completed'"]), {}, "hour"),
        "archive count city x status": (city_status, {}, "city_status"),
        "archive sum by city": (by_city, {}, "city"),
        "archive count city x status, ARES_RUNLEN=1": (
            city_status, {"ARES_RUNLEN": "1"}, "runlen"),
        f"archive id % {HUNDREDM_MODULUS} sum": (
            q("sum(fare)", f"id % {HUNDREDM_MODULUS}"), {}, "modulus"),
        "archive sum by city, after eviction": (by_city, {}, "city"),
    }


class HundredmOracle:
    """The drive's answers from np.bincount over each upsert's rows as it
    is built: sum(fare) by city, completed sum(fare) by hour x city (and
    its row counts, for the groups present), rows by city x status, and
    sum(fare) and rows by id % HUNDREDM_MODULUS."""

    def __init__(self):
        c, h, m = HUNDREDM_CITIES, HUNDREDM_HOURS, HUNDREDM_MODULUS
        self.city_fare = np.zeros(c)
        self.hour_city_fare = np.zeros(h * c)
        self.hour_city_rows = np.zeros(h * c, np.int64)
        self.city_status_rows = np.zeros(c * 3, np.int64)
        self.mod_fare = np.zeros(m)
        self.mod_rows = np.zeros(m, np.int64)

    def add(self, ts, ids, city, status, fare) -> None:
        c, h, m = HUNDREDM_CITIES, HUNDREDM_HOURS, HUNDREDM_MODULUS
        city = city.astype(np.int64)
        fare = fare.astype(np.float64)
        done = status == 0
        hc = ((ts.astype(np.int64) - HUNDREDM_BASE) // 3600) * c + city
        self.city_fare += np.bincount(city, fare, c)
        self.hour_city_fare += np.bincount(hc[done], fare[done], h * c)
        self.hour_city_rows += np.bincount(hc[done], minlength=h * c)
        self.city_status_rows += np.bincount(city * 3 + status, minlength=3 * c)
        mod = ids.astype(np.int64) % m
        self.mod_fare += np.bincount(mod, fare, m)
        self.mod_rows += np.bincount(mod, minlength=m)

    def want(self, kind: str) -> dict:
        """{(dim values...): measure} of a kind of shape, as flatten()
        gives an answer: every group that holds a row."""
        c = HUNDREDM_CITIES
        if kind == "city":
            return {(str(k),): v for k, v in enumerate(self.city_fare)}
        if kind == "hour":
            return {(time.strftime("%Y-%m-%d %H:00", time.gmtime(
                HUNDREDM_BASE + k // c * 3600)), str(k % c)):
                self.hour_city_fare[k]
                for k in np.flatnonzero(self.hour_city_rows).tolist()}
        if kind in ("city_status", "runlen"):
            return {(str(k // 3), STATUSES[k % 3]): float(n)
                    for k, n in enumerate(self.city_status_rows.tolist())
                    if n}
        return {(str(k),): self.mod_fare[k]
                for k in np.flatnonzero(self.mod_rows).tolist()}

    def check(self, name: str, kind: str, answer: dict) -> None:
        """Every group of the answer against the oracle: counts exactly,
        sums within HUNDREDM_RTOL."""
        got, want = flatten(answer), self.want(kind)
        if set(got) != set(want):
            raise AssertionError(f"hundredm {name}: {len(got)} groups, the "
                                 f"oracle {len(want)}")
        exact = kind in ("city_status", "runlen")
        for k, v in want.items():
            g = got[k]
            if (g != v) if exact else (abs(g - v) > HUNDREDM_RTOL * abs(v)):
                raise AssertionError(f"hundredm {name}: {k} {g} against "
                                     f"the oracle's {v}")


def hundredm_rows(n_rows: int, seed: int, batch_rows: int):
    """The drive's upserts (tools/drive_100m.py:63-83), one at a time:
    (request_at, id, city_id, status, fare) of batch_rows rows each, ids
    from 0, drawn from one RandomState(seed) in the drive's order."""
    rng = np.random.RandomState(seed)
    for off in range(0, n_rows, batch_rows):
        m = min(batch_rows, n_rows - off)
        ts = (HUNDREDM_BASE + rng.randint(0, 4 * DAY, m)).astype(np.uint32)
        city = rng.randint(0, HUNDREDM_CITIES, m).astype(np.uint16)
        status = rng.randint(0, 3, m).astype(np.uint8)
        fare = (rng.rand(m) * 50).astype(np.float32)
        yield ts, np.arange(off, off + m, dtype=np.uint32), city, status, fare


def hundredm_launches(kind: str, runs: int, layout: dict) -> dict:
    """Each kernel's launches over `runs` runs of a shape: a dense shape's
    K1 on every batch or chunk of at least FD_MIN_ROWS padded rows (K2 on
    the others); the run-length shape's K2 on every archive chunk; the
    200k-group shape sorts its chunks (index_add_, past K2's 65,536
    slots) and reduces each live batch, whose rows all lie behind the
    archiving cutoff, through the runtime-dense branch's K2 (no live key:
    one slot)."""
    if kind == "modulus":
        return {"K1": 0, "K2": runs * len(layout["live"]), "K3": 0}
    if kind == "runlen":
        return atrips_launches("A4", runs, layout)
    return atrips_launches("A1", runs, layout)


def cache_line(stats: dict) -> str:
    return (f"{stats['entries']} entries, {stats['bytes']} bytes, "
            f"{stats['hits']} hits, {stats['misses']} misses")


def phase_hundredm(n_rows: int = HUNDREDM_ROWS, seed: int = HUNDREDM_SEED,
                   warm: int = HUNDREDM_WARM, device=None,
                   batch_rows: int = HUNDREDM_BATCH,
                   budget: int = HUNDREDM_BUDGET, cache_bytes=None) -> tuple:
    """tools/drive_100m.py on the port: n_rows of its trips through a
    MemStore with its redo log (WAL) on and total_memory_bytes = budget,
    its host-memory workers running, in upserts of batch_rows; the oracle
    (HundredmOracle) built beside the ingest, outside its timing. Then
    the drive's seven shapes (hundredm_queries) on `device` through a
    QueryService whose executor has a column cache of its own (cache_bytes,
    else the device's budget): one cold and `warm` warm runs each, each
    answer against the oracle, each kernel's launches held to
    hundredm_launches, a profiled warm run's device busy share and each
    kernel's ms a launch in it, the cache's stats before and after and its
    misses on each warm run; the Archiver over every row after the
    second; before the seventh the budget tightened to HUNDREDM_TIGHTEN x
    the managed bytes and the eviction triggered, so that columns evict
    and reload from disk. Fails unless a column was evicted and the
    managed bytes end within 1.2 x the tightened budget
    (tools/drive_100m.py:226-227). The store and the cache are released
    at the end. Returns each kernel's launches, {kernel: {shape: device
    ms a launch}} and {shape: answer}."""
    from aresdb_tpu_torch.common import data_types as mdt
    from aresdb_tpu_torch.common.schema import Table
    from aresdb_tpu_torch.common.upsert_batch import (UpsertBatch,
                                                      build_columnar_upsert)
    from aresdb_tpu_torch.diskstore.local_diskstore import LocalDiskStore
    from aresdb_tpu_torch.memstore import archive_store as AS
    from aresdb_tpu_torch.memstore.archiving import Archiver
    from aresdb_tpu_torch.memstore.memstore import MemStore
    from aresdb_tpu_torch.metastore.disk_metastore import DiskMetaStore
    from aresdb_tpu_torch.query import executor as X
    from aresdb_tpu_torch.query.service import QueryService

    counters = kernel_counters()
    totals = dict.fromkeys(counters, 0)
    in_situ = {k: {} for k in counters}
    answers = {}
    evictions = [0]
    real_evict = AS.ArchiveBatch.evict_column

    def evict_column(self, column_id):
        out = real_evict(self, column_id)
        evictions[0] += bool(out)
        return out

    oracle = HundredmOracle()
    svc = cache = None
    with tempfile.TemporaryDirectory() as root:
        ms = MemStore(DiskMetaStore(root), LocalDiskStore(root),
                      total_memory_bytes=budget)
        AS.ArchiveBatch.evict_column = evict_column
        try:
            ms.create_table(Table.from_json(dict(
                HUNDREDM_SCHEMA_JSON, config={"batchSize": batch_rows,
                                              "recordRetentionInDays": 0})))
            ms.init_shards()
            ms.get_schemas()["trips"].extend_enum("status", STATUSES)
            hmm = ms.host_memory_manager
            hmm.start()
            shard = ms.get_table_shard("trips")
            ingest_s = 0.0
            for ts, ids, city, status, fare in hundredm_rows(
                    n_rows, seed, batch_rows):
                blob = build_columnar_upsert(
                    [(0, mdt.Uint32, ts, None, 0),
                     (1, mdt.Uint32, ids, None, 0),
                     (2, mdt.Uint16, city, None, 0),
                     (3, mdt.SmallEnum, status, None, 0),
                     (4, mdt.Float32, fare, None, 0)], len(ids))
                t0 = time.perf_counter()
                shard.save_upsert_batch(UpsertBatch(blob))
                ingest_s += time.perf_counter() - t0
                oracle.add(ts, ids, city, status, fare)
            print(f"hundredm: {n_rows} rows ingested in {ingest_s:.3f} s "
                  f"({n_rows / ingest_s:.0f} rows/s, redo log on, upserts "
                  f"of {batch_rows}), host budget {budget} bytes, "
                  f"{hmm.get_reserved_memory()} bytes held", flush=True)

            svc = QueryService(ms, device=device)
            cache = X.DeviceColumnCache(cache_bytes)
            svc.executor = X.ShardExecutor(ms, svc.device,
                                           device_cache=cache)
            gpu = svc.device.type == "cuda"
            if gpu:
                torch.cuda.reset_peak_memory_stats()
            print(f"hundredm: the column cache's budget on {svc.device}: "
                  f"{cache.budget(svc.device)} bytes", flush=True)
            runs = 1 + warm
            tight = None
            archived = False
            for name, (q, env, kind) in hundredm_queries().items():
                if name.startswith("archive") and not archived:
                    archived = True
                    t0 = time.perf_counter()
                    stats = Archiver(shard, ms.metastore, ms.diskstore) \
                        .archive(HUNDREDM_BASE + 4 * DAY)
                    archive_s = time.perf_counter() - t0
                    if stats.rows_archived != n_rows:
                        raise AssertionError(f"hundredm: archived "
                                             f"{stats.rows_archived} rows")
                    print(f"hundredm: the Archiver archived "
                          f"{stats.rows_archived} rows in {archive_s:.3f} s "
                          f"({stats.rows_archived / archive_s:.0f} rows/s); "
                          f"{hmm.get_reserved_memory()} bytes held",
                          flush=True)
                if name.endswith("after eviction"):
                    managed = hmm.get_reserved_memory()
                    tight = int(managed * HUNDREDM_TIGHTEN)
                    hmm.total_memory_bytes = tight
                    hmm.trigger_eviction()
                    deadline = time.monotonic() + 30
                    while hmm.get_reserved_memory() > tight and \
                            time.monotonic() < deadline:
                        time.sleep(0.1)
                    print(f"hundredm: budget tightened to {tight} bytes "
                          f"({HUNDREDM_TIGHTEN} x the {managed} held); "
                          f"{evictions[0]} columns evicted so far, "
                          f"{hmm.get_reserved_memory()} bytes held",
                          flush=True)
                layout = atrips_layout(shard, X.ShardExecutor
                                       .ARCHIVE_CHUNK_ROWS)
                rec = hundredm_run(svc, cache, name, q, env, runs,
                                   counters, hundredm_launches(
                                       kind, runs, layout))
                oracle.check(name, kind, rec["answer"])
                answers[name] = rec["answer"]
                for k in totals:
                    totals[k] += rec["launches"][k]
                for k, v in rec["in_situ"].items():
                    in_situ[k]["hundredm " + name] = v
                hundredm_report(name, rec, n_rows, layout)
            managed = hmm.get_reserved_memory()
            peak = (torch.cuda.max_memory_allocated(svc.device) if gpu
                    else None)
            print(f"hundredm: {evictions[0]} columns evicted; {managed} "
                  f"bytes held against the tightened budget {tight} "
                  f"({managed / tight:.3f} x); the card's peak allocated "
                  f"{peak} bytes; every shape equals the numpy oracle",
                  flush=True)
            if evictions[0] < 1:
                raise AssertionError("hundredm: no column was evicted")
            if managed > 1.2 * tight:
                raise AssertionError(f"hundredm: {managed} bytes held over "
                                     f"1.2 x the budget {tight}")
        finally:
            AS.ArchiveBatch.evict_column = real_evict
            close_memstore(ms)
            del svc, cache
    return totals, in_situ, answers


def hundredm_run(svc, cache, name, q, env, runs, counters, want) -> dict:
    """One shape `runs` times (each kernel's launches set to 0 just before
    and read just after; raises unless they equal `want`), its cache's
    stats before and after and its misses on each run, then once under
    the profiler on the card."""
    from aresdb_tpu_torch.query import executor as X

    with query_setting(X, env, False):
        before = cache.stats()
        for c in counters.values():
            c.launches = 0
        times, contexts, misses = [], [], []
        for _ in range(runs):
            m0 = cache.stats()["misses"]
            t0 = time.perf_counter()
            answer, ctx = ask(svc, name, q)
            if svc.device.type == "cuda":
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            contexts.append(ctx)
            misses.append(cache.stats()["misses"] - m0)
        got = {k: c.launches for k, c in counters.items()}
        if got != want:
            raise AssertionError(f"hundredm {name}: launches {got}, "
                                 f"expected {want}")
        after = cache.stats()
        events, in_situ = [], {}
        if svc.device.type == "cuda":
            def profiled_run():
                for c in counters.values():
                    c.launches = 0
                ask(svc, name, q)

            events = device_events(profiled_run, 1)
            for k, c in counters.items():
                if c.launches and len(kernel_events(events, k)) != c.launches:
                    events = counted_events(profiled_run, 1, k, c.launches)
            # a kernel's ms a launch only where the trace holds every one
            for k, c in counters.items():
                if c.launches and len(kernel_events(events, k)) == c.launches:
                    in_situ[k] = (sum(kernel_events(events, k)) / 1e3
                                  / c.launches)
    return dict(answer=answer, contexts=contexts, times=times, launches=got,
                events=events, in_situ=in_situ, misses=misses,
                cache=(before, after))


def hundredm_report(name: str, rec: dict, n_rows: int, layout: dict) -> None:
    times = 1e3 * np.array(rec["times"])
    warm = times[1:]
    med = float(np.median(warm))
    busy = sum(us for _, us in rec["events"]) / 1e3
    last = rec["contexts"][-1] or {}
    print(f"hundredm {name}: cold {times[0]:.3f} ms, warm median "
          f"{med:.3f} ms (min {warm.min():.3f}, max {warm.max():.3f}, "
          f"{len(warm)} runs; {n_rows / med * 1e3:.0f} rows/s), "
          f"{len(flatten(rec['answer']))} groups, launches "
          + " ".join(f"{k}={v}" for k, v in rec["launches"].items())
          + f" over {len(layout['live'])} live batches and "
          f"{len(layout['chunks'])} archive chunks, host fetches cold "
          f"{(rec['contexts'][0] or {}).get('hostFetches')} warm "
          f"{last.get('hostFetches')}", flush=True)
    print(f"hundredm {name} last warm run, seconds by stage: "
          + ", ".join(f"{k}={v:.6f}" for k, v in last.items()
                      if isinstance(v, float)), flush=True)
    if rec["events"]:
        print(f"hundredm {name} warm run under the profiler: device busy "
              f"{busy:.3f} ms = {100 * busy / med:.1f}% of the warm median"
              + "".join(f"; {k} {v:.4f} ms a launch"
                        for k, v in rec["in_situ"].items()), flush=True)
    print(f"hundredm {name} column cache: before {cache_line(rec['cache'][0])}"
          f"; after {cache_line(rec['cache'][1])}; misses by run "
          f"{rec['misses']}", flush=True)


def start_daemon(args, what: str, timeout: float = 600,
                 module: str = "aresdb_tpu_torch.cmd.aresd") -> tuple:
    """`python -m MODULE ARGS` (the daemon, or another of the port's
    commands whose start-up line names its port) as a process of its own
    from the repository's root, its standard error read into a list by a
    thread; waits for its start-up line. Returns (process, port, the
    lines of its standard error, seconds to the line)."""
    log = []
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", module, *args],
        cwd=str(Path(__file__).resolve().parent),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    threading.Thread(target=lambda: log.extend(proc.stderr),
                     daemon=True).start()
    try:
        wait_for(lambda: any(" serving on :" in x for x in log), what,
                 timeout, proc, log)
    except BaseException:
        kill(proc)
        raise
    line = next(x for x in log if " serving on :" in x)
    return (proc, int(line.split(" on :")[1].split()[0]), log,
            time.perf_counter() - t0)


def kill(proc) -> None:
    """SIGKILL a process of the phase (no flush, no clean stop) and reap
    it."""
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=60)


# tools/drive_crash.py's table and load: acked upserts through the
# Connector, one more in flight when the daemon is SIGKILLed
CRASH_SCHEMA_JSON = {
    "name": "t",
    "columns": [{"name": "ts", "type": "Uint32"},
                {"name": "id", "type": "Uint32"},
                {"name": "v", "type": "Float32"}],
    "primaryKeyColumns": [1], "isFactTable": True,
    "config": {"batchSize": 4096, "recordRetentionInDays": 0}}
CRASH_NOW = 1_600_000_000
CRASH_UPSERTS = 16
CRASH_UPSERT_ROWS = 1 << 17
CRASH_MORE = 1000
CRASH_QUERIES = [{"table": "t", "now": CRASH_NOW,
                  "measures": [{"sqlExpression": m}]}
                 for m in ("count(*)", "sum(v)")]


def crash_columns(lo: int, n: int, rng) -> dict:
    """n rows of t from id lo: times in the hour before CRASH_NOW, v whole
    numbers below 16, so that every sum is exact in float32."""
    return {"ts": (CRASH_NOW - rng.randint(0, 3600, n)).astype(np.uint32),
            "id": np.arange(lo, lo + n, dtype=np.uint32),
            "v": rng.randint(0, 16, n).astype(np.float32)}


def count_and_sum(port: int, queries) -> tuple:
    """(count(*), sum(v)) of one request of the two queries."""
    resp = http(port, "query/aql", {"queries": queries})
    if "errors" in resp:
        raise AssertionError(f"count and sum: {resp['errors']}")
    return tuple(float(r.get("", 0.0) or 0.0) for r in resp["results"])


def phase_crash(seed: int, device=None, upserts: int = CRASH_UPSERTS,
                upsert_rows: int = CRASH_UPSERT_ROWS,
                timeout: float = 600) -> dict:
    """tools/drive_crash.py on the port: `cmd.aresd` on `device` (its
    scheduler off, as the drive's server) over a temporary root, the
    drive's table t created through the Connector, `upserts` acked
    upserts of `upsert_rows` through Connector.insert_columns, one more
    sent from a thread, and the daemon SIGKILLed while it is in flight.
    A new daemon on the same root must answer count(*) and sum(v) equal to
    the acked rows' oracle, or that oracle with the in-flight upsert, and
    never fewer; then CRASH_MORE rows go in and are counted. A daemon
    that does not serve within `timeout` s fails the phase; every process
    is killed at the end. Returns {"restart_s", "acked", "in_flight"}."""
    from aresdb_tpu_torch.client import Connector
    from aresdb_tpu_torch.utils.torch_env import resolve_device

    dev = resolve_device(device)
    rng = np.random.RandomState(seed + 16)
    procs = []
    with tempfile.TemporaryDirectory() as root:
        args = ["--port", "0", "--root-path", root, "--device", dev.type,
                "--scheduler-off"]
        try:
            proc, port, log, _ = start_daemon(args, "aresd to serve",
                                              timeout)
            procs.append(proc)
            conn = Connector("localhost", port)
            conn.create_table(CRASH_SCHEMA_JSON)
            acked = [0.0, 0.0]
            t0 = time.perf_counter()
            for i in range(upserts):
                cols = crash_columns(i * upsert_rows, upsert_rows, rng)
                stats = conn.insert_columns("t", cols)
                if stats["inserted"] != upsert_rows:
                    raise AssertionError(f"crash: upsert {i}: {stats}")
                acked[0] += upsert_rows
                acked[1] += float(cols["v"].astype(np.float64).sum())
            load_s = time.perf_counter() - t0
            last = crash_columns(upserts * upsert_rows, upsert_rows, rng)
            flight = [acked[0] + upsert_rows,
                      acked[1] + float(last["v"].astype(np.float64).sum())]
            sent = {}

            def in_flight():
                try:
                    sent["stats"] = Connector("localhost", port) \
                        .insert_columns("t", last)
                except Exception as e:  # noqa: BLE001 — the kill cut it
                    sent["error"] = repr(e)

            writer = threading.Thread(target=in_flight, daemon=True)
            writer.start()
            time.sleep(0.02)
            kill(proc)
            writer.join(timeout=60)
            print(f"crash: {upserts} upserts of {upsert_rows} rows acked in "
                  f"{load_s:.3f} s; the daemon SIGKILLed with upsert "
                  f"{upserts + 1} in flight "
                  f"({'acked' if 'stats' in sent else 'not acked'}: "
                  f"{sent.get('stats') or sent.get('error')})", flush=True)

            t0 = time.perf_counter()
            proc, port, log, serve_s = start_daemon(
                args, "the restarted aresd to serve", timeout)
            procs.append(proc)
            got = count_and_sum(port, CRASH_QUERIES)
            restart_s = time.perf_counter() - t0
            if got != tuple(acked) and got != tuple(flight):
                raise AssertionError(
                    f"crash: the restarted daemon answers (count, sum) "
                    f"{got}; the acked rows hold {tuple(acked)}, with the "
                    f"in-flight upsert {tuple(flight)}")
            if "stats" in sent and got != tuple(flight):
                raise AssertionError(f"crash: the in-flight upsert was "
                                     f"acked, and the daemon answers {got}")
            more = crash_columns((upserts + 1) * upsert_rows, CRASH_MORE, rng)
            Connector("localhost", port).insert_columns("t", more)
            after = count_and_sum(port, CRASH_QUERIES)
            want = (got[0] + CRASH_MORE,
                    got[1] + float(more["v"].astype(np.float64).sum()))
            if after != want:
                raise AssertionError(f"crash: after {CRASH_MORE} more rows "
                                     f"the daemon answers {after}, not "
                                     f"{want}")
            print(f"crash: the restarted daemon served {serve_s:.3f} s after "
                  f"its start and answered {restart_s:.3f} s after it: "
                  f"count {got[0]:.0f}, sum(v) {got[1]:.1f} "
                  f"({'with' if got == tuple(flight) else 'without'} the "
                  f"in-flight upsert; every acked row held); then "
                  f"{CRASH_MORE} more rows counted: {after[0]:.0f}",
                  flush=True)
        finally:
            for p in procs:
                kill(p)
    return {"restart_s": restart_s, "acked": acked[0],
            "in_flight": got == tuple(flight)}


# tools/drive_rf2.py: two datanode processes holding both shards at
# replica factor 2; one is SIGKILLed and the broker answers from the other
RF2_NS = "rf2"
RF2_SHARDS = 2
RF2_SHARD_ROWS = 1 << 20
RF2_GROUPS = 16
RF2_FAILOVER_S = 30.0
RF2_QUERIES = [{"table": "t", "measures": [{"sqlExpression": m}],
                "dimensions": [{"sqlExpression": f"id % {RF2_GROUPS}"}]}
               for m in ("count(*)", "sum(v)")]


def rf2_answers(port: int, now: int) -> tuple:
    """(answers, errors) of RF2_QUERIES through the broker at port, each
    its own request."""
    out, errors = [], []
    for q in RF2_QUERIES:
        resp = http(port, "query/aql", {"queries": [dict(q, now=now)]})
        errors += [e for e in resp.get("errors") or [] if e]
        out.append({k: float(v) for k, v in
                    ((resp.get("results") or [{}])[0] or {}).items()})
    return out, errors


def phase_rf2(seed: int, device=None, shard_rows: int = RF2_SHARD_ROWS,
              timeout: float = 600) -> dict:
    """tools/drive_rf2.py on the port: the controller and a broker in this
    process, two datanodes as processes of their own (`cmd.aresd
    --controller`, on `device`, their clocks the wall's); the drive's
    table t at RF2_SHARDS shards and replica factor 2, each shard's
    shard_rows rows written to both replicas through
    Connector.insert_columns; count(*) and sum(v) by id % RF2_GROUPS
    through the broker equal to the oracle; then dn0 SIGKILLed, and the
    broker's answers must equal the oracle again within RF2_FAILOVER_S.
    A datanode that does not serve within `timeout` s fails the phase;
    every process is killed at the end. Returns {"failover_s"}."""
    from aresdb_tpu_torch.broker.server import BrokerServer
    from aresdb_tpu_torch.broker.validator import BrokerSchemaView
    from aresdb_tpu_torch.client import Connector
    from aresdb_tpu_torch.cluster.topology import DynamicTopology
    from aresdb_tpu_torch.controller.server import ControllerServer
    from aresdb_tpu_torch.controller.state import ControllerState
    from aresdb_tpu_torch.utils.torch_env import resolve_device

    dev = resolve_device(device)
    ns = RF2_NS
    rng = np.random.RandomState(seed + 2)
    stack = []
    with tempfile.TemporaryDirectory() as root:
        try:
            ctrl = ControllerServer(ControllerState(f"{root}/ctrl"))
            cport = ctrl.start_background()
            stack.append(ctrl.stop)
            caddr = f"localhost:{cport}"
            http(cport, "namespaces", {"namespace": ns})
            http(cport, f"schema/{ns}/tables", CRASH_SCHEMA_JSON)
            # both datanodes start at once: each takes seconds to its card
            starts = [None, None]

            def start(i):
                starts[i] = start_daemon(
                    ["--controller", caddr, "--namespace", ns, "--instance",
                     f"dn{i}", "--port", "0", "--root-path", f"{root}/dn{i}",
                     "--device", dev.type], f"dn{i} to serve", timeout)

            threads = [threading.Thread(target=start, args=(i,))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            for s in starts:
                if s is not None:
                    stack.append(lambda p=s[0]: kill(p))
            if None in starts:
                raise AssertionError("rf2: a datanode did not start")
            (p0, port0, log0, _), (p1, port1, log1, _) = starts
            http(cport, f"placement/{ns}/datanode",
                 {"numShards": RF2_SHARDS, "replicaFactor": 2,
                  "instances": ["dn0", "dn1"]})

            def placement():
                return http(cport, f"placement/{ns}/datanode")["shards"]

            wait_for(lambda: all(
                sd["instances"] == {"dn0": "Available", "dn1": "Available"}
                for sd in placement()), "both replicas Available", 120)
            topology = DynamicTopology(caddr, ns, poll_seconds=0.5)
            topology.start()
            stack.append(topology.stop)
            view = BrokerSchemaView(caddr, ns, poll_seconds=1.0)
            view.start()
            stack.append(view.stop)
            broker = BrokerServer(topology, schema_view=view)
            bport = broker.start_background()
            stack.append(broker.stop)

            now = int(time.time())
            ids, vs = [], []
            t0 = time.perf_counter()
            for sid in range(RF2_SHARDS):
                cols = {"ts": np.full(shard_rows, now - 30, np.uint32),
                        "id": np.arange(sid * shard_rows,
                                        (sid + 1) * shard_rows,
                                        dtype=np.uint32),
                        "v": rng.randint(0, 16, shard_rows)
                        .astype(np.float32)}
                for port in (port0, port1):
                    stats = Connector("localhost", port).insert_columns(
                        "t", dict(cols), shard_id=sid)
                    if stats["inserted"] != shard_rows:
                        raise AssertionError(f"rf2: shard {sid} on :{port}: "
                                             f"{stats}")
                ids.append(cols["id"])
                vs.append(cols["v"])
            load_s = time.perf_counter() - t0
            group = np.concatenate(ids).astype(np.int64) % RF2_GROUPS
            values = np.concatenate(vs).astype(np.float64)
            want = [{str(g): float(n) for g, n in enumerate(
                        np.bincount(group, minlength=RF2_GROUPS))},
                    {str(g): float(s) for g, s in enumerate(
                        np.bincount(group, values, RF2_GROUPS))}]
            got, errors = rf2_answers(bport, now)
            if errors or got != want:
                raise AssertionError(f"rf2: the broker answers {got} "
                                     f"{errors}, the oracle {want}")
            print(f"rf2: {RF2_SHARDS} shards of {shard_rows} rows written to "
                  f"both replicas (dn0 and dn1, processes on {dev.type}) in "
                  f"{load_s:.3f} s; count(*) and sum(v) by id % "
                  f"{RF2_GROUPS} through the broker equal the oracle",
                  flush=True)
            t0 = time.perf_counter()
            kill(p0)
            tries = 0
            while True:
                tries += 1
                try:
                    got, errors = rf2_answers(bport, now)
                except Exception as e:  # noqa: BLE001 — tried again
                    got, errors = None, [repr(e)]
                failover_s = time.perf_counter() - t0
                if not errors and got == want:
                    break
                if failover_s > RF2_FAILOVER_S:
                    raise AssertionError(f"rf2: {failover_s:.1f} s after "
                                         f"dn0's kill the broker answers "
                                         f"{got} {errors}")
                time.sleep(0.2)
            if p1.poll() is not None:
                raise AssertionError(f"rf2: dn1 exited:\n{''.join(log1)}")
            print(f"rf2: dn0 SIGKILLed; the broker's answers equal the "
                  f"oracle again {failover_s:.3f} s after the kill, on try "
                  f"{tries}", flush=True)
        finally:
            for stop in reversed(stack):
                try:
                    stop()
                except Exception as e:  # noqa: BLE001 — stop the rest
                    print(f"rf2: stopping: {e!r}", file=sys.stderr)
    return {"failover_s": failover_s}


# tools/drive_migrate_live.py: a shard moved while its source ingests and
# archives, three times over
MIGRATE_NS = "mig"
MIGRATE_SHARDS = 2
MIGRATE_BATCH = 2000
MIGRATE_CHURN_S = 0.3
MIGRATE_SCHEMA_JSON = {
    "name": "trips",
    "columns": [{"name": "request_at", "type": "Uint32"},
                {"name": "id", "type": "Uint32"},
                {"name": "fare", "type": "Float32"}],
    "primaryKeyColumns": [1], "isFactTable": True,
    "config": {"batchSize": 4096, "recordRetentionInDays": 3}}
# the moves: dn1 joins and a rebalance moves a shard to it; dn1's shard
# goes back to dn0 (a replace); a rebalance moves one to dn1 again
MIGRATE_MOVES = ("rebalance", ("dn1", "dn0"), "rebalance")


def migrate_counts(node, sid: int, counters: dict) -> tuple:
    """(rows below the shard's archiving cutoff, rows at or above it,
    the cutoff) of trips shard sid on an in-process datanode, through its
    HTTP query route with shards: [sid]: a count by `request_at >=
    cutoff`, and a count by hour whose groups add up to the same rows,
    its K1 launches held to the shard's batches and chunks of at least
    FD_MIN_ROWS padded rows."""
    from aresdb_tpu_torch.query import executor as X
    from aresdb_tpu_torch.query import fused_dense as FD

    shard = node.memstore.get_table_shard("trips", sid)
    cutoff = shard.archive_store.get_current_version().archiving_cutoff
    layout = atrips_layout(shard, X.ShardExecutor.ARCHIVE_CHUNK_ROWS)
    split, hours = ({"table": "trips", "shards": [sid],
                     "measures": [{"sqlExpression": "count(*)"}],
                     "dimensions": [dim]}
                    for dim in ({"sqlExpression": f"request_at >= {cutoff}"},
                                {"sqlExpression": "request_at",
                                 "timeBucketizer": "hour"}))
    resp = http(node.port, "query/aql", {"queries": [split]})
    for c in counters.values():
        c.launches = 0
    by_hour = http(node.port, "query/aql", {"queries": [hours]})
    got = {k: c.launches for k, c in counters.items()}
    for r in (resp, by_hour):
        if "errors" in r:
            raise AssertionError(f"migrate: shard {sid} count: "
                                 f"{r['errors']}")
    k1 = sum(n >= FD.FD_MIN_ROWS
             for n in layout["live"] + layout["chunks"])
    if got["K1"] != k1 or got["K3"]:
        raise AssertionError(f"migrate: shard {sid}'s count by hour "
                             f"launched {got}, K1 expected {k1}")
    r = resp["results"][0]
    below, above = int(r.get("0", 0)), int(r.get("1", 0))
    total = sum(flatten(by_hour["results"][0]).values())
    if total != below + above:
        raise AssertionError(f"migrate: shard {sid}: {below} + {above} "
                             f"rows, by hour {total}")
    return below, above, cutoff, got


def phase_migrate_live(seed: int, device=None, moves=MIGRATE_MOVES,
                       settle_s: float = 2.0) -> dict:
    """tools/drive_migrate_live.py on the port, in this process: the
    controller; dn0 (a DataNode over a root of its own, its scheduler on,
    the wall's clock) owning both shards of the drive's trips; a writer
    thread upserting MIGRATE_BATCH new ids at a time to every current
    owner of a shard (consistency-all, each owner with retries), half of
    them timed a day back (archivable at once) and half in the last hour;
    and a thread running archiving on every owned shard every
    MIGRATE_CHURN_S. Each move of `moves` runs under that traffic: a
    rebalance (dn1 started first) or a replace (leaving, joining),
    waited to every shard Available. Before and after each move the
    writer and the archiver pause, every owner drains (backfill, then
    archiving) and each shard is counted below and at or above its cutoff
    on its owner (migrate_counts, K1 asserted): a moved shard's rows on
    its new owner equal those on its old one with the rows acked to it
    during the move, and the broker's count(*) equals the acked ids
    exactly and its sum(fare) the acked fares' (whole eighths, so
    exact). Returns {"moves": [seconds of each move], "acked": rows}."""
    from aresdb_tpu_torch.broker.server import BrokerServer
    from aresdb_tpu_torch.cluster.topology import DynamicTopology
    from aresdb_tpu_torch.common import data_types as mdt
    from aresdb_tpu_torch.common.upsert_batch import build_columnar_upsert
    from aresdb_tpu_torch.controller.server import ControllerServer
    from aresdb_tpu_torch.controller.state import ControllerState
    from aresdb_tpu_torch.datanode.datanode import DataNode
    from aresdb_tpu_torch.diskstore.local_diskstore import LocalDiskStore
    from aresdb_tpu_torch.memstore.memstore import MemStore
    from aresdb_tpu_torch.memstore.scheduler import Scheduler
    from aresdb_tpu_torch.metastore.disk_metastore import DiskMetaStore
    from aresdb_tpu_torch.utils.torch_env import resolve_device

    dev = resolve_device(device)
    ns = MIGRATE_NS
    counters = kernel_counters()
    now = int(time.time())
    stack = []
    nodes = {}
    with tempfile.TemporaryDirectory() as root:
        try:
            ctrl = ControllerServer(ControllerState(f"{root}/ctrl"))
            cport = ctrl.start_background()
            stack.append(ctrl.stop)
            caddr = f"localhost:{cport}"
            http(cport, "namespaces", {"namespace": ns})
            http(cport, f"schema/{ns}/tables", MIGRATE_SCHEMA_JSON)

            def start_node(name):
                ms = MemStore(DiskMetaStore(f"{root}/{name}"),
                              LocalDiskStore(f"{root}/{name}"))
                node = DataNode(ms, Scheduler(ms), controller_address=caddr,
                                namespace=ns, instance_name=name,
                                heartbeat_seconds=0.4, poll_seconds=0.25,
                                device=dev)
                node.open()
                stack.append(lambda n=node: (n.close(),
                                             close_memstore(n.memstore)))
                node.serve()
                nodes[name] = node

            def placement():
                return http(cport, f"placement/{ns}/datanode")["shards"]

            def owners() -> dict:
                return {sd["shardId"]: sorted(sd["instances"])
                        for sd in placement()}

            def converged() -> bool:
                return all(set(sd["instances"].values()) == {"Available"}
                           for sd in placement())

            start_node("dn0")
            http(cport, f"placement/{ns}/datanode",
                 {"numShards": MIGRATE_SHARDS, "replicaFactor": 1,
                  "instances": ["dn0"]})
            wait_for(converged, "the placement", 60)

            stop, paused = threading.Event(), threading.Event()
            idle = [threading.Event(), threading.Event()]
            acked_by_shard = dict.fromkeys(range(MIGRATE_SHARDS), 0)
            fare_sum = [0.0]
            archive_runs, errors = [0], []

            def writer():
                rng = np.random.RandomState(seed + 4)
                next_id, nbatch = 1, 0
                try:
                    while not stop.is_set():
                        if paused.is_set():
                            idle[0].set()
                            time.sleep(0.01)
                            continue
                        idle[0].clear()
                        sid = nbatch % MIGRATE_SHARDS
                        nbatch += 1
                        ids = np.arange(next_id, next_id + MIGRATE_BATCH,
                                        dtype=np.uint32)
                        back = np.where(ids % 2 == 0, DAY, 0)
                        ts = (now - back - rng.randint(1, 3600, MIGRATE_BATCH)
                              ).astype(np.uint32)
                        fare = (rng.randint(0, 128, MIGRATE_BATCH) / 8
                                ).astype(np.float32)
                        payload = build_columnar_upsert(
                            [(0, mdt.Uint32, ts, None, 0),
                             (1, mdt.Uint32, ids, None, 0),
                             (2, mdt.Float32, fare, None, 0)], MIGRATE_BATCH)
                        ok = True
                        for name in owners()[sid]:
                            for _ in range(200):
                                try:
                                    http(nodes[name].port, f"data/trips/{sid}",
                                         payload)
                                    break
                                except Exception:  # noqa: BLE001 — retried
                                    time.sleep(0.05)
                            else:
                                ok = False
                        if ok:
                            acked_by_shard[sid] += MIGRATE_BATCH
                            fare_sum[0] += float(fare.astype(np.float64).sum())
                            next_id += MIGRATE_BATCH
                        time.sleep(0.01)
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(f"writer: {e!r}")

            def churner():
                while not stop.is_set():
                    if paused.is_set():
                        idle[1].set()
                        time.sleep(0.01)
                        continue
                    idle[1].clear()
                    for node in list(nodes.values()):
                        for sid in sorted(node.owned_shards):
                            try:
                                node.scheduler.run_job("trips", sid,
                                                       "archiving")
                                archive_runs[0] += 1
                            except KeyError:
                                pass   # the shard left the node meanwhile
                            except Exception as e:  # noqa: BLE001
                                errors.append(f"archiving {sid}: {e!r}")
                    time.sleep(MIGRATE_CHURN_S)

            def pause() -> None:
                for e in idle:
                    e.clear()
                paused.set()
                for e in idle:
                    if not e.wait(120):
                        raise AssertionError("migrate: traffic did not pause")
                for node in nodes.values():
                    for sid in sorted(node.owned_shards):
                        for job in ("backfill", "archiving"):
                            node.scheduler.run_job("trips", sid, job)

            topology = DynamicTopology(caddr, ns, poll_seconds=0.25)
            topology.start()
            stack.append(topology.stop)
            broker = BrokerServer(topology)
            bport = broker.start_background()
            stack.append(broker.stop)

            def check(stage: str) -> dict:
                """Each shard counted on its owner; the broker's count and
                sum against the acks."""
                topology.refresh()
                counts = {}
                for sid, names in sorted(owners().items()):
                    (name,) = names
                    counts[sid] = (name,) + migrate_counts(
                        nodes[name], sid, counters)[:3]
                    below, above = counts[sid][1:3]
                    if below + above != acked_by_shard[sid]:
                        raise AssertionError(
                            f"migrate {stage}: shard {sid} on {name} holds "
                            f"{below} + {above} rows, "
                            f"{acked_by_shard[sid]} acked")
                resp = http(bport, "query/aql", {"queries": [
                    {"table": "trips", "now": now,
                     "measures": [{"sqlExpression": m}],
                     "timeFilter": {"column": "request_at",
                                    "from": "30 days ago"}}
                    for m in ("count(*)", "sum(fare)")]})
                if resp.get("errors") and any(resp["errors"]):
                    raise AssertionError(f"migrate {stage}: the broker: "
                                         f"{resp['errors']}")
                got = [float(r.get("", 0.0) or 0.0) for r in resp["results"]]
                acked = sum(acked_by_shard.values())
                if got != [float(acked), fare_sum[0]]:
                    raise AssertionError(
                        f"migrate {stage}: the broker answers count, sum "
                        f"{got}; acked {acked} rows, their fares "
                        f"{fare_sum[0]}")
                print(f"migrate {stage}: " + "; ".join(
                    f"shard {sid} on {c[0]}: {c[1]} rows below the cutoff "
                    f"{c[3]}, {c[2]} at or above" for sid, c in
                    counts.items()) + f"; the broker's count {got[0]:.0f} "
                    f"equals the acked ids and its sum {got[1]} the acked "
                    "fares'", flush=True)
                return counts

            threads = [threading.Thread(target=writer, daemon=True),
                       threading.Thread(target=churner, daemon=True)]
            for t in threads:
                t.start()
            seconds = []
            try:
                time.sleep(settle_s)
                for i, move in enumerate(moves):
                    pause()
                    before = check(f"before move {i + 1}")
                    during = dict(acked_by_shard)
                    if move == "rebalance" and "dn1" not in nodes:
                        start_node("dn1")
                        wait_for(lambda: "dn1" in http(
                            cport, f"membership/{ns}/instances"),
                            "dn1's heartbeat", 30)
                    paused.clear()
                    t0 = time.perf_counter()
                    if move == "rebalance":
                        r = http(cport,
                                 f"placement/{ns}/datanode/rebalance", {})
                        if r.get("moves", 0) < 1:
                            raise AssertionError(f"migrate: rebalance {r}")
                    else:
                        http(cport, f"placement/{ns}/datanode/replace",
                             {"leaving": move[0], "joining": move[1]})
                    wait_for(lambda: converged() and all(
                        len(v) == 1 for v in owners().values()),
                        f"move {i + 1} to converge", 180)
                    seconds.append(time.perf_counter() - t0)
                    time.sleep(settle_s)
                    pause()
                    after = check(f"after move {i + 1}")
                    moved = [s for s in after if after[s][0] != before[s][0]]
                    if not moved:
                        raise AssertionError(f"migrate: move {i + 1} moved "
                                             f"no shard: {after}")
                    for sid in moved:
                        grown = acked_by_shard[sid] - during[sid]
                        if sum(after[sid][1:3]) != \
                                sum(before[sid][1:3]) + grown:
                            raise AssertionError(
                                f"migrate: shard {sid} held "
                                f"{before[sid]} before, {after[sid]} after, "
                                f"with {grown} rows acked between")
                    print(f"migrate move {i + 1} ({move}): shard(s) {moved} "
                          f"moved in {seconds[-1]:.3f} s under ingest and "
                          f"archiving; each counted on its old owner before "
                          f"and its new owner after, equal with the rows "
                          f"acked between", flush=True)
                    paused.clear()
            finally:
                stop.set()
                for t in threads:
                    t.join(timeout=60)
            if errors:
                raise AssertionError(f"migrate: {errors[:3]}")
            acked = sum(acked_by_shard.values())
            print(f"migrate: {len(moves)} moves in "
                  + ", ".join(f"{s:.3f}" for s in seconds)
                  + f" s; {acked} rows acked, {archive_runs[0]} archiving "
                  f"runs; no row lost or duplicated", flush=True)
        finally:
            for stop_fn in reversed(stack):
                try:
                    stop_fn()
                except Exception as e:  # noqa: BLE001 — stop the rest
                    print(f"migrate: stopping: {e!r}", file=sys.stderr)
    return {"moves": seconds, "acked": acked}


# tools/drive_soak.py: writes, re-upserts of old ids, queries and the
# archiving, backfill and snapshot jobs at once against one daemon
SOAK_NOW = 1_600_000_000
SOAK_SECONDS = 60.0
SOAK_CHUNK = 4096
SOAK_CITIES = 8
SOAK_TRIPS_JSON = {
    "name": "trips",
    "columns": [{"name": "request_at", "type": "Uint32"},
                {"name": "id", "type": "Uint32"},
                {"name": "city_id", "type": "Uint16"},
                {"name": "status", "type": "SmallEnum"},
                {"name": "fare", "type": "Float32"}],
    "primaryKeyColumns": [1], "isFactTable": True,
    # small batches and a short delay: archiving has work every cycle
    "config": {"batchSize": SOAK_CHUNK, "recordRetentionInDays": 0,
               "archivingDelayMinutes": 1, "archivingIntervalMinutes": 1}}
SOAK_CITIES_JSON = {
    "name": "cities",
    "columns": [{"name": "id", "type": "Uint16"},
                {"name": "name", "type": "BigEnum"}],
    "primaryKeyColumns": [0], "isFactTable": False}
SOAK_WINDOW = {"column": "request_at", "from": f"{SOAK_NOW - 3 * DAY}",
               "to": f"{SOAK_NOW + 60}"}


def soak_queries() -> dict:
    """The drive's shapes (tools/drive_soak.py:184-191): count(*), the
    completed sum(fare) joined to cities by name, and sum(fare)."""
    base = {"table": "trips", "now": SOAK_NOW, "timeFilter": SOAK_WINDOW}
    return {
        "count": dict(base, measures=[{"sqlExpression": "count(*)"}]),
        "join": dict(base, joins=[{"table": "cities", "alias": "c",
                                   "conditions": ["c.id = city_id"]}],
                     dimensions=[{"sqlExpression": "c.name"}],
                     measures=[{"sqlExpression": "sum(fare)",
                                "rowFilters": ["status='completed'"]}]),
        "sum": dict(base, measures=[{"sqlExpression": "sum(fare)"}]),
    }


def phase_soak(seed: int, device=None, seconds: float = SOAK_SECONDS
               ) -> dict:
    """tools/drive_soak.py on the port: an ApiServer on `device` over a
    MemStore in a temporary directory (its scheduler not started, the
    port's clock frozen at SOAK_NOW), the drive's trips and 8 cities
    created through the Connector; for `seconds`, at once: a writer
    inserting SOAK_CHUNK rows at a time through Connector.insert, three
    quarters new ids and a quarter re-upserts of acked ids with fresh
    fares (half the ids timed in the last half hour, half a day and more
    back, a pure function of the id), a last-write-wins oracle kept under
    the ack; a count(*) thread (never below a count it saw, nor below the
    ids acked before it asked less the rows the daemon had put in its
    backfill queue by its answer and not yet backfilled before it asked:
    a row timed behind the archiving cutoff stays out of sight until the
    backfill applies it) and a thread of the join by city name with its
    status filter (never an error); a job
    thread cycling archiving, backfill and snapshot through /dbg. Then
    the jobs drained and the drive's checks: count(*) equal to the unique
    acked ids, sum(fare) and each city's completed sum to the oracle
    (the drive's tolerances), the join's K1 launches held to the batches
    and chunks of at least FD_MIN_ROWS padded rows. Prints the rows
    backfilled and the column cache's stats. Returns {"rows",
    "backfilled", "cache"}."""
    import urllib.error

    from aresdb_tpu_torch.api.server import ApiServer
    from aresdb_tpu_torch.client import Connector
    from aresdb_tpu_torch.diskstore.local_diskstore import LocalDiskStore
    from aresdb_tpu_torch.memstore.memstore import MemStore
    from aresdb_tpu_torch.memstore.scheduler import Scheduler
    from aresdb_tpu_torch.metastore.disk_metastore import DiskMetaStore
    from aresdb_tpu_torch.query import executor as X
    from aresdb_tpu_torch.query import fused_dense as FD
    from aresdb_tpu_torch.utils import clock

    queries = soak_queries()
    counters = kernel_counters()
    clock.set_current_time(SOAK_NOW)
    server = ms = None
    with tempfile.TemporaryDirectory() as root:
        try:
            ms = MemStore(DiskMetaStore(root), LocalDiskStore(root))
            ms.fetch_schema()
            server = ApiServer(ms, Scheduler(ms), port=0, device=device)
            port = server.start_background()
            conn = Connector("localhost", port)
            conn.create_table(SOAK_TRIPS_JSON)
            conn.create_table(SOAK_CITIES_JSON)
            conn.insert("cities", ["id", "name"],
                        [(c, f"city{c}") for c in range(SOAK_CITIES)])

            stop = threading.Event()
            errors = []
            oracle, olock = {}, threading.Lock()
            acked = [0]
            counts = {"count": 0, "join": 0, "jobs": 0, "lowest": None}
            # rows the daemon queued for backfill (each upsert's answer)
            # and rows the backfill jobs applied
            queued, backfilled = [0], [0]

            def writer():
                w = Connector("localhost", port)
                rng = np.random.RandomState(seed + 7)
                next_id = 0
                try:
                    while not stop.is_set():
                        n_new = SOAK_CHUNK * 3 // 4
                        new = np.arange(next_id, next_id + n_new,
                                        dtype=np.uint32)
                        old = rng.randint(0, max(1, next_id),
                                          SOAK_CHUNK - n_new).astype(np.uint32)
                        ids = np.concatenate([new, old])
                        mix = (ids.astype(np.uint64) * 2654435761) % (1 << 32)
                        ts = np.where(mix % 2 == 0, SOAK_NOW - mix % 1800,
                                      SOAK_NOW - DAY - mix % DAY
                                      ).astype(np.uint32)
                        city = rng.randint(0, SOAK_CITIES, SOAK_CHUNK)
                        status = [STATUSES[i]
                                  for i in rng.randint(0, 3, SOAK_CHUNK)]
                        fare = rng.rand(SOAK_CHUNK).astype(np.float32).round(2)
                        rows = list(zip(ts.tolist(), ids.tolist(),
                                        city.tolist(), status, fare.tolist()))
                        stats = w.insert("trips", ["request_at", "id",
                                                   "city_id", "status",
                                                   "fare"], rows)
                        with olock:
                            for r in rows:   # later rows of a batch win
                                oracle[r[1]] = r
                            acked[0] = len(oracle)
                            queued[0] += stats["backfilled"]
                        next_id += n_new
                        time.sleep(0.01)
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(f"writer: {e!r}")

            def querier(name):
                q = Connector("localhost", port)
                last = -1.0
                try:
                    while not stop.is_set():
                        with olock:
                            floor, applied = acked[0], backfilled[0]
                        resp = q.query_aql(queries[name])
                        with olock:
                            waiting = queued[0] - applied
                        if resp.get("errors") and any(resp["errors"]):
                            errors.append(f"{name}: {resp['errors']}")
                            return
                        counts[name] += 1
                        if name == "count":
                            cnt = float(resp["results"][0].get("", 0.0)
                                        or 0.0)
                            if cnt < last:
                                errors.append(f"count fell {last} -> {cnt}")
                                return
                            if cnt < floor - waiting:
                                errors.append(f"count {cnt} below the acked "
                                              f"floor {floor} less the "
                                              f"{waiting} rows awaiting "
                                              "backfill")
                                return
                            low = floor - cnt
                            if counts["lowest"] is None or \
                                    low > counts["lowest"]:
                                counts["lowest"] = low
                            last = max(last, cnt)
                        time.sleep(0.002)
                except Exception as e:  # noqa: BLE001
                    errors.append(f"{name}: {e!r}")

            def job(kind: str) -> dict:
                out = http(port, f"dbg/trips/0/{kind}", {})
                if kind == "backfill" and out.get("result"):
                    with olock:
                        backfilled[0] += out["result"]["rowsBackfilled"]
                return out

            def jobs():
                cycle = ("archiving", "backfill", "snapshot")
                i = 0
                try:
                    while not stop.is_set():
                        job(cycle[i % len(cycle)])
                        counts["jobs"] += 1
                        i += 1
                        time.sleep(0.25)
                except urllib.error.HTTPError as e:
                    errors.append(f"job {cycle[i % 3]}: {e.code} "
                                  f"{e.read()[:200]!r}")
                except Exception as e:  # noqa: BLE001
                    errors.append(f"jobs: {e!r}")

            threads = [threading.Thread(target=writer),
                       threading.Thread(target=querier, args=("count",)),
                       threading.Thread(target=querier, args=("join",)),
                       threading.Thread(target=jobs)]
            t0 = time.time()
            for t in threads:
                t.start()
            while time.time() - t0 < seconds and not errors:
                time.sleep(0.2)
            stop.set()
            for t in threads:
                t.join(timeout=120)
            if errors:
                raise AssertionError(f"soak: {errors[:3]}")
            for kind in ("archiving", "backfill", "archiving"):
                job(kind)

            with olock:
                rows = list(oracle.values())
            want_count = float(len(rows))
            fares = np.array([r[4] for r in rows], np.float32)
            want_sum = float(fares.astype(np.float64).sum())
            city_sums = {}
            for r in rows:
                if r[3] == "completed":
                    k = f"city{r[2]}"
                    city_sums[k] = city_sums.get(k, 0.0) + float(
                        np.float32(r[4]))
            shard = ms.get_table_shard("trips")
            layout = atrips_layout(shard, X.ShardExecutor.ARCHIVE_CHUNK_ROWS)
            for c in counters.values():
                c.launches = 0
            final = {name: conn.query_aql(q) for name, q in queries.items()}
            got = {k: c.launches for k, c in counters.items()}
            for name, resp in final.items():
                if resp.get("errors") and any(resp["errors"]):
                    raise AssertionError(f"soak final {name}: "
                                         f"{resp['errors']}")
            k1 = sum(n >= FD.FD_MIN_ROWS
                     for n in layout["live"] + layout["chunks"])
            if got["K1"] != k1 or got["K3"]:
                raise AssertionError(f"soak: the final queries launched "
                                     f"{got}, K1 expected {k1}")
            count = final["count"]["results"][0][""]
            total = final["sum"]["results"][0][""]
            join = final["join"]["results"][0]
            if count != want_count:
                raise AssertionError(f"soak: count {count}, the acked ids "
                                     f"{want_count}")
            if abs(total - want_sum) >= max(1.0, 1e-4 * abs(want_sum)):
                raise AssertionError(f"soak: sum(fare) {total}, the oracle "
                                     f"{want_sum}")
            for k, v in city_sums.items():
                if abs(join.get(k, 0.0) - v) >= max(1.0, 1e-3 * abs(v)):
                    raise AssertionError(f"soak: {k} {join.get(k)}, the "
                                         f"oracle {v}")
            cache = http(port, "dbg/device-cache")
            print(f"soak: {seconds:.0f} s of writes (re-upserts of old ids "
                  f"among them), {counts['count']} counts, {counts['join']} "
                  f"joins and {counts['jobs']} jobs at once, no error; the "
                  f"count trailed the acks by at most "
                  f"{counts['lowest']} rows and never fell; "
                  f"{backfilled[0]} rows backfilled; final count "
                  f"{count:.0f} equals the unique acked ids, sum(fare) "
                  f"{total:.2f} the oracle's {want_sum:.2f}, the join's "
                  f"{len(city_sums)} cities the oracle's; the final queries "
                  f"launched " + " ".join(f"{k}={v}" for k, v in got.items())
                  + f" over {len(layout['live'])} live batches and "
                  f"{len(layout['chunks'])} archive chunks; column cache "
                  f"{cache_line(cache)}", flush=True)
        finally:
            if server is not None:
                server.stop()
            if ms is not None:
                close_memstore(ms)
            clock.reset_clock()
    return {"rows": int(want_count), "backfilled": backfilled[0],
            "cache": cache}


# tools/drive_controller_ha.py: two controllers in a lease election over a
# shared root, every client given both addresses; the leader SIGKILLed,
# then the restarted one promoted while the other is SIGSTOPped
HA_NS = "prod"
HA_TTL = 1.5                     # the drive's --lease-ttl
HA_PAUSE = 4 * HA_TTL            # the SIGSTOP's least length
HA_MORE_SHARE = 8                # step 5 adds shard_rows / 8 to each shard
HA_RUNS = 3                      # the asserted rounds: one cold, two warm
HA_CONVERGE_S = 60.0
# the drive's trips at a batch size K1 takes: its 4,096-row batches stay
# under FD_MIN_ROWS, where every query would reduce through K2
HA_SCHEMA_JSON = dict(CRASH_SCHEMA_JSON, name="trips",
                      config={"batchSize": 1 << 18,
                              "recordRetentionInDays": 0})
HA_CITIES_JSON = {"name": "cities", "columns": [{"name": "id",
                                                  "type": "Uint16"}],
                  "primaryKeyColumns": [0], "isFactTable": False,
                  "config": {"batchSize": 64}}
# the drive's count(*), and sum(v) by id % RF2_GROUPS
HA_QUERIES = [{"table": "trips", "measures": [{"sqlExpression": "count(*)"}]},
              dict(RF2_QUERIES[1], table="trips")]


def ha_answers(port: int, now: int) -> list:
    """HA_QUERIES through the broker at port, back to back, each its own
    request: [(status, answer or None)]; a status other than 200, a
    refused or cut request or an error in the answer stands as it came."""
    import urllib.error

    out = []
    for q in HA_QUERIES:
        try:
            resp = http(port, "query/aql", {"queries": [dict(q, now=now)]})
        except urllib.error.HTTPError as e:
            out.append((e.code, None))
            continue
        except Exception as e:  # noqa: BLE001 — counted as an error
            out.append((repr(e), None))
            continue
        if any(resp.get("errors") or []):
            out.append((f"200 {resp['errors']}", None))
            continue
        out.append((200, {k: float(v) for k, v in
                          ((resp.get("results") or [{}])[0] or {}).items()}))
    return out


def ha_oracle(parts) -> list:
    """The two answers over the rows of `parts`, (ids, v) pairs."""
    group = np.concatenate([i for i, _ in parts]).astype(np.int64) \
        % RF2_GROUPS
    values = np.concatenate([v for _, v in parts]).astype(np.float64)
    return [{"": float(len(group))},
            {str(g): float(x) for g, x in enumerate(
                np.bincount(group, values, RF2_GROUPS))}]


def ha_launches(nodes, runs: int) -> dict:
    """Each kernel's launches over `runs` runs of HA_QUERIES on the
    shards the nodes own: count(*), with no dimension, is one slot and
    reduced with no kernel; the sum by id % RF2_GROUPS takes K1 on a live
    batch of at least FD_MIN_ROWS padded rows and K2 (the unfused dense
    kernel) on a smaller one."""
    from aresdb_tpu_torch.query import fused_dense as FD

    layout = shards_layout(nodes)
    fused = sum(n >= FD.FD_MIN_ROWS for n in layout["live"])
    return {"K1": runs * fused, "K2": runs * (len(layout["live"]) - fused),
            "K3": 0}


def phase_controller_ha(seed: int, device=None,
                        shard_rows: int = RF2_SHARD_ROWS,
                        timeout: float = 600) -> dict:
    """tools/drive_controller_ha.py on the port. Two controllers as
    processes of their own (`cmd.controller --elect --lease-ttl HA_TTL`
    on one root); dn0 and dn1 in this process on `device` and a broker
    over DynamicTopology, each of them, the broker's schema view and the
    phase's FailoverSession given both controllers' addresses. The
    drive's trips (ts, id, v), 2 shards at replica factor 1, shard_rows
    rows a shard through Connector.insert_columns to its owner; the
    drive's count(*) and sum(v) by id % RF2_GROUPS through the broker
    against a numpy oracle, K1's launches held to ha_launches over
    HA_RUNS runs. Then a querier thread sends both queries back to back
    until the end, holding each answer to the oracle of the rows acked
    before it was sent (or of those with an upsert that was in flight by
    its answer) while: the leader is SIGKILLed and the other controller
    takes over; the drive's cities is created through the session and
    the tables listed; shard_rows / HA_MORE_SHARE more rows go to each
    shard; the killed controller restarts on its port and root as a
    follower; the leader is SIGSTOPped for at least HA_PAUSE s and the
    restarted one takes over; during_pause is created through the
    session; the paused controller is SIGCONTed and at once asked for
    stale_write with no failover: 503, and the new leader lists cities,
    during_pause and trips, as does the snapshot on the root. The querier
    must count no error and no wrong answer. Every process is killed at
    the end. Returns {"failover_s": [kill, pause], "querier": {...},
    "launches", "in_situ"}."""
    from aresdb_tpu_torch.broker.server import BrokerServer
    from aresdb_tpu_torch.broker.validator import BrokerSchemaView
    from aresdb_tpu_torch.client import Connector
    from aresdb_tpu_torch.cluster.failover import FailoverSession
    from aresdb_tpu_torch.cluster.topology import DynamicTopology
    from aresdb_tpu_torch.datanode.datanode import DataNode
    from aresdb_tpu_torch.diskstore.local_diskstore import LocalDiskStore
    from aresdb_tpu_torch.memstore.memstore import MemStore
    from aresdb_tpu_torch.memstore.scheduler import Scheduler
    from aresdb_tpu_torch.metastore.disk_metastore import DiskMetaStore
    from aresdb_tpu_torch.utils import http_client
    from aresdb_tpu_torch.utils.torch_env import resolve_device

    dev = resolve_device(device)
    ns = HA_NS
    rng = np.random.RandomState(seed + 17)
    counters = kernel_counters()
    now = int(time.time())
    more_rows = shard_rows // HA_MORE_SHARE
    plain = http_client.Session()
    stack, ctl, nodes = [], {}, {}
    with tempfile.TemporaryDirectory() as root:
        ctl_root = f"{root}/ctl"

        def start_controller(i: int, port: int = 0) -> int:
            proc, bound, _, _ = start_daemon(
                ["--port", str(port), "--root-path", ctl_root, "--elect",
                 "--lease-ttl", str(HA_TTL), "--instance", f"ctl{i}"],
                f"ctl{i} to serve", timeout,
                module="aresdb_tpu_torch.cmd.controller")
            ctl[i] = proc
            stack.append(lambda: kill(proc))
            return bound

        def leader_flag(port: int):
            """The controller's isLeader, or None where it does not
            answer."""
            try:
                return plain.get(f"http://localhost:{port}/leader",
                                 timeout=1).json().get("isLeader")
            except (http_client.RequestException, ValueError):
                return None

        def leads(port: int) -> bool:
            return leader_flag(port) is True

        def tables(r) -> list:
            if r.status_code != 200:
                raise AssertionError(f"controller_ha: the table list "
                                     f"answers {r.status_code}")
            return sorted(t["name"] for t in r.json())

        try:
            ports = [start_controller(i) for i in range(2)]
            addrs = [f"localhost:{p}" for p in ports]
            ctl_list = ",".join(addrs)
            wait_for(lambda: any(leads(p) for p in ports), "a leader", 30)
            fs = FailoverSession(addrs)
            base = f"http://{addrs[0]}"
            for path, body in (("namespaces", {"namespace": ns}),
                               (f"schema/{ns}/tables", HA_SCHEMA_JSON)):
                r = fs.post(f"{base}/{path}", json=body)
                if r.status_code != 200:
                    raise AssertionError(f"controller_ha: {path}: "
                                         f"{r.status_code} {r.text}")
            for name in ("dn0", "dn1"):
                ms = MemStore(DiskMetaStore(f"{root}/{name}"),
                              LocalDiskStore(f"{root}/{name}"))
                node = DataNode(ms, Scheduler(ms),
                                controller_address=ctl_list, namespace=ns,
                                instance_name=name, poll_seconds=0.5,
                                device=dev)
                node.open()
                stack.append(lambda n=node: (n.close(),
                                             close_memstore(n.memstore)))
                node.serve()
                nodes[name] = node
            r = fs.post(f"{base}/placement/{ns}/datanode", json={
                "numShards": 2, "replicaFactor": 1,
                "instances": ["dn0", "dn1"]})
            if r.status_code != 200:
                raise AssertionError(f"controller_ha: placement {r.text}")

            def placement() -> list:
                r = fs.get(f"{base}/placement/{ns}/datanode", timeout=2)
                return r.json()["shards"] if r.status_code == 200 else []

            def converged() -> bool:
                shards = placement()
                return bool(shards) and all(
                    set(sd["instances"].values()) == {"Available"}
                    for sd in shards)

            wait_for(converged, "the placement to turn Available",
                     HA_CONVERGE_S)
            owner = {sd["shardId"]: next(iter(sd["instances"]))
                     for sd in placement()}
            topology = DynamicTopology(ctl_list, ns, poll_seconds=0.5)
            topology.start()
            stack.append(topology.stop)
            view = BrokerSchemaView(addrs[0], ns, poll_seconds=1.0,
                                    session=FailoverSession(addrs))
            view.start()
            stack.append(view.stop)
            broker = BrokerServer(topology, schema_view=view)
            bport = broker.start_background()
            stack.append(broker.stop)

            # the oracle: each shard's upserts in order; acked[sid] of them
            # acked, seen[sid] possibly visible (acked, or in flight)
            upserts = {sid: [] for sid in range(2)}
            acked, seen = [0, 0], [0, 0]
            lock = threading.Lock()

            def ingest(sid: int, n: int) -> None:
                lo = sum(len(i) for i, _ in upserts[sid]) + sid * (1 << 30)
                cols = {"ts": np.full(n, now - 60, np.uint32),
                        "id": np.arange(lo, lo + n, dtype=np.uint32),
                        "v": rng.randint(0, 16, n).astype(np.float32)}
                with lock:
                    upserts[sid].append((cols["id"], cols["v"]))
                    seen[sid] += 1
                port = nodes[owner[sid]].port
                stats = Connector("localhost", port).insert_columns(
                    "trips", dict(cols), shard_id=sid)
                if stats["inserted"] != n:
                    raise AssertionError(f"controller_ha: shard {sid}: "
                                         f"{stats}")
                with lock:
                    acked[sid] += 1

            def wants(lo, hi) -> list:
                return [ha_oracle(upserts[0][:a] + upserts[1][:b])
                        for a in range(lo[0], hi[0] + 1)
                        for b in range(lo[1], hi[1] + 1)]

            def answers_right(got, *options) -> bool:
                """Each answer 200 and equal to its query's answer in one
                of the oracles `options` (the two requests of a pair may
                see an upsert land between them)."""
                return all(status == 200 and any(a == w[i] for w in options)
                           for i, (status, a) in enumerate(got))

            t0 = time.perf_counter()
            for sid in range(2):
                ingest(sid, shard_rows)
            load_s = time.perf_counter() - t0
            want = wants(acked, acked)[0]
            for c in counters.values():
                c.launches = 0
            for _ in range(HA_RUNS):
                got = ha_answers(bport, now)
                if not answers_right(got, want):
                    raise AssertionError(f"controller_ha: the broker answers "
                                         f"{got}, the oracle {want}")
            launches = {k: c.launches for k, c in counters.items()}
            expected = ha_launches(nodes.values(), HA_RUNS)
            if launches != expected:
                raise AssertionError(f"controller_ha: launches {launches}, "
                                     f"expected {expected}")
            totals = dict(launches)
            print(f"controller_ha: ctl0 and ctl1 in an election (ttl "
                  f"{HA_TTL} s), dn0 and dn1 on {dev.type}; 2 shards of "
                  f"{shard_rows} rows in {load_s:.3f} s; count(*) and "
                  f"sum(v) by id % {RF2_GROUPS} through the broker equal the "
                  f"oracle over {HA_RUNS} runs, launches "
                  + " ".join(f"{k}={v}" for k, v in launches.items()),
                  flush=True)

            # the querier, from before the kill to the end
            stop = threading.Event()
            record = []      # (end, ms, statuses, right)

            def querier():
                while not stop.is_set():
                    with lock:
                        lo = list(acked)
                    t_send = time.perf_counter()
                    got = ha_answers(bport, now)
                    t_end = time.perf_counter()
                    with lock:
                        hi = list(seen)
                    right = answers_right(got, *wants(lo, hi))
                    record.append((t_end, 1e3 * (t_end - t_send),
                                   [s_ for s_, _ in got], right))

            for c in counters.values():
                c.launches = 0
            q_thread = threading.Thread(target=querier, daemon=True)
            q_start = time.perf_counter()
            q_thread.start()
            try:
                time.sleep(1.0)
                # 3: SIGKILL the leader
                lead = next(i for i, p in enumerate(ports) if leads(p))
                other = 1 - lead
                t0 = time.perf_counter()
                kill(ctl[lead])
                wait_for(lambda: leads(ports[other]),
                         f"ctl{other} to take over", 30)
                kill_s = time.perf_counter() - t0
                print(f"controller_ha: ctl{lead}, the leader, SIGKILLed; "
                      f"ctl{other} reports isLeader {kill_s:.3f} s after",
                      flush=True)
                # 4: cities through the same session; the table list
                r = fs.post(f"{base}/schema/{ns}/tables", json=HA_CITIES_JSON)
                if r.status_code != 200:
                    raise AssertionError(f"controller_ha: cities: "
                                         f"{r.status_code} {r.text}")
                listed = tables(fs.get(f"{base}/schema/{ns}/tables"))
                if listed != ["cities", "trips"]:
                    raise AssertionError(f"controller_ha: tables {listed}")
                # 5: more rows to each shard; the broker catches up
                for sid in range(2):
                    ingest(sid, more_rows)
                want = wants(acked, acked)[0]
                wait_for(lambda: answers_right(ha_answers(bport, now), want),
                         "the broker to count the new rows", 30)
                print(f"controller_ha: cities created and listed through "
                      f"the failover session; {more_rows} more rows to each "
                      f"shard, counted by the broker", flush=True)
                # 6: the killed controller restarts as a follower
                start_controller(lead, ports[lead])
                wait_for(lambda: leader_flag(ports[lead]) is False,
                         f"ctl{lead} to follow", 30)
                # 7: SIGSTOP the leader; the restarted one takes over
                paused = ctl[other]
                t0 = time.perf_counter()
                paused.send_signal(signal.SIGSTOP)
                try:
                    wait_for(lambda: leads(ports[lead]),
                             f"ctl{lead} to take over", 30)
                    pause_s = time.perf_counter() - t0
                    # 8: a table while the old leader is paused
                    r = fs.post(f"{base}/schema/{ns}/tables", timeout=2,
                                json=dict(HA_CITIES_JSON,
                                          name="during_pause"))
                    if r.status_code != 200:
                        raise AssertionError(f"controller_ha: during_pause: "
                                             f"{r.status_code} {r.text}")
                    time.sleep(max(0.0, HA_PAUSE
                                   - (time.perf_counter() - t0)))
                finally:
                    paused.send_signal(signal.SIGCONT)
                # 9: the paused controller, at once, with no failover
                r = plain.post(f"http://{addrs[other]}/schema/{ns}/tables",
                               json=dict(HA_CITIES_JSON, name="stale_write"),
                               timeout=10)
                if r.status_code != 503 or \
                        r.json().get("leader") != addrs[lead]:
                    raise AssertionError(
                        f"controller_ha: the paused controller answers "
                        f"stale_write {r.status_code} {r.text}")
                listed = tables(plain.get(
                    f"http://{addrs[lead]}/schema/{ns}/tables", timeout=5))
                with open(f"{ctl_root}/state.json") as f:
                    on_disk = sorted(json.load(f)[ns]["tables"])
                three = ["cities", "during_pause", "trips"]
                if listed != three or on_disk != three:
                    raise AssertionError(f"controller_ha: the leader lists "
                                         f"{listed}, the snapshot holds "
                                         f"{on_disk}")
                print(f"controller_ha: ctl{lead} restarted as a follower; "
                      f"ctl{other} SIGSTOPped for "
                      f"{time.perf_counter() - t0:.3f} s, ctl{lead} reports "
                      f"isLeader {pause_s:.3f} s after the stop; "
                      f"during_pause created through the session; ctl{other}"
                      f" SIGCONTed answers stale_write 503 with ctl{lead}'s "
                      f"address; the leader and the snapshot hold {three}",
                      flush=True)
                time.sleep(1.0)
            finally:
                stop.set()
                q_thread.join(timeout=60)
            q_launches = {k: c.launches for k, c in counters.items()}
            for k in totals:
                totals[k] += q_launches[k]
            q_s = time.perf_counter() - q_start
            errors = [r for r in record if any(s_ != 200 for s_ in r[2])]
            wrong = [r for r in record if not r[3] and r not in errors]
            ms_ = np.array([r[1] for r in record])
            ends = [q_start] + [r[0] for r in record if r[3]]
            gap_ms = 1e3 * max((b - a for a, b in zip(ends, ends[1:])),
                               default=float("inf"))
            querier_figures = {
                "pairs": len(record), "errors": len(errors),
                "wrong": len(wrong), "p50_ms": float(np.percentile(ms_, 50)),
                "p99_ms": float(np.percentile(ms_, 99)),
                "longest_gap_ms": gap_ms}
            print(f"controller_ha: the querier sent {len(record)} pairs in "
                  f"{q_s:.3f} s: {len(errors)} errors, {len(wrong)} wrong "
                  f"answers; p50 {querier_figures['p50_ms']:.3f} ms, p99 "
                  f"{querier_figures['p99_ms']:.3f} ms a pair, the longest "
                  f"gap between two right answers {gap_ms:.3f} ms; launches "
                  "in its run " + " ".join(f"{k}={v}"
                                           for k, v in q_launches.items()),
                  flush=True)
            if errors or wrong or not record:
                raise AssertionError(
                    f"controller_ha: the querier's {len(record)} pairs hold "
                    f"{len(errors)} errors ({errors[:3]}) and {len(wrong)} "
                    f"wrong answers ({wrong[:3]})")
            if expected["K1"] and not q_launches["K1"]:
                raise AssertionError("controller_ha: the querier's run "
                                     "launched no K1")

            # the same two queries after the failovers, launches held again
            for c in counters.values():
                c.launches = 0
            for _ in range(HA_RUNS):
                got = ha_answers(bport, now)
                if not answers_right(got, want):
                    raise AssertionError(f"controller_ha: after the "
                                         f"failovers the broker answers "
                                         f"{got}, the oracle {want}")
            launches = {k: c.launches for k, c in counters.items()}
            expected = ha_launches(nodes.values(), HA_RUNS)
            if launches != expected:
                raise AssertionError(f"controller_ha: launches after the "
                                     f"failovers {launches}, expected "
                                     f"{expected}")
            for k in totals:
                totals[k] += launches[k]
            in_situ = {k: {} for k in counters}
            if dev.type == "cuda" and expected["K1"]:
                def profiled_run():
                    for c in counters.values():
                        c.launches = 0
                    ha_answers(bport, now)

                events = counted_events(
                    profiled_run, 1, "K1", expected["K1"] // HA_RUNS)
                k1 = kernel_events(events, "K1")
                if k1 and len(k1) == expected["K1"] // HA_RUNS:
                    in_situ["K1"]["controller_ha count and sum"] = \
                        sum(k1) / 1e3 / len(k1)
                smi = subprocess.run(
                    ["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"], capture_output=True,
                    text=True).stdout.strip()
                k1_ms = in_situ["K1"].get("controller_ha count and sum")
                print(f"controller_ha: {smi}; K1 in situ "
                      + (f"{k1_ms:.4f} ms a launch" if k1_ms is not None
                         else "not recorded"), flush=True)
            print(f"controller_ha: after both failovers the two queries "
                  f"equal the oracle over {HA_RUNS} runs, launches "
                  + " ".join(f"{k}={v}" for k, v in launches.items())
                  + "; the phase's K1 launches "
                  f"{totals['K1']}", flush=True)
        finally:
            for stop_fn in reversed(stack):
                try:
                    stop_fn()
                except Exception as e:  # noqa: BLE001 — stop the rest
                    print(f"controller_ha: stopping: {e!r}", file=sys.stderr)
    return {"failover_s": [kill_s, pause_s], "querier": querier_figures,
            "launches": totals, "in_situ": in_situ}


# the deployments of tools/drive_*.py, in the order main runs them
DRIVES = ("hundredm", "crash", "rf2", "migrate", "soak", "controller_ha")


MEASURED = ("max_abs_err", "ms", "kernel_ms", "wall_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")


def kernel_row(name, source, replaces, launches, measured, in_situ,
               traffic=None) -> dict:
    """One kernel of the {"kernels": [...]} line; `traffic` adds other
    cases of its phase by key (K1's J1 plan with a joined lane, K2's
    run-length shapes, K3's case on Q5's batch)."""
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches,
           **{k: measured[k] for k in MEASURED},
           "in_situ_ms_per_launch": in_situ}
    for key, case in (traffic or {}).items():
        row[key] = {m: case[m] for m in MEASURED}
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=4 * BATCH_ROWS)
    ap.add_argument("--atrips-rows", type=int, default=ATRIPS_ROWS)
    ap.add_argument("--events-rows", type=int, default=EVENTS_ROWS)
    ap.add_argument("--server-rows", type=int, default=SERVER_ROWS)
    ap.add_argument("--cluster-rows", type=int, default=SERVER_ROWS,
                    help="phase_cluster's rows; held against "
                         "phase_server's answers where equal to "
                         "--server-rows")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hundredm-rows", type=int, default=HUNDREDM_ROWS,
                    help="phase_hundredm's rows (tools/drive_100m.py's 100M)")
    ap.add_argument("--hundredm-cache-bytes", type=int, default=None,
                    help="phase_hundredm's column cache budget (default: "
                         "the card's share, admission.device_cache_budget)")
    ap.add_argument("--only", default=None,
                    help="run only these drive phases, comma-separated, of "
                         + ", ".join(DRIVES) + " (no kernel phase and no "
                         "kernels line)")
    args = ap.parse_args(argv)
    only = None if args.only is None else args.only.split(",")
    if only is not None and not set(only) <= set(DRIVES):
        ap.error(f"--only: phases of {', '.join(DRIVES)}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from aresdb_tpu_torch import demo
    from aresdb_tpu_torch.query import fused_dense as FD
    from aresdb_tpu_torch.query import pallas_ops as P
    from aresdb_tpu_torch.query.dense import plan_dense
    from aresdb_tpu_torch.query.executor import columns_from_numpy
    from aresdb_tpu_torch.utils import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    device = torch.device("cuda")

    def timed(phase, *a, **kw):
        t0 = time.perf_counter()
        out = phase(*a, **kw)
        print(f"{phase.__name__} took {time.perf_counter() - t0:.3f} s",
              flush=True)
        return out

    def drives(names) -> tuple:
        """The deployments of tools/drive_*.py, in order: each kernel's
        launches and in-situ ms in them, and their figures."""
        launches = dict.fromkeys(kernel_counters(), 0)
        in_situ = {k: {} for k in launches}
        figures = {}
        for name in names:
            if name != "hundredm":
                figures[name] = timed(
                    {"crash": phase_crash, "rf2": phase_rf2,
                     "migrate": phase_migrate_live, "soak": phase_soak,
                     "controller_ha": phase_controller_ha}[name], args.seed)
                for k, n in figures[name].pop("launches", {}).items():
                    launches[k] += n
                for k, ms_ in figures[name].pop("in_situ", {}).items():
                    in_situ[k].update(ms_)
                continue
            got, ms_, _ = timed(phase_hundredm, args.hundredm_rows,
                                HUNDREDM_SEED,
                                cache_bytes=args.hundredm_cache_bytes)
            figures[name] = {"rows": args.hundredm_rows}
            for k in launches:
                launches[k] += got[k]
                in_situ[k].update(ms_[k])
        return launches, in_situ, figures

    if only is not None:
        _, _, figures = drives(only)
        print(json.dumps({"drives": figures}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}, "only": only}), flush=True)
        return 0

    build = timed(phase_build, demo, FD, columns_from_numpy, plan_dense,
                  cuda_build, device, args.seed)
    # build every kernel of the path at once: one nvcc process for each of
    # K2's and K3's libraries and K1's launcher, one NVRTC thread for each
    # K1 plan structure's cubin
    sources = [("segment_sum", cuda_build.csrc_text(P.SOURCE), "nvcc"),
               ("dense_segment_sum", cuda_build.csrc_text(P.K3_SOURCE),
                "nvcc"), FD.launcher_item()]
    for query, city_max in k1_cases(demo, args.seed).values():
        spec = k1_spec(demo, FD, plan_dense, query, city_max)[2]
        sources.append(FD.build_item(spec.source))
    build["all_at_once_s"] = cuda_build.build_all(sources)
    print(f"built {len(sources)} kernel libraries and cubins in "
          f"{build['all_at_once_s']:.1f} s", flush=True)
    ptxas = {name: ptxas_functions(cuda_build.library_path(*src)
                                   .with_suffix(".log").read_text())
             for name, src in (("segment_sum", sources[0]),
                               ("dense_segment_sum", sources[1]))}

    rng = np.random.RandomState(args.seed)
    k2 = phase_k2(P, device, rng)
    k3 = phase_k3(P, device, rng, q5_batch(args.seed))
    k1 = phase_k1(demo, FD, columns_from_numpy, plan_dense, cuda_build,
                  device, args.seed)
    launches, in_situ = timed(phase_e2e, args.rows, args.seed,
                              mesh=MESH_E2E, pool=True)
    phases = [timed(phase_atrips, args.atrips_rows, args.seed,
                    mesh=("G1",)),
              timed(phase_events, args.events_rows, args.seed,
                    mesh=("E1",))]
    *server, single = timed(phase_server, args.server_rows, args.seed)
    phases += [server, timed(
        phase_cluster, args.cluster_rows, args.seed,
        single if args.cluster_rows == args.server_rows else None),
        timed(phase_stream, args.server_rows, args.seed)]
    *drive_counts, figures = drives(DRIVES)
    phases.append(drive_counts)
    for phase_launches, phase_in_situ in phases:
        for k in launches:
            launches[k] += phase_launches[k]
            in_situ[k].update(phase_in_situ[k])

    kernels = [
        kernel_row("fused_dense",
                   "aresdb_tpu_torch/csrc/fused_dense_template.cuh",
                   "aresdb_tpu/query/fused_dense.py:286", launches["K1"],
                   k1["Q1 sum(fare) hour x city"], in_situ["K1"],
                   traffic={"j1_joined_lane": k1[J1_K1_CASE]}),
        kernel_row("segment_sum", "aresdb_tpu_torch/csrc/segment_sum.cu",
                   "aresdb_tpu/query/pallas_ops.py:308", launches["K2"],
                   k2[K2_ROW_CASE], in_situ["K2"],
                   traffic={"runlen_a2": k2[K2_RUNLEN_CASES[0][0]],
                            "runlen_a4": k2[K2_RUNLEN_CASES[1][0]],
                            **{key: k2[name]
                               for name, _, key in K2_SORTED_CASES}}),
        kernel_row("dense_segment_sum",
                   "aresdb_tpu_torch/csrc/dense_segment_sum.cu",
                   "aresdb_tpu/query/pallas_ops.py:99", launches["K3"],
                   k3[K3_CASES[0][0]], in_situ["K3"],
                   traffic={"q5_traffic": k3[K3_Q5_CASE]}),
    ]
    kernels[0]["usage"] = {name: r["usage"] for name, r in k1.items()}
    kernels[1]["ptxas"] = ptxas["segment_sum"]
    kernels[2]["ptxas"] = ptxas["dense_segment_sum"]
    if sorted(WINDOW) != ["A6", "B1 raised range", "Q1"]:
        raise AssertionError(f"window: runs of {sorted(WINDOW)}")
    print(json.dumps({"window": WINDOW}), flush=True)
    print(json.dumps({"drives": figures}), flush=True)
    print(json.dumps({"build": {**build, "built": cuda_build.built,
                                "seconds": cuda_build.build_seconds}}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
