"""Array columns of the port against the JAX package.

The same upsert bytes fill both packages' stores; the same AQL requests go
to the JAX package's `QueryService` (ARES_FUSED=interp) and the port's
(`device="cpu"`). Answers must be equal, exactly for counts and groups:
the cases of tests/test_array_queries.py, UUID, GeoPoint, Uint32 (items
at 2^31 and above) and Uint16 arrays, array columns staged from archive
batches as well as live ones, and the error answer for a joined table's
array column. `_pad_array_column` is held against the JAX package's
layout directly.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from aresdb_tpu.common import data_types as dt
from aresdb_tpu.common.upsert_batch import UpsertBatchBuilder
from aresdb_tpu.query import executor as JX
from aresdb_tpu_torch.query import executor as TX
from tests.test_torch_geo import PORT_SIDE, build, services

NOW = 1_600_000_000
DAY = 86400
REL = 2.0 ** -17

EVENTS = {
    "name": "events",
    "columns": [
        {"name": "ts", "type": "Uint32"},
        {"name": "id", "type": "Uint32"},
        {"name": "tags", "type": "ArrayInt32"},
        {"name": "score", "type": "Float32"},
        {"name": "u32s", "type": "ArrayUint32"},
        {"name": "u16s", "type": "ArrayUint16"},
        {"name": "uuids", "type": "ArrayUUID"},
        {"name": "points", "type": "ArrayGeoPoint"},
        {"name": "city_id", "type": "Uint16"},
    ],
    "primaryKeyColumns": [1],
    "isFactTable": True,
    "config": {"batchSize": 64, "recordRetentionInDays": 0},
}
CITIES = {
    "name": "cities",
    "columns": [{"name": "id", "type": "Uint16"},
                {"name": "aliases", "type": "ArrayInt32"}],
    "primaryKeyColumns": [0], "isFactTable": False,
    "config": {"batchSize": 64},
}
UUID_A = "11111111-2222-3333-4444-555555555555"
UUID_B = "ffffffff-0000-0000-0000-000000000001"

# tests/test_array_queries.py's five rows, then rows of the other types
ROWS = [
    # tags, score, u32s, u16s, uuids, points
    ([1, 2, 3], 1.0, [3_000_000_000, 7], [40_000, 1], [UUID_A],
     [(1.5, 2.5)]),
    ([2, 4], 2.0, [2**32 - 1], [2], [UUID_B, UUID_A], [(3.0, 4.0),
                                                        (5.0, 6.0)]),
    ([], 4.0, [], [], [], []),
    (None, 8.0, None, None, None, None),
    ([5, None, 7], 16.0, [2**31, None, 5], [None, 65_535], [None, UUID_B],
     [None, (7.0, 8.0)]),
]


def events_bytes():
    b = UpsertBatchBuilder()
    for cid, t in enumerate((dt.Uint32, dt.Uint32, dt.ArrayInt32, dt.Float32,
                             dt.ArrayUint32, dt.ArrayUint16, dt.ArrayUUID,
                             dt.ArrayGeoPoint, dt.Uint16)):
        b.add_column(cid, t)
    for i, (tags, score, u32s, u16s, uuids, points) in enumerate(ROWS):
        b.add_row()
        b.set_value(i, 0, NOW - 100 - i)
        b.set_value(i, 1, i)
        b.set_value(i, 3, score)
        b.set_value(i, 8, 1 + i % 2)
        for cid, v in ((2, tags), (4, u32s), (5, u16s), (6, uuids),
                       (7, points)):
            if v is not None:
                b.set_value(i, cid, v)
    return b.to_bytes()


def cities_bytes():
    b = UpsertBatchBuilder()
    b.add_column(0, dt.Uint16)
    b.add_column(1, dt.ArrayInt32)
    for i, aliases in enumerate(([1, 2], [3])):
        b.add_row()
        b.set_value(i, 0, i + 1)
        b.set_value(i, 1, aliases)
    return b.to_bytes()


@pytest.fixture(scope="module", autouse=True)
def interpret_pallas_kernels():
    mp = pytest.MonkeyPatch()
    mp.setenv("ARES_FUSED", "interp")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def live():
    return services([(EVENTS, [events_bytes()]), (CITIES, [cities_bytes()])])


def ask(svc, query):
    return svc.handle_aql({"queries": [dict(query, table="events", now=NOW)]})


def same(svcs, query, exact=True):
    jr, tr = (ask(svc, query) for svc in svcs)
    assert "errors" not in tr, tr.get("errors")
    if exact:
        assert tr == jr
    else:
        (j,), (t,) = jr["results"], tr["results"]
        assert set(t) == set(j)
        for k, v in j.items():
            assert t[k] == pytest.approx(v, rel=REL, abs=1e-3), k
    return tr["results"][0]


def count_by(expr, filters=()):
    return {"measures": [{"sqlExpression": "count(*)",
                          "rowFilters": list(filters)}],
            "dimensions": [{"sqlExpression": expr}]}


def count_where(*filters):
    return {"measures": [{"sqlExpression": "count(*)",
                          "rowFilters": list(filters)}]}


@pytest.mark.parametrize("query, want", [
    (count_by("length(tags)"), {"3": 2.0, "2": 1.0, "0": 1.0, "NULL": 1.0}),
    ({"measures": [{"sqlExpression": "sum(score)",
                    "rowFilters": ["contains(tags, 2)"]}]}, {"": 3.0}),
    (count_by("element_at(tags, 0)"),
     {"1": 1.0, "2": 1.0, "5": 1.0, "NULL": 2.0}),
    (count_by("element_at(tags, -1)"),
     {"3": 1.0, "4": 1.0, "7": 1.0, "NULL": 2.0}),
    (count_where("tags[1] = 4"), {"": 1.0}),
    (count_where("element_at(tags, 1) IS NULL"), {"": 3.0}),
], ids=["length", "contains_filter", "element_at", "element_at_negative",
        "subscript_sugar", "null_element_is_null"])
def test_cases_of_test_array_queries(live, query, want):
    assert same(live, query) == want


def test_bare_array_column_is_rejected_alike(live):
    jr, tr = (ask(svc, {"measures": [{"sqlExpression": "sum(tags)"}]})
              for svc in live)
    assert tr["errors"][0] and tr == jr


@pytest.mark.parametrize("query", [
    count_where(f"contains(uuids, '{UUID_A}')"),
    count_where(f"contains(uuids, '{UUID_B}')"),
    count_by("element_at(uuids, 0)"),
    count_by("element_at(uuids, -1)"),
    count_by("length(points)"),
    count_where("element_at(points, 0) IS NULL"),
    count_where("element_at(points, -1) IS NOT NULL"),
], ids=["uuid_contains_a", "uuid_contains_b", "uuid_element_at",
        "uuid_last", "geopoint_length", "geopoint_null_element",
        "geopoint_last_not_null"])
def test_uuid_and_geopoint_arrays(live, query):
    result = same(live, query)
    assert result


def test_a_geopoint_item_dimension_is_refused_alike(live):
    """The compiler types element_at over a GeoPoint array as Uint32; the
    JAX package's group key then fails to broadcast its two lanes, and
    the port refuses the grouping (ROADMAP section 3)."""
    jr, tr = (ask(svc, count_by("element_at(points, -1)")) for svc in live)
    assert jr["errors"] and tr["errors"]
    assert jr["results"] == tr["results"] == [{}]


def test_contains_over_a_geopoint_array_needs_a_uuid_literal(live):
    jr, tr = (ask(svc, count_where("contains(points, 1)")) for svc in live)
    assert "UUID literal" in tr["errors"][0]
    assert tr == jr


@pytest.mark.parametrize("query", [
    count_where("contains(u32s, 3000000000)"),
    count_where(f"contains(u32s, {2**31})"),
    count_where(f"contains(u32s, {2**32 - 1})"),
    count_where("contains(u32s, -1)"),
    count_by("element_at(u32s, 0)"),
    count_by("element_at(u32s, -1)"),
    count_by("element_at(u16s, 0)"),
    count_by("element_at(u16s, -1)"),
    count_where("contains(u16s, 40000)"),
    count_where("contains(tags, 2.0)"),
], ids=["u32_3e9", "u32_2pow31", "u32_max", "u32_minus_one",
        "u32_element_at", "u32_last", "u16_element_at", "u16_last",
        "u16_contains", "float_needle"])
def test_wide_unsigned_items_wrap_as_the_jax_package_does(live, query):
    """The JAX package compares non-float items in int32 and returns
    element_at values in int32, so a Uint32 item at 2^31 or above wraps;
    Uint16 items zero-extend."""
    same(live, query)


def test_a_joined_tables_array_column_answers_not_staged(live):
    q = {"joins": [{"table": "cities", "alias": "c",
                    "conditions": ["c.id = city_id"]}],
         "measures": [{"sqlExpression": "count(*)",
                       "rowFilters": ["contains(c.aliases, 1)"]}]}
    jr, tr = (ask(svc, q) for svc in live)
    assert "not staged" in tr["errors"][0]
    assert tr == jr


@pytest.mark.parametrize("item_type", [dt.ArrayInt32, dt.ArrayUint32,
                                       dt.ArrayUint16, dt.ArrayUUID,
                                       dt.ArrayGeoPoint, dt.ArrayBool])
def test_pad_array_column_layout(item_type):
    rng = np.random.RandomState(item_type & 0xFF)
    two = dt.lanes(item_type) == 2
    lists, validity = [], []
    for i in range(37):
        if i % 7 == 3:
            lists.append(None)
            validity.append(False)
            continue
        items = []
        for _ in range(rng.randint(0, 6)):
            if rng.rand() < 0.2:
                items.append(None)
            elif two:
                items.append((int(rng.randint(1, 2**31)),
                              int(rng.randint(1, 2**31))))
            elif item_type == dt.ArrayBool:
                items.append(bool(rng.rand() < 0.5))
            else:
                items.append(int(rng.randint(0, 2**15)))
        lists.append(items)
        validity.append(True)
    want = [np.asarray(a) for a in JX._pad_array_column(
        lists, np.array(validity), 64, item_type)]
    got = [t.numpy() for t in TX._pad_array_column(
        lists, np.array(validity), 64, item_type, torch.device("cpu"))]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(
            g, w.view(g.dtype) if w.dtype.itemsize == g.dtype.itemsize
            else w)


# array columns in archive batches: events over three days, two archived

def archived_events(n=3000, seed=3):
    rng = np.random.RandomState(seed)
    ts = np.sort(NOW - NOW % DAY - 3 * DAY + rng.randint(0, 3 * DAY, n))
    tags = [rng.randint(0, 20, rng.randint(0, 5)).tolist() for _ in range(n)]
    score = (rng.rand(n) * 10).astype(np.float32)
    bufs = []
    for lo in range(0, n, 1000):
        b = UpsertBatchBuilder()
        for cid, t in enumerate((dt.Uint32, dt.Uint32, dt.ArrayInt32,
                                 dt.Float32)):
            b.add_column(cid, t)
        for i in range(lo, min(lo + 1000, n)):
            b.add_row()
            b.set_value(i - lo, 0, int(ts[i]))
            b.set_value(i - lo, 1, i)
            b.set_value(i - lo, 2, tags[i])
            b.set_value(i - lo, 3, float(score[i]))
        bufs.append(b.to_bytes())
    return bufs, tags, score


ARCH_EVENTS = {
    "name": "events",
    "columns": [{"name": "ts", "type": "Uint32"},
                {"name": "id", "type": "Uint32"},
                {"name": "tags", "type": "ArrayInt32"},
                {"name": "score", "type": "Float32"}],
    "primaryKeyColumns": [1], "isFactTable": True,
    "config": {"batchSize": 1024, "recordRetentionInDays": 0}}
E1 = {"measures": [{"sqlExpression": "sum(score)",
                    "rowFilters": ["contains(tags, 7)"]}],
      "dimensions": [{"sqlExpression": "length(tags)"}]}
E2 = count_by("element_at(tags, -1)")


def test_arrays_in_archive_batches(tmp_path):
    bufs, tags, score = archived_events()
    svcs = services([(ARCH_EVENTS, bufs)], str(tmp_path),
                    NOW - NOW % DAY - DAY)
    shard = svcs[1].executor.memstore.get_table_shard("events")
    assert shard.archive_store.get_current_version().batches
    e1 = same(svcs, E1, exact=False)
    want = {}
    for t, s in zip(tags, score):
        if 7 in t:
            want[str(len(t))] = want.get(str(len(t)), 0.0) + float(s)
    assert set(e1) == set(want)
    for k, v in want.items():
        assert e1[k] == pytest.approx(v, rel=1e-5)
    e2 = same(svcs, E2)
    last = {}
    for t in tags:
        k = str(t[-1]) if t else "NULL"
        last[k] = last.get(k, 0.0) + 1.0
    assert e2 == last


def test_archived_array_columns_stage_once(tmp_path):
    """The archive branch caches its staged lanes under ("arch", ...),
    as the JAX package keys them: a second query stages nothing new."""
    bufs, _, _ = archived_events(1200, seed=4)
    store = build(PORT_SIDE, [(ARCH_EVENTS, bufs)],
                  os.path.join(tmp_path, "port"), NOW - NOW % DAY - DAY)
    from aresdb_tpu_torch.query.service import QueryService

    cache = TX.DeviceColumnCache()
    svc = QueryService(store, device="cpu")
    svc.executor = TX.ShardExecutor(store, torch.device("cpu"),
                                    device_cache=cache)
    ask(svc, E2)
    misses = cache.stats()["misses"]
    ask(svc, E2)
    assert cache.stats()["misses"] == misses
    assert any(k[1] == "arch" for k in cache._entries)
    assert any(k[1] == "live-arr" for k in cache._entries)
