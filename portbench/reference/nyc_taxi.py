"""The nyc_taxi deployment's rows, drawn from a seed.

One day is held in every `day_stride` of the `days` from `first_day`
(2009-01-01 .. 2015-06-30), each with `rows_per_day` trips in time
order: the 51 columns of the published trips table, drawn from the laws
of the file's `assumed`. The Archiver's cutoff is the midnight after the
last day, so set-up archives the whole table, a day batch a held day. A
seed changes the rows and never their number or the layout of days.

The frozen encoder (`wire.py`) has no code for Int8, Int16, BigEnum or
GeoPoint. Those columns go to it as lanes of the same width (int8 viewed
as uint8, int16 and BigEnum codes as uint16, a GeoPoint's two float32 as
two uint32), and their type words in the header are then set to
AresDB's codes: the bytes are those of the port's own encoder.
"""

from __future__ import annotations

import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from portbench import wire
from portbench.reference.engine import (DAY, Deployment, Rows, day_seconds,
                                        rng_of)

# AresDB's codes of the types wire.py lacks (memstore/common/data_type.go)
Int8 = 0x00010008
Int16 = 0x00030010
BigEnum = 0x00090010
GeoPoint = 0x000B0040
# type name -> (the wire.py lane type it goes as, the code set after)
LANES = {"Int8": (wire.Uint8, Int8), "Int16": (wire.Uint16, Int16),
         "BigEnum": (wire.Uint16, BigEnum),
         "GeoPoint": (wire.Uint32, GeoPoint)}

CENSUS = ("nyct2010_gid", "ctlabel", "borocode", "boroname", "ct2010",
          "boroct2010", "cdeligibil", "ntacode", "ntaname", "puma")


def held_days(cfg: dict) -> list:
    """The held days' midnights, oldest first."""
    first = day_seconds(cfg["first_day"])
    days = [first + d * DAY for d in range(0, cfg["days"], cfg["day_stride"])]
    if len(days) != cfg["days_held"]:
        raise ValueError(f"day_stride {cfg['day_stride']} holds {len(days)} "
                         f"days, not days_held {cfg['days_held']}")
    return days


def tracts(cfg: dict) -> dict:
    """{census column: its value (code) for each tract}, the tracts
    borough by borough, and each tract's (latitude, longitude) centre
    and share of trips. A tract's NTA and PUMA are its borough's in
    blocks, as the configuration's case lists lay them out."""
    a = cfg["assumed"]
    per, ntas, pumas = (a["tracts_per_borough"], a["ntas_per_borough"],
                        a["pumas_per_borough"])
    cols = {k: [] for k in CENSUS}
    share = []
    nta0 = puma0 = t0 = 0
    for b, n in enumerate(per):
        j = np.arange(n)
        cols["nyct2010_gid"].append(t0 + j + 1)
        cols["ctlabel"].append(j)
        cols["borocode"].append(np.full(n, b + 1))
        cols["boroname"].append(np.full(n, b))
        cols["ct2010"].append(j)
        cols["boroct2010"].append(t0 + j)
        cols["cdeligibil"].append((j % 3 == 0).astype(int))
        cols["ntacode"].append(nta0 + j * ntas[b] // n)
        cols["ntaname"].append(nta0 + j * ntas[b] // n)
        cols["puma"].append(puma0 + j * pumas[b] // n)
        z = 1.0 / (j + 1) ** a["tract_zipf"]
        share.append(a["borough_shares"][b] * z / z.sum())
        t0, nta0, puma0 = t0 + n, nta0 + ntas[b], puma0 + pumas[b]
    out = {k: np.concatenate(v) for k, v in cols.items()}
    rng = rng_of(0, 99)     # the city's layout, the same for every seed
    n = t0
    out["lat"] = (40.70 + 0.12 * rng.random(n)).astype(np.float32)
    out["lon"] = (-74.02 + 0.15 * rng.random(n)).astype(np.float32)
    share = np.concatenate(share)
    out["share"] = share / share.sum()
    return out


def _weather(rng, day: int) -> dict:
    """One day's weather, the same for all its trips."""
    doy = (day // DAY) % 365
    tmax = 62 + 22 * np.sin(2 * np.pi * (doy - 105) / 365) + rng.normal(0, 6)
    winter = doy < 80 or doy > 335
    return {
        "precipitation": 0 if rng.random() < 0.65 else
        min(127, int(rng.geometric(1 / 3))),
        "snow_depth": int(rng.integers(0, 13)) if winter and
        rng.random() < 0.3 else 0,
        "snowfall": int(rng.integers(1, 101)) if winter and
        rng.random() < 0.1 else 0,
        "max_temperature": int(round(tmax)),
        "min_temperature": int(round(tmax - rng.uniform(8, 20))),
        "average_wind_speed": int(round(rng.uniform(3, 15))),
    }


def _shares(p) -> np.ndarray:
    p = np.asarray(p, np.float64)
    return p / p.sum()


def draw(cfg: dict, rng, day: int, first_id: int, geo: dict) -> dict:
    """One held day's trips in time order: {column: values}, and each
    nullable column's validity under "<column>_valid"."""
    a = cfg["assumed"]
    n = cfg["rows_per_day"]
    f32 = np.float32
    out = {}
    pickup = day + np.sort(rng.integers(0, DAY, n))
    out["pickup_datetime"] = pickup.astype(np.uint32)
    out["trip_id"] = np.arange(first_id, first_id + n, dtype=np.uint32)
    green = np.zeros(n, bool)
    if day >= day_seconds(a["green_from"]):
        green = rng.random(n) < a["green_share"]
    out["cab_type"] = green.astype(np.uint8)
    late = day >= day_seconds("2015-01-01")
    v_old = rng.choice(5, n, p=_shares(a["vendor_shares_before_2015"]))
    v_new = rng.choice(5, n, p=_shares(a["vendor_shares_from_2015_and_green"]))
    out["vendor_id"] = np.where(green | late, v_new, v_old).astype(np.uint8)
    dur = rng.lognormal(np.log(a["trip_duration_lognormal_median_s"]),
                        a["trip_duration_lognormal_sigma"], n)
    out["dropoff_datetime"] = (pickup + np.minimum(dur, 6 * 3600).astype(
        np.int64)).astype(np.uint32)
    out["store_and_fwd_flag"] = (rng.random(n) < a[
        "store_and_fwd_flag_y_share"]).astype(np.uint8)
    out["store_and_fwd_flag_valid"] = rng.random(n) >= a[
        "store_and_fwd_flag_null_share"]
    out["rate_code_id"] = rng.choice(
        np.asarray(a["rate_code_values"], np.uint8), n,
        p=_shares(a["rate_code_shares"]))
    # passenger_count: the published shares, and a few absurd values
    pc = rng.choice(np.asarray(a["passenger_count_values"], np.uint8), n,
                    p=_shares(a["passenger_count_shares"]))
    odd = rng.random(n) < a["passenger_count_beyond_share"]
    pc[odd] = rng.integers(10, 256, int(odd.sum()))
    out["passenger_count"] = pc
    # trip_distance: lognormal, some zeros, a few absurd values
    dist = rng.lognormal(np.log(a["trip_distance_lognormal_median"]),
                         a["trip_distance_lognormal_sigma"], n)
    dist[rng.random(n) < a["trip_distance_zero_share"]] = 0.0
    absurd = rng.random(n) < a["trip_distance_absurd_share"]
    lo, hi = a["trip_distance_absurd_log10"]
    dist[absurd] = 10 ** rng.uniform(lo, hi, int(absurd.sum()))
    out["trip_distance"] = dist.astype(f32)
    out["fare_amount"] = rng.lognormal(
        np.log(a["fare_amount_lognormal_median"]),
        a["fare_amount_lognormal_sigma"], n).astype(f32)
    out["extra"] = rng.choice(np.asarray(a["extra_values"], f32), n,
                              p=_shares(a["extra_shares"]))
    out["mta_tax"] = np.full(n, a["mta_tax"], f32)
    tip = rng.lognormal(np.log(a["tip_lognormal_median"]),
                        a["tip_lognormal_sigma"], n)
    tip[rng.random(n) < a["tip_zero_share"]] = 0.0
    out["tip_amount"] = tip.astype(f32)
    out["tolls_amount"] = np.where(rng.random(n) < a["tolls_share"],
                                   a["tolls_value"], 0.0).astype(f32)
    out["ehail_fee"] = np.zeros(n, f32)
    out["ehail_fee_valid"] = green.copy()
    out["improvement_surcharge"] = np.full(n, 0.3 if late else 0.0, f32)
    out["total_amount"] = rng.lognormal(
        np.log(a["total_amount_lognormal_median"]),
        a["total_amount_lognormal_sigma"], n).astype(f32)
    out["total_amount_valid"] = rng.random(n) >= a["total_amount_null_share"]
    out["payment_type"] = rng.choice(5, n, p=_shares(
        a["payment_type_shares"])).astype(np.uint8)
    out["trip_type"] = np.where(rng.random(n) < 0.98, 1, 2).astype(np.uint8)
    out["trip_type_valid"] = green.copy()
    for k, v in _weather(rng, day).items():
        out[k] = np.full(n, v, np.int8)
    types = {c["name"]: c["type"] for c in cfg["table"]["columns"]}
    for side in ("pickup", "dropoff"):
        t = rng.choice(len(geo["share"]), n, p=geo["share"])
        known = rng.random(n) >= a["census_null_share"]
        lat = np.where(known, geo["lat"][t] + rng.normal(0, 0.003, n)
                       .astype(f32), 0).astype(f32)
        lon = np.where(known, geo["lon"][t] + rng.normal(0, 0.003, n)
                       .astype(f32), 0).astype(f32)
        out[f"{side}_latitude"] = lat
        out[f"{side}_longitude"] = lon
        out[side] = np.stack([lat, lon], axis=1)
        out[f"{side}_valid"] = known
        for k in CENSUS:
            col = f"{side}_{k}"
            out[col] = geo[k][t].astype(_DTYPES[types[col]])
            out[f"{col}_valid"] = known
    return out


# the census columns' types
_DTYPES = {"Int8": np.int8, "Int16": np.int16, "SmallEnum": np.uint8,
           "BigEnum": np.uint16}


def generate(cfg: dict, seed: int, clock: int) -> "NycDeployment":
    """The deployment's rows for `seed`: every held day, oldest first.
    The clock plays no part: the table is historical."""
    days = held_days(cfg)
    geo = tracts(cfg)
    n = cfg["rows_per_day"]
    first = day_seconds(cfg["first_day"])
    jobs = [(rng_of(seed, 0, i), d, 1 + (d - first) // DAY * n)
            for i, d in enumerate(days)]
    # a stream of its own a day, so the days are drawn side by side
    with ThreadPoolExecutor(min(len(jobs), 8)) as pool:
        parts = list(pool.map(lambda j: draw(cfg, j[0], j[1], j[2], geo),
                              jobs))
    cols = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    valid = {k[:-len("_valid")]: cols.pop(k) for k in list(cols)
             if k.endswith("_valid")}
    rows = Rows(cols, valid, dict(cfg["enums"]), cfg["time_column"])
    cutoff = days[-1] + DAY
    return NycDeployment(cfg, rows, cutoff, cutoff)


class NycDeployment(Deployment):
    """A Deployment whose upserts carry the types wire.py lacks."""

    def upserts(self, lo: int = 0, hi: int = None):
        hi = len(self.rows) if hi is None else hi
        step = self.cfg["upsert_rows"]
        for off in range(lo, hi, step):
            yield encode(self.cfg, self.rows,
                         np.arange(off, min(off + step, hi)))


def encode(cfg: dict, rows: Rows, index: np.ndarray) -> bytes:
    """The upsert of rows[index], every column of the configuration's
    table in its order: wire.encode with each column wire.py lacks as
    lanes of its width, then that column's type word set."""
    cols, patch = [], {}
    for cid, col in enumerate(cfg["table"]["columns"]):
        name, typ = col["name"], col["type"]
        values = rows.columns[name][index]
        if typ in LANES:
            lane, code = LANES[typ]
            values = values.view(wire.LANE_DTYPE[lane])
            patch[cid] = code
        else:
            lane = wire.TYPE_CODES[typ]
        valid = rows.valid.get(name)
        cols.append((cid, lane, values,
                     None if valid is None else valid[index], 0))
    buf = bytearray(wire.encode(cols, len(index)))
    n_cols = len(cols)
    # the header's type words: after the version, the row and column
    # counts and the arrival time (28 bytes), the column end offsets
    # (n + 1 words) and the enum dict lengths and reserved words
    type_off = 28 + (n_cols + 1) * 4 + n_cols * 8
    for cid, code in patch.items():
        struct.pack_into("<I", buf, type_off + cid * 4, code)
    return bytes(buf)
