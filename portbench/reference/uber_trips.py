"""The uber_trips deployment's rows, drawn from a seed, and the ingest
stream of its ingest cell.

Each archived day holds `rows_per_day` trips, and so does the live day:
the table's `archivingDelayMinutes` (1440) keep the last 24 hours live.
A day's trips arrive in time order.
Cities follow a Zipf law over `cities` ids (id 0 the largest), statuses
and fares the shares and lognormal law of the file's `assumed`; a seed
changes the rows and never their number, the cities' sizes in
expectation, or the layout of days and batches.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from portbench.reference.engine import DAY, Deployment, Rows, encode, rng_of

STATUS = ["completed", "canceled", "rejected"]


def live_seconds(cfg: dict) -> int:
    """How long a row stays live: the table's archiving delay."""
    return cfg["table"]["config"]["archivingDelayMinutes"] * 60


def anchors(cfg: dict, clock: int) -> tuple:
    """(now, cutoff): now the latest midnight UTC at or before the clock,
    the Archiver's cutoff the archiving delay before it."""
    now = clock // DAY * DAY
    return now, now - live_seconds(cfg)


def city_shares(cfg: dict) -> np.ndarray:
    a = cfg["assumed"]
    p = 1.0 / np.arange(1, a["cities"] + 1) ** a["city_zipf"]
    return p / p.sum()


def draw(cfg: dict, rng, n: int, t0: int, span: int) -> dict:
    """n trips with request_at uniform in [t0, t0 + span), in time order:
    {column: values}, with the fare's validity under "fare_valid"."""
    a = cfg["assumed"]
    return {
        "request_at": (t0 + np.sort(rng.integers(0, span, n))).astype(
            np.uint32),
        "uuid": rng.integers(0, np.iinfo(np.uint64).max, (n, 2),
                             dtype=np.uint64, endpoint=True),
        "city_id": rng.choice(a["cities"], n, p=city_shares(cfg)).astype(
            np.uint16),
        "status": rng.choice(3, n, p=a["status_shares"]).astype(np.uint8),
        "fare": rng.lognormal(np.log(a["fare_lognormal_median"]),
                              a["fare_lognormal_sigma"], n).astype(
            np.float32),
        "fare_valid": rng.random(n) >= a["fare_null_share"],
    }


def generate(cfg: dict, seed: int, clock: int) -> Deployment:
    """The deployment's rows for `seed`, anchored on the set-up's clock:
    the archived days oldest first, then the live day."""
    now, cutoff = anchors(cfg, clock)
    live_s = live_seconds(cfg)
    live = cfg["rows_per_day"] * live_s // DAY
    jobs = [(rng_of(seed, 0, d), cfg["rows_per_day"], cutoff - d * DAY, DAY)
            for d in range(cfg["archived_days"], 0, -1)]
    jobs.append((rng_of(seed, 1), live, cutoff, live_s))
    # a stream of its own a day, so the days are drawn side by side
    with ThreadPoolExecutor(len(jobs)) as pool:
        parts = list(pool.map(lambda j: draw(cfg, *j), jobs))
    cols = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    valid = {"fare": cols.pop("fare_valid")}
    rows = Rows(cols, valid, {"status": STATUS}, "request_at")
    return Deployment(cfg, rows, now, cutoff)


class Stream:
    """The ingest cell's upserts: for each sender, upserts of `rows` rows,
    `new_share` of them new trips at request_at in the last `window_s`
    before now, the rest status updates, by uuid, of set-up trips of that
    window (the sender's own share of them, so no two senders update one
    trip). `blobs[s]` are sender s's wire bytes in order, `new[s][k]` the
    new rows of its k-th upsert and `updates[s][k]` (row indices, new
    statuses) of its updates."""

    def __init__(self, dep: Deployment, seed: int, senders: int,
                 per_sender: int, rows: int, new_share: float,
                 window_s: int):
        t = dep.rows.columns["request_at"]
        recent = np.flatnonzero(t >= dep.now - window_s)
        n_new = int(round(rows * new_share))
        n_upd = rows - n_new
        a = dep.cfg["assumed"]
        self.blobs, self.new, self.updates = [], [], []
        for s in range(senders):
            rng = rng_of(seed, 2, s)
            mine = recent[s::senders]
            blobs, news, upds = [], [], []
            for _ in range(per_sender):
                new = draw(dep.cfg, rng, n_new, dep.now - window_s, window_s)
                idx = rng.choice(mine, n_upd, replace=False) \
                    if n_upd else np.zeros(0, np.int64)
                status = rng.choice(3, n_upd, p=a["status_shares"]).astype(
                    np.uint8)
                cols = {k: np.concatenate([new[k], dep.rows.columns[k][idx]])
                        for k in ("request_at", "uuid", "city_id", "fare")}
                cols["status"] = np.concatenate([new["status"], status])
                valid = {"fare": np.concatenate(
                    [new["fare_valid"], dep.rows.valid["fare"][idx]])}
                blobs.append(encode(dep.cfg, Rows(cols, valid, {},
                                                  "request_at"),
                                    np.arange(rows)))
                news.append(new)
                upds.append((idx, status))
            self.blobs.append(blobs)
            self.new.append(news)
            self.updates.append(upds)

    def applied(self, dep: Deployment, acked) -> Rows:
        """The rows once the upserts in acked ({sender: [k...]}, in each
        sender's order) are applied to dep's rows: last write wins."""
        c = dep.rows.columns
        status = c["status"].copy()
        extra = []
        for s, ks in acked.items():
            for k in ks:
                idx, st = self.updates[s][k]
                status[idx] = st
                extra.append(self.new[s][k])
        cols = dict(c, status=status)
        valid = dict(dep.rows.valid)
        if extra:
            for k in ("request_at", "uuid", "city_id", "status", "fare"):
                cols[k] = np.concatenate([cols[k]] + [e[k] for e in extra])
            valid["fare"] = np.concatenate(
                [valid["fare"]] + [e["fare_valid"] for e in extra])
        return Rows(cols, valid, dep.rows.enums, dep.rows.time_column)

    def every(self) -> dict:
        """Every upsert of every sender, as `applied` takes them."""
        return {s: list(range(len(b))) for s, b in enumerate(self.blobs)}
