"""arescli: interactive SQL/AQL shell.

Reference: cmd/arescli (ishell-based — show tables/configs, multi-line
AQL/SQL ending with ';', cluster flag) plus the conveniences its TODOs
promise: readline history, `desc <table>`, timing, verbose stats
pass-through, JSON output mode, statement files, and broker targeting
(cluster mode is just a broker URL here — the broker serves the same
/query/sql and /query/aql surface).

    python -m aresdb_tpu_torch.cmd.arescli --host localhost --port 9374
    python -m aresdb_tpu_torch.cmd.arescli -e "SELECT count(*) FROM trips"
    python -m aresdb_tpu_torch.cmd.arescli -f statements.sql

Shell commands:
    show tables | show configs | desc <table>
    connect <host> <port>        retarget without restarting
    timing on|off                print wall latency per statement
    verbose on|off               request + print per-stage query stats
    format table|json            result rendering
    source <file>                run ';'-separated statements from a file
    exit | quit
Anything else is a statement: SQL, or AQL JSON (starts with '{').
Statements may span lines; terminate with ';' (reference ReadMultiLines).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def render_table(headers, rows) -> str:
    """ASCII table (reference utils/table_writer.go)."""
    widths = [len(str(h)) for h in headers]
    for row in rows:
        for i, v in enumerate(row):
            widths[i] = max(widths[i], len(str(v)))
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out = [sep,
           "|" + "|".join(f" {str(h):<{w}} " for h, w in zip(headers, widths))
           + "|", sep]
    for row in rows:
        out.append("|" + "|".join(
            f" {str(v):<{w}} " for v, w in zip(row, widths)) + "|")
    out.append(sep)
    return "\n".join(out)


def flatten_result(result, prefix=()):
    """Nested dim tree → rows."""
    rows = []
    for k, v in sorted(result.items()):
        if isinstance(v, dict):
            rows.extend(flatten_result(v, prefix + (k,)))
        else:
            rows.append(prefix + (k, v))
    return rows


class Shell:
    """Stateful shell: connection target + toggles + statement dispatch.

    Testable without a TTY: `dispatch(stmt)` handles one statement/command
    and writes to self.out / self.err.
    """

    def __init__(self, host: str, port: int, out=None, err=None):
        self.host = host
        self.port = port
        self.timing = False
        self.verbose = False
        self.format = "table"
        self.out = out or sys.stdout
        self.err = err or sys.stderr

    @property
    def base(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _print(self, *a):
        print(*a, file=self.out)

    def _error(self, *a):
        print("error:", *a, file=self.err)

    # -- command / statement dispatch --

    def dispatch(self, stmt: str) -> bool:
        """Handle one statement. Returns False when the shell should exit."""
        stmt = stmt.strip().rstrip(";").strip()
        if not stmt:
            return True
        low = stmt.lower()
        words = low.split()
        try:
            if low in ("exit", "quit"):
                return False
            if low in ("show tables", "tables"):
                self._show_tables()
            elif low == "show configs":
                self._print(json.dumps({
                    "host": self.host, "port": self.port,
                    "timing": self.timing, "verbose": self.verbose,
                    "format": self.format}, indent=1))
            elif words[0] in ("desc", "describe") and len(words) == 2:
                self._describe(stmt.split()[1])
            elif words[0] == "connect" and len(words) == 3:
                self.host, self.port = stmt.split()[1], int(words[2])
                self._print(f"target {self.base}")
            elif words[0] in ("timing", "verbose") and len(words) == 2 \
                    and words[1] in ("on", "off"):
                setattr(self, words[0], words[1] == "on")
            elif words[0] == "format" and len(words) == 2 \
                    and words[1] in ("table", "json"):
                self.format = words[1]
            elif words[0] == "source" and len(words) == 2:
                self._source(stmt.split()[1])
            else:
                self._query(stmt)
        except Exception as e:  # noqa: BLE001 — shell survives everything
            self._error(e)
        return True

    # -- commands --

    def _http(self):
        from aresdb_tpu_torch.utils import http_client

        return http_client

    def _show_tables(self):
        r = self._http().get(f"{self.base}/schema/tables", timeout=30)
        r.raise_for_status()
        self._print("\n".join(r.json()))

    def _describe(self, table: str):
        r = self._http().get(f"{self.base}/schema/tables/{table}",
                             timeout=30)
        if r.status_code != 200:
            self._error(f"got code {r.status_code} from aresdb server")
            return
        schema = r.json()
        if self.format == "json":
            self._print(json.dumps(schema, indent=2))
            return
        cols = schema.get("columns", [])
        pk = set(schema.get("primaryKeyColumns", []))
        sort_cols = {c: i for i, c in
                     enumerate(schema.get("archivingSortColumns", []))}
        rows = [(i, c.get("name"), c.get("type"),
                 "pk" if i in pk else "",
                 f"sort#{sort_cols[i]}" if i in sort_cols else "",
                 "deleted" if c.get("deleted") else "")
                for i, c in enumerate(cols)]
        self._print(render_table(
            ["id", "name", "type", "key", "sort", ""], rows))
        self._print(f"factTable={schema.get('isFactTable')} "
                    f"config={json.dumps(schema.get('config', {}))}")

    def _source(self, path: str):
        with open(path) as f:
            text = f.read()
        for stmt in text.split(";"):
            if stmt.strip():
                if not self.dispatch(stmt):
                    break

    def _query(self, stmt: str):
        t0 = time.perf_counter()
        if stmt.startswith("{"):
            body = {"queries": [json.loads(stmt)]}
            if self.verbose:
                body["verbose"] = True
            r = self._http().post(f"{self.base}/query/aql", json=body,
                                  timeout=600)
        else:
            body = {"queries": [stmt]}
            if self.verbose:
                body["verbose"] = True
            r = self._http().post(f"{self.base}/query/sql", json=body,
                                  timeout=600)
        dt = (time.perf_counter() - t0) * 1e3
        try:
            out = r.json()
        except ValueError:
            self._error(f"got code {r.status_code} from aresdb server")
            return
        if out.get("errors") and any(out["errors"]):
            self._error(out["errors"])
            return
        result = out["results"][0]
        if self.format == "json":
            self._print(json.dumps(result, indent=1))
        elif "matrixData" in result:
            self._print(render_table(result.get("headers", []),
                                     result["matrixData"]))
        else:
            rows = flatten_result(result)
            n_dims = max((len(r) - 1 for r in rows), default=1)
            headers = [f"dim{i}" for i in range(n_dims)] + ["value"]
            self._print(render_table(headers, rows))
        if self.verbose and "context" in out:
            self._print("stats:", json.dumps(out["context"][0], indent=1))
        if self.timing:
            self._print(f"({dt:.0f} ms)")


def repl(shell: Shell) -> None:
    try:
        import readline  # noqa: F401 — history + line editing
    except ImportError:
        pass
    print(f"connected to {shell.base}; SQL statements / AQL JSON end with "
          f"';' and may span lines. Commands: show tables, desc <t>, "
          f"connect, timing, verbose, format, source, exit",
          file=sys.stderr)
    buf: list = []
    while True:
        prompt = "ares> " if not buf else "  ... "
        try:
            line = input(prompt)
        except (EOFError, KeyboardInterrupt):
            break
        buf.append(line)
        stripped = line.strip()
        # commands complete on one line; statements need the ';'
        one = " ".join(buf).strip()
        first = one.split()[0].lower() if one.split() else ""
        is_cmd = first in ("exit", "quit", "show", "tables", "desc",
                           "describe", "connect", "timing", "verbose",
                           "format", "source")
        if is_cmd or stripped.endswith(";"):
            buf.clear()
            if not shell.dispatch(one):
                break


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="arescli", description=__doc__)
    p.add_argument("--host", default="localhost")
    p.add_argument("--port", type=int, default=9374)
    p.add_argument("-e", "--execute", help="run one statement and exit")
    p.add_argument("-f", "--file", help="run ';'-separated statements "
                                        "from a file and exit")
    p.add_argument("--timing", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--json", action="store_true", dest="json_out",
                   help="render results as JSON")
    args = p.parse_args(argv)

    shell = Shell(args.host, args.port)
    shell.timing = args.timing
    shell.verbose = args.verbose
    if args.json_out:
        shell.format = "json"
    if args.execute:
        shell.dispatch(args.execute)
        return 0
    if args.file:
        shell._source(args.file)
        return 0
    repl(shell)
    return 0


if __name__ == "__main__":
    sys.exit(main())
