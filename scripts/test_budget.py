"""Per-file time budget of a pytest run, read from its junit XML.

    python scripts/test_budget.py RUN.xml              # one run
    python scripts/test_budget.py PARENT.xml CHANGE.xml  # a comparison

For one run it prints each test file's summed seconds (a case's junit time
is its setup, call and teardown together, so a module fixture counts on the
case that first asks for it), its case count and its passes, longest
first, then every case over 10 s.  Given a
parent's run and a change's run of the same command on the same machine, it
prints both sums and counts side by side, the ratio of the port's sums
(files `test_torch_*.py`; the rank jobs module runs inside them), the
ratio of the other files' sums, and every file whose case count changed.
For each run it then replays the cases on the tier-1 command's 6 workers
as pytest-xdist 3.8 hands them out under `--dist loadfile`: whole files,
the file with the most cases first (ties in collection order), two files
to a worker at the start and one more whenever a worker has two or fewer
cases left; it prints the predicted wall time and the files each worker
ends on.  It only reads: no test reads it.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import xml.etree.ElementTree as ET

PORT_PREFIX = "test_torch_"
SLOW_S = 10.0   # the cases listed by name
WORKERS = 6     # the tier-1 command's `-n 6`

Case = collections.namedtuple("Case", "file name seconds outcome")


def _file_of(case: ET.Element) -> str:
    """The test file of a junit testcase: its `file` attribute where the
    junit family writes one, else the module part of `classname`
    (`tests.test_x` or `tests.test_x.TestClass`)."""
    if case.get("file"):
        return os.path.basename(case.get("file"))
    parts = case.get("classname", "").split(".")
    for i in range(len(parts) - 1, -1, -1):
        if parts[i].startswith("test_") or parts[i].endswith("_test"):
            return parts[i] + ".py"
    return ".".join(parts) or "?"


def _outcome(case: ET.Element) -> str:
    for tag in ("failure", "error", "skipped"):
        if case.find(tag) is not None:
            return tag
    return "passed"


def read(path: str) -> list[Case]:
    root = ET.parse(path).getroot()
    return [Case(_file_of(c), c.get("name", "?"), float(c.get("time") or 0.0), _outcome(c))
            for c in root.iter("testcase")]


def per_file(cases: list[Case]) -> dict[str, dict]:
    out: dict[str, dict] = {}
    for c in cases:
        row = out.setdefault(c.file, dict(seconds=0.0, cases=0, passed=0))
        row["seconds"] += c.seconds
        row["cases"] += 1
        row["passed"] += c.outcome == "passed"
    return out


def is_port(file: str) -> bool:
    return file.startswith(PORT_PREFIX)


def totals(files: dict[str, dict]) -> dict[str, dict]:
    out = {"port": dict(seconds=0.0, cases=0, passed=0), "other": dict(seconds=0.0, cases=0, passed=0)}
    for name, row in files.items():
        side = out["port" if is_port(name) else "other"]
        for k in side:
            side[k] += row[k]
    return out


def replay(cases: list[Case], workers: int) -> tuple[float, list[list[str]]]:
    """Predicted wall time of `cases` on `workers` under xdist's loadfile
    scheduling (xdist/scheduler/loadscope.py), and each worker's files."""
    files: dict[str, list[float]] = {}
    for c in cases:
        files.setdefault(c.file, []).append(c.seconds)
    queue = [f for f, _ in sorted(files.items(), key=lambda kv: (-len(kv[1]), kv[0]))]
    pending = [[] for _ in range(workers)]   # per worker: seconds of its queued cases
    clock = [0.0] * workers
    order = [[] for _ in range(workers)]

    def assign(w):
        if queue:
            f = queue.pop(0)
            pending[w].extend(files[f])
            order[w].append(f)

    for w in range(workers):
        assign(w)
    for w in range(workers):
        if len(pending[w]) <= 2:
            assign(w)
    while any(pending):
        w = min((w for w in range(workers) if pending[w]), key=lambda w: clock[w] + pending[w][0])
        clock[w] += pending[w].pop(0)
        if len(pending[w]) <= 2:
            assign(w)
    return max(clock), order


def _table(header: list[str], rows: list[list[str]]) -> str:
    widths = [max(len(x) for x in col) for col in zip(header, *rows)]
    fmt = lambda r: "  ".join(x.rjust(w) if i else x.ljust(w) for i, (x, w) in enumerate(zip(r, widths)))
    return "\n".join([fmt(header)] + [fmt(r) for r in rows])


def _print_replay(path: str, cases: list[Case], workers: int) -> None:
    wall, order = replay(cases, workers)
    print(f"replay of {path} on {workers} workers: {wall:.1f} s")
    for w, fs in enumerate(order):
        print(f"  worker {w}: ... {', '.join(fs[-3:])}")


def report_one(path: str) -> None:
    cases = read(path)
    files = per_file(cases)
    rows = [[name, f"{row['seconds']:.1f}", str(row["cases"]), str(row["passed"])]
            for name, row in sorted(files.items(), key=lambda kv: -kv[1]["seconds"])]
    print(f"# {path}: {len(cases)} cases in {len(files)} files")
    print(_table(["file", "summed s", "cases", "passed"], rows))
    for side, row in totals(files).items():
        print(f"{side}: {row['seconds']:.1f} s summed, {row['cases']} cases, {row['passed']} passed")
    slow_cases = sorted((c for c in cases if c.seconds > SLOW_S), key=lambda c: -c.seconds)
    print(f"\n# cases over {SLOW_S:g} s: {len(slow_cases)}, "
          f"{sum(c.seconds for c in slow_cases):.1f} s")
    for c in slow_cases:
        print(f"{c.seconds:8.1f}  {c.file}::{c.name}")
    _print_replay(path, cases, WORKERS)


def report_two(parent: str, change: str) -> None:
    before, after = per_file(read(parent)), per_file(read(change))
    names = sorted(set(before) | set(after),
                   key=lambda n: -max(before.get(n, {}).get("seconds", 0.0),
                                      after.get(n, {}).get("seconds", 0.0)))
    empty = dict(seconds=0.0, cases=0, passed=0)
    rows = []
    for n in names:
        b, a = before.get(n, empty), after.get(n, empty)
        rows.append([n, f"{b['seconds']:.1f}", f"{a['seconds']:.1f}", str(b["cases"]),
                     str(a["cases"]), str(b["passed"]), str(a["passed"])])
    print(f"# parent {parent}\n# change {change}")
    print(_table(["file", "parent s", "change s", "parent cases", "change cases",
                  "parent passed", "change passed"], rows))
    tb, ta = totals(before), totals(after)
    for side in ("port", "other"):
        b, a = tb[side], ta[side]
        ratio = a["seconds"] / b["seconds"] if b["seconds"] else float("nan")
        print(f"{side}: {b['seconds']:.1f} s -> {a['seconds']:.1f} s summed (ratio {ratio:.3f}); "
              f"cases {b['cases']} -> {a['cases']}; passed {b['passed']} -> {a['passed']}")
    longest = max((r for n, r in after.items() if is_port(n)), key=lambda r: r["seconds"],
                  default=empty)
    print(f"longest port file in the change: {longest['seconds']:.1f} s")
    moved = [n for n in names if before.get(n, empty)["cases"] != after.get(n, empty)["cases"]]
    if moved:
        print("files whose case count changed: " + ", ".join(
            f"{n} {before.get(n, empty)['cases']}->{after.get(n, empty)['cases']}" for n in moved))
    for path in (parent, change):
        _print_replay(path, read(path), WORKERS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("xml", nargs="+", help="one junit XML file, or a parent's and a change's")
    args = ap.parse_args(argv)
    if len(args.xml) == 1:
        report_one(args.xml[0])
    elif len(args.xml) == 2:
        report_two(args.xml[0], args.xml[1])
    else:
        ap.error("give one or two junit XML files")
    return 0


if __name__ == "__main__":
    sys.exit(main())
