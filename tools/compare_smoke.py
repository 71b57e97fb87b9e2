#!/usr/bin/env python3
"""Compare the timed rows of several chip_smoke.py outputs, run in turns in
one chip call (e.g. parent, change, change, parent).

Usage:  python3 tools/compare_smoke.py BASE_1 NEW_1 NEW_2 BASE_2 ...
        (files holding chip_smoke.py's standard output; the ones named
        with --base are the reference runs, the rest the change's)

    python3 tools/compare_smoke.py --base p1.txt p2.txt --new c1.txt c2.txt

Prints, per kernel, net, layer and bucket, the mean device time of the base
runs and of the new runs, their ratio and the spread of each side, then per
path and net the bucket-64 dispatch time (ms) the same way, as markdown
tables.
"""
from __future__ import annotations

import argparse
import json
import statistics


def read(path):
    rows, e2e = {}, {}
    for line in open(path):
        if line.startswith('{"layer_time"'):
            r = json.loads(line)["layer_time"]
            rows[r["kernel"], r["net"], r["layer"], r["bucket"]] = r
        elif line.startswith('{"end_to_end"'):
            d = json.loads(line)
            e2e[d["path"], d["net"]] = d["end_to_end"]
    return rows, e2e


def spread(v):
    return (max(v) - min(v)) / statistics.mean(v) if len(v) > 1 else 0.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", nargs="+", required=True)
    ap.add_argument("--new", nargs="+", required=True)
    a = ap.parse_args()
    base = [read(p) for p in a.base]
    new = [read(p) for p in a.new]
    print("| kernel | net | layer | bucket | base ms | new ms | new / base "
          "| base spread | new spread | new split |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for key in base[0][0]:
        b = [r[0][key]["ms"] for r in base]
        n = [r[0][key]["ms"] for r in new if key in r[0]]
        if not n:
            continue
        split = new[0][0][key].get("split", "")
        print(f"| {key[0]} | {key[1]} | {key[2]} | {key[3]} | "
              f"{statistics.mean(b):.4f} | {statistics.mean(n):.4f} | "
              f"{statistics.mean(n) / statistics.mean(b):.3f} | "
              f"{spread(b):.3f} | {spread(n):.3f} | {split} |")
    print()
    print("| path | net | base ms per dispatch | new ms | new / base | base "
          "CVs | new CVs |")
    print("|---|---|---|---|---|---|---|")
    for key in base[0][1]:
        b = [r[1][key]["mean_ms"] for r in base]
        n = [r[1][key]["mean_ms"] for r in new]
        print(f"| {key[0]} | {key[1]} | {statistics.mean(b):.3f} | "
              f"{statistics.mean(n):.3f} | "
              f"{statistics.mean(n) / statistics.mean(b):.3f} | "
              f"{', '.join(f'{r[1][key]['cv']:.3f}' for r in base)} | "
              f"{', '.join(f'{r[1][key]['cv']:.3f}' for r in new)} |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
