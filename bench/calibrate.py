#!/usr/bin/env python3
"""Readings that the check's limit is set from, for one cell: for each
seed, a run of the cell (set-up, a window of ``--seconds``, the program's
state freed), then the widest gap of the program's sampled images to the
float32 reference, and the widest gap of the control (the reference in
TF32, put in the program's place) on the same requests.  One process for
all seeds; needs the card.  One JSON line per seed.

    python3 bench/calibrate.py --workload celeba.batch64 --seconds 3 --seeds 1 2 3
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(HERE), "src")]

from benchkit import harness, spec  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.find_cell(spec.load_benchmark(), args.workload)
    harness.require_cards(cell.chips)
    for seed in args.seeds:
        run = harness.execute(cell, seed, args.seconds, False,
                              time.perf_counter())
        z, _ = harness.sample_inputs(run)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "requests": len(run.sample), "images": int(z.shape[0]),
            "program": harness.check(run, seed),
            "control": harness.check(run, seed, control=True)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
