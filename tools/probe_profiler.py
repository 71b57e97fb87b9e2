#!/usr/bin/env python3
"""Does a torch.profiler session lose device events after a stretch of
unprofiled work?  Needs an NVIDIA card.

Usage:  python3 tools/probe_profiler.py [--gap 6] [--trials 10]

CelebA at full width (random weights from a seed), one fp32 bucket-64
engine.  Per trial and variant: ``--gap`` seconds of unprofiled serving
(dispatches and queued sleeps timed with CUDA events), then one profiled
session of three dispatches (15 kernel launches when the trace is whole):

* ``bare``: the session as it comes;
* ``fenced``: a little device work and a 20 ms pause after the session
  starts, 50 ms before it stops;
* ``throwaway``: a throwaway session first, then ``fenced`` (what
  `chip_smoke.profiled` does).

Prints per trial the kernels each variant's trace holds, then per variant
how many sessions came up short, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.models.dcnn import CELEBA_DCNN, generator_init  # noqa: E402
from repro_torch.serve import DcnnServeEngine, EngineConfig  # noqa: E402

DISPATCHES = 3


def main() -> int:
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser()
    ap.add_argument("--gap", type=float, default=6.0)
    ap.add_argument("--trials", type=int, default=10)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_profiler: needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    params = generator_init(torch.Generator().manual_seed(0), CELEBA_DCNN,
                            "cuda")
    eng = DcnnServeEngine.from_config(
        EngineConfig(model="celeba", buckets=(64,), warmup=True), params)
    z = np.zeros((64, 100), np.float32)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    want = DISPATCHES * len(CELEBA_DCNN.layers)

    def serve(seconds):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                eng.generate(z)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            torch.cuda._sleep(1_000_000)
            ev[1].record()
            torch.cuda.synchronize()
            ev[0].elapsed_time(ev[1])

    def fence(pause_s):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(pause_s)

    def session(variant):
        if variant == "throwaway":
            with profile(activities=acts):
                fence(0.0)
        with profile(activities=acts) as prof:
            if variant != "bare":
                fence(0.02)
            for _ in range(DISPATCHES):
                eng.generate(z)
            torch.cuda.synchronize()
            if variant != "bare":
                fence(0.05)
        return sum(1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "deconv2d" in e.name)

    got = {k: [] for k in ("bare", "fenced", "throwaway")}
    for trial in range(a.trials):
        for variant in got:
            serve(a.gap)
            got[variant].append(session(variant))
        print(json.dumps({"trial": trial, "gap_s": a.gap,
                          **{k: v[-1] for k, v in got.items()},
                          "want": want}), flush=True)
    print(json.dumps({"probe_profiler": {
        k: {"short": sum(n < want for n in v), "sessions": len(v)}
        for k, v in got.items()}, "want": want, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
