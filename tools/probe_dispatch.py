#!/usr/bin/env python3
"""Where the host time of a replayed dispatch goes, and what bringing the
images back another way would cost.  Needs an NVIDIA card.

Usage:  python3 tools/probe_dispatch.py [--runs 50] [--keep 32] [--out FILE]

For both generators on the fp32 and int8 paths at bucket 64 (random
weights from a seed, default engines), times with the host clock, in
turns, one dispatch's device side (staged z copied up, one replay) followed
by one of five ways to hand the images to the caller, each keeping its
last ``--keep`` results alive as a caller holding tickets does (so a way
that needs new memory per result pays for it):

* ``engine``: what `ShardedExecutable` does: into a pinned tensor of its
  own while the process-wide budget ``engine.PINNED_RESULTS`` allows,
  else into the bucket's pinned buffer and a numpy copy out of it;
* ``copy_numpy``: always into one pinned staging buffer, then a numpy copy
  out of it (so that a result never aliases a buffer the next dispatch
  reuses);
* ``copy_torch``: the same, the copy made by torch into a new pageable
  tensor (spread over the intra-op threads);
* ``fresh_pinned``: into a pinned tensor of its own from PyTorch's caching
  host allocator, handed out as it is, without a bound (pinned memory
  grows with the results kept);
* ``pageable``: ``.cpu()`` of the device output (a pageable copy).

Prints one JSON line per net, path and way: median, mean and CV of the
dispatch in ms, with the card's name and power limit; and per net and path
the statistics of PyTorch's pinned host allocator after the runs, where
``torch.cuda.host_memory_stats`` exists.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.models.dcnn import (CELEBA_DCNN, MNIST_DCNN,  # noqa: E402
                                     generator_init)
from repro_torch.serve import DcnnServeEngine, EngineConfig  # noqa: E402
from repro_torch.serve import engine as engine_mod  # noqa: E402


def ways(ex, take):
    """``ex`` is the bucket's `ShardedExecutable`, of one shard."""
    out_dev = ex.shards[0].out_dev
    staging = torch.empty(out_dev.shape, dtype=out_dev.dtype,
                          pin_memory=True)

    def copy_numpy():
        staging.copy_(out_dev, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        return staging[:take].numpy().copy()

    def copy_torch():
        staging.copy_(out_dev, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        out = torch.empty((take,) + tuple(staging.shape[1:]),
                          dtype=staging.dtype)
        return out.copy_(staging[:take]).numpy()

    def fresh_pinned():
        out = torch.empty(out_dev.shape, dtype=out_dev.dtype,
                          pin_memory=True)
        out.copy_(out_dev, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        return out[:take].numpy()

    def pageable():
        return out_dev[:take].cpu().numpy()

    def engine():
        got = ex.enqueue(take)
        ex.wait()
        return ex.images(got, take)

    return {"engine": engine, "copy_numpy": copy_numpy,
            "copy_torch": copy_torch, "fresh_pinned": fresh_pinned,
            "pageable": pageable}


def pinned_stats():
    """The pinned host allocator's statistics (bytes, allocations and the
    time spent in them), where this PyTorch reports them (else None)."""
    if not hasattr(torch.cuda, "host_memory_stats"):
        return None
    return dict(torch.cuda.host_memory_stats())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=50)
    ap.add_argument("--keep", type=int, default=32)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_dispatch: needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    lines = []
    rng = np.random.default_rng(0)
    for cfg in (MNIST_DCNN, CELEBA_DCNN):
        params = generator_init(torch.Generator().manual_seed(0), cfg, "cuda")
        for path, kw in (("fp32", {}), ("int8", {"precision": "int8"})):
            eng = DcnnServeEngine.from_config(
                EngineConfig(model=cfg, buckets=(64,), warmup=True, **kw),
                params)
            ex = eng._get_fn(64)
            shard, = ex.shards
            z = rng.standard_normal((64, cfg.z_dim)).astype(np.float32)
            fns = ways(ex, 64)
            want = eng.generate(z)
            times = {k: [] for k in fns}
            kept = {k: collections.deque(maxlen=a.keep) for k in fns}
            for r in range(a.runs + 3):
                for k, fn in fns.items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    ex.stage(z)
                    if k != "engine":   # the engine's way enqueues its own
                        shard.z_dev.copy_(shard.z_host, non_blocking=True)
                        shard.replay()
                    got = fn()
                    dt = (time.perf_counter() - t0) * 1e3
                    if r >= 3:
                        times[k].append(dt)
                    if r == 0 and not np.array_equal(got, want):
                        raise AssertionError(f"{cfg.name} {path} {k}: images "
                                             "differ from the engine's")
                    if a.keep:
                        kept[k].append(got)
                    del got
            for k, v in times.items():
                mean = statistics.mean(v)
                row = {"net": cfg.name, "path": path, "way": k,
                       "median_ms": statistics.median(v), "mean_ms": mean,
                       "cv": statistics.pstdev(v) / mean, "runs": len(v),
                       "kept": a.keep, "threads": torch.get_num_threads(),
                       "card": smi}
                lines.append(json.dumps({"probe_dispatch": row}))
                print(lines[-1], flush=True)
            lines.append(json.dumps({"probe_pinned": {
                "net": cfg.name, "path": path, "kept": a.keep,
                "budget_held": engine_mod.PINNED_RESULTS.held,
                "stats": pinned_stats(), "card": smi}}))
            print(lines[-1], flush=True)
    if a.out:
        with open(a.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
