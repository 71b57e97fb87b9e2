#!/usr/bin/env python3
"""What a replayed bucket spends its device time on, kernel by kernel.
Needs an NVIDIA card.

Usage:  python3 tools/profile_replay.py [--bucket 64] [--replays 20]
            [--towers sr denoise mnist celeba] [--paths fp32 int8 cuda_sparse]

For each tower and path, builds a default engine (random weights from a
seed; zero-skip on params pruned at 0.9) with the one bucket, serves one
request to capture its graph, then runs ``--replays`` replays under
``torch.profiler`` and prints one JSON line per tower and path: the
device time per replay of every kernel name in the trace (summed over its
launches, divided by the replays), the deconv kernel's share, and the rest
(pads, crops, quantization, casts), with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core.sparsity import prune_tree  # noqa: E402
from repro_torch.serve import DcnnServeEngine, EngineConfig  # noqa: E402
from repro_torch.workloads import get  # noqa: E402

PATHS = {"fp32": {}, "int8": {"precision": "int8"},
         "cuda_sparse": {"backend": "cuda_sparse"}}
DECONV = re.compile(r"\b(deconv2d_tc_kernel|deconv2d_tc_int8_kernel|"
                    r"deconv2d_kernel)<")


def kernel_name(name: str) -> str:
    """A traced kernel's C++ name (demangled where it is not), without its
    namespace and argument list."""
    if name.startswith("_Z"):
        try:
            name = subprocess.run(["c++filt", name], capture_output=True,
                                  text=True, check=True).stdout.strip() or name
        except (OSError, subprocess.CalledProcessError):
            pass
    return name.replace("(anonymous namespace)::", "").split("(")[0].strip()


def profile(tower: str, path: str, bucket: int, replays: int) -> dict:
    w = get(tower)
    params = w.init(torch.Generator().manual_seed(0), "cuda")
    if path == "cuda_sparse":
        params = prune_tree(params, 0.9)
    eng = DcnnServeEngine.from_config(
        EngineConfig(model=tower, buckets=(bucket,), **PATHS[path]), params)
    rng = np.random.default_rng(0)
    if w.cfg.is_latent:
        x = rng.standard_normal((bucket,) + w.cfg.input_shape)
    else:
        x = w.training_pairs(0, bucket)[0]
    eng.generate(np.asarray(x, np.float32))
    ex = eng._get_fn(bucket).shards[0]
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(replays):
            ex.replay()
        torch.cuda.synchronize()
    per = collections.Counter()
    launches = collections.Counter()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = kernel_name(e.name)
        per[name] += e.time_range.elapsed_us() / 1e3 / replays  # us -> ms
        launches[name] += 1
    total = sum(per.values())
    deconv = sum(v for k, v in per.items() if DECONV.search(k))
    return {"tower": tower, "path": path, "bucket": bucket,
            "replays": replays, "device_ms_per_replay": total,
            "deconv_ms_per_replay": deconv, "other_ms_per_replay":
            total - deconv,
            "kernels": {k: {"ms_per_replay": v,
                            "launches_per_replay": launches[k] / replays}
                        for k, v in per.most_common()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bucket", type=int, default=64)
    ap.add_argument("--replays", type=int, default=20)
    ap.add_argument("--towers", nargs="+",
                    default=["sr", "denoise", "mnist", "celeba"])
    ap.add_argument("--paths", nargs="+", default=list(PATHS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_replay: needs an NVIDIA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for tower in args.towers:
        for path in args.paths:
            row = profile(tower, path, args.bucket, args.replays)
            print(json.dumps({**row, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
