#!/usr/bin/env python3
"""CelebA served and trained over every visible NVIDIA card, against one
card.  Needs at least one card; with several it is the multi-GPU run the
one-card `chip_smoke.py` cannot make.

Usage:  python3 tools/probe_mesh.py [--runs 30] [--out FILE]

With n the visible cards and `make_serving_mesh()` over them, for the fp32
(B1) and int8 (B2) paths at full width (random weights from a seed):

* images of 64 x n rows (64 a shard) from the mesh engine against the
  single-device engine's (fp32 within 1e-5, int8 bit for bit), and the
  engine's launch count == layers x shards x dispatches;
* ms per dispatch (the engine's clock, mean and CV of ``--runs``) of one
  card at bucket 64 and 64 x n, and of the mesh at bucket 64 x n: the
  rows/s of n cards against one;
* an elastic drill: an injected device loss keeping half the cards (at
  least one), images unchanged;
* MNIST WGAN-GP at full width, one critic and one generator step on the
  mesh against ``z_shards=n`` on one card (losses relative, Adam's
  moments as a tree-norm ratio).

Prints one JSON line per measurement with the card's name and power
limit, and ``{"ok": true}`` last.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.dist import DeviceLoss, FaultInjector  # noqa: E402
from repro_torch.launch import make_serving_mesh  # noqa: E402
from repro_torch.models.dcnn import (CELEBA_DCNN, MNIST_DCNN,  # noqa: E402
                                     generator_init)
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.serve import DcnnServeEngine, EngineConfig  # noqa: E402
from repro_torch.train import WganTrainer  # noqa: E402


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def timed(eng, z, runs):
    """Mean ms and CV of ``runs`` dispatches of ``z`` (one bucket)."""
    b = z.shape[0]
    eng.generate(z)
    eng.bucket_stats.clear()
    for _ in range(runs):
        eng.generate(z)
    tp = eng.throughput()[b]
    return tp["mean_s"] * 1e3, tp["cv"]


def serve(n, runs, smi, emit):
    cfg = CELEBA_DCNN
    params = generator_init(torch.Generator().manual_seed(0), cfg, "cuda")
    z = np.random.default_rng(0).standard_normal(
        (64 * n, cfg.z_dim)).astype(np.float32)
    for precision in ("fp32", "int8"):
        one = DcnnServeEngine.from_config(EngineConfig(
            model=cfg, buckets=(64, 64 * n), precision=precision), params)
        inj = FaultInjector()
        mesh = DcnnServeEngine.from_config(EngineConfig(
            model=cfg, buckets=(64 * n,), precision=precision,
            quant_cfg=one.quant_cfg, mesh=make_serving_mesh()), params,
            fault_injector=inj)
        want = one.generate(z)
        mesh.launch_counts.clear()
        got = mesh.generate(z)
        launches = sum(mesh.launch_counts.values())
        err = float(np.abs(got - want).max())
        if (precision == "int8" and not np.array_equal(got, want)) \
                or err > 1e-5 or launches != len(cfg.layers) * n:
            raise AssertionError(f"{precision}: images {err}, launches "
                                 f"{launches}")
        rows = {}
        for label, eng, zz in (("one card, bucket 64", one, z[:64]),
                               (f"one card, bucket {64 * n}", one, z),
                               (f"{n} cards, bucket {64 * n}", mesh, z)):
            ms, cv = timed(eng, zz, runs)
            rows[label] = {"ms": ms, "cv": cv,
                           "rows_per_s": zz.shape[0] / (ms / 1e3)}
        emit({"serve": precision, "cards": n, "max_abs_err": err,
              "launches": launches, "dispatch": rows, "card": smi})
        keep = max(1, n // 2)
        inj.schedule(DeviceLoss(at_call=inj.calls, keep=keep))
        after = mesh.generate(z)
        ev = mesh.fault_stats["remesh_events"]
        err = float(np.abs(after - want).max())
        if len(ev) != 1 or mesh.n_devices != keep or err > 1e-5:
            raise AssertionError(f"{precision} remesh: {ev}, {err}")
        emit({"remesh": precision, "devices": [n, keep],
              "buckets": list(mesh.buckets), "seconds": ev[0]["seconds"],
              "max_abs_err": err, "card": smi})


def train(n, smi, emit):
    cfg = MNIST_DCNN
    real = np.random.default_rng(1).uniform(
        -1, 1, (64, 28, 28, 1)).astype(np.float32)

    def run(**kw):
        t = WganTrainer(cfg, AdamW(lr=1e-4, b1=0.5, b2=0.9),
                        AdamW(lr=1e-4, b1=0.5, b2=0.9), n_critic=1,
                        backend="cuda", **kw)
        gp, dp, gs, ds = t.init_state(0)
        dp, ds, dm = t.critic_step(dp, ds, gp, real, (0, 0, 0))
        gp, gs, gm = t.gen_step(gp, gs, dp, (0, 0, 1), 64)
        return {**dm, **gm}, (gs, ds)

    (mm, ms), (m1, s1) = run(mesh=make_serving_mesh()), run(z_shards=n)
    rel = max(abs(float(mm[k]) - float(m1[k])) / max(abs(float(m1[k])),
                                                     1e-30) for k in m1)

    def moments(a, b):
        num = sum(float(((x - y).double() ** 2).sum()) for x, y in
                  zip(tree_leaves((a.mu, a.nu)), tree_leaves((b.mu, b.nu))))
        den = sum(float((y.double() ** 2).sum())
                  for y in tree_leaves((b.mu, b.nu)))
        return (num / den) ** 0.5

    mom = max(moments(ms[0], s1[0]), moments(ms[1], s1[1]))
    if rel > 1e-4 or mom > 1e-4:
        raise AssertionError(f"training: losses {rel}, moments {mom}")
    emit({"train": "mnist wgan-gp", "cards": n, "losses_rel": rel,
          "moments_rel": mom, "card": smi})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=30)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tools/probe_mesh.py needs an NVIDIA card")
    n, smi = torch.cuda.device_count(), card()
    out = open(args.out, "w") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    try:
        serve(n, args.runs, smi, emit)
        train(n, smi, emit)
    finally:
        if out:
            out.close()
    print(json.dumps({"ok": True, "cards": n}), flush=True)


if __name__ == "__main__":
    main()
