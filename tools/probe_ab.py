#!/usr/bin/env python3
"""One-card measurements that hold two checkouts of the port against each
other in one machine.  Needs an NVIDIA card.

Usage:  python3 tools/probe_ab.py --root DIR dispatch [--runs 200]
        python3 tools/probe_ab.py --root DIR frontend [--runs 5]
        python3 tools/probe_ab.py --root DIR mesh [--runs 30]

``--root`` is the checkout whose ``src/repro_torch`` (and, for
``frontend``, whose ``chip_smoke.py``) is imported; run the script once
per checkout, alternating them (A, B, B, A), so that both meet the same
card.

* ``dispatch``: both generators on the fp32 and int8 paths at bucket 64
  (random weights from a seed), one engine on one device and, where the
  checkout has `launch.make_serving_mesh`, one on a mesh of one card;
  ``--runs`` dispatches of each in turns, each timed with the host clock
  from a synchronised card to the images on the host.  Prints per engine
  the median and mean ms and the engine's own mean and CV, and checks the
  mesh engine's images equal the one-device engine's.
* ``frontend``: ``chip_smoke.phase_frontend`` (CelebA through the async
  frontend under torch.profiler, B1's and B2's traced launches held
  against layers x dispatches) ``--runs`` times in one process.  Prints
  per run its counts and whether the phase passed (a failure named
  ``TraceLoss`` where the checkout tells the profiler's record loss
  apart), then how many runs failed; the phase's own output goes to
  ``chiprun_out/probe_ab_frontend.log`` under the working directory.
* ``mesh``: ``chip_smoke.py`` phase 10's traced run (CelebA fp32 and
  int8 on 2 shards of cuda:0, its three requests) ``--runs`` times per
  path, each under one profiler session, in turns with two orders of a
  sharded dispatch: each shard's copy back enqueued right after its
  replay, and every replay enqueued before any copy back.  Prints per path and order how many
  sessions held fewer launches of the path's kernel than the engine
  counted, and their counts.

Each line is JSON with the card's name and power limit.
"""
import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def dispatch(root, runs, smi):
    import numpy as np
    import torch

    from repro_torch.models.dcnn import (CELEBA_DCNN, MNIST_DCNN,
                                         generator_init)
    from repro_torch.serve import DcnnServeEngine, EngineConfig
    try:
        from repro_torch.launch import make_serving_mesh
    except ImportError:
        make_serving_mesh = None

    engines, zs = {}, {}
    rng = np.random.default_rng(0)
    for cfg in (MNIST_DCNN, CELEBA_DCNN):
        params = generator_init(torch.Generator().manual_seed(0), cfg, "cuda")
        zs[cfg.name] = rng.standard_normal((64, cfg.z_dim)).astype(np.float32)
        for path in ("fp32", "int8"):
            one = DcnnServeEngine.from_config(EngineConfig(
                model=cfg, buckets=(64,), precision=path, warmup=True),
                params)
            engines[cfg.name, path, "one device"] = one
            if make_serving_mesh is not None:
                engines[cfg.name, path, "mesh of one card"] = \
                    DcnnServeEngine.from_config(EngineConfig(
                        model=cfg, buckets=(64,), precision=path,
                        quant_cfg=one.quant_cfg, warmup=True,
                        mesh=make_serving_mesh(1)), params)
    for (net, path, kind), eng in engines.items():
        if kind != "one device":
            want = engines[net, path, "one device"].generate(zs[net])
            if not np.array_equal(eng.generate(zs[net]), want):
                raise AssertionError(f"{net} {path}: the mesh of one card "
                                     "differs from one device")
        eng.generate(zs[net])
        eng.bucket_stats.clear()
    times = {k: [] for k in engines}
    for _ in range(runs):
        for k, eng in engines.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.generate(zs[k[0]])
            times[k].append((time.perf_counter() - t0) * 1e3)
    for (net, path, kind), ts in times.items():
        tp = engines[net, path, kind].throughput()[64]
        print(json.dumps({
            "dispatch": net, "path": path, "engine": kind, "root": root,
            "runs": runs, "median_ms": statistics.median(ts),
            "mean_ms": statistics.fmean(ts),
            "engine_mean_ms": tp["mean_s"] * 1e3, "engine_cv": tp["cv"],
            "card": smi}), flush=True)


def frontend(root, runs, smi):
    import chip_smoke as cs

    os.makedirs("chiprun_out", exist_ok=True)
    failed = 0
    with open(os.path.join("chiprun_out", "probe_ab_frontend.log"),
              "a") as log:
        for r in range(runs):
            buf = io.StringIO()
            err = None
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(buf):
                    cs.phase_frontend(smi)
            except AssertionError as e:
                err = f"{type(e).__name__}: {str(e)[:400]}"
                failed += 1
            out = buf.getvalue()
            log.write(f"== {root} run {r}\n{out}\n{err or ''}\n")
            counts = [ln.strip() for ln in out.splitlines()
                      if ln.strip().startswith("frontend run:")]
            print(json.dumps({"frontend": r, "root": root, "ok": err is None,
                              "seconds": time.perf_counter() - t0,
                              "counts": counts[0] if counts else None,
                              "error": err, "card": smi}), flush=True)
    print(json.dumps({"frontend_runs": runs, "failed": failed, "root": root,
                      "card": smi}), flush=True)


def mesh(root, runs, smi):
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.launch import make_test_mesh
    from repro_torch.models.dcnn import CELEBA_DCNN, generator_init
    from repro_torch.serve import DcnnServeEngine, EngineConfig
    from repro_torch.serve import engine as engine_mod

    def dispatch_in(replays_first):
        def call(ex, rows):
            take = rows.shape[0]
            ex.stage(rows)
            out = ex.shards[0].out_dev
            got = engine_mod.pinned_result((take,) + tuple(out.shape[1:]),
                                           out.dtype)

            def replay(s):
                with torch.cuda.device(s.z_dev.device):
                    s.z_dev.copy_(s.z_host, non_blocking=True)
                    s.replay()

            def copy_back(s, sl, n):
                if n:
                    dst = (got[0][sl.start:sl.start + n] if got is not None
                           else s.out_host[:n])
                    with torch.cuda.device(s.out_dev.device):
                        dst.copy_(s.out_dev[:n], non_blocking=True)

            takes = ex._takes(take)
            if replays_first:
                for t in takes:
                    replay(t[0])
                for t in takes:
                    copy_back(*t)
            else:
                for t in takes:
                    replay(t[0])
                    copy_back(*t)
            ex.wait()
            return ex.images(got, take)
        return call

    cls = engine_mod.ShardedExecutable
    own = cls.__call__
    orders = {"copy after each replay": dispatch_in(False),
              "replays first": dispatch_in(True)}
    cfg = CELEBA_DCNN
    params = generator_init(torch.Generator().manual_seed(0), cfg, "cuda")
    rng = np.random.default_rng(7)
    reqs = [cs.tower_inputs(cfg, n, rng) for n in cs.MESH_REQUESTS]
    for path in ("fp32", "int8"):
        eng = DcnnServeEngine.from_config(EngineConfig(
            model=cfg, buckets=(1, 64), precision=path,
            mesh=make_test_mesh(2, device="cuda:0")), params)
        eng._warmup_bucket(64)
        kernel = cs.PATHS[path][0]
        want = len(cfg.layers) * 2 * len(reqs)
        short = {o: [] for o in orders}
        try:
            for _ in range(runs):
                for order, fn in orders.items():
                    cls.__call__ = fn
                    torch.cuda.synchronize()
                    with cs.profiled() as prof:
                        cs.zero_launch_counts()
                        eng.launch_counts.clear()
                        for r in reqs:
                            eng.collect(eng.submit(r))
                        torch.cuda.synchronize()
                        engine = sum(eng.launch_counts.values())
                    traced = cs.traced_launches(prof)[0]
                    if engine != want:
                        raise AssertionError(f"{path} {order}: engine "
                                             f"{engine} of {want}")
                    if traced[kernel] != want or any(
                            v for k, v in traced.items() if k != kernel):
                        short[order].append(traced[kernel])
        finally:
            cls.__call__ = own
        for order, got in short.items():
            print(json.dumps({"mesh": path, "order": order, "root": root,
                              "sessions": runs, "short": len(got),
                              "traced_when_short": got, "want": want,
                              "card": smi}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("mode", choices=("dispatch", "frontend", "mesh"))
    ap.add_argument("--runs", type=int, default=None)
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "src"))
    # no run reads another's tile timings
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(
        tempfile.mkdtemp(prefix="probe_ab_"), "autotune.json")
    import torch

    if not torch.cuda.is_available():
        sys.exit("tools/probe_ab.py needs an NVIDIA card")
    smi = card()
    if a.mode == "dispatch":
        dispatch(a.root, a.runs or 200, smi)
    elif a.mode == "frontend":
        frontend(a.root, a.runs or 5, smi)
    else:
        mesh(a.root, a.runs or 30, smi)


if __name__ == "__main__":
    main()
