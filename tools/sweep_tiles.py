#!/usr/bin/env python3
"""Time every tile the int8 or the bf16 tensor-core kernel takes, per
generator layer and bucket, on one NVIDIA card, and check each against the
plain version.

Usage, from the root of a checkout:
    python3 tools/sweep_tiles.py [--dtype int8|bfloat16|float32]
                                 [--out tile_sweep.jsonl]
                                 [--buckets 1 64] [--runs 10]
                                 [--only dcnn-celeba:1 ...]
                                 [--stage-budget BYTES] [--library]

For every layer of both generators and every bucket, every candidate of
`autotune._tc_candidates(geom, bucket, dtype)` that the kernel takes
(`tc_cost` is not None) is launched on random data and timed: CUDA events
around each of ``--runs`` launches queued behind a sleep on the card,
median.  int8: random int8 data at the engine's packed widths, held
against `deconv2d_int8_launch_plain` at its cluster split (int8 outputs
bit for bit).  bf16: random bf16 data through the dense launcher, held
against `deconv2d_launch_plain` at its split within 8e-2.  Each row
(tiles, split, blocks, the model's clocks, ms, whether it matched) goes to
``--out`` as one JSON line; a summary per layer and bucket (the model's
pick, the best timed tile that fills the SMs, and their ratio) goes to
standard output, with the card's name and power limit.  The rows are what
the int8 and bf16 constants of `kernels/autotune.py` are fitted to by
hand.  float32 runs the fp32 candidates the same way, within 1e-4 (the
rows the bucket-1 tile rule and the fp32 wgmma path's constants are set
by; a fp32 launch reads the weights packed CI-minor once, as an engine's).
A bf16 or fp32 row names the path the launch takes (``wgmma`` or
``mma.sync``), its instance and its ring's stages; ``--wgmma-only`` keeps
the wgmma path's tiles.  ``--only NET:LAYER`` keeps those
layers; ``--library`` adds cuDNN's time of the same layer in the same
dtype; ``--sparse`` runs the zero-skip kernel instead, on the weights
magnitude-pruned at 0.9; ``--stage-budget`` builds the kernel library from a copy of the
source whose ring budget (``kStageBudget``) is BYTES, and sizes the
host's shared-memory model to match, so that a tile's stages can be
raised without changing its tiles.  The ``ptxas`` report of every bf16
instance (registers, spill bytes) is printed after the first launch.
Exits non-zero if any candidate disagreed with the plain version.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels.deconv2d import int8 as int8_kernel  # noqa: E402
from repro_torch.kernels.deconv2d import kernel as deconv_kernel  # noqa: E402
from repro_torch.kernels.deconv2d.ops import launch_args  # noqa: E402
from repro_torch.kernels.deconv2d_sparse import (  # noqa: E402
    kernel as sparse_kernel, make_sparse_plan, schedule_tensors)
from repro_torch.models.dcnn import CELEBA_DCNN, MNIST_DCNN  # noqa: E402


def device_ms(fn, runs):
    """Median device time of ``fn`` over ``runs`` launches queued behind a
    sleep (so that each event pair brackets device time only)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
    torch.cuda._sleep(200_000_000)
    for e0, e1 in events:
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return statistics.median(e0.elapsed_time(e1) for e0, e1 in events)


def int8_cases(g, l, last, batch, rng, w_data):
    """``(tiles, launch, check)`` per int8 candidate the packed widths take."""
    out_scale = None if last else 0.05
    w, wpk = w_data
    sc = torch.full((g.c_out,), 3.0 / (127 * 127 * g.c_in * 4), device="cuda")
    x = torch.from_numpy(rng.integers(-127, 128, (batch, g.in_h, g.in_w, g.c_in),
                                      dtype=np.int8)).cuda()
    for t, t_n, t_co, t_ci in autotune._tc_candidates(g, batch, "int8"):
        clk = autotune.tc_cost(g, batch, t, t_n, t_co, t_ci, "int8")
        if clk is None or wpk.cip % t_ci or wpk.cop % t_co:
            continue
        xp, pk, sp, bp, kw, _ = int8_kernel.launch_args_int8(
            x, wpk, sc, None, g.stride, g.padding, t, t, t_ci, t_co, t_n,
            l.activation, out_scale)
        split = int8_kernel.launch_split_int8(xp, pk, kw)

        def launch(xp=xp, pk=pk, sp=sp, bp=bp, kw=kw):
            return int8_kernel.deconv2d_int8_launch(xp, pk, sp, bp, **kw)

        ref = int8_kernel.deconv2d_int8_launch_plain(
            xp, int8_kernel.unpack_int8_weights(pk), sp, bp, split=split, **kw)
        yield (t, t_n, t_co, t_ci, clk, split, launch, ref,
               0.0 if out_scale is not None else 1e-6, None)


def bf16_cases(g, l, last, batch, rng, w_data, dtype="bfloat16",
               sparse=False):
    """``(tiles, launch, check)`` per bf16 (or fp32) candidate; with
    ``sparse`` the zero-skip launcher on the weights magnitude-pruned at
    0.9, against its plain version on the same schedule."""
    w, b = w_data
    if sparse:
        cut = w.float().abs().flatten().kthvalue(int(0.9 * w.numel())).values
        w = torch.where(w.float().abs() > cut, w, torch.zeros_like(w))
    x = torch.from_numpy(rng.standard_normal(
        (batch, g.in_h, g.in_w, g.c_in)).astype(np.float32)).cuda().to(
            w.dtype)
    for t, t_n, t_co, t_ci in autotune._tc_candidates(g, batch, dtype,
                                                      sparse):
        clk = autotune.tc_cost(g, batch, t, t_n, t_co, t_ci, dtype, sparse)
        if clk is None:
            continue
        xp, wp, bp, kw, _ = launch_args(x, w, b, g.stride, g.padding, t, t,
                                        t_ci, t_co, t_n, l.activation)
        split = deconv_kernel.launch_split(
            xp.shape[0], xp.shape[3], wp.shape[3], kw["ohp"], kw["owp"], t,
            t, t_ci, t_co, kw["t_n"])

        if sparse:
            sched = schedule_tensors(make_sparse_plan(
                w, g.stride, g.padding, t_ci, t_co), "cuda")

            def launch(xp=xp, wp=wp, bp=bp, kw=kw, sched=sched):
                return sparse_kernel.deconv2d_sparse_launch(xp, wp, bp,
                                                            *sched, **kw)

            ref = sparse_kernel.deconv2d_sparse_launch_plain(
                xp, wp, bp, *sched, split=split, **kw)
        else:
            # the weights packed CI-minor once, as an engine holds them
            # (read by a fp32 launch on the wgmma path)
            wt = deconv_kernel.pack_ci_minor(wp)

            def launch(xp=xp, wp=wp, bp=bp, kw=kw, wt=wt):
                return deconv_kernel.deconv2d_launch(xp, wp, bp, wt=wt, **kw)

            ref = deconv_kernel.deconv2d_launch_plain(xp, wp, bp,
                                                      split=split, **kw)
        tol = 8e-2 if dtype == "bfloat16" else 1e-4
        info = deconv_kernel.launch_info(deconv_kernel.launch_params(
            xp, wp, [("b", bp, xp.dtype)], sparse=sparse, **kw))
        yield t, t_n, t_co, t_ci, clk, split, launch, ref, tol, info


def library_ms(g, batch, dtype, rng, runs):
    """cuDNN's device time of the same layer (``F.conv_transpose2d``) in
    ``dtype``, TF32 off."""
    torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal(
        (batch, g.c_in, g.in_h, g.in_w)).astype(np.float32)).cuda().to(dt)
    w = torch.randn((g.c_in, g.c_out, g.kernel, g.kernel), device="cuda",
                    dtype=dt)
    b = torch.zeros((g.c_out,), device="cuda", dtype=dt)
    return device_ms(lambda: torch.nn.functional.conv_transpose2d(
        x, w, b, stride=g.stride, padding=g.padding), runs)


def use_stage_budget(budget):
    """Build the kernel library from a copy of its source whose ring
    budget is ``budget`` bytes (into a temporary directory), and size the
    host's shared-memory model by the same budget."""
    from repro_torch.core import tiling
    from repro_torch.kernels import _build

    src = (_build.CSRC_DIR / "deconv2d_tc.cu").read_text()
    pat = r"constexpr int kStageBudget = [^;]+;"
    if not re.search(pat, src):
        raise SystemExit("sweep_tiles: no kStageBudget in the source")
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="stage_budget_"))
    (tmp / "deconv2d_tc.cu").write_text(
        re.sub(pat, f"constexpr int kStageBudget = {budget};", src))
    _build.CSRC_DIR, _build.BUILD_DIR = tmp, tmp / "build"
    tiling.TC_STAGE_BUDGET = budget


def print_instances():
    """Registers and spill bytes of every bf16 and fp32 instance."""
    from repro_torch.kernels import _build

    for r in _build.ptxas_report("deconv2d_tc"):
        if "int8" not in r["kernel"]:
            print(f"ptxas: {r}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", choices=("int8", "bfloat16", "float32"),
                    default="int8")
    ap.add_argument("--out", default="tile_sweep.jsonl")
    ap.add_argument("--buckets", type=int, nargs="+", default=[1, 64])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--only", nargs="+", default=None,
                    help="NET:LAYER, e.g. dcnn-celeba:1")
    ap.add_argument("--stage-budget", type=int, default=None)
    ap.add_argument("--library", action="store_true")
    ap.add_argument("--sparse", action="store_true",
                    help="bf16/fp32: the zero-skip kernel on weights pruned "
                         "at 0.9")
    ap.add_argument("--wgmma-only", action="store_true",
                    help="bf16/fp32: only the tiles that take the wgmma path")
    ap.add_argument("--verbose", action="store_true",
                    help="print each tile's row as it is timed")
    a = ap.parse_args()
    if a.stage_budget is not None:
        use_stage_budget(a.stage_budget)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_tiles: needs an NVIDIA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    rng = np.random.default_rng(0)
    int8 = a.dtype == "int8"
    bad = 0
    reported = False
    with open(a.out, "w") as out:
        for cfg in (MNIST_DCNN, CELEBA_DCNN):
            for i, (g, l) in enumerate(zip(cfg.geometries(), cfg.layers)):
                if a.only and f"{cfg.name}:{i}" not in a.only:
                    continue
                last = i == len(cfg.layers) - 1
                shape = (g.kernel, g.kernel, g.c_in, g.c_out)
                if int8:
                    w = torch.from_numpy(rng.integers(-127, 128, shape,
                                                      dtype=np.int8)).cuda()
                    w_data = (w, int8_kernel.pack_int8_weights(
                        w, int8_kernel.packed_ci_width(g.c_in),
                        int8_kernel.packed_width(g.c_out)))
                else:
                    w = rng.standard_normal(shape) / np.sqrt(g.c_in * g.kernel ** 2)
                    b = 0.1 * rng.standard_normal(g.c_out)
                    w_data = tuple(torch.from_numpy(v.astype(np.float32)).cuda()
                                   .to(getattr(torch, a.dtype)) for v in (w, b))
                for batch in a.buckets:
                    rows = []
                    cases = (int8_cases(g, l, last, batch, rng, w_data) if int8
                             else bf16_cases(g, l, last, batch, rng, w_data,
                                             a.dtype, a.sparse))
                    for (t, t_n, t_co, t_ci, clk, split, launch, ref,
                         tol, info) in cases:
                        if a.wgmma_only and (info or {}).get("path") != "wgmma":
                            continue
                        y = launch()
                        if not reported:
                            print_instances()
                            reported = True
                        err = float((y.float() - ref.float()).abs().max())
                        ok = err <= tol
                        bad += not ok
                        ms = device_ms(launch, a.runs)
                        blocks = autotune.grid_blocks(g, batch, t, t_co, t_n)
                        row = {"dtype": a.dtype, "sparse": a.sparse,
                               "net": cfg.name, "layer": i,
                               "bucket": batch, "t": t, "t_n": t_n,
                               "t_co": t_co, "t_ci": t_ci, "split": split,
                               "blocks": blocks, "model_clk": clk, "ms": ms,
                               "max_abs_err": err, "ok": ok,
                               "stage_budget": a.stage_budget, **(info or {}),
                               "card": card}
                        rows.append(row)
                        out.write(json.dumps(row) + "\n")
                        if a.verbose:
                            print(json.dumps(row), flush=True)
                    if not rows:
                        continue
                    pick = autotune.hopper_tiles(g, batch, a.dtype,
                                                 a.sparse)
                    fill = [r for r in rows
                            if r["blocks"] * r["split"] >= autotune.SMS] or rows
                    best = min(fill, key=lambda r: r["ms"])
                    mine = [r for r in rows if (r["t"], r["t_n"], r["t_co"],
                                                r["t_ci"]) ==
                            (pick.t_oh, pick.t_n, pick.t_co, pick.t_ci)]
                    pick_ms = mine[0]["ms"] if mine else float("nan")
                    lib = (f"; cuDNN {library_ms(g, batch, a.dtype, rng, a.runs):.4f}"
                           " ms" if a.library and not int8 else "")
                    print(f"{cfg.name} l{i} bucket {batch}: {len(rows)} tiles, "
                          f"{sum(not r['ok'] for r in rows)} disagree; pick "
                          f"{pick.as_kwargs()} {pick_ms:.4f} ms; best "
                          f"{ {k: best[k] for k in ('t', 't_n', 't_co', 't_ci', 'split')} } "
                          f"{best['ms']:.4f} ms; pick/best "
                          f"{pick_ms / best['ms']:.3f}{lib}", flush=True)
    print(f"disagreeing tiles: {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
