#!/usr/bin/env python3
"""Time every tile the int8 or the bf16 tensor-core kernel takes, per
generator layer and bucket, on one NVIDIA card, and check each against the
plain version.

Usage, from the root of a checkout:
    python3 tools/sweep_tiles.py [--dtype int8|bfloat16]
                                 [--out tile_sweep.jsonl]
                                 [--buckets 1 64] [--runs 10]

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
hand.  Exits non-zero if any candidate disagreed with the plain version.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels.deconv2d import int8 as int8_kernel  # noqa: E402
from repro_torch.kernels.deconv2d import kernel as deconv_kernel  # noqa: E402
from repro_torch.kernels.deconv2d.ops import launch_args  # noqa: E402
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
               0.0 if out_scale is not None else 1e-6)


def bf16_cases(g, l, last, batch, rng, w_data):
    """``(tiles, launch, check)`` per bf16 candidate."""
    w, b = w_data
    x = torch.from_numpy(rng.standard_normal(
        (batch, g.in_h, g.in_w, g.c_in)).astype(np.float32)).cuda().to(
            torch.bfloat16)
    for t, t_n, t_co, t_ci in autotune._tc_candidates(g, batch, "bfloat16"):
        clk = autotune.tc_cost(g, batch, t, t_n, t_co, t_ci, "bfloat16")
        if clk is None:
            continue
        xp, wp, bp, kw, _ = launch_args(x, w, b, g.stride, g.padding, t, t,
                                        t_ci, t_co, t_n, l.activation)
        split = deconv_kernel.launch_split(
            xp.shape[0], xp.shape[3], wp.shape[3], kw["ohp"], kw["owp"], t,
            t, t_ci, t_co, kw["t_n"])

        def launch(xp=xp, wp=wp, bp=bp, kw=kw):
            return deconv_kernel.deconv2d_launch(xp, wp, bp, **kw)

        ref = deconv_kernel.deconv2d_launch_plain(xp, wp, bp, split=split,
                                                  **kw)
        yield t, t_n, t_co, t_ci, clk, split, launch, ref, 8e-2


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", choices=("int8", "bfloat16"), default="int8")
    ap.add_argument("--out", default="tile_sweep.jsonl")
    ap.add_argument("--buckets", type=int, nargs="+", default=[1, 64])
    ap.add_argument("--runs", type=int, default=10)
    a = ap.parse_args()
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
    with open(a.out, "w") as out:
        for cfg in (MNIST_DCNN, CELEBA_DCNN):
            for i, (g, l) in enumerate(zip(cfg.geometries(), cfg.layers)):
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
                                   .to(torch.bfloat16) for v in (w, b))
                cases = int8_cases if int8 else bf16_cases
                for batch in a.buckets:
                    rows = []
                    for (t, t_n, t_co, t_ci, clk, split, launch, ref,
                         tol) in cases(g, l, last, batch, rng, w_data):
                        y = launch()
                        err = float((y.float() - ref.float()).abs().max())
                        ok = err <= tol
                        bad += not ok
                        ms = device_ms(launch, a.runs)
                        blocks = autotune.grid_blocks(g, batch, t, t_co, t_n)
                        row = {"dtype": a.dtype, "net": cfg.name, "layer": i,
                               "bucket": batch, "t": t, "t_n": t_n,
                               "t_co": t_co, "t_ci": t_ci, "split": split,
                               "blocks": blocks, "model_clk": clk, "ms": ms,
                               "max_abs_err": err, "ok": ok, "card": card}
                        rows.append(row)
                        out.write(json.dumps(row) + "\n")
                    pick = autotune.hopper_tiles(g, batch, a.dtype)
                    fill = [r for r in rows
                            if r["blocks"] * r["split"] >= autotune.SMS] or rows
                    best = min(fill, key=lambda r: r["ms"])
                    mine = [r for r in rows if (r["t"], r["t_n"], r["t_co"],
                                                r["t_ci"]) ==
                            (pick.t_oh, pick.t_n, pick.t_co, pick.t_ci)]
                    pick_ms = mine[0]["ms"] if mine else float("nan")
                    print(f"{cfg.name} l{i} bucket {batch}: {len(rows)} tiles, "
                          f"{sum(not r['ok'] for r in rows)} disagree; pick "
                          f"{pick.as_kwargs()} {pick_ms:.4f} ms; best "
                          f"{ {k: best[k] for k in ('t', 't_n', 't_co', 't_ci', 'split')} } "
                          f"{best['ms']:.4f} ms; pick/best "
                          f"{pick_ms / best['ms']:.3f}", flush=True)
    print(f"disagreeing tiles: {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
