#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises and the exit code is non-zero):
 1. device: the card's name and power limit (nvidia-smi), torch's name;
 2. build: nvcc builds the deconv kernel from src/repro_torch/csrc;
 3. kernel vs plain version, on the card: the JAX package's kernel sweep,
    ragged and batch-tiled shapes, several CI chunks, and every layer of
    both generators at buckets 1 and 64 (fp32 tol 1e-4, bf16 tol 8e-2);
 4. serving: both generators at full width through DcnnServeEngine on
    backend "cuda", mixed-size requests, results held against the
    reverse_loop and cudnn backends, kernel launches == layers x dispatches;
 5. times: per layer and bucket, the kernel's device time (CUDA events,
    median of 25, launches queued behind a sleep, with a check that the
    sleep outlasted the host's enqueue) and its per-call time against its
    bound, the plain version and F.conv_transpose2d; per net, images/s and
    run-to-run CV from the engine;
 6. the kernels line; 7. the result line.

Imports nothing of JAX: only torch, numpy and the port (src/repro_torch).
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.core.tiling import DeconvGeometry  # noqa: E402
from repro_torch.kernels.autotune import fill_tiles, hopper_tiles  # noqa: E402
from repro_torch.kernels.deconv2d import kernel as deconv_kernel  # noqa: E402
from repro_torch.kernels.deconv2d.ops import launch_args  # noqa: E402
from repro_torch.models.dcnn import (CELEBA_DCNN, MNIST_DCNN,  # noqa: E402
                                     generator_apply, generator_init)
from repro_torch.serve import DcnnServeEngine, EngineConfig  # noqa: E402

# Published peaks (NVIDIA data sheets): fp32 outside the tensor cores, and
# device-memory bandwidth.  Keyed by a substring of the card's name.
PEAKS = (
    ("H100 PCIe", 51e12, 2.0e12),
    ("H100 NVL", 60e12, 3.9e12),
    ("H100", 67e12, 3.35e12),      # SXM5, HBM3
    ("H200", 67e12, 4.8e12),
)

# (ih, iw, ci, co, k, s, p, t_oh): the JAX package's kernel sweep
SWEEP = [
    (7, 7, 8, 16, 4, 2, 1, None),
    (7, 7, 8, 16, 4, 2, 1, 4),
    (1, 1, 4, 8, 7, 1, 0, None),
    (1, 1, 4, 8, 4, 1, 0, 2),
    (5, 6, 3, 5, 3, 2, 0, 4),
    (4, 4, 2, 3, 5, 3, 2, 6),
    (16, 16, 32, 64, 4, 2, 1, 8),
    (6, 5, 4, 4, 4, 1, 2, None),
    (8, 8, 16, 8, 3, 3, 1, 9),
]
# (ih, iw, ci, co, k, s, p, t): ragged last tiles, non-square, stride 3
ALG1_GEOMS = [
    (4, 4, 6, 5, 5, 2, 2, 4),
    (4, 6, 3, 4, 5, 2, 2, 4),
    (5, 3, 4, 7, 4, 2, 1, 6),
    (4, 5, 2, 3, 5, 3, 1, 6),
]
TOL = {torch.float32: 1e-4, torch.bfloat16: 8e-2}
NETS = (MNIST_DCNN, CELEBA_DCNN)
REQUEST_SIZES = (64, 37, 5, 1, 64)
# serving outputs are tanh images in [-1, 1]; the backends sum the same
# fp32 products in different orders, which moves them by ~1e-6
SERVE_TOL = 1e-4
TIMED_RUNS = 25
BACKLOG_CYCLES = 400_000_000   # ~0.2 s of queued sleep at the H100's clocks
BACKLOG_TRIES = 3              # the sleep doubles after each try that did not hold


def device_info():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    for key, fp32, bw in PEAKS:
        if key in name:
            return smi, name, fp32, bw
    raise RuntimeError(f"no published peaks recorded for {name!r}")


def rand(rng, shape, dtype, scale=1.0):
    return (torch.from_numpy((rng.standard_normal(shape) * scale)
                             .astype(np.float32)).to(dtype).cuda())


def layer_inputs(rng, batch, ih, iw, ci, co, k, dtype):
    x = rand(rng, (batch, ih, iw, ci), dtype)
    w = rand(rng, (k, k, ci, co), dtype, 1.0 / np.sqrt(ci * k * k))
    b = rand(rng, (co,), dtype, 0.1)
    return x, w, b


def check_case(label, x, w, b, s, p, tiles, activation, results):
    """Kernel wrapper against its plain version on the same padded inputs."""
    xp, wp, bp, kw, _ = launch_args(x, w, b, s, p, activation=activation,
                                    **tiles.as_kwargs())
    y = deconv_kernel.deconv2d_launch(xp, wp, bp, **kw)
    torch.cuda.synchronize()
    y_ref = deconv_kernel.deconv2d_launch_plain(xp, wp, bp, **kw)
    torch.cuda.synchronize()
    tol = TOL[x.dtype]
    err = (y.float() - y_ref.float()).abs()
    bad = err > tol + tol * y_ref.float().abs()
    max_err = float(err.max())
    print(f"  {label} {str(x.dtype)[6:]} max_abs_err={max_err:.3e} "
          f"tol={tol}", flush=True)
    if y.shape != y_ref.shape or bool(bad.any()):
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{label} {x.dtype} max_abs_err={max_err}")
    results.setdefault(x.dtype, []).append(max_err)


def phase_kernel_checks():
    rng = np.random.default_rng(0)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        for (ih, iw, ci, co, k, s, p, t) in SWEEP:
            x, w, b = layer_inputs(rng, 2, ih, iw, ci, co, k, dtype)
            tl = fill_tiles(DeconvGeometry(ih, iw, ci, co, k, s, p), 2,
                            t_oh=t, t_ow=t)
            check_case(f"sweep {(ih, iw, ci, co, k, s, p, t)}", x, w, b, s, p,
                       tl, "relu", results)
        for (ih, iw, ci, co, k, s, p, t) in ALG1_GEOMS:
            for batch, t_n in ((2, 1), (5, 2)):
                x, w, b = layer_inputs(rng, batch, ih, iw, ci, co, k, dtype)
                tl = fill_tiles(DeconvGeometry(ih, iw, ci, co, k, s, p), batch,
                                t_oh=t, t_ow=t, t_n=t_n)
                check_case(f"ragged {(ih, iw, ci, co, k, s, p, t)} n={batch} "
                           f"t_n={t_n}", x, w, b, s, p, tl, "tanh", results)
        x, w, b = layer_inputs(rng, 3, 6, 6, 24, 40, 4, dtype)
        check_case("ci-chunks t_ci=8 t_co=16", x, w, b, 2, 1,
                   fill_tiles(DeconvGeometry(6, 6, 24, 40, 4, 2, 1), 3,
                              t_ci=8, t_co=16), None, results)
        for cfg in NETS:
            for i, (g, l) in enumerate(zip(cfg.geometries(), cfg.layers)):
                for batch in (1, 64):
                    x, w, b = layer_inputs(rng, batch, g.in_h, g.in_w, g.c_in,
                                           g.c_out, g.kernel, dtype)
                    t = hopper_tiles(g, batch)
                    check_case(f"{cfg.name} l{i} bucket {batch} {t.as_kwargs()}",
                               x, w, b, g.stride, g.padding, t, l.activation,
                               results)
    return results


def phase_serving():
    """Both generators through the engine; returns (engines, launches)."""
    engines, requests = {}, {}
    for cfg in NETS:
        params = generator_init(torch.Generator().manual_seed(0), cfg, "cuda")
        engines[cfg.name] = DcnnServeEngine.from_config(
            EngineConfig(model=cfg, backend="cuda", max_batch=64, warmup=True),
            params)
    rng = np.random.default_rng(1)
    for cfg in NETS:
        requests[cfg.name] = [rng.standard_normal((n, cfg.z_dim))
                              .astype(np.float32) for n in REQUEST_SIZES]
    # the main path: every kernel count at 0 just before, read just after
    deconv_kernel.LAUNCHES = 0
    outputs, per_net = {}, {}
    for cfg in NETS:
        eng = engines[cfg.name]
        before = deconv_kernel.LAUNCHES
        tickets = [eng.submit(z) for z in requests[cfg.name]]
        outputs[cfg.name] = [eng.collect(t) for t in tickets]
        per_net[cfg.name] = deconv_kernel.LAUNCHES - before
    launches = deconv_kernel.LAUNCHES

    for cfg in NETS:
        eng = engines[cfg.name]
        dispatches = len(eng.plan_chunks(sum(REQUEST_SIZES)))
        want = len(cfg.layers) * dispatches
        print(f"  {cfg.name}: {dispatches} dispatches x {len(cfg.layers)} "
              f"layers, kernel launches {per_net[cfg.name]}", flush=True)
        if per_net[cfg.name] != want:
            raise AssertionError(f"{cfg.name}: {per_net[cfg.name]} kernel "
                                 f"launches, expected {want}")
        z = torch.from_numpy(np.concatenate(requests[cfg.name])).cuda()
        refs = {be: generator_apply(eng.params, cfg, z, backend=be).cpu().numpy()
                for be in ("reverse_loop", "cudnn")}
        ofs = 0
        for n, img in zip(REQUEST_SIZES, outputs[cfg.name]):
            if img.shape != (n, cfg.img_hw, cfg.img_hw, cfg.img_c) or \
                    not np.isfinite(img).all():
                raise AssertionError(f"{cfg.name}: bad output {img.shape}")
            for be, ref in refs.items():
                err = float(np.abs(img - ref[ofs:ofs + n]).max())
                if err > SERVE_TOL:
                    raise AssertionError(f"{cfg.name} request of {n}: "
                                         f"{err} from {be}")
            ofs += n
        errs = {be: float(np.abs(np.concatenate(outputs[cfg.name]) - ref).max())
                for be, ref in refs.items()}
        print(f"  {cfg.name}: max |cuda - ref| {errs} (tol {SERVE_TOL})",
              flush=True)
    return engines, launches


def time_ms(fn, runs=TIMED_RUNS, warmup=3, backlog=True):
    """``(ms, held)``: the median of ``runs`` CUDA-event timings of ``fn``
    after warm-up.

    With ``backlog`` the card first runs a queued sleep while the host
    enqueues every timed run, so that each event pair brackets device time
    only (a short kernel would otherwise be timed together with the host
    work of its own launch).  ``held`` says whether that worked: the event
    after the sleep had not completed when the host had enqueued the last
    run.  If it had, the sleep is doubled and the timing taken again, up to
    ``BACKLOG_TRIES`` times; a timing that never held is returned with
    ``held`` False.  Without ``backlog``, ``held`` is None."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = BACKLOG_CYCLES
    for _ in range(BACKLOG_TRIES if backlog else 1):
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
        if backlog:
            torch.cuda._sleep(cycles)
            slept = torch.cuda.Event()
            slept.record()
        for e0, e1 in events:
            e0.record()
            fn()
            e1.record()
        held = (not slept.query()) if backlog else None
        torch.cuda.synchronize()
        ms = statistics.median(e0.elapsed_time(e1) for e0, e1 in events)
        if held is not False:
            break
        cycles *= 2
    return ms, held


def phase_times(smi, fp32_peak, mem_bw):
    rng = np.random.default_rng(2)
    rows = []
    for cfg in NETS:
        for i, (g, l) in enumerate(zip(cfg.geometries(), cfg.layers)):
            for batch in (1, 64):
                x, w, b = layer_inputs(rng, batch, g.in_h, g.in_w, g.c_in,
                                       g.c_out, g.kernel, torch.float32)
                t = hopper_tiles(g, batch)
                xp, wp, bp, kw, _ = launch_args(x, w, b, g.stride, g.padding,
                                                *t.as_kwargs().values(),
                                                l.activation)
                x_nchw = x.permute(0, 3, 1, 2).contiguous()
                w_lib = w.permute(2, 3, 0, 1).contiguous()
                torch.backends.cudnn.allow_tf32 = False
                torch.backends.cuda.matmul.allow_tf32 = False
                launch = lambda: deconv_kernel.deconv2d_launch(xp, wp, bp, **kw)
                ms, held = time_ms(launch)
                call_ms, _ = time_ms(launch, backlog=False)
                plain_ms, plain_held = time_ms(
                    lambda: deconv_kernel.deconv2d_launch_plain(xp, wp, bp, **kw))
                lib_ms, lib_held = time_ms(lambda: F.conv_transpose2d(
                    x_nchw, w_lib, b, stride=g.stride, padding=g.padding))
                # only the products that land in the output: the transposed
                # conv crops a padding border that the input pixels also feed
                ops = 2 * g.output_macs * batch
                nbytes = 4 * (batch * g.in_h * g.in_w * g.c_in
                              + g.kernel ** 2 * g.c_in * g.c_out + g.c_out
                              + batch * g.out_h * g.out_w * g.c_out)
                ops_ms = ops / fp32_peak * 1e3
                bytes_ms = nbytes / mem_bw * 1e3
                row = {"net": cfg.name, "layer": i, "bucket": batch,
                       "tiles": t.as_kwargs(), "ms": ms, "call_ms": call_ms,
                       "ms_is_device_time": held,
                       "plain_ms": plain_ms, "plain_is_device_time": plain_held,
                       "library_is_device_time": lib_held,
                       "library_ms": lib_ms, "bound_ms": max(ops_ms, bytes_ms),
                       "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                       "gflop": ops / 1e9, "mbytes": nbytes / 1e6,
                       "launches_per_dispatch": 1, "card": smi}
                rows.append(row)
                print(json.dumps({"layer_time": row}), flush=True)
    return rows


def phase_end_to_end(engines, smi):
    rng = np.random.default_rng(3)
    out = {}
    for name, eng in engines.items():
        z = rng.standard_normal((64, eng.cfg.z_dim)).astype(np.float32)
        for _ in range(30):
            eng.generate(z)
        tp = eng.throughput()[64]
        out[name] = {"bucket": 64, "img_per_s": tp["img_per_s"],
                     "mean_ms": tp["mean_s"] * 1e3, "cv": tp["cv"],
                     "calls": tp["calls"], "card": smi}
        print(json.dumps({"end_to_end": out[name], "net": name}), flush=True)
    return out


def main() -> int:
    smi, name, fp32_peak, mem_bw = device_info()
    print(f"[1] device: {smi} | torch: {name} | peaks: fp32 "
          f"{fp32_peak / 1e12} TFLOP/s, memory {mem_bw / 1e12} TB/s", flush=True)

    t0 = time.perf_counter()
    deconv_kernel.build()
    print(f"[2] build: {time.perf_counter() - t0:.2f} s", flush=True)

    print("[3] kernel vs plain version on the card", flush=True)
    errs = phase_kernel_checks()

    print("[4] serving", flush=True)
    engines, launches = phase_serving()
    if launches == 0:
        raise AssertionError("the main path launched no kernel")

    print("[5] times", flush=True)
    rows = phase_times(smi, fp32_peak, mem_bw)
    phase_end_to_end(engines, smi)

    b64 = [r for r in rows if r["bucket"] == 64]
    by = {k: sum(r["bound_ms"] for r in b64 if r["bound_by"] == k)
          for k in ("operations", "bytes")}
    print(json.dumps({"kernels": [{
        "name": "deconv2d_kernel",
        "route": "cuda",
        "source": "src/repro_torch/csrc/deconv2d.cu",
        "replaces": "src/repro/kernels/deconv2d/kernel.py:92",
        "launches": launches,
        "max_abs_err": max(errs[torch.float32]),
        "max_abs_err_bf16": max(errs[torch.bfloat16]),
        "ms": sum(r["ms"] for r in b64),
        "plain_ms": sum(r["plain_ms"] for r in b64),
        "bound_ms": sum(r["bound_ms"] for r in b64),
        "bound_by": max(by, key=by.get),
        "library_ms": sum(r["library_ms"] for r in b64),
        "times_are": "sum over every layer of both generators at bucket 64",
        "ms_is_device_time": all(r["ms_is_device_time"] for r in b64),
        "card": smi,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
