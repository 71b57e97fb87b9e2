#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Three kernels, one per TPU kernel of the JAX package: B1 the dense
reverse-loop deconv (fp32/bf16), B2 the int8 one with its requant epilogue,
B3 the zero-skip one.  All three live in src/repro_torch/csrc/deconv2d.cu.

Phases (any failure raises and the exit code is non-zero):
 1. device: the card's name and power limit (nvidia-smi), torch's name;
 2. build: nvcc builds the kernel library from src/repro_torch/csrc;
 3. each kernel vs its plain version, on the card: the JAX package's kernel
    sweep, ragged and batch-tiled shapes, several CI chunks, and every
    layer of both generators at buckets 1 and 64.  B1 fp32 tol 1e-4, bf16
    8e-2; B2 int8 outputs bit-equal, f32 outputs 1e-6, with real requant
    scales on the generator layers; B3 as B1, under magnitude pruning at
    0.5 / 0.9 / 0.97 and hand-zeroed slabs, and some case must skip slabs;
 4. serving, both generators at full width through DcnnServeEngine with
    mixed-size requests, on three paths, each driven with every kernel
    count at 0 just before and read just after: fp32 on "cuda" (held
    against reverse_loop and cudnn), int8 (against the int8 plain chain;
    MMD against the fp32 images) and "cuda_sparse" on params pruned at 0.9
    (against reverse_loop and cudnn on the same params); the path's kernel
    launches == layers x dispatches, the others' 0;
 5. times: per kernel, layer and bucket, device time (CUDA events, median
    of 25, launches queued behind a sleep, with a check that the sleep
    outlasted the host's enqueue) and per-call time against its bound, the
    plain version's per-call time and the library call's device time where
    there is one; per net and path, images/s and run-to-run CV from the
    engine;
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

from repro_torch.core.mmd import mmd  # noqa: E402
from repro_torch.core.sparsity import magnitude_prune, prune_tree  # noqa: E402
from repro_torch.core.tiling import DeconvGeometry  # noqa: E402
from repro_torch.kernels.autotune import fill_tiles, hopper_tiles  # noqa: E402
from repro_torch.kernels.deconv2d import int8 as int8_kernel  # noqa: E402
from repro_torch.kernels.deconv2d import kernel as deconv_kernel  # noqa: E402
from repro_torch.kernels.deconv2d.ops import launch_args  # noqa: E402
from repro_torch.kernels.deconv2d_sparse import kernel as sparse_kernel  # noqa: E402
from repro_torch.kernels.deconv2d_sparse import (make_sparse_plan,  # noqa: E402
                                                 schedule_tensors)
from repro_torch.models.dcnn import (CELEBA_DCNN, MNIST_DCNN,  # noqa: E402
                                     generator_apply, generator_init)
from repro_torch.quant import (calibrate, quantize_params,  # noqa: E402
                               quantize_symmetric, quantized_generator_ref)
from repro_torch.serve import DcnnServeEngine, EngineConfig  # noqa: E402
from repro_torch.workloads import calibration_input  # noqa: E402

# Published peaks (NVIDIA data sheets, dense): fp32 outside the tensor
# cores, int8 on the tensor cores, and device-memory bandwidth.  Keyed by a
# substring of the card's name.
PEAKS = (
    ("H100 PCIe", 51e12, 1513e12, 2.0e12),
    ("H100 NVL", 60e12, 1671e12, 3.9e12),
    ("H100", 67e12, 1979e12, 3.35e12),      # SXM5, HBM3
    ("H200", 67e12, 1979e12, 4.8e12),
)
# (name, module, source, the TPU kernel it replaces)
KERNELS = (
    ("deconv2d_kernel", deconv_kernel, "src/repro/kernels/deconv2d/kernel.py:92"),
    ("deconv2d_int8_kernel", int8_kernel, "src/repro/kernels/deconv2d/int8.py:57"),
    ("deconv2d_sparse_kernel", sparse_kernel,
     "src/repro/kernels/deconv2d_sparse/kernel.py:57"),
)
SOURCE = "src/repro_torch/csrc/deconv2d.cu"

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
# int8: the int8 activations agree bit for bit, so the images differ only
# by tanh on the card (tanhf in the kernel, torch.tanh in the plain chain)
INT8_TOL = 1e-6
SPARSITY_LEVELS = (0.5, 0.9, 0.97, "hand")
SERVE_SPARSITY = 0.9   # a level of benchmarks/bench_sparsity.py's sweep
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
    for key, fp32, int8, bw in PEAKS:
        if key in name:
            return smi, name, {"fp32": fp32, "int8": int8, "bw": bw}
    raise RuntimeError(f"no published peaks recorded for {name!r}")


def rand(rng, shape, dtype, scale=1.0):
    return (torch.from_numpy((rng.standard_normal(shape) * scale)
                             .astype(np.float32)).to(dtype).cuda())


def layer_inputs(rng, batch, ih, iw, ci, co, k, dtype):
    x = rand(rng, (batch, ih, iw, ci), dtype)
    w = rand(rng, (k, k, ci, co), dtype, 1.0 / np.sqrt(ci * k * k))
    b = rand(rng, (co,), dtype, 0.1)
    return x, w, b


def check_cases():
    """``(label, geometry, batch, tiles, activation)`` of every kernel
    check: the JAX package's sweep, ragged and batch-tiled shapes, several
    CI chunks, and every generator layer at buckets 1 and 64."""
    out = []
    for (ih, iw, ci, co, k, s, p, t) in SWEEP:
        g = DeconvGeometry(ih, iw, ci, co, k, s, p)
        out.append((f"sweep {(ih, iw, ci, co, k, s, p, t)}", g, 2,
                    fill_tiles(g, 2, t_oh=t, t_ow=t), "relu"))
    for (ih, iw, ci, co, k, s, p, t) in ALG1_GEOMS:
        g = DeconvGeometry(ih, iw, ci, co, k, s, p)
        for batch, t_n in ((2, 1), (5, 2)):
            out.append((f"ragged {(ih, iw, ci, co, k, s, p, t)} n={batch} "
                        f"t_n={t_n}", g, batch,
                        fill_tiles(g, batch, t_oh=t, t_ow=t, t_n=t_n), "tanh"))
    g = DeconvGeometry(6, 6, 24, 40, 4, 2, 1)
    out.append(("ci-chunks t_ci=8 t_co=16", g, 3,
                fill_tiles(g, 3, t_ci=8, t_co=16), None))
    for cfg in NETS:
        for i, (g, l) in enumerate(zip(cfg.geometries(), cfg.layers)):
            for batch in (1, 64):
                t = hopper_tiles(g, batch)
                out.append((f"{cfg.name} l{i} bucket {batch} {t.as_kwargs()}",
                            g, batch, t, l.activation))
    return out


def disagree(label, y, y_ref, tol):
    err = (y.float() - y_ref.float()).abs()
    max_err = float(err.max())
    bad = bool((err > tol + tol * y_ref.float().abs()).any())
    if y.shape != y_ref.shape or y.dtype != y_ref.dtype or bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{label} max_abs_err={max_err} tol={tol}")
    return max_err


def check_dense(label, x, w, b, s, p, tiles, activation, results):
    """B1 against its plain version on the same padded inputs."""
    xp, wp, bp, kw, _ = launch_args(x, w, b, s, p, activation=activation,
                                    **tiles.as_kwargs())
    y = deconv_kernel.deconv2d_launch(xp, wp, bp, **kw)
    torch.cuda.synchronize()
    y_ref = deconv_kernel.deconv2d_launch_plain(xp, wp, bp, **kw)
    torch.cuda.synchronize()
    err = disagree(label, y, y_ref, TOL[x.dtype])
    print(f"  B1 {label} {str(x.dtype)[6:]} max_abs_err={err:.3e} "
          f"tol={TOL[x.dtype]}", flush=True)
    results.setdefault(x.dtype, []).append(err)


def check_int8(label, x, w, sc, b, s, p, tiles, activation, out_scale,
               results):
    """B2 against its plain version: int8 outputs equal, f32 within
    INT8_TOL."""
    xp, wp, sp, bp, kw, _ = int8_kernel.launch_args_int8(
        x, w, sc, b, s, p, *tiles.as_kwargs().values(), activation, out_scale)
    y = int8_kernel.deconv2d_int8_launch(xp, wp, sp, bp, **kw)
    torch.cuda.synchronize()
    y_ref = int8_kernel.deconv2d_int8_launch_plain(xp, wp, sp, bp, **kw)
    torch.cuda.synchronize()
    err = disagree(label, y, y_ref, 0.0 if out_scale is not None else INT8_TOL)
    nz = int((y_ref != 0).sum())
    print(f"  B2 {label} out={'int8' if out_scale else 'f32'} "
          f"max_abs_err={err:.3e} nonzero={nz}/{y_ref.numel()}", flush=True)
    results.append(err)


def prune(w, level):
    """Magnitude pruning at ``level``, or "hand": the first half of the
    input channels and one tap row zeroed, so that whole slabs drop out."""
    if level == "hand":
        w = w.clone()
        w[:, :, :max(1, w.shape[2] // 2)] = 0.0
        w[w.shape[0] // 2] = 0.0
        return w
    return magnitude_prune(w, level)[0]


def schedule_stats(tables, n_ci, k):
    """(slabs skipped, slabs, tap bits off in listed slabs, listed taps)."""
    ci_idx, valid, tap_mask = (np.asarray(t) for t in tables)
    listed = int(valid.sum())
    off = int(((tap_mask == 0) & (valid[..., None] == 1)).sum())
    return n_ci * ci_idx.shape[0] - listed, n_ci * ci_idx.shape[0], off, \
        listed * k * k


def check_sparse(label, x, w, b, s, p, tiles, activation, results):
    """B3 against its plain version; returns the slabs it skipped."""
    tables = make_sparse_plan(w, s, p, tiles.t_ci, tiles.t_co)
    xp, wp, bp, kw, _ = launch_args(x, w, b, s, p, activation=activation,
                                    **tiles.as_kwargs())
    sched = schedule_tensors(tables, x.device)
    y = sparse_kernel.deconv2d_sparse_launch(xp, wp, bp, *sched, **kw)
    torch.cuda.synchronize()
    y_ref = sparse_kernel.deconv2d_sparse_launch_plain(xp, wp, bp, *sched, **kw)
    torch.cuda.synchronize()
    err = disagree(label, y, y_ref, TOL[x.dtype])
    skipped, slabs, off, taps = schedule_stats(tables, wp.shape[2] // tiles.t_ci,
                                               w.shape[0])
    print(f"  B3 {label} {str(x.dtype)[6:]} max_abs_err={err:.3e} slabs "
          f"skipped {skipped}/{slabs} tap bits off {off}/{taps}", flush=True)
    results.setdefault(x.dtype, []).append(err)
    return skipped


def int8_net(cfg):
    """Seeded params of ``cfg``, calibrated on `calibration_input` and
    quantized: ``(params, qcfg, qp)``."""
    params = generator_init(torch.Generator().manual_seed(0), cfg, "cuda")
    qcfg = calibrate(params, cfg, calibration_input(cfg).cuda())
    return params, qcfg, quantize_params(params, cfg, qcfg)


def int8_layer_inputs(cfg, net, batch, rng):
    """Each layer's real int8 input at ``batch``: the fp32 chain's layer
    inputs quantized at their calibrated scales (``net`` from `int8_net`)."""
    params, qcfg, qp = net
    z = rand(rng, (batch, cfg.z_dim), torch.float32)
    with torch.no_grad():
        _, inters = generator_apply(params, cfg, z, backend="reverse_loop",
                                    return_intermediates=True)
    return [(quantize_symmetric(x, qcfg.layers[i].x_scale), qp[f"l{i}"],
             qcfg.out_scale(i)) for i, x in enumerate(inters)]


def phase_kernel_checks(int8_nets):
    """Every kernel against its plain version; returns the largest errors."""
    rng = np.random.default_rng(0)
    cases = check_cases()
    dense, int8, sparse = {}, [], {}
    for dtype in (torch.float32, torch.bfloat16):
        for label, g, batch, t, act in cases:
            x, w, b = layer_inputs(rng, batch, g.in_h, g.in_w, g.c_in,
                                   g.c_out, g.kernel, dtype)
            check_dense(label, x, w, b, g.stride, g.padding, t, act, dense)
    # B2: random int8 data on the synthetic cases, scaled so that the
    # epilogue lands on O(1) values and requant rounds at every step;
    # the generator layers get their real inputs and calibrated scales
    for label, g, batch, t, act in cases:
        if label.startswith("dcnn-"):
            continue
        x = torch.from_numpy(rng.integers(-127, 128, (batch, g.in_h, g.in_w,
                                                      g.c_in), dtype=np.int8)).cuda()
        w = torch.from_numpy(rng.integers(-127, 128, (g.kernel, g.kernel, g.c_in,
                                                      g.c_out), dtype=np.int8)).cuda()
        n = g.c_in * (-(-g.kernel // g.stride)) ** 2
        sc = torch.full((g.c_out,), 3.0 / (127 * 127 * np.sqrt(n)),
                        device="cuda")
        b = rand(rng, (g.c_out,), torch.float32, 0.1)
        check_int8(label, x, w, sc, b, g.stride, g.padding, t, act, 3.0 / 127,
                   int8)
        check_int8(label, x, w, sc, b, g.stride, g.padding, t, "tanh", None,
                   int8)
    for cfg in NETS:
        for batch in (1, 64):
            for i, (x, lq, out_scale) in enumerate(
                    int8_layer_inputs(cfg, int8_nets[cfg.name], batch, rng)):
                g, l = cfg.geometries()[i], cfg.layers[i]
                t = hopper_tiles(g, batch)
                check_int8(f"{cfg.name} l{i} bucket {batch} {t.as_kwargs()}",
                           x, lq["w_q"], lq["scale"], lq["b"], g.stride,
                           g.padding, t, l.activation, out_scale, int8)
    skipped = 0
    for dtype in (torch.float32, torch.bfloat16):
        for label, g, batch, t, act in cases:
            x, w, b = layer_inputs(rng, batch, g.in_h, g.in_w, g.c_in,
                                   g.c_out, g.kernel, torch.float32)
            for level in SPARSITY_LEVELS:
                skipped += check_sparse(
                    f"{label} pruned {level}", x.to(dtype),
                    prune(w, level).to(dtype), b.to(dtype), g.stride,
                    g.padding, t, act, sparse)
    if skipped == 0:
        raise AssertionError("no zero-skip case skipped a slab")
    print(f"  B3 cases skipped {skipped} slabs in all", flush=True)
    return dense, int8, sparse


def drive(engines, requests):
    """The main path of one kind of engine: every kernel count at 0 just
    before, each net's requests submitted and collected, the counts read
    just after.  Returns (outputs, launches per net and kernel, totals)."""
    for _, mod, _ in KERNELS:
        mod.LAUNCHES = 0
    outputs, per_net = {}, {}
    for name, eng in engines.items():
        before = {k: mod.LAUNCHES for k, mod, _ in KERNELS}
        tickets = [eng.submit(z) for z in requests[name]]
        outputs[name] = [eng.collect(t) for t in tickets]
        per_net[name] = {k: mod.LAUNCHES - before[k] for k, mod, _ in KERNELS}
    return outputs, per_net, {k: mod.LAUNCHES for k, mod, _ in KERNELS}


def check_launches(kernel, engines, per_net):
    for name, eng in engines.items():
        dispatches = len(eng.plan_chunks(sum(REQUEST_SIZES)))
        want = len(eng.cfg.layers) * dispatches
        got = per_net[name]
        print(f"  {name}: {dispatches} dispatches x {len(eng.cfg.layers)} "
              f"layers, launches {got}", flush=True)
        if got[kernel] != want or any(v for k, v in got.items() if k != kernel):
            raise AssertionError(f"{name}: launches {got}, expected {want} of "
                                 f"{kernel} and none of the others")


def check_images(name, outputs, refs, tol):
    """Every request's images finite, of the right shape and within ``tol``
    of each reference; returns the largest error per reference."""
    ofs = 0
    for n, img in zip(REQUEST_SIZES, outputs):
        if img.shape[0] != n or not np.isfinite(img).all():
            raise AssertionError(f"{name}: bad output {img.shape}")
        for be, ref in refs.items():
            err = float(np.abs(img - ref[ofs:ofs + n]).max())
            if err > tol:
                raise AssertionError(f"{name} request of {n}: {err} from {be}")
        ofs += n
    return {be: float(np.abs(np.concatenate(outputs) - ref).max())
            for be, ref in refs.items()}


def phase_serving():
    """Both generators through the engine on the three paths; returns
    (engines per path, launches per path and kernel)."""
    rng = np.random.default_rng(1)
    requests = {cfg.name: [rng.standard_normal((n, cfg.z_dim))
                           .astype(np.float32) for n in REQUEST_SIZES]
                for cfg in NETS}
    params = {cfg.name: generator_init(torch.Generator().manual_seed(0), cfg,
                                       "cuda") for cfg in NETS}
    pruned = {n: prune_tree(p, SERVE_SPARSITY) for n, p in params.items()}
    paths = {
        "fp32": ("deconv2d_kernel", {}, params),
        "int8": ("deconv2d_int8_kernel", {"precision": "int8"}, params),
        "cuda_sparse": ("deconv2d_sparse_kernel", {"backend": "cuda_sparse"},
                        pruned),
    }
    engines, launches, images = {}, {}, {}
    for path, (kernel, kw, tree) in paths.items():
        print(f"  path {path}", flush=True)
        engines[path] = {cfg.name: DcnnServeEngine.from_config(
            EngineConfig(model=cfg, max_batch=64, warmup=True, **kw),
            tree[cfg.name]) for cfg in NETS}
        outputs, per_net, totals = drive(engines[path], requests)
        launches[path] = totals
        check_launches(kernel, engines[path], per_net)
        for cfg in NETS:
            eng = engines[path][cfg.name]
            z = torch.from_numpy(np.concatenate(requests[cfg.name])).cuda()
            imgs = np.concatenate(outputs[cfg.name])
            images[path, cfg.name] = imgs
            if path == "int8":
                ref = quantized_generator_ref(eng.params, cfg, eng.quant_cfg, z)
                errs = check_images(cfg.name, outputs[cfg.name],
                                    {"int8 plain chain": ref.cpu().numpy()},
                                    INT8_TOL)
                fp32 = images["fp32", cfg.name]
                dist = float(mmd(torch.from_numpy(fp32).cuda(),
                                 torch.from_numpy(imgs).cuda()))
                print(f"  {cfg.name} int8: max |kernel - plain chain| {errs} "
                      f"(tol {INT8_TOL}); vs fp32 images: largest pixel error "
                      f"{float(np.abs(imgs - fp32).max()):.4f}, MMD "
                      f"{dist:.3e}", flush=True)
                continue
            with torch.no_grad():
                refs = {be: generator_apply(eng.params, cfg, z, backend=be)
                        .cpu().numpy() for be in ("reverse_loop", "cudnn")}
            errs = check_images(cfg.name, outputs[cfg.name], refs, SERVE_TOL)
            print(f"  {cfg.name} {path}: max |kernel - ref| {errs} "
                  f"(tol {SERVE_TOL})", flush=True)
            if path == "cuda_sparse":
                plan = eng.plans[64]
                shares = []
                for l in plan.layers:
                    sk, n, _, _ = schedule_stats(
                        l.sparse_tables, -(-l.geometry.c_in // l.tiles.t_ci),
                        l.geometry.kernel)
                    shares.append(f"{sk}/{n}")
                print(f"  {cfg.name} pruned {SERVE_SPARSITY}: slabs skipped per "
                      f"layer at bucket 64 {shares}", flush=True)
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


def time_row(kernel, cfg, i, batch, tiles, launch, plain, library, ops, peak,
             nbytes, mem_bw, smi, **extra):
    """One layer's row: device and per-call time of ``launch``, the plain
    version's and the library call's (None: there is none), and the
    bound."""
    ms, held = time_ms(launch)
    call_ms, _ = time_ms(launch, backlog=False)
    # the plain version is no yardstick of speed and enqueues more work
    # than a queued sleep outlasts: its per-call time, host work included
    plain_ms, _ = time_ms(plain, backlog=False)
    lib_ms, lib_held = time_ms(library) if library else (None, None)
    ops_ms = ops / peak * 1e3
    bytes_ms = nbytes / mem_bw * 1e3
    row = {"kernel": kernel, "net": cfg.name, "layer": i, "bucket": batch,
           "tiles": tiles.as_kwargs(), "ms": ms, "call_ms": call_ms,
           "ms_is_device_time": held, "plain_call_ms": plain_ms,
           "library_ms": lib_ms,
           "library_is_device_time": lib_held,
           "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "gop": ops / 1e9, "mbytes": nbytes / 1e6,
           "launches_per_dispatch": 1, **extra, "card": smi}
    print(json.dumps({"layer_time": row}), flush=True)
    return row


def kept_work(g, tables, t_ci, t_co):
    """(MACs, weights) that a zero-skip schedule keeps: for each listed slab
    and live tap, its real channels times the output pixels the tap
    reaches (`DeconvGeometry.output_macs`, over the kept slabs only)."""
    ci_idx, valid, tap_mask = (np.asarray(t) for t in tables)

    def reach(n_in, n_out):  # per tap: inputs whose product lands inside
        return [sum(1 for i in range(n_in)
                    if 0 <= i * g.stride + k - g.padding < n_out)
                for k in range(g.kernel)]

    per_tap = np.outer(reach(g.in_h, g.out_h), reach(g.in_w, g.out_w)).ravel()
    live = tap_mask * valid[..., None]
    ci_sz = np.clip(g.c_in - np.arange(ci_idx.max() + 1) * t_ci, 0,
                    t_ci)[ci_idx]
    co_sz = np.clip(g.c_out - np.arange(ci_idx.shape[0]) * t_co, 0, t_co)
    macs = int((((live * per_tap).sum(-1) * ci_sz).sum(-1) * co_sz).sum())
    weights = int(((live.sum(-1) * ci_sz).sum(-1) * co_sz).sum())
    return macs, weights


def phase_times(smi, peaks, int8_nets):
    rng = np.random.default_rng(2)
    rows = []
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for cfg in NETS:
        for i, (g, l) in enumerate(zip(cfg.geometries(), cfg.layers)):
            for batch in (1, 64):
                t = hopper_tiles(g, batch)
                n_out = batch * g.out_h * g.out_w * g.c_out
                n_in = batch * g.in_h * g.in_w * g.c_in
                n_w = g.kernel ** 2 * g.c_in * g.c_out
                ops = 2 * g.output_macs * batch
                # B1: fp32, every product that lands in the output
                x, w, b = layer_inputs(rng, batch, g.in_h, g.in_w, g.c_in,
                                       g.c_out, g.kernel, torch.float32)
                xp, wp, bp, kw, _ = launch_args(x, w, b, g.stride, g.padding,
                                                *t.as_kwargs().values(),
                                                l.activation)
                x_nchw = x.permute(0, 3, 1, 2).contiguous()
                rows.append(time_row(
                    "deconv2d_kernel", cfg, i, batch, t,
                    lambda: deconv_kernel.deconv2d_launch(xp, wp, bp, **kw),
                    lambda: deconv_kernel.deconv2d_launch_plain(xp, wp, bp,
                                                                **kw),
                    lambda: F.conv_transpose2d(
                        x_nchw, w.permute(2, 3, 0, 1).contiguous(), b,
                        stride=g.stride, padding=g.padding),
                    ops, peaks["fp32"], 4 * (n_in + n_w + g.c_out + n_out),
                    peaks["bw"], smi))
                # B2: int8 in and weights, f32 scale and bias, int8 out (f32
                # on the last layer); no PyTorch call computes this
                xq, lq, out_scale = int8_layer_inputs(
                    cfg, int8_nets[cfg.name], batch, rng)[i]
                qa = int8_kernel.launch_args_int8(
                    xq, lq["w_q"], lq["scale"], lq["b"], g.stride, g.padding,
                    *t.as_kwargs().values(), l.activation, out_scale)
                rows.append(time_row(
                    "deconv2d_int8_kernel", cfg, i, batch, t,
                    lambda: int8_kernel.deconv2d_int8_launch(*qa[:4], **qa[4]),
                    lambda: int8_kernel.deconv2d_int8_launch_plain(*qa[:4],
                                                                   **qa[4]),
                    None, ops, peaks["int8"],
                    n_in + n_w + 8 * g.c_out
                    + n_out * (1 if out_scale is not None else 4),
                    peaks["bw"], smi,
                    library_note="no PyTorch call computes an int8 "
                                 "transposed convolution on CUDA"))
                # B3: fp32 on weights pruned at the serving level; the bound
                # counts the MACs and weights its schedule keeps
                wq = prune(w, SERVE_SPARSITY)
                tables = make_sparse_plan(wq, g.stride, g.padding, t.t_ci,
                                          t.t_co)
                sched = schedule_tensors(tables, "cuda")
                macs, kept_w = kept_work(g, tables, t.t_ci, t.t_co)
                sp = launch_args(x, wq, b, g.stride, g.padding,
                                 *t.as_kwargs().values(), l.activation)
                wq_lib = wq.permute(2, 3, 0, 1).contiguous()
                skipped, slabs, _, _ = schedule_stats(
                    tables, sp[1].shape[2] // t.t_ci, g.kernel)
                rows.append(time_row(
                    "deconv2d_sparse_kernel", cfg, i, batch, t,
                    lambda: sparse_kernel.deconv2d_sparse_launch(
                        *sp[:3], *sched, **sp[3]),
                    lambda: sparse_kernel.deconv2d_sparse_launch_plain(
                        *sp[:3], *sched, **sp[3]),
                    lambda: F.conv_transpose2d(x_nchw, wq_lib, b,
                                               stride=g.stride,
                                               padding=g.padding),
                    2 * macs * batch, peaks["fp32"],
                    4 * (n_in + kept_w + g.c_out + n_out), peaks["bw"], smi,
                    sparsity=SERVE_SPARSITY, slabs_skipped=f"{skipped}/{slabs}",
                    kept_mac_share=macs / g.output_macs))
    return rows


def phase_end_to_end(engines, smi):
    rng = np.random.default_rng(3)
    out = {}
    for path, by_net in engines.items():
        for name, eng in by_net.items():
            z = rng.standard_normal((64, eng.cfg.z_dim)).astype(np.float32)
            for _ in range(30):
                eng.generate(z)
            tp = eng.throughput()[64]
            out[path, name] = {"bucket": 64, "img_per_s": tp["img_per_s"],
                               "mean_ms": tp["mean_s"] * 1e3, "cv": tp["cv"],
                               "calls": tp["calls"], "card": smi}
            print(json.dumps({"end_to_end": out[path, name], "net": name,
                              "path": path}), flush=True)
    return out


def main() -> int:
    smi, name, peaks = device_info()
    print(f"[1] device: {smi} | torch: {name} | peaks: fp32 "
          f"{peaks['fp32'] / 1e12} TFLOP/s, int8 {peaks['int8'] / 1e12} "
          f"TOP/s, memory {peaks['bw'] / 1e12} TB/s", flush=True)

    t0 = time.perf_counter()
    deconv_kernel.build()
    print(f"[2] build: {time.perf_counter() - t0:.2f} s ({SOURCE}: "
          f"{', '.join(k for k, _, _ in KERNELS)})", flush=True)

    print(f"[3] each kernel vs its plain version on the card (at "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    int8_nets = {cfg.name: int8_net(cfg) for cfg in NETS}
    dense, int8, sparse = phase_kernel_checks(int8_nets)

    print(f"[4] serving (at {time.perf_counter() - t0:.1f} s)", flush=True)
    engines, launches = phase_serving()

    print(f"[5] times (at {time.perf_counter() - t0:.1f} s)", flush=True)
    rows = phase_times(smi, peaks, int8_nets)
    phase_end_to_end(engines, smi)

    errs = {"deconv2d_kernel": (max(dense[torch.float32]),
                                {"max_abs_err_bf16": max(dense[torch.bfloat16])}),
            "deconv2d_int8_kernel": (max(int8), {}),
            "deconv2d_sparse_kernel": (max(sparse[torch.float32]),
                                       {"max_abs_err_bf16":
                                        max(sparse[torch.bfloat16])})}
    path_of = {"deconv2d_kernel": "fp32", "deconv2d_int8_kernel": "int8",
               "deconv2d_sparse_kernel": "cuda_sparse"}
    entries = []
    for kname, _, replaces in KERNELS:
        b64 = [r for r in rows if r["kernel"] == kname and r["bucket"] == 64]
        by = {k: sum(r["bound_ms"] for r in b64 if r["bound_by"] == k)
              for k in ("operations", "bytes")}
        launched = launches[path_of[kname]][kname]
        if launched == 0:
            raise AssertionError(f"the main path launched no {kname}")
        lib = [r["library_ms"] for r in b64]
        entries.append({
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": launched,
            "max_abs_err": errs[kname][0], **errs[kname][1],
            "ms": sum(r["ms"] for r in b64),
            "plain_ms": sum(r["plain_call_ms"] for r in b64),
            "bound_ms": sum(r["bound_ms"] for r in b64),
            "bound_by": max(by, key=by.get),
            "library_ms": None if None in lib else sum(lib),
            **({"library_note": b64[0]["library_note"]} if None in lib else {}),
            "times_are": "sum over every layer of both generators at bucket 64",
            "ms_is_device_time": all(r["ms_is_device_time"] for r in b64),
            "card": smi,
        })
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
