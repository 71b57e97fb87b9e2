#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Three kernels, one per TPU kernel of the JAX package: B1 the dense
reverse-loop deconv (fp32/bf16), B2 the int8 one with its requant epilogue,
B3 the zero-skip one (fp32/bf16).  All run on the tensor cores, with
bulk-copy staging and a cluster split of the CI reduction, in
src/repro_torch/csrc/deconv2d_tc.cu: fp32 B1 and B3 on 3xTF32 mma, bf16 B1
and B3 on bf16 mma (m16n8k16, ldmatrix fragments), B2 on s8 mma into exact
int32 sums (weights packed CI-minor).

Phases (any failure raises and the exit code is non-zero; a launch check
that meets only the profiler's record loss, every count agreeing and the
trace short of the path's own launches, runs its phase once more from
scratch, and a second loss fails):
 1. device: the card's name and power limit (nvidia-smi), torch's name;
 2. build: nvcc builds the kernel library from src/repro_torch/csrc, and
    ptxas's registers and spills of every kernel instance (fp32, bf16 and
    int8) are printed;
 3. each kernel vs its plain version, on the card: the JAX package's kernel
    sweep, ragged and batch-tiled shapes, several CI chunks, and every
    layer of both generators and of the workload zoo's image-rooted towers
    (the super-resolution head "sr" and the denoiser "denoise": stride 1,
    K = 5 with padding 2, C_in = 1 and C_out = 1, 14x14 and 28x28 roots) at
    buckets 1 and 64 (the thin C_out 1 and 3 heads among them).  B1 fp32
    tol 1e-4, bf16 8e-2; B2 int8 outputs bit-equal, f32 outputs 1e-6, with
    real requant scales on the towers' layers (calibrated on each tower's
    own calibration batch); B3 as B1, under magnitude pruning at 0.5 / 0.9
    / 0.97 and hand-zeroed slabs, and some case must skip slabs; every
    plain version at its launch's cluster split; then B1, B2 and B3 (B1 and
    B3 in fp32 and bf16) launched twice on the same inputs at every tower
    layer at bucket 1 must give bit-identical outputs (the cluster split
    sums its partials in rank order, with no atomics);
 4. serving through DcnnServeEngine with mixed-size requests, every tower
    at full width, each bucket one captured CUDA graph, each path and
    tower driven under torch.profiler with every count at 0 just before
    and read just after: fp32 on "cuda" (held against reverse_loop and
    cudnn), int8 (against the int8 plain chain; MMD against the fp32
    images; weights packed once by the engine) and "cuda_sparse" on params
    pruned at 0.9 (against reverse_loop and cudnn on the same params), for
    both generators (latent requests) and both zoo towers (requests of
    images from the towers' own pair synthesizers); and bf16 generators on
    "cuda" and "cuda_sparse" (pruned 0.9; float32 in and out, bf16 on the
    card), against reverse_loop and cudnn in bf16 at 8e-2, with the
    largest error against the fp32 images of the same params reported;
    the trace's device launches of the path's kernel instance == layers x
    dispatches and none of the others, the engine's launch_counts the
    same, the Python wrappers' counts 0 (replays only, no eager run),
    capture_counts 1 per bucket; every bucket's replayed images
    bit-identical to an eager run of the same plan through the public ops;
 5. times: per kernel, layer and bucket, device time (CUDA events, median
    of 25, launches queued behind a sleep, with a check that the sleep
    outlasted the host's enqueue) and per-call time against its bound (B1
    and B3: the 3xTF32 rate, a third of the TF32 tensor-core peak, with the
    bound at the fp32 FMA peak beside it; B2: the int8 peak; bf16 B1 and
    B3: 2 bytes per element, operations at the bf16 tensor-core peak), the
    plain version's per-call time and the library call's device time where
    there is one (cuDNN in the layer's dtype), and each row's cluster split
    (B2's and the bf16 rows also the registers and spills of the instance
    they launch), for every tower; per path and
    tower, images/s and run-to-run CV from the engine, and the bucket-64
    dispatch split into its host-to-device copy, replay and device-to-host
    copy (CUDA events);
 6. the async SLO frontend (`AsyncServeFrontend`) over CelebA at full
    width: fp32 engines (B1) and the int8 degraded path (B2), every bucket
    x precision captured by prime() before the worker starts; offered
    loads 0.5, 1 and 2 x the primed fp32 capacity with gold (SLO) and std
    tenants, a degrade drill (gold served on int8 while fp32 is predicted
    past its SLO) and a fault drill (one transient failure: retried,
    tainted, out of the CV; one slow call: a straggler and a heartbeat
    fire), all under torch.profiler and the port's span tracer: every
    request resolved typed, traced B1 fp32 and B2 launches == layers x
    dispatches per precision and none of another kernel, one graph per
    bucket x precision, fp32 images within 1e-4 of the fp32 engine's
    generate of the same rows, int8 images bit-equal to the int8
    engine's; printed: per load and tenant p50/p99/CV, shed, downgraded,
    requeued, the queue-wait / dispatch split, Table II of the engines,
    the drill's counters and the trace's span counts (the Chrome trace
    exported to a temporary file);
 7. refine: fp32 engines with refine=True at buckets 1 and 64 time the
    model's pick and the next candidates per layer (tile cache in a fresh
    temporary file); per layer both picks and times, and the refined
    engine's images against reverse_loop;
 8. training, with float32 products in full float32 (TF32 off): CelebA
    WGAN-GP at full width (its 64x64x3 critic), batch 64, n_critic 5, 3
    steps through `WganTrainer.fit` on "cuda" (B1 in the generator's
    forward, the reverse loop's autograd as its backward) on seeded
    synthetic faces, under torch.profiler with every count at 0 just
    before: exactly 5 layers x 6 x 3 = 90 traced B1 launches and no B2 or
    B3; the fused generator's backward traced alone launches no B1; losses,
    params and Adam moments finite; after each generator update (each
    step's checkpoint) the trainer's fused forward within 1e-4 of the
    reverse loop; a run resumed from step 1's checkpoint bitwise the
    uninterrupted one (the fit and resume run with cuDNN's deterministic
    algorithms); one critic and one generator step on "cuda" equal to the
    same on "reverse_loop" from fit's params, fresh optimizer states and
    the same noise (losses rtol 1e-4; Adam's moments, i.e. the grads,
    within 1e-4 as ||difference|| / ||reverse_loop's|| over each tree;
    params 2 lr), the same from the initial params printed; ms per critic
    and generator step on cuda, reverse_loop and cudnn, the generator
    forward alone (B1 vs reverse loop vs cuDNN) and the remat backward's
    share of a generator step; then the zoo's sr head, 3 masked-MSE steps
    at batch 64 through `SupervisedTrainer` on "cuda": 3 x 3 = 9 traced B1
    launches, against the same run on "reverse_loop": each step's loss
    rtol 1e-4, the params after the three within 1e-5, and the first
    step's moments within 1e-5 as a tree-norm ratio;
 9. the plan DRC (`repro_torch.analysis.check`): every plan the serving
    engines of phase 4 built (4 towers x their paths x 7 buckets)
    DRC-clean against `H100_SXM`, each zero-skip tower's bucket-64 plan
    also against the weights it serves; for every tiled launch of them
    (one eager pass per bucket on the engine's own operands) the DRC's
    shared memory, threads and split equal to the launcher's parameter
    array and the library's ``deconv2d_tc_smem_bytes``; the engine's gate
    on the card: a pinned CelebA plan with a 512/512/2048/2048 tile, the
    same plan named for the JAX package's "pallas" backend and an int8
    plan with a broken requant chain each refused with `PlanCheckError`
    (drc.smem_budget, drc.backend, drc.scale_chain) before any planning,
    build, capture or launch, the "pallas" plan served after
    `NetworkPlan.for_hopper`; ``examples/serve_dcnn_torch.py --plan-json``
    writes, reloads, DRCs and serves MNIST's plan and exits 2 on a
    mutated one;
10. the mesh: CelebA at full width on `make_test_mesh(2,
    device="cuda:0")` at bucket 64 (32 rows a shard), fp32 (B1) and int8
    (B2), three dispatches under torch.profiler with every count at 0
    just before: traced launches == layers x shards x dispatches of the
    path's kernel and none of the others, images within 1e-5 of the
    single-device engine's (int8 bit-equal), every per-shard plan
    DRC-clean; `make_serving_mesh()` serves once over every visible card
    (one on a one-card machine); ms per bucket-64 dispatch on one
    device, 2 shards and the serving mesh (two shards on one card time
    the split and gather, not multi-GPU scaling); an elastic drill (an
    injected device loss with keep=1: one shard, buckets re-aligned from
    (2, 64) to (1, 64), one remesh event, images unchanged); MNIST
    WGAN-GP at full width, 2 steps on 2 shards against z_shards=2
    (losses rtol 1e-4, Adam's moments 1e-4 as a tree-norm ratio; traced
    B1 = layers x shards x 6 x 2);
11. the kernels line (launches summed over the serving paths, the
    frontend run, the training runs and the mesh phase); 12. the result
    line.

Imports nothing of JAX: only torch, numpy and the port (src/repro_torch).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import queue
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.analysis.check import (PlanCheckError,  # noqa: E402
                                        check_network_plan)
from repro_torch.analysis.check.plan_drc import launch_resources  # noqa: E402
from repro_torch.ckpt import AsyncCheckpointer, restore  # noqa: E402
from repro_torch.core.deconv import fp32_exact  # noqa: E402
from repro_torch.core.dse import H100_SXM  # noqa: E402
from repro_torch.core.mmd import mmd  # noqa: E402
from repro_torch.core.sparsity import magnitude_prune, prune_tree  # noqa: E402
from repro_torch.core.tiling import DeconvGeometry, tc_warp_tile  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.data import image_source  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels.autotune import (SMS, fill_tiles,  # noqa: E402
                                          grid_blocks, hopper_tiles, time_ms)
from repro_torch.kernels.deconv2d import int8 as int8_kernel  # noqa: E402
from repro_torch.kernels.deconv2d import kernel as deconv_kernel  # noqa: E402
from repro_torch.kernels.deconv2d.ops import launch_args  # noqa: E402
from repro_torch.kernels.deconv2d_sparse import kernel as sparse_kernel  # noqa: E402
from repro_torch.kernels.deconv2d_sparse import (make_sparse_plan,  # noqa: E402
                                                 schedule_tensors)
from repro_torch.models.dcnn import (CELEBA_DCNN, MNIST_DCNN,  # noqa: E402
                                     generator_apply, generator_init)
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.quant import (calibrate, quantize_params,  # noqa: E402
                               quantize_symmetric, quantized_generator_apply,
                               quantized_generator_ref)
from repro_torch.dist import (DeviceLoss, FaultInjector, SlowCall,  # noqa: E402
                              TransientFailure)
from repro_torch.launch import make_serving_mesh, make_test_mesh  # noqa: E402
from repro_torch.obs import trace as obstrace  # noqa: E402
from repro_torch.obs.report import render_table2, table2_rows  # noqa: E402
from repro_torch.serve import (AdmissionRejected,  # noqa: E402
                               AsyncServeFrontend, DcnnServeEngine,
                               EngineConfig, EngineDegraded, TenantClass)
from repro_torch.train import (SupervisedTrainer, WganTrainer,  # noqa: E402
                               pair_source)
from repro_torch.train.wgan import requiring_grad  # noqa: E402
from repro_torch.workloads import (DAE_DENOISE, SR_X2,  # noqa: E402
                                   calibration_input, workload_for)

# Published peaks (NVIDIA data sheets, dense): fp32 outside the tensor
# cores, int8, TF32 and bf16 on the tensor cores (the data sheets' figures
# with sparsity, halved), and device-memory bandwidth.  Keyed by a
# substring of the card's name; the H100 SXM's are the port's
# `core.dse.H100_SXM`.
PEAKS = (
    ("H100 PCIe", 51e12, 1513e12, 378e12, 756e12, 2.0e12),
    ("H100 NVL", 60e12, 1671e12, 418e12, 835e12, 3.9e12),
    ("H100", H100_SXM.peak_ops, H100_SXM.int8_peak_ops,      # SXM5, HBM3
     H100_SXM.tf32_peak_ops, H100_SXM.bf16_peak_ops, H100_SXM.bandwidth),
    ("H200", 67e12, 1979e12, 495e12, 989e12, 4.8e12),
)
# (name, module, source, the TPU kernel it replaces)
KERNELS = (
    ("deconv2d_kernel", deconv_kernel, "src/repro/kernels/deconv2d/kernel.py:92"),
    ("deconv2d_int8_kernel", int8_kernel, "src/repro/kernels/deconv2d/int8.py:57"),
    ("deconv2d_sparse_kernel", sparse_kernel,
     "src/repro/kernels/deconv2d_sparse/kernel.py:57"),
)
SOURCES = {"deconv2d_kernel": "src/repro_torch/csrc/deconv2d_tc.cu",
           "deconv2d_int8_kernel": "src/repro_torch/csrc/deconv2d_tc.cu",
           "deconv2d_sparse_kernel": "src/repro_torch/csrc/deconv2d_tc.cu"}

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
# the workload zoo's image-rooted towers (super-resolution, denoising)
ZOO = (SR_X2, DAE_DENOISE)
TOWERS = NETS + ZOO
# the generators with their chains in bf16 (same widths, same params)
BF16_NETS = tuple(dataclasses.replace(c, dtype="bfloat16") for c in NETS)
REQUEST_SIZES = (64, 37, 5, 1, 64)
# serving outputs are tanh images in [-1, 1]; the backends sum the same
# fp32 products in different orders, which moves them by ~1e-6
SERVE_TOL = 1e-4
# bf16 chains round every layer's output to bf16 (PERF.md section 2)
BF16_SERVE_TOL = 8e-2
# int8: the int8 activations agree bit for bit, so the images differ only
# by tanh on the card (tanhf in the kernel, torch.tanh in the plain chain)
INT8_TOL = 1e-6
SPARSITY_LEVELS = (0.5, 0.9, 0.97, "hand")
SERVE_SPARSITY = 0.9   # a level of benchmarks/bench_sparsity.py's sweep
# what each kernel's instances are called in a profiler trace (demangled),
# per (kernel, dtype): every one a template of the tensor-core library,
# its first argument kSparse (fp32, bf16) or kRequant (int8)
TRACE_NAMES = {
    ("deconv2d_kernel", "fp32"): r"deconv2d_tc_kernel<false",
    ("deconv2d_kernel", "bf16"): r"deconv2d_tc_bf16_kernel<false",
    ("deconv2d_int8_kernel", "int8"): r"deconv2d_tc_int8_kernel<",
    ("deconv2d_sparse_kernel", "fp32"): r"deconv2d_tc_kernel<true",
    ("deconv2d_sparse_kernel", "bf16"): r"deconv2d_tc_bf16_kernel<true",
}
# serving paths: (kernel instance, engine options, towers, pruned params)
PATHS = {
    "fp32": (("deconv2d_kernel", "fp32"), {}, TOWERS, False),
    "int8": (("deconv2d_int8_kernel", "int8"), {"precision": "int8"}, TOWERS,
             False),
    "cuda_sparse": (("deconv2d_sparse_kernel", "fp32"),
                    {"backend": "cuda_sparse"}, TOWERS, True),
    "bf16": (("deconv2d_kernel", "bf16"), {}, BF16_NETS, False),
    "bf16_sparse": (("deconv2d_sparse_kernel", "bf16"),
                    {"backend": "cuda_sparse"}, BF16_NETS, True),
}
SPLIT_RUNS = 30
REFINE_BUCKETS = (1, 64)
# the async frontend phase: CelebA at full width, offered loads as the JAX
# package's serving bench sweeps them (benchmarks/bench_deconv.py slo_rows)
FRONTEND_LOADS = (0.5, 1.0, 2.0)
FRONTEND_REQUESTS = 600        # per load; rows per request 1..64
FRONTEND_QUEUE_ROWS = 256      # the frontend's default bound
FRONTEND_WAIT_S = 60           # a request unresolved after this is a hang
HEARTBEAT_S = 0.05             # below SLOW_CALL_S
SLOW_CALL_S = 0.25             # well past 3x a bucket-64 dispatch's EMA
DEGRADE_REQUESTS = 8
# the training phase: CelebA WGAN-GP at full width (AdamW with b1 0.5 and
# b2 0.9, as the reference's WGAN tests), and the zoo's sr head supervised
TRAIN_BATCH = 64
TRAIN_N_CRITIC = 5
TRAIN_STEPS = 3
TRAIN_LR = 1e-4
SR_LR = 1e-3
TRAIN_RUNS = 10
# Adam's moments after one step from the same params and a fresh state
# (what the grads set), as ||difference|| / ||reverse_loop's|| over a tree:
# sr's; and the WGAN step's, whose critic grads move by 1.3e-5 at fit's
# params and 1.4e-3 at the initial ones (H100, fp32) when B1's rounding of
# the fake flips LeakyReLU inputs that lie within it of the kink
MOMENT_TOL = 1e-5
WGAN_MOMENT_TOL = 1e-4
# sr's params after three steps on "cuda" against "reverse_loop"
SR_PARAM_TOL = 1e-5
# the mesh phase: CelebA on 2 shards of one card at bucket 64 (32 rows a
# shard), three dispatches; its images against the single-device engine's
# (fp32: the per-shard plans may tile differently; int8 bit for bit); and
# MNIST WGAN-GP at full width, 2 steps on 2 shards against z_shards=2
MESH_SHARDS = 2
MESH_REQUESTS = (64, 64, 37)
MESH_TOL = 1e-5
MESH_RUNS = 30
MESH_TRAIN_STEPS = 2


@functools.lru_cache(maxsize=None)
def demangle(name):
    """A kernel's C++ name (its mangled one where c++filt is missing),
    without its argument list."""
    try:
        name = subprocess.run(["c++filt", name], capture_output=True,
                              text=True, check=True).stdout.strip() or name
    except (OSError, subprocess.CalledProcessError):
        return name
    return name.replace("(anonymous namespace)::", "").split("(", 1)[0]


def device_info():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    for key, fp32, int8, tf32, bf16, bw in PEAKS:
        if key in name:
            return smi, name, {"fp32": fp32, "int8": int8, "tf32": tf32,
                               "bf16": bf16, "bw": bw}
    raise RuntimeError(f"no published peaks recorded for {name!r}")


def rand(rng, shape, dtype, scale=1.0):
    return (torch.from_numpy((rng.standard_normal(shape) * scale)
                             .astype(np.float32)).to(dtype).cuda())


def layer_inputs(rng, batch, ih, iw, ci, co, k, dtype):
    x = rand(rng, (batch, ih, iw, ci), dtype)
    w = rand(rng, (k, k, ci, co), dtype, 1.0 / np.sqrt(ci * k * k))
    b = rand(rng, (co,), dtype, 0.1)
    return x, w, b


def check_cases(dtype):
    """``(label, geometry, batch, tiles, activation)`` of every kernel
    check, at the tiles of the kernel that runs ``dtype``: the JAX
    package's sweep, ragged and batch-tiled shapes, several CI chunks, and
    every layer of every tower at buckets 1 and 64 (labelled by the
    tower's name)."""
    out = []
    for (ih, iw, ci, co, k, s, p, t) in SWEEP:
        g = DeconvGeometry(ih, iw, ci, co, k, s, p)
        out.append((f"sweep {(ih, iw, ci, co, k, s, p, t)}", g, 2,
                    fill_tiles(g, 2, dtype, t_oh=t, t_ow=t), "relu"))
    for (ih, iw, ci, co, k, s, p, t) in ALG1_GEOMS:
        g = DeconvGeometry(ih, iw, ci, co, k, s, p)
        for batch, t_n in ((2, 1), (5, 2)):
            out.append((f"ragged {(ih, iw, ci, co, k, s, p, t)} n={batch} "
                        f"t_n={t_n}", g, batch,
                        fill_tiles(g, batch, dtype, t_oh=t, t_ow=t, t_n=t_n),
                        "tanh"))
    # three CI chunks of the kernel's smallest (int8: 32 channels, bf16:
    # 16, fp32: 8)
    t_ci = {torch.int8: 32, torch.bfloat16: 16}.get(dtype, 8)
    g = DeconvGeometry(6, 6, 3 * t_ci, 40, 4, 2, 1)
    out.append((f"ci-chunks t_ci={t_ci} t_co=16", g, 3,
                fill_tiles(g, 3, dtype, t_ci=t_ci, t_co=16), None))
    for cfg in TOWERS:
        for i, (g, l) in enumerate(zip(cfg.geometries(), cfg.layers)):
            for batch in (1, 64):
                t = hopper_tiles(g, batch, dtype)
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
    """B1 against its plain version on the same padded inputs, at the
    launch's cluster split."""
    args = launch_args(x, w, b, s, p, activation=activation,
                       **tiles.as_kwargs())
    xp, wp, bp, kw, _ = args
    split = split_of(args)
    y = deconv_kernel.deconv2d_launch(xp, wp, bp, **kw)
    torch.cuda.synchronize()
    y_ref = deconv_kernel.deconv2d_launch_plain(xp, wp, bp, split=split,
                                                **kw)
    torch.cuda.synchronize()
    err = disagree(label, y, y_ref, TOL[x.dtype])
    print(f"  B1 {label} {str(x.dtype)[6:]} split {split} max_abs_err="
          f"{err:.3e} tol={TOL[x.dtype]}", flush=True)
    results.setdefault(x.dtype, []).append(err)


def check_int8(label, x, w, sc, b, s, p, tiles, activation, out_scale,
               results):
    """B2 against its plain version at the launch's cluster split: int8
    outputs equal, f32 outputs within INT8_TOL."""
    xp, wpk, sp, bp, kw, _ = int8_kernel.launch_args_int8(
        x, w, sc, b, s, p, *tiles.as_kwargs().values(), activation, out_scale)
    split = int8_kernel.launch_split_int8(xp, wpk, kw)
    y = int8_kernel.deconv2d_int8_launch(xp, wpk, sp, bp, **kw)
    torch.cuda.synchronize()
    y_ref = int8_kernel.deconv2d_int8_launch_plain(
        xp, int8_kernel.unpack_int8_weights(wpk), sp, bp, split=split, **kw)
    torch.cuda.synchronize()
    err = disagree(label, y, y_ref, 0.0 if out_scale is not None else INT8_TOL)
    nz = int((y_ref != 0).sum())
    print(f"  B2 {label} out={'int8' if out_scale else 'f32'} split {split} "
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
    """B3 against its plain version at the launch's cluster split; returns
    the slabs it skipped."""
    tables = make_sparse_plan(w, s, p, tiles.t_ci, tiles.t_co)
    args = launch_args(x, w, b, s, p, activation=activation,
                       **tiles.as_kwargs())
    xp, wp, bp, kw, _ = args
    split = split_of(args)
    sched = schedule_tensors(tables, x.device)
    y = sparse_kernel.deconv2d_sparse_launch(xp, wp, bp, *sched, **kw)
    torch.cuda.synchronize()
    y_ref = sparse_kernel.deconv2d_sparse_launch_plain(xp, wp, bp, *sched,
                                                       split=split, **kw)
    torch.cuda.synchronize()
    err = disagree(label, y, y_ref, TOL[x.dtype])
    skipped, slabs, off, taps = schedule_stats(tables, wp.shape[2] // tiles.t_ci,
                                               w.shape[0])
    print(f"  B3 {label} {str(x.dtype)[6:]} split {split} max_abs_err="
          f"{err:.3e} slabs skipped {skipped}/{slabs} tap bits off "
          f"{off}/{taps}", flush=True)
    results.setdefault(x.dtype, []).append(err)
    return skipped


def tower_inputs(cfg, n, rng):
    """``n`` input rows of ``cfg`` as float32 numpy: N(0, 1) latents for a
    generator, and for an image-rooted tower images from its workload's
    own pair synthesizer (at a seed drawn from ``rng``)."""
    w = workload_for(cfg)
    if cfg.is_latent or w is None or w.pair_fn is None:
        return rng.standard_normal((n,) + cfg.input_shape).astype(np.float32)
    return np.asarray(w.training_pairs(int(rng.integers(1 << 16)), n)[0],
                      np.float32)


def int8_net(cfg):
    """Seeded params of ``cfg``, calibrated on `calibration_input` (the
    tower's own calibration batch) and quantized: ``(params, qcfg, qp)``."""
    params = generator_init(torch.Generator().manual_seed(0), cfg, "cuda")
    qcfg = calibrate(params, cfg, calibration_input(cfg).cuda())
    return params, qcfg, quantize_params(params, cfg, qcfg)


def int8_layer_inputs(cfg, net, batch, rng):
    """Each layer's real int8 input at ``batch``: the fp32 chain's layer
    inputs quantized at their calibrated scales (``net`` from `int8_net`)."""
    params, qcfg, qp = net
    z = torch.from_numpy(tower_inputs(cfg, batch, rng)).cuda()
    with torch.no_grad():
        _, inters = generator_apply(params, cfg, z, backend="reverse_loop",
                                    return_intermediates=True)
    return [(quantize_symmetric(x, qcfg.layers[i].x_scale), qp[f"l{i}"],
             qcfg.out_scale(i)) for i, x in enumerate(inters)]


def phase_kernel_checks(int8_nets):
    """Every kernel against its plain version; returns the largest errors."""
    rng = np.random.default_rng(0)
    cases = {dtype: check_cases(dtype)
             for dtype in (torch.float32, torch.bfloat16, torch.int8)}
    dense, int8, sparse = {}, [], {}
    for dtype in (torch.float32, torch.bfloat16):
        for label, g, batch, t, act in cases[dtype]:
            x, w, b = layer_inputs(rng, batch, g.in_h, g.in_w, g.c_in,
                                   g.c_out, g.kernel, dtype)
            check_dense(label, x, w, b, g.stride, g.padding, t, act, dense)
    # B2: random int8 data on the synthetic cases, scaled so that the
    # epilogue lands on O(1) values and requant rounds at every step;
    # the generator layers get their real inputs and calibrated scales
    for label, g, batch, t, act in cases[torch.int8]:
        if label.split(" ")[0] in {c.name for c in TOWERS}:
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
    for cfg in TOWERS:
        for batch in (1, 64):
            for i, (x, lq, out_scale) in enumerate(
                    int8_layer_inputs(cfg, int8_nets[cfg.name], batch, rng)):
                g, l = cfg.geometries()[i], cfg.layers[i]
                t = hopper_tiles(g, batch, "int8")
                check_int8(f"{cfg.name} l{i} bucket {batch} {t.as_kwargs()}",
                           x, lq["w_q"], lq["scale"], lq["b"], g.stride,
                           g.padding, t, l.activation, out_scale, int8)
    skipped = 0
    for dtype in (torch.float32, torch.bfloat16):
        for label, g, batch, t, act in cases[dtype]:
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


@contextlib.contextmanager
def profiled():
    """torch.profiler over CPU and CUDA activity, entered after a throwaway
    session and fenced at each end.  On the H100 the first session after
    a stretch of unprofiled work can lose device events at its edges,
    more often the older the process, and a session that follows a
    throwaway one does not (`tools/probe_profiler.py` measures both); a
    little device work and a pause after the session starts and before it
    stops keep the caller's work off its edges.  The caller zeroes its
    counts inside."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def fence(pause_s):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(pause_s)

    with profile(activities=activities):
        fence(0.0)
    with profile(activities=activities) as prof:
        fence(0.02)
        yield prof
        fence(0.05)


def traced_launches(prof):
    """Per kernel instance, its device launches in a profiler trace, and
    the trace's device kernels in all."""
    device = [e.name for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return ({k: sum(kernel_of(n) == k for n in device) for k in TRACE_NAMES},
            len(device))


class TraceLoss(AssertionError):
    """A launch check failed only because the trace holds fewer of the
    path's launches than ran: every count the run read agrees and no other
    kernel is traced.  The profiler drops device records now and then, as
    it did under the engine before the mesh (PERF.md §7)."""


def failure(traced, want, exact):
    """The exception for a failed launch check: `TraceLoss` when ``exact``
    (the counts the run read agree with ``want``, the path's kernel
    instances -> launches) and the trace holds fewer of them and nothing
    else; AssertionError otherwise."""
    lost = (exact and not any(v for k, v in traced.items() if k not in want)
            and all(traced[k] <= v for k, v in want.items())
            and any(traced[k] < v for k, v in want.items()))
    return TraceLoss if lost else AssertionError


def once_more_on_trace_loss(label, phase, *args):
    """``phase(*args)``, run once more from scratch (new engines or
    trainers, the same seeds) if a launch check met the profiler's record
    loss; every check holds in that run, and a second loss fails."""
    try:
        return phase(*args)
    except TraceLoss as e:
        print(f"  {label}: the profiler dropped device records ({e}); the "
              "phase runs once more from scratch", flush=True)
        return phase(*args)


def zero_launch_counts():
    for _, mod, _ in KERNELS:
        mod.LAUNCHES = 0


def launch_counts():
    return {k: mod.LAUNCHES for k, mod, _ in KERNELS}


def drive(engines, requests):
    """The main path of one kind of engine, per net under torch.profiler
    with every count at 0 just before (the engines' ``launch_counts`` and
    the wrappers' ``LAUNCHES``): the net's requests submitted and
    collected, the counts read just after.  Returns (outputs, per net: the
    device launches of each kernel in the trace, the engine's
    ``launch_counts`` and the wrappers' counts)."""
    outputs, per_net = {}, {}
    for name, eng in engines.items():
        torch.cuda.synchronize()
        with profiled() as prof:
            zero_launch_counts()
            eng.launch_counts.clear()
            tickets = [eng.submit(z) for z in requests[name]]
            outputs[name] = [eng.collect(t) for t in tickets]
            torch.cuda.synchronize()
            engine = sum(eng.launch_counts.values())
            wrappers = launch_counts()
        per_net[name] = {"traced": traced_launches(prof)[0],
                         "engine": engine, "wrappers": wrappers}
    return outputs, per_net


def check_launches(path, engines, per_net):
    """Per tower: the traced device launches of the path's kernel instance
    == layers x dispatches and none of the others; the engine's
    ``launch_counts`` the same; no wrapper launched anything (every
    dispatch a replay); one executable per bucket.  Returns the traced
    launches of the path's kernel over its towers."""
    want_k = PATHS[path][0]
    for name, eng in engines.items():
        dispatches = len(eng.plan_chunks(sum(REQUEST_SIZES)))
        want = len(eng.cfg.layers) * dispatches
        got = per_net[name]
        traced = {"/".join(k): v for k, v in got["traced"].items()}
        print(f"  {name} {path}: {dispatches} dispatches x "
              f"{len(eng.cfg.layers)} layers; traced device launches "
              f"{traced}, engine launch_counts {got['engine']}, wrapper "
              f"launches {got['wrappers']}, capture_counts "
              f"{eng.capture_counts}", flush=True)
        exact = got["engine"] == want and not any(got["wrappers"].values())
        if (got["traced"][want_k] != want or not exact
                or any(v for k, v in got["traced"].items() if k != want_k)):
            raise failure(got["traced"], {want_k: want}, exact)(
                f"{path} {name}: launches {got}, expected {want} of "
                f"{want_k} traced and counted, none of the others and none "
                "through the wrappers")
        if eng.capture_counts != {b: 1 for b in eng.buckets}:
            raise AssertionError(f"{name}: capture_counts "
                                 f"{eng.capture_counts}, expected 1 per "
                                 "bucket")
    return sum(per_net[name]["traced"][want_k] for name in engines)


def eager_images(path, eng, z):
    """``z`` (one bucket of rows) through the public ops at the bucket's
    plan, eagerly, every operand prepared per call (int8: from the
    reference-layout weights, packed per launch), as float32."""
    plan = eng.plans[z.shape[0]]
    with torch.no_grad():
        if path == "int8":
            qp = {k: {n: v[n] for n in ("w_q", "scale", "b")}
                  for k, v in eng.params.items()}
            y = quantized_generator_apply(qp, eng.cfg, None, z, plan=plan)
        else:
            y = generator_apply(eng.params, eng.cfg, z, plan=plan)
    return y.float().cpu().numpy()


def check_replay_equals_eager(path, by_net):
    """Every bucket's replayed images bit-identical to an eager run of the
    same plan on the same rows."""
    rng = np.random.default_rng(5)
    for name, eng in by_net.items():
        for b in eng.buckets:
            z = tower_inputs(eng.cfg, b, rng)
            got = eng.generate(z)
            want = eager_images(path, eng, torch.from_numpy(z).cuda())
            if not np.array_equal(got, want):
                raise AssertionError(
                    f"{path} {name} bucket {b}: replayed images differ from "
                    f"eager ones by {np.abs(got - want).max()}")
        print(f"  {name} {path}: replayed images bit-identical to eager at "
              f"buckets {list(eng.buckets)}", flush=True)


def kernel_of(trace_name):
    """Which kernel instance, ``(kernel, dtype)``, a traced device kernel
    is, or None."""
    name = demangle(trace_name) if trace_name.startswith("_Z") else trace_name
    for k, pat in TRACE_NAMES.items():
        if re.search(pat, name):
            return k
    return None


def check_images(name, outputs, refs, tol):
    """Every request's images finite, of the right shape and within ``tol``
    of each reference; returns the largest error per reference."""
    ofs = 0
    for n, img in zip(REQUEST_SIZES, outputs):
        if img.shape[0] != n or img.dtype != np.float32 \
                or not np.isfinite(img).all():
            raise AssertionError(f"{name}: bad output {img.shape} "
                                 f"{img.dtype}")
        for be, ref in refs.items():
            err = float(np.abs(img - ref[ofs:ofs + n]).max())
            if err > tol:
                raise AssertionError(f"{name} request of {n}: {err} from {be}")
        ofs += n
    return {be: float(np.abs(np.concatenate(outputs) - ref).max())
            for be, ref in refs.items()}


def phase_serving():
    """Every path's towers through the engine (`PATHS`); returns (engines
    per path, traced launches per path and kernel)."""
    rng = np.random.default_rng(1)
    requests = {cfg.name: [tower_inputs(cfg, n, rng) for n in REQUEST_SIZES]
                for cfg in TOWERS}
    params = {cfg.name: generator_init(torch.Generator().manual_seed(0), cfg,
                                       "cuda") for cfg in TOWERS}
    pruned = {n: prune_tree(p, SERVE_SPARSITY) for n, p in params.items()}
    engines, launches, images = {}, {}, {}
    for path, (kernel, kw, towers, prune_params) in PATHS.items():
        print(f"  path {path}", flush=True)
        tree = pruned if prune_params else params
        engines[path] = {cfg.name: DcnnServeEngine.from_config(
            EngineConfig(model=cfg, max_batch=64, warmup=True, **kw),
            tree[cfg.name]) for cfg in towers}
        outputs, per_net = drive(engines[path],
                                 {c.name: requests[c.name] for c in towers})
        launches[path] = {kernel: check_launches(path, engines[path],
                                                 per_net)}
        check_replay_equals_eager(path, engines[path])
        bf16 = path.startswith("bf16")
        for cfg in towers:
            eng = engines[path][cfg.name]
            z = torch.from_numpy(np.concatenate(requests[cfg.name])).cuda()
            imgs = np.concatenate(outputs[cfg.name])
            images[path, cfg.name] = imgs
            if path == "int8":
                # the engine packed every layer's weight once, on the card
                if not all(isinstance(eng.params[f"l{i}"]["static"].w,
                                      int8_kernel.PackedInt8Weights)
                           and eng.params[f"l{i}"]["static"].w.device.type
                           == "cuda" for i in range(len(cfg.layers))):
                    raise AssertionError(f"{cfg.name}: int8 weights not packed")
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
                        .float().cpu().numpy()
                        for be in ("reverse_loop", "cudnn")}
            tol = BF16_SERVE_TOL if bf16 else SERVE_TOL
            errs = check_images(cfg.name, outputs[cfg.name], refs, tol)
            extra = ""
            if bf16:
                if not np.array_equal(imgs, torch.from_numpy(imgs).to(
                        torch.bfloat16).float().numpy()):
                    raise AssertionError(f"{cfg.name} {path}: images are not "
                                         "bf16 values")
                same = "cuda_sparse" if path == "bf16_sparse" else "fp32"
                fp32 = images[same, cfg.name]
                extra = (f"; vs the fp32 images of the same params (path "
                         f"{same}): largest pixel error "
                         f"{float(np.abs(imgs - fp32).max()):.4f}")
            print(f"  {cfg.name} {path}: max |kernel - ref| {errs} "
                  f"(tol {tol}){extra}", flush=True)
            if "sparse" in path:
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


def time_row(kernel, cfg, i, batch, tiles, launch, plain, library, ops, peak,
             nbytes, mem_bw, smi, **extra):
    """One layer's row: device and per-call time of ``launch``, the plain
    version's and the library call's (None: there is none), and the
    bound: the larger of ``ops`` at ``peak`` and ``nbytes`` at
    ``mem_bw``."""
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


def phase_bit_identity(int8_nets):
    """B1, B2 and B3 (B1 and B3 in fp32 and bf16) launched twice on the
    same inputs at every tower's layers at bucket 1 (where the grid splits
    the CI reduction over clusters) must agree bit for bit; B2 on the
    layer's real int8 input."""
    rng = np.random.default_rng(4)
    for cfg in TOWERS:
        q_inputs = int8_layer_inputs(cfg, int8_nets[cfg.name], 1, rng)
        for i, (g, l) in enumerate(zip(cfg.geometries(), cfg.layers)):
            t = hopper_tiles(g, 1)
            x, w, b = layer_inputs(rng, 1, g.in_h, g.in_w, g.c_in, g.c_out,
                                   g.kernel, torch.float32)
            wq = prune(w, SERVE_SPARSITY)
            sched = schedule_tensors(make_sparse_plan(wq, g.stride, g.padding,
                                                      t.t_ci, t.t_co), "cuda")
            dense = launch_args(x, w, b, g.stride, g.padding,
                                *t.as_kwargs().values(), l.activation)
            sparse = launch_args(x, wq, b, g.stride, g.padding,
                                 *t.as_kwargs().values(), l.activation)
            bf, tb = torch.bfloat16, hopper_tiles(g, 1, torch.bfloat16)
            dense_bf = launch_args(x.to(bf), w.to(bf), b.to(bf), g.stride,
                                   g.padding, *tb.as_kwargs().values(),
                                   l.activation)
            sparse_bf = launch_args(x.to(bf), wq.to(bf), b.to(bf), g.stride,
                                    g.padding, *tb.as_kwargs().values(),
                                    l.activation)
            sched_bf = schedule_tensors(make_sparse_plan(
                wq.to(bf), g.stride, g.padding, tb.t_ci, tb.t_co), "cuda")
            xq, lq, out_scale = q_inputs[i]
            t8 = hopper_tiles(g, 1, "int8")
            qa = int8_kernel.launch_args_int8(
                xq, lq["w_q"], lq["scale"], lq["b"], g.stride, g.padding,
                *t8.as_kwargs().values(), l.activation, out_scale)
            runs = {
                "B1": lambda: deconv_kernel.deconv2d_launch(*dense[:3],
                                                            **dense[3]),
                "B2": lambda: int8_kernel.deconv2d_int8_launch(*qa[:4],
                                                               **qa[4]),
                "B3": lambda: sparse_kernel.deconv2d_sparse_launch(
                    *sparse[:3], *sched, **sparse[3]),
                "B1 bf16": lambda: deconv_kernel.deconv2d_launch(
                    *dense_bf[:3], **dense_bf[3]),
                "B3 bf16": lambda: sparse_kernel.deconv2d_sparse_launch(
                    *sparse_bf[:3], *sched_bf, **sparse_bf[3])}
            for name, fn in runs.items():
                y0 = fn()
                y1 = fn()
                torch.cuda.synchronize()
                if not torch.equal(y0, y1):
                    raise AssertionError(f"{name} {cfg.name} l{i} bucket 1: two "
                                         "launches on the same inputs differ")
            print(f"  B1, B3 {cfg.name} l{i} bucket 1 {t.as_kwargs()} split "
                  f"{split_of(dense)}; bf16 {tb.as_kwargs()} split "
                  f"{split_of(dense_bf)}; B2 {t8.as_kwargs()} split "
                  f"{int8_kernel.launch_split_int8(qa[0], qa[1], qa[4])}: "
                  "repeated launches bit-identical", flush=True)


def split_of(args):
    """The fp32 or bf16 kernel's cluster split for ``launch_args`` output."""
    xp, wp, _, kw, _ = args
    return deconv_kernel.launch_split(
        xp.shape[0], xp.shape[3], wp.shape[3], kw["ohp"], kw["owp"],
        kw["t_oh"], kw["t_ow"], kw["t_ci"], kw["t_co"], kw["t_n"])


def kernel_instance(report, template, tiles, stride, flag):
    """(name, registers, spill bytes) from ``ptxas`` of the instance of
    ``template`` (its first argument ``flag``: kRequant or kSparse) that a
    launch at ``tiles`` runs; registers and spills None where the report
    lacks it."""
    pix = tiles.t_n * (tiles.t_oh // stride) * (tiles.t_ow // stride)
    wm, wn = tc_warp_tile(pix, tiles.t_co)
    want = f"{template}<{'true' if flag else 'false'}, {wm}, {wn}>"
    for r in report.get("deconv2d_tc", []):
        if want in demangle(r["kernel"]):
            return want, r["registers"], r["spill_stores"] + r["spill_loads"]
    return want, None, None


def phase_times(smi, peaks, int8_nets, report):
    rng = np.random.default_rng(2)
    rows = []
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # B1 and B3 compute 3xTF32: three tensor-core products per product
    tf32x3 = peaks["tf32"] / 3
    for cfg in TOWERS:
        for i, (g, l) in enumerate(zip(cfg.geometries(), cfg.layers)):
            for batch in (1, 64):
                t = hopper_tiles(g, batch)
                t8 = hopper_tiles(g, batch, "int8")
                n_out = batch * g.out_h * g.out_w * g.c_out
                n_in = batch * g.in_h * g.in_w * g.c_in
                n_w = g.kernel ** 2 * g.c_in * g.c_out
                ops = 2 * g.output_macs * batch
                # B1: fp32, every product that lands in the output
                x, w, b = layer_inputs(rng, batch, g.in_h, g.in_w, g.c_in,
                                       g.c_out, g.kernel, torch.float32)
                dense = launch_args(x, w, b, g.stride, g.padding,
                                    *t.as_kwargs().values(), l.activation)
                xp, wp, bp, kw, _ = dense
                x_nchw = x.permute(0, 3, 1, 2).contiguous()
                nbytes = 4 * (n_in + n_w + g.c_out + n_out)
                rows.append(time_row(
                    "deconv2d_kernel", cfg, i, batch, t,
                    lambda: deconv_kernel.deconv2d_launch(xp, wp, bp, **kw),
                    lambda: deconv_kernel.deconv2d_launch_plain(xp, wp, bp,
                                                                **kw),
                    lambda: F.conv_transpose2d(
                        x_nchw, w.permute(2, 3, 0, 1).contiguous(), b,
                        stride=g.stride, padding=g.padding),
                    ops, tf32x3, nbytes, peaks["bw"], smi,
                    split=split_of(dense), dtype="float32",
                    bound_fp32_fma_ms=max(ops / peaks["fp32"],
                                          nbytes / peaks["bw"]) * 1e3))
                # B2: int8 in and weights, f32 scale and bias, int8 out (f32
                # on the last layer); no PyTorch call computes this
                xq, lq, out_scale = int8_layer_inputs(
                    cfg, int8_nets[cfg.name], batch, rng)[i]
                qa = int8_kernel.launch_args_int8(
                    xq, lq["w_q"], lq["scale"], lq["b"], g.stride, g.padding,
                    *t8.as_kwargs().values(), l.activation, out_scale)
                split8 = int8_kernel.launch_split_int8(qa[0], qa[1], qa[4])
                w_ref = int8_kernel.unpack_int8_weights(qa[1])
                inst, regs, spill = kernel_instance(
                    report, "deconv2d_tc_int8_kernel", t8, g.stride,
                    out_scale is not None)
                rows.append(time_row(
                    "deconv2d_int8_kernel", cfg, i, batch, t8,
                    lambda: int8_kernel.deconv2d_int8_launch(*qa[:4], **qa[4]),
                    lambda: int8_kernel.deconv2d_int8_launch_plain(
                        qa[0], w_ref, *qa[2:4], split=split8, **qa[4]),
                    None, ops, peaks["int8"],
                    n_in + n_w + 8 * g.c_out
                    + n_out * (1 if out_scale is not None else 4),
                    peaks["bw"], smi, split=split8, dtype="int8", instance=inst,
                    registers=regs, spill_bytes=spill,
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
                kept_bytes = 4 * (n_in + kept_w + g.c_out + n_out)
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
                    2 * macs * batch, tf32x3, kept_bytes, peaks["bw"], smi,
                    split=split_of(sp), dtype="float32",
                    bound_fp32_fma_ms=max(2 * macs * batch / peaks["fp32"],
                                          kept_bytes / peaks["bw"]) * 1e3,
                    sparsity=SERVE_SPARSITY, slabs_skipped=f"{skipped}/{slabs}",
                    kept_mac_share=macs / g.output_macs))
                if cfg in NETS:
                    rows += bf16_rows(cfg, i, g, l, batch, x, w, b, smi,
                                      peaks, report)
    return rows


def bf16_rows(cfg, i, g, l, batch, x, w, b, smi, peaks, report):
    """B1 and B3 in bf16 on the tensor cores at one generator layer and
    bucket (``x``, ``w``, ``b``: the fp32 rows' inputs, cast), beside cuDNN
    in bf16.  The bound: 2 bytes per element, and the operations at the
    card's bf16 tensor-core peak."""
    bf = torch.bfloat16
    t = hopper_tiles(g, batch, bf)
    xb, wb, bb = x.to(bf), w.to(bf), b.to(bf)
    n_out = batch * g.out_h * g.out_w * g.c_out
    n_in = batch * g.in_h * g.in_w * g.c_in
    xb_nchw = xb.permute(0, 3, 1, 2).contiguous()
    dense = launch_args(xb, wb, bb, g.stride, g.padding,
                        *t.as_kwargs().values(), l.activation)
    xp, wp, bp, kw, _ = dense
    split = split_of(dense)
    ops = 2 * g.output_macs * batch
    nbytes = 2 * (n_in + g.kernel ** 2 * g.c_in * g.c_out + g.c_out + n_out)
    inst, regs, spill = kernel_instance(report, "deconv2d_tc_bf16_kernel", t,
                                        g.stride, False)
    rows = [time_row(
        "deconv2d_kernel", cfg, i, batch, t,
        lambda: deconv_kernel.deconv2d_launch(xp, wp, bp, **kw),
        lambda: deconv_kernel.deconv2d_launch_plain(xp, wp, bp, split=split,
                                                    **kw),
        lambda: F.conv_transpose2d(xb_nchw, wb.permute(2, 3, 0, 1)
                                   .contiguous(), bb, stride=g.stride,
                                   padding=g.padding),
        ops, peaks["bf16"], nbytes, peaks["bw"], smi, dtype="bfloat16",
        kernel_file="csrc/deconv2d_tc.cu", split=split, instance=inst,
        registers=regs, spill_bytes=spill)]
    wq = prune(w, SERVE_SPARSITY).to(bf)
    tables = make_sparse_plan(wq, g.stride, g.padding, t.t_ci, t.t_co)
    sched = schedule_tensors(tables, "cuda")
    macs, kept_w = kept_work(g, tables, t.t_ci, t.t_co)
    sp = launch_args(xb, wq, bb, g.stride, g.padding,
                     *t.as_kwargs().values(), l.activation)
    wq_lib = wq.permute(2, 3, 0, 1).contiguous()
    skipped, slabs, _, _ = schedule_stats(tables, sp[1].shape[2] // t.t_ci,
                                          g.kernel)
    inst, regs, spill = kernel_instance(report, "deconv2d_tc_bf16_kernel", t,
                                        g.stride, True)
    rows.append(time_row(
        "deconv2d_sparse_kernel", cfg, i, batch, t,
        lambda: sparse_kernel.deconv2d_sparse_launch(*sp[:3], *sched,
                                                     **sp[3]),
        lambda: sparse_kernel.deconv2d_sparse_launch_plain(
            *sp[:3], *sched, split=split, **sp[3]),
        lambda: F.conv_transpose2d(xb_nchw, wq_lib, bb, stride=g.stride,
                                   padding=g.padding),
        2 * macs * batch, peaks["bf16"],
        2 * (n_in + kept_w + g.c_out + n_out), peaks["bw"], smi,
        dtype="bfloat16", kernel_file="csrc/deconv2d_tc.cu", split=split,
        instance=inst, registers=regs, spill_bytes=spill,
        sparsity=SERVE_SPARSITY, slabs_skipped=f"{skipped}/{slabs}",
        kept_mac_share=macs / g.output_macs))
    return rows


def phase_end_to_end(engines, smi):
    """Per path and net, 30 bucket-64 dispatches (the stats of the checks
    before, a profiled one among them, cleared first): images/s and CV
    from the engine, then the dispatch split."""
    rng = np.random.default_rng(3)
    out = {}
    for path, by_net in engines.items():
        for name, eng in by_net.items():
            z = tower_inputs(eng.cfg, 64, rng)
            eng.bucket_stats.clear()
            for _ in range(30):
                eng.generate(z)
            tp = eng.throughput()[64]
            out[path, name] = {"bucket": 64, "img_per_s": tp["img_per_s"],
                               "mean_ms": tp["mean_s"] * 1e3, "cv": tp["cv"],
                               "calls": tp["calls"], "card": smi}
            print(json.dumps({"end_to_end": out[path, name], "net": name,
                              "path": path}), flush=True)
            print(json.dumps({"dispatch_split": dispatch_split(eng, z, smi),
                              "net": name, "path": path}), flush=True)
    return out


def dispatch_split(eng, z, smi):
    """A bucket-64 dispatch in parts, medians of SPLIT_RUNS: on the device
    (CUDA events) the host-to-device copy of z, the replay and the
    device-to-host copy of the images; on the host clock staging z,
    enqueueing (the images' pinned tensor allocated), waiting for the
    stream and handing the images out; and the engine's mean dispatch
    (``host_ms``: that mean less the three device parts)."""
    ex = eng._get_fn(64)
    shard, = ex.shards
    ex.stage(z)
    pinned = torch.empty(shard.out_dev.shape, dtype=shard.out_dev.dtype,
                         pin_memory=True)
    parts = {"h2d_ms": [], "replay_ms": [], "d2h_ms": []}
    for _ in range(SPLIT_RUNS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        ev[0].record()
        shard.z_dev.copy_(shard.z_host, non_blocking=True)
        ev[1].record()
        shard.replay()
        ev[2].record()
        pinned.copy_(shard.out_dev, non_blocking=True)
        ev[3].record()
        torch.cuda.synchronize()
        for i, k in enumerate(parts):
            parts[k].append(ev[i].elapsed_time(ev[i + 1]))
    row = {k: statistics.median(v) for k, v in parts.items()}
    # the host clock of the dispatch's own steps, as `ShardedExecutable`
    # takes them: staging z, enqueueing the copies and the replay, waiting
    # for the stream, handing the images out (each result dropped before
    # the next dispatch, as in the end-to-end runs)
    host = {"stage_ms": [], "enqueue_ms": [], "wait_ms": [],
            "images_ms": []}
    for _ in range(SPLIT_RUNS):
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        ex.stage(z)
        t.append(time.perf_counter())
        got = ex.enqueue(64)
        t.append(time.perf_counter())
        ex.wait()
        t.append(time.perf_counter())
        out = ex.images(got, 64)
        t.append(time.perf_counter())
        del out, got
        for i, k in enumerate(host):
            host[k].append((t[i + 1] - t[i]) * 1e3)
    row.update({k: statistics.median(v) for k, v in host.items()})
    tp = eng.throughput()[64]
    row["dispatch_ms"] = tp["mean_s"] * 1e3
    row["host_ms"] = row["dispatch_ms"] - sum(
        row[k] for k in ("h2d_ms", "replay_ms", "d2h_ms"))
    row.update(bucket=64, runs=SPLIT_RUNS, card=smi)
    return row


def fills(g, batch, t):
    """Whether tiles ``t`` give a grid that, split included, fills the
    card's SMs (the model's preference)."""
    blocks = grid_blocks(g, batch, t["t_oh"], t["t_co"], t["t_n"])
    return blocks * autotune.ci_split(blocks, -(-g.c_in // t["t_ci"])) >= SMS


def phase_refine(smi):
    """fp32 engines with refine=True at REFINE_BUCKETS, per net: each
    layer's model pick and timed pick with their times (from the tile
    cache the tuning wrote), and the engine's images against reverse_loop
    (the timed tiles must serve the same function).  The entries' model
    picks must be the tiles of plans that ignore the cache."""
    from repro_torch.plan import build_network_plan

    rng = np.random.default_rng(6)
    for cfg in NETS:
        params = generator_init(torch.Generator().manual_seed(0), cfg, "cuda")
        t0 = time.perf_counter()
        eng = DcnnServeEngine.from_config(
            EngineConfig(model=cfg, buckets=REFINE_BUCKETS, warmup=True,
                         refine=True), params)
        tuned_s = time.perf_counter() - t0
        for b in REFINE_BUCKETS:
            model = build_network_plan(cfg, batch=b, autotune=False)
            for i, l in enumerate(eng.plans[b].layers):
                g = l.geometry
                e = autotune.cached_entry(g, "float32", "cuda", b)
                if e is None or l.tiles.source not in ("timed", "cache"):
                    raise AssertionError(f"{cfg.name} l{i} bucket {b}: no "
                                         "timed entry after refine")
                if e["model"] != model.layers[i].tiles.as_kwargs():
                    raise AssertionError(f"{cfg.name} l{i} bucket {b}: the "
                                         "entry's model pick is not the "
                                         "model's plan")
                timed = {k: e[k] for k in ("t_oh", "t_ow", "t_ci", "t_co",
                                           "t_n")}
                row = {"net": cfg.name, "layer": i, "bucket": b,
                       "model": e["model"], "model_ms": e["model_ms"],
                       "model_fills": fills(g, b, e["model"]),
                       "timed": timed, "timed_ms": e["ms"],
                       "timed_fills": fills(g, b, timed),
                       "candidates": e["timed"], "card": smi}
                print(json.dumps({"refine": row}), flush=True)
            z = rng.standard_normal((b, cfg.z_dim)).astype(np.float32)
            got = eng.generate(z)
            with torch.no_grad():
                want = generator_apply(eng.params, cfg,
                                       torch.from_numpy(z).cuda(),
                                       backend="reverse_loop").cpu().numpy()
            err = float(np.abs(got - want).max())
            if err > SERVE_TOL:
                raise AssertionError(f"{cfg.name} refined bucket {b}: {err} "
                                     "from reverse_loop")
        print(f"  {cfg.name}: refine engine built in {tuned_s:.1f} s, "
              f"images within {SERVE_TOL} of reverse_loop", flush=True)


def take(fe, z, req, rid):
    """A served request's record ``(z, precision, downgraded, rid,
    images)``: its images in a copy of their own, and no reference to the
    request kept (it holds the pinned result), so the pinned memory goes
    back to the engine's budget at once.  A request unresolved after
    FRONTEND_WAIT_S raises `DeadlineExceeded` (a hang)."""
    img = fe.result(rid, timeout_s=FRONTEND_WAIT_S).copy()
    return z, req.precision, req.downgraded, rid, img


def collector(fe, tickets, served, late, errors):
    """A client's collecting thread: each admitted request's record
    (`take`), or its rid in ``late`` when the scheduler shed it before
    dispatch because it could no longer meet its deadline (stage
    ``late``).  Anything else goes into ``errors``: a hang
    (`DeadlineExceeded`), a failed dispatch (`EngineDegraded`, or a shed
    after a requeue) or any other error.  No fault is injected during the
    sweep, so each of them fails the phase."""
    while True:
        item = tickets.get()
        if item is None:
            return
        z, req, rid = item
        try:
            served.append(take(fe, z, req, rid))
        except AdmissionRejected as e:
            if e.stage == "late":
                late.append(rid)
            else:
                errors.append(f"request {rid}: {e!r} (stage {e.stage})")
        except BaseException as e:
            errors.append(f"request {rid}: {e!r}")


def check_resolved(fe, load, admitted, served, late):
    """Every admitted request of a load ended served or shed late: the
    frontend's worker hit no error, nothing was requeued or shed after a
    failed dispatch, and its per-tenant counts match what the client
    collected."""
    st = fe.stats()["tenants"]
    tot = {k: sum(t[k] for t in st.values())
           for k in ("admitted", "completed", "shed_late", "requeued",
                     "shed_requeue")}
    if (fe._worker_errors or tot["requeued"] or tot["shed_requeue"]
            or tot["admitted"] != admitted
            or len(served) + len(late) != admitted
            or tot["completed"] != len(served)
            or tot["shed_late"] != len(late)):
        raise AssertionError(
            f"load {load}: {admitted} admitted, {len(served)} served, "
            f"{len(late)} shed late; frontend counts {tot}; worker errors "
            f"{fe._worker_errors[:3]}")


def frontend_traffic(fe, cfg, loads, rng, smi, tracer):
    """The offered-load sweep: per load ``FRONTEND_REQUESTS`` requests of
    1..64 rows, paced on an absolute schedule at ``load`` x the primed
    fp32 capacity (rows/s of a bucket-64 dispatch), alternating gold
    (priority 0, SLO max(50 ms, 20 x the bucket-64 service)) and std (no
    deadline), collected by a `collector` thread as they resolve.  Every
    admitted request resolves within FRONTEND_WAIT_S, to images or a shed
    before dispatch (`check_resolved`); any other outcome fails the
    phase.  Each load runs inside a profiler range ``frontend_load
    {load}``.  Returns (per load: its stats row, the served requests' records
    (`take`), the tracer's events of the load)."""
    service_s = fe._model.estimate("fp32", 64)
    cap_rows = 64 / service_s
    slo_ms = max(50.0, 20.0 * service_s * 1e3)
    out = []
    for load in loads:
        fe.reset_stats()
        n0 = len(tracer)
        sizes = rng.integers(1, 65, size=FRONTEND_REQUESTS)
        interval = sizes.mean() / (load * cap_rows)
        tickets, served, late, errors = queue.Queue(), [], [], []
        coll = threading.Thread(target=collector,
                                args=(fe, tickets, served, late, errors))
        coll.start()
        admitted, rejected = 0, {"gold": 0, "std": 0}
        # marks the load on the profiler's clock (`load_split`)
        with torch.profiler.record_function(f"frontend_load {load}"):
            t0 = time.perf_counter()
            for i, n in enumerate(sizes):
                target = t0 + i * interval
                while time.perf_counter() < target:
                    time.sleep(max(0.0, min(target - time.perf_counter(),
                                            0.001)))
                z = tower_inputs(cfg, int(n), rng)
                tenant = "gold" if i % 2 == 0 else "std"
                try:
                    rid = fe.submit(z, tenant, slo_ms=(
                        slo_ms if tenant == "gold" else None))
                except AdmissionRejected:
                    rejected[tenant] += 1
                    continue
                admitted += 1
                tickets.put((z, fe._requests[rid], rid))
            tickets.put(None)
            coll.join(timeout=FRONTEND_WAIT_S * (admitted + 1))
            wall = time.perf_counter() - t0
        if coll.is_alive() or errors:
            raise AssertionError(f"load {load}: requests unresolved or "
                                 f"failed {errors[:5]}")
        check_resolved(fe, load, admitted, served, late)
        st = fe.stats()
        row = {"load": load, "wall_s": wall,
               "offered_rows_per_s": load * cap_rows,
               "capacity_rows_per_s": cap_rows,
               "service_b64_ms": service_s * 1e3, "gold_slo_ms": slo_ms,
               "requests": len(sizes), "admitted": admitted,
               "rejected_at_submit": rejected,
               "served_rows_per_s": sum(len(r[0]) for r in served) / wall,
               "tenants": st["tenants"], "card": smi}
        out.append((row, served, tracer.events()[n0:]))
    return out


def span_stats(events):
    """Median durations (ms) of the spans that split a request's time on
    the host clock: its queue wait, the frontend's wave dispatch, the
    engine's generate and its bucket dispatches (per precision, and at
    bucket 64), and collecting the result."""
    by = {}
    for e in events:
        if e["ph"] != "X":
            continue
        names = [e["name"]]
        if e["name"].startswith("dispatch b"):
            names = [f"dispatch_{e['args']['precision']}"]
            if e["args"]["bucket"] == 64:
                names.append(names[0] + "_b64")
        for name in names:
            by.setdefault(name, []).append(e["dur"] / 1e3)
    return {f"{k}_p50_ms": statistics.median(v) for k, v in sorted(by.items())
            if k in ("queue_wait", "wave_dispatch", "generate", "collect")
            or k.startswith("dispatch_")}


def device_split(events, wall_s):
    """From a trace's device events: per precision the median device span
    of one dispatch (its host-to-device copy's start to its device-to-host
    copy's end, the replay between) and the device's busy share of the
    traced run's wall clock ``wall_s`` (the union of its events)."""
    dev = device_events(events)
    spans, group = {}, None
    for e in dev:
        if "HtoD" in e.name:
            group = [e]
        elif group is not None:
            group.append(e)
            if "DtoH" in e.name:
                kinds = {kernel_of(x.name) for x in group} - {None}
                if len(kinds) == 1:
                    (k,) = kinds
                    spans.setdefault(k[1], []).append(
                        (e.time_range.end - group[0].time_range.start) / 1e3)
                group = None
    return {**{f"replay_device_{k}_p50_ms": statistics.median(v)
               for k, v in sorted(spans.items())},
            "device_busy_share": busy_us(dev) / 1e6 / wall_s}


def device_events(trace):
    """A trace's device activity (kernels, copies, memsets) in start
    order, without the device-side copies of the ``frontend_load`` and
    ``train_step`` ranges."""
    return sorted((e for e in trace
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and not e.name.startswith(("frontend_load", "train_step"))),
                  key=lambda e: e.time_range.start)


def busy_us(dev, lo=None, hi=None):
    """The union (us) of device events' time ranges, clipped to
    [lo, hi] on the profiler's clock."""
    busy, end = 0.0, None
    for e in dev:
        a, b = e.time_range.start, e.time_range.end
        if lo is not None:
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def load_split(trace, row, spans):
    """One load's split of the worker's time: waves dispatched and how
    full they were (rows per wave; the share of the dispatched bucket
    rows that were padding), the worker's busy share (its wave dispatches
    over the load's wall clock, host clock) and the device's busy share
    inside the load's profiler range ``frontend_load {load}``."""
    marks = [e for e in trace if e.name == f"frontend_load {row['load']}"
             and e.device_type == torch.autograd.DeviceType.CPU]
    if len(marks) != 1:
        raise AssertionError(f"load {row['load']}: {len(marks)} profiler "
                             "ranges for the load")
    lo, hi = marks[0].time_range.start, marks[0].time_range.end
    dev = device_events(trace)
    waves = [e for e in spans if e["ph"] == "X"
             and e["name"] == "wave_dispatch"]
    buckets = [e["args"]["bucket"] for e in spans if e["ph"] == "X"
               and e["name"].startswith("dispatch b")]
    rows = sum(e["args"]["rows"] for e in waves)
    return {"waves": len(waves),
            "rows_per_wave_mean": rows / max(1, len(waves)),
            "padding_share": 1.0 - rows / max(1, sum(buckets)),
            "worker_busy_share": sum(e["dur"] for e in waves) / 1e6
            / row["wall_s"],
            "device_busy_share": busy_us(dev, lo, hi) / (hi - lo)}


def degrade_drill(fe, cfg, rng, slo_ms):
    """Gold requests while fp32 is predicted past the gold SLO (its
    estimates pinned at 1 s, as the JAX package's frontend tests pin
    decisions with `ServiceModel.override`): the scheduler serves each on
    the int8 engine, tagged downgraded.  One request at a time, so no
    backlog stands against the SLO.  The primed estimates are put back
    after.  Returns the served requests."""
    saved = {b: fe._model.estimate("fp32", b) for b in fe._buckets}
    for b in fe._buckets:
        fe._model.override("fp32", b, 1.0)
    try:
        served = []
        for _ in range(DEGRADE_REQUESTS):
            z = tower_inputs(cfg, int(rng.integers(1, 65)), rng)
            rid = fe.submit(z, "gold", slo_ms=slo_ms)
            served.append(take(fe, z, fe._requests[rid], rid))
    finally:
        for b, v in saved.items():
            fe._model.override("fp32", b, v)
    if not all(down and prec == "int8" for _, prec, down, _, _ in served):
        raise AssertionError("degrade drill: gold requests not downgraded "
                             f"to int8: {[r[1] for r in served]}")
    return served


def fault_drill(fe, inj, cfg, rng):
    """One TransientFailure, then one SlowCall, on the fp32 engine, each on
    a 64-row request alone in its wave (one bucket-64 dispatch): the first
    retries (a tainted dispatch, out of the CV), the second outlasts the
    heartbeat and 3x the bucket's EMA.  The counters are checked by what
    each fault alone moved, and the straggler monitor must have flagged
    the SlowCall's own dispatch.  Returns (the served requests, what
    moved)."""
    eng = fe._engines["fp32"]
    keys = ("retries", "transient_failures", "stragglers", "heartbeat_fires")
    captures = {p: dict(e.capture_counts) for p, e in fe._engines.items()}
    before = dict(eng.throughput()[64])
    served, moved = [], {}
    for make in (TransientFailure,
                 functools.partial(SlowCall, delay_s=SLOW_CALL_S)):
        fs0 = {k: eng.fault_stats[k] for k in keys}
        step = eng._dispatches + 1               # the fault's dispatch
        inj.schedule(make(at_call=inj.calls))    # the next fp32 dispatch
        z = tower_inputs(cfg, 64, rng)
        rid = fe.submit(z, "std")
        served.append(take(fe, z, fe._requests[rid], rid))
        name = type(inj.log[-1][1]).__name__
        moved[name] = {k: eng.fault_stats[k] - fs0[k] for k in keys}
        moved[name]["dispatch"] = step
    after = eng.throughput()[64]
    flagged = eng._stragglers[64].flagged
    moved.update(tainted_calls_b64=after["tainted_calls"],
                 healthy_calls_b64=[before["calls"], after["calls"]],
                 flagged_b64=flagged[-3:],
                 injected=[(i, type(f).__name__) for i, f in inj.log])
    tf, sc = moved.get("TransientFailure"), moved.get("SlowCall")
    if (tf is None or sc is None
            or tf["retries"] != 1 or tf["transient_failures"] != 1
            or sc["stragglers"] < 1 or sc["heartbeat_fires"] < 1
            or sc["dispatch"] not in flagged):
        raise AssertionError(f"fault drill: counters {moved}")
    # the retried dispatch is tainted, the slow one a healthy sample
    if (after["tainted_calls"] != before["tainted_calls"] + 1
            or after["calls"] != before["calls"] + 1):
        raise AssertionError(f"fault drill: bucket-64 samples {before} -> "
                             f"{after}")
    if captures != {p: dict(e.capture_counts)
                    for p, e in fe._engines.items()}:
        raise AssertionError("fault drill: the retry built an executable")
    return served, moved


def phase_frontend(smi):
    """CelebA at full width through `AsyncServeFrontend`: fp32 engines on
    B1 and the int8 degraded path on B2, every bucket x precision captured
    by ``prime`` before the worker starts.  Under torch.profiler and the
    port's span tracer, with every count at 0 just before: the
    offered-load sweep, the degrade drill and the fault drill.
    Checks: every request resolved typed; at 2x load some gold requests
    downgraded or shed; traced launches of B1 fp32 and B2 = layers x
    dispatches per precision and none of another kernel; one executable
    per bucket x precision; then fp32 images within SERVE_TOL of the fp32
    engine's generate of the same rows and int8 images equal to the int8
    engine's bit for bit.  Returns the traced launches per kernel."""
    cfg = CELEBA_DCNN
    params = generator_init(torch.Generator().manual_seed(0), cfg, "cuda")
    inj = FaultInjector()
    t0 = time.perf_counter()
    fe = AsyncServeFrontend.from_config(
        EngineConfig(model="celeba", backend="cuda", max_batch=64,
                     heartbeat_timeout_s=HEARTBEAT_S),
        params, [TenantClass("gold", priority=0),
                 TenantClass("std", priority=1)],
        precisions=("fp32", "int8"), prime=2, fault_injector=inj,
        max_queue_rows=FRONTEND_QUEUE_ROWS)
    try:
        built_s = time.perf_counter() - t0
        engines = fe._engines
        for p, eng in engines.items():
            if eng.capture_counts != {b: 1 for b in eng.buckets}:
                raise AssertionError(f"prime: {p} capture_counts "
                                     f"{eng.capture_counts}")
        print(f"  frontend built and primed in {built_s:.1f} s: buckets "
              f"{list(fe._buckets)} x {list(engines)}, one graph each "
              f"[{smi}]", flush=True)
        rng = np.random.default_rng(8)
        tracer = obstrace.enable(clear=True)
        torch.cuda.synchronize()
        with profiled() as prof:
            zero_launch_counts()
            for eng in engines.values():
                eng.launch_counts.clear()
            d0 = {p: eng._dispatches for p, eng in engines.items()}
            t_run = time.perf_counter()
            loads = frontend_traffic(fe, cfg, FRONTEND_LOADS, rng, smi,
                                     tracer)
            slo_ms = loads[0][0]["gold_slo_ms"]
            degraded = degrade_drill(fe, cfg, rng, slo_ms)
            faulted, moved = fault_drill(fe, inj, cfg, rng)
            fe.drain(timeout_s=FRONTEND_WAIT_S)
            torch.cuda.synchronize()
            t_run = time.perf_counter() - t_run
            if fe._worker_errors:
                raise AssertionError(f"frontend worker errors "
                                     f"{fe._worker_errors[:3]}")
            dispatches = {p: eng._dispatches - d0[p]
                          for p, eng in engines.items()}
            counted = {p: sum(eng.launch_counts.values())
                       for p, eng in engines.items()}
            wrappers = launch_counts()
        obstrace.disable()
        trace = prof.events()
        device = [e.name for e in trace
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        traced = {k: sum(kernel_of(n) == k for n in device)
                  for k in TRACE_NAMES}
        layers = len(cfg.layers)
        want = {("deconv2d_kernel", "fp32"): layers * dispatches["fp32"],
                ("deconv2d_int8_kernel", "int8"): layers * dispatches["int8"]}
        print(f"  frontend run: dispatches {dispatches} x {layers} layers; "
              f"traced device launches "
              f"{ {'/'.join(k): v for k, v in traced.items()} }, engine "
              f"launch_counts {counted}, wrapper launches {wrappers} "
              f"[{smi}]", flush=True)
        exact = (counted == {p: layers * n for p, n in dispatches.items()}
                 and not any(wrappers.values()) and dispatches["int8"] > 0)
        if (any(traced[k] != v for k, v in want.items())
                or any(v for k, v in traced.items() if k not in want)
                or not exact):
            raise failure(traced, want, exact)(
                f"frontend: traced {traced}, expected {want} and none of "
                f"the others; engine {counted}; wrappers {wrappers}")
        for p, eng in engines.items():
            if eng.capture_counts != {b: 1 for b in eng.buckets}:
                raise AssertionError(f"frontend: {p} capture_counts "
                                     f"{eng.capture_counts}")

        for row, _, spans in loads:
            row.update(span_stats(spans))
            row.update(load_split(trace, row, spans))
            print(json.dumps({"frontend_load": row}), flush=True)
        high = loads[-1][0]
        gold = high["tenants"]["gold"]
        if gold["downgraded"] + gold["shed"] == 0:
            raise AssertionError(f"load {high['load']}: no gold request "
                                 "downgraded or shed")
        qwait = fe.metrics.histogram("frontend.queue_wait_seconds")
        disp = fe.metrics.histogram("engine.dispatch_seconds")
        split = {"queue_wait_mean_ms": qwait.merged_summary()["mean"] * 1e3,
                 "dispatch_fp32_mean_ms": disp.merged_summary(
                     precision="fp32")["mean"] * 1e3,
                 "dispatch_int8_mean_ms": disp.merged_summary(
                     precision="int8")["mean"] * 1e3,
                 **span_stats(tracer.events()),
                 **device_split(trace, t_run), "run_s": t_run,
                 "note": "p50s over the whole run's spans (host clock) and "
                         "its trace (device); means from the registry "
                         "(queue wait: last load and the drills)",
                 "card": smi}
        print(json.dumps({"frontend_host_engine_split": split}), flush=True)
        rows = table2_rows(fe.metrics)
        t64 = [r for r in rows if r["precision"] == "fp32"
               and r["bucket"] == 64]
        if not t64 or t64[0]["tainted_calls"] < 1:
            raise AssertionError(f"table2: no tainted bucket-64 fp32 row "
                                 f"{t64}")
        print(f"  Table II of the frontend's engines ({smi}):", flush=True)
        for line in render_table2(rows).splitlines():
            print(f"  {line}  [{smi}]", flush=True)
        print(json.dumps({"frontend_fault_drill": moved, "card": smi}),
              flush=True)
        names = {}
        for e in tracer.events():
            key = e["name"].split(" b")[0] if e["name"].startswith(
                ("dispatch b", "plan_build b")) else e["name"]
            names[key] = names.get(key, 0) + 1
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "frontend_trace.json")
            n_events = tracer.export(path)
            size = os.path.getsize(path)
        print(json.dumps({"frontend_spans": names, "events": n_events,
                          "chrome_trace_bytes": size, "card": smi}),
              flush=True)

        served = [s for _, sv, _ in loads for s in sv] + degraded + faulted
        worst = {"fp32": 0.0, "int8": 0.0}
        counts = {"fp32": 0, "int8": 0}
        for z, prec, down, rid, img in served:
            want_img = engines[prec].generate(z)
            if img.shape != want_img.shape or not np.isfinite(img).all():
                raise AssertionError(f"frontend: bad images {img.shape}")
            err = float(np.abs(img - want_img).max())
            worst[prec] = max(worst[prec], err)
            counts[prec] += 1
            if prec == "int8" and (not down
                                   or not np.array_equal(img, want_img)):
                raise AssertionError(f"frontend int8 request {rid}: {err} "
                                     "from the int8 engine")
            if prec == "fp32" and err > SERVE_TOL:
                raise AssertionError(f"frontend fp32 request {rid}: {err} "
                                     "from the fp32 engine")
        print(f"  frontend images: {counts} requests served; largest error "
              f"vs each engine's own generate {worst} (fp32 tol "
              f"{SERVE_TOL}, int8 bit-equal) [{smi}]", flush=True)
        return {("deconv2d_kernel", "fp32"): traced[("deconv2d_kernel",
                                                     "fp32")],
                ("deconv2d_int8_kernel", "int8"): traced[
                    ("deconv2d_int8_kernel", "int8")]}
    finally:
        obstrace.disable()
        fe.close(timeout_s=FRONTEND_WAIT_S)


# ---------------------------------------------------------------------------
# phase 8: training
# ---------------------------------------------------------------------------
def check_b1_only(label, traced, wrappers, want):
    """The traced run launched ``want`` fp32 B1 kernels, counted alike by
    the trace and the wrapper (``wrappers``, read just after the run), and
    nothing of B2 or B3."""
    b1 = ("deconv2d_kernel", "fp32")
    exact = (wrappers["deconv2d_kernel"] == want and not any(
        v for k, v in wrappers.items() if k != "deconv2d_kernel"))
    if (traced[b1] != want or not exact
            or any(v for k, v in traced.items() if k != b1)):
        raise failure(traced, {b1: want}, exact)(
            f"{label}: traced {traced}, wrappers {wrappers}; expected "
            f"{want} fp32 B1 launches and nothing else")


def max_diff(a, b):
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def all_finite(tree):
    return all(bool(torch.isfinite(t).all()) for t in tree_leaves(tree)
               if t.is_floating_point())


def moment_diff(a, b):
    """The larger of ||a.mu - b.mu|| / ||b.mu|| and the same of nu, each
    norm over the whole tree, for two Adam states of one step."""
    if int(a.step) != int(b.step):
        raise AssertionError(f"Adam steps {int(a.step)} != {int(b.step)}")

    def norm(leaves):
        return float(torch.sqrt(sum((t.double() ** 2).sum() for t in leaves)))

    return max(norm([x - y for x, y in zip(tree_leaves(ma), tree_leaves(mb))])
               / norm(tree_leaves(mb))
               for ma, mb in ((a.mu, b.mu), (a.nu, b.nu)))


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms (the critic's conv backward and
    the penalty's double backward otherwise may sum in another order from
    run to run), restored on exit."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


def train_times(trainers, cfg, gp0, dp0, gs0, ds0, real, z, eps, smi):
    """ms per critic and generator step per backend (CUDA events around
    each of TRAIN_RUNS steps from the same state, median), the generator
    forward alone at the bucket (B1, reverse loop, cuDNN; device time
    behind a queued sleep), and the remat backward's share of a "cuda"
    generator step."""
    n = real.shape[0]
    step_ms = {}
    for be, t in trainers.items():
        c, _ = time_ms(lambda: t.critic_update(dp0, ds0, gp0, real, n, z, eps),
                       runs=TRAIN_RUNS, warmup=2, backlog=False)
        g, _ = time_ms(lambda: t.gen_update(gp0, gs0, dp0, z),
                       runs=TRAIN_RUNS, warmup=2, backlog=False)
        step_ms[be] = (c, g)
        print(f"  {cfg.name} {be}: critic step {c:.3f} ms, generator step "
              f"{g:.3f} ms (bucket {n}, median of {TRAIN_RUNS}) [{smi}]",
              flush=True)
    fused = trainers["cuda"]._gen_for(n)
    forwards = {"B1 (fused forward)": lambda: fused(gp0, z),
                "reverse_loop": lambda: generator_apply(
                    gp0, cfg, z, backend="reverse_loop"),
                "cudnn": lambda: generator_apply(gp0, cfg, z, backend="cudnn")}
    fwd_ms = {}
    with torch.no_grad():
        for name, fn in forwards.items():
            fwd_ms[name] = time_ms(fn, runs=TRAIN_RUNS)
    print(f"  {cfg.name} generator forward at bucket {n}, ms (device time "
          f"held): " + ", ".join(f"{k} {v[0]:.3f} ({v[1]})"
                                 for k, v in fwd_ms.items()) + f" [{smi}]",
          flush=True)
    pg = requiring_grad(gp0)
    ct = torch.randn((n, cfg.img_hw, cfg.img_hw, cfg.img_c), device=z.device)
    remat, _ = time_ms(lambda: torch.autograd.grad(
        generator_apply(pg, cfg, z, backend="reverse_loop"), tree_leaves(pg),
        ct), runs=TRAIN_RUNS, warmup=2, backlog=False)
    print(f"  {cfg.name} remat backward (reverse-loop forward + its "
          f"autograd) {remat:.3f} ms = {remat / step_ms['cuda'][1]:.3f} of a "
          f"cuda generator step [{smi}]", flush=True)
    # one of each step, each in its own profiler range, the device idle
    # before it: how much of its wall clock the device is busy
    ranges = {}
    for be, t in trainers.items():
        ranges[f"{be} critic"] = lambda t=t: t.critic_update(
            dp0, ds0, gp0, real, n, z, eps)
        ranges[f"{be} generator"] = lambda t=t: t.gen_update(gp0, gs0, dp0, z)
    ranges["cuda remat"] = lambda: torch.autograd.grad(
        generator_apply(pg, cfg, z, backend="reverse_loop"), tree_leaves(pg),
        ct)
    torch.cuda.synchronize()
    with profiled() as prof:
        for name, fn in ranges.items():
            with torch.profiler.record_function(f"train_step {name}"):
                fn()
                torch.cuda.synchronize()
    trace = prof.events()
    dev = device_events(trace)
    shares = []
    for name in ranges:
        mark, = [e for e in trace if e.name == f"train_step {name}"
                 and e.device_type == torch.autograd.DeviceType.CPU]
        lo, hi = mark.time_range.start, mark.time_range.end
        kernels = sum(lo <= e.time_range.start < hi for e in dev)
        shares.append(f"{name} {busy_us(dev, lo, hi) / (hi - lo):.3f} of "
                      f"{(hi - lo) / 1e3:.2f} ms, {kernels} device ops")
    print(f"  {cfg.name} device busy share of one step, traced: "
          + "; ".join(shares) + f" [{smi}]", flush=True)
    return step_ms, fwd_ms, remat


def phase_training(smi):
    """CelebA WGAN-GP at full width and the zoo's sr head through their
    trainers on "cuda" (B1 in the generator's forward, the reverse loop's
    autograd behind it); returns the traced B1 launches."""
    dev = torch.device("cuda")
    fp32_exact(dev)
    cfg = CELEBA_DCNN

    def opt():
        return AdamW(lr=TRAIN_LR, b1=0.5, b2=0.9)

    trainers = {be: WganTrainer(cfg, opt(), opt(), n_critic=TRAIN_N_CRITIC,
                                backend=be, device=dev)
                for be in ("cuda", "reverse_loop", "cudnn")}
    src = image_source("celeba", seed=0, batch=TRAIN_BATCH)
    tmp = tempfile.mkdtemp(prefix="repro_torch_train_")
    try:
        with cudnn_deterministic():
            traced, (gp0, dp0, gs0, ds0), real, zn, eps = check_wgan(
                cfg, trainers, src, tmp, opt)
        train_times(trainers, cfg, gp0, dp0, gs0, ds0, real, zn, eps, smi)
        with cudnn_deterministic():
            sr_traced = check_sr(smi)
        return {("deconv2d_kernel", "fp32"):
                traced[("deconv2d_kernel", "fp32")]
                + sr_traced[("deconv2d_kernel", "fp32")]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_wgan(cfg, trainers, src, tmp, opt):
    """The CelebA WGAN-GP checks of phase 8 (see the module doc); returns
    the fit's traced launches, an initial state and one batch of real
    images, z and eps for the timings."""
    dev = torch.device("cuda")
    n_layers = len(cfg.layers)
    trainer = trainers["cuda"]
    run_dir = os.path.join(tmp, "run")
    ck = AsyncCheckpointer(run_dir, keep=TRAIN_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profiled() as prof:
        zero_launch_counts()
        gp, dp, hist = trainer.fit(src, TRAIN_STEPS, 0, log_every=1,
                                   ckpt=ck, ckpt_every=1)
        ck.wait()
        torch.cuda.synchronize()
        traced_fit_s = time.perf_counter() - t0
        wrappers = launch_counts()
    traced, _ = traced_launches(prof)
    check_b1_only("CelebA WGAN-GP fit", traced, wrappers,
                  n_layers * (TRAIN_N_CRITIC + 1) * TRAIN_STEPS)
    losses = [v for h in hist for k, v in h.items() if k != "step"]
    if len(hist) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"training losses {hist}")
    print(f"  {cfg.name} WGAN-GP on cuda: {TRAIN_STEPS} steps x "
          f"({TRAIN_N_CRITIC} critic + 1 generator) at batch "
          f"{TRAIN_BATCH}, {traced_fit_s:.2f} s traced with checkpoints;"
          f" traced B1 launches {traced[('deconv2d_kernel', 'fp32')]} = "
          f"{n_layers} layers x {TRAIN_N_CRITIC + 1} x {TRAIN_STEPS}, "
          "no B2/B3; losses " + "; ".join(
              f"step {h['step']}: d {h['d_loss']:+.4f} g "
              f"{h['g_loss']:+.4f} gp {h['gp']:.4f}" for h in hist),
          flush=True)

    # no B1 launch in a backward: the fused generator's backward alone,
    # traced
    fused = trainer._gen_for(TRAIN_BATCH)
    zg = torch.Generator(device=dev).manual_seed(7)
    z = torch.randn((TRAIN_BATCH, cfg.z_dim), generator=zg, device=dev)
    pg = requiring_grad(gp)
    y = fused(pg, z)
    ct = torch.randn(y.shape, generator=zg, device=dev)
    torch.cuda.synchronize()
    with profiled() as prof:
        zero_launch_counts()
        torch.autograd.grad(y, tree_leaves(pg), ct)
        torch.cuda.synchronize()
        wrappers = launch_counts()
    traced_bwd, n_bwd = traced_launches(prof)
    check_b1_only("the fused generator's backward", traced_bwd, wrappers, 0)
    if n_bwd == 0:
        raise AssertionError("the traced backward ran no device kernel")
    print(f"  the fused generator's backward alone, traced: {n_bwd} "
          "device kernels, no B1", flush=True)

    # every update's generator params (each step's checkpoint): the
    # trainer's own fused forward against the reverse loop
    like = dict(zip(("g", "d", "gs", "ds"), trainer.init_state(0)))
    errs = []
    for s in range(TRAIN_STEPS):
        tree, _, extra = restore(run_dir, like, step=s)
        if extra != {"step": s} or not all_finite(tree):
            raise AssertionError(f"checkpoint {s}: {extra}, finite "
                                 f"{all_finite(tree)}")
        with torch.no_grad():
            got = fused(tree["g"], z)
            ref = generator_apply(tree["g"], cfg, z, backend="reverse_loop")
        errs.append(float((got - ref).abs().max()))
        if errs[-1] > SERVE_TOL:
            raise AssertionError(f"after update {s} the fused forward is "
                                 f"{errs[-1]} from the reverse loop")
    if max_diff(tree["g"], gp) or max_diff(tree["d"], dp):
        raise AssertionError("the last checkpoint is not fit's result")
    print(f"  after each generator update (checkpoints 0..{TRAIN_STEPS - 1}"
          f", params, moments and steps all finite): |fused forward - "
          f"reverse_loop| {errs} (tol {SERVE_TOL})", flush=True)

    # resume from step 1's checkpoint; the uninterrupted run is the traced
    # one
    resume_dir = os.path.join(tmp, "resume")
    shutil.copytree(os.path.join(run_dir, "step_00000001"),
                    os.path.join(resume_dir, "step_00000001"))
    rt = WganTrainer(cfg, opt(), opt(), n_critic=TRAIN_N_CRITIC,
                     backend="cuda", device=dev)
    gp_r, dp_r, _ = rt.fit(src, TRAIN_STEPS, 0, resume_from=resume_dir)
    diff = max_diff((gp_r, dp_r), (gp, dp))
    print(f"  resumed from checkpoint 1 (cuDNN deterministic): largest "
          f"param difference from the uninterrupted run {diff!r} (bitwise "
          "required)", flush=True)
    if diff != 0:
        raise AssertionError(f"the resumed run differs by {diff}")

    # one critic step and one generator step per backend, the same params,
    # fresh optimizer states (the moments are then the step's grads) and
    # noise: from fit's params (checked) and from the initial ones (only
    # printed: the fake images are about 3e-3 there and the critic's
    # biases 0, so thousands of its pre-activations lie within 1e-6 of
    # LeakyReLU's kink, and B1's rounding flips some of them)
    gp0, dp0, gs0, ds0 = trainer.init_state(0)
    real = torch.from_numpy(src.batch(0)["images"]).to(dev)
    ng = torch.Generator(device=dev).manual_seed(11)
    zn = torch.randn((TRAIN_BATCH, cfg.z_dim), generator=ng, device=dev)
    eps = torch.rand((TRAIN_BATCH, 1, 1, 1), generator=ng, device=dev)
    for label, g_p, d_p in (("from fit's params", gp, dp),
                            ("from the initial params", gp0, dp0)):
        steps = {}
        for be, t in trainers.items():
            dp1, ds1, dmet = t.critic_update(d_p, ds0, g_p, real,
                                             TRAIN_BATCH, zn, eps)
            gp1, gs1, gmet = t.gen_update(g_p, gs0, d_p, zn)
            steps[be] = (dp1, gp1, ds1, gs1, {**dmet, **gmet})
        ref = steps["reverse_loop"]
        for be in ("cuda", "cudnn"):
            dp1, gp1, ds1, gs1, met = steps[be]
            rel = {k: abs(float(v) - float(ref[4][k])) / abs(float(ref[4][k]))
                   for k, v in met.items()}
            d_err, g_err = max_diff(dp1, ref[0]), max_diff(gp1, ref[1])
            d_mom, g_mom = moment_diff(ds1, ref[2]), moment_diff(gs1, ref[3])
            print(f"  one step {label} on {be} vs reverse_loop: loss rel. "
                  f"errors { {k: f'{v:.1e}' for k, v in rel.items()} } (tol "
                  f"1e-4); Adam moments |d|/|ref| critic {d_mom:.2e}, "
                  f"generator {g_mom:.2e} (tol {WGAN_MOMENT_TOL:.0e}); critic "
                  f"params {d_err:.2e}, generator params {g_err:.2e} (tol 2 "
                  f"lr = {2 * TRAIN_LR:.0e}: a first Adam step moves each by"
                  f" about lr){'' if g_p is gp else ' [not checked]'}",
                  flush=True)
            if g_p is gp and be == "cuda" and (
                    max(rel.values()) > 1e-4
                    or max(d_mom, g_mom) > WGAN_MOMENT_TOL
                    or max(d_err, g_err) > 2 * TRAIN_LR):
                raise AssertionError(f"a cuda step is not the reverse "
                                     f"loop's: {rel}, {d_mom}, {g_mom}, "
                                     f"{d_err}, {g_err}")
    return traced, (gp0, dp0, gs0, ds0), real, zn, eps


def check_sr(smi):
    """The zoo's sr head through `SupervisedTrainer` on "cuda" against
    "reverse_loop" (see the module doc); returns the traced launches."""
    dev = torch.device("cuda")
    w = workload_for(SR_X2)
    sr_src = pair_source(w, 0, TRAIN_BATCH)
    sr, hists, first = {}, {}, {}
    for be in ("cuda", "reverse_loop"):
        st = SupervisedTrainer(w.cfg, AdamW(lr=SR_LR), backend=be,
                               device=dev)
        torch.cuda.synchronize()
        with profiled() as prof:
            zero_launch_counts()
            sr[be], hists[be] = st.fit(sr_src, TRAIN_STEPS, 0, log_every=1)
            torch.cuda.synchronize()
            wrappers = launch_counts()
        if be == "cuda":
            sr_traced, _ = traced_launches(prof)
            check_b1_only("sr supervised fit", sr_traced, wrappers,
                          len(w.cfg.layers) * TRAIN_STEPS)
        if not np.isfinite([h["loss"] for h in hists[be]]).all():
            raise AssertionError(f"sr losses {hists[be]}")
        # the first step alone, for what its grads set
        p0, s0 = st.init_state(0)
        b = sr_src.batch(0)
        first[be] = st.step(p0, s0, b["x"], b["y"])[1]
    loss_rel = max(abs(h["loss"] - r["loss"]) / abs(r["loss"]) for h, r in
                   zip(hists["cuda"], hists["reverse_loop"]))
    sr_err = max_diff(sr["cuda"], sr["reverse_loop"])
    mom = moment_diff(first["cuda"], first["reverse_loop"])
    print(f"  {w.cfg.name} supervised on cuda: {TRAIN_STEPS} steps at "
          f"batch {TRAIN_BATCH}, traced B1 launches "
          f"{sr_traced[('deconv2d_kernel', 'fp32')]} = "
          f"{len(w.cfg.layers)} layers x {TRAIN_STEPS}; vs reverse_loop: "
          f"losses {loss_rel:.1e} relative (tol 1e-4), params after "
          f"{TRAIN_STEPS} steps {sr_err:.2e} (tol {SR_PARAM_TOL:.0e}), the "
          f"first step's Adam moments |d|/|ref| {mom:.2e} (tol "
          f"{MOMENT_TOL:.0e}) [{smi}]", flush=True)
    if (len(hists["cuda"]) != TRAIN_STEPS or loss_rel > 1e-4
            or sr_err > SR_PARAM_TOL or mom > MOMENT_TOL):
        raise AssertionError(f"sr cuda vs reverse_loop: losses {loss_rel}, "
                             f"params {sr_err}, moments {mom}")
    return sr_traced


# ---------------------------------------------------------------------------
# phase 9: the plan DRC
# ---------------------------------------------------------------------------
def recorded_launches(eng, bucket):
    """Per layer, the launch parameter array of one eager pass of
    ``eng``'s bucket on the shard's own operands (`_tc_launch_params`
    recorded as the launchers call it)."""
    seen, real = [], deconv_kernel._tc_launch_params

    def record(*args):
        out = real(*args)
        seen.append(out)
        return out

    deconv_kernel._tc_launch_params = record
    try:
        z = torch.zeros((eng.shard_batch(bucket),) + eng.cfg.input_shape,
                        device="cuda")
        with torch.no_grad():
            eng._apply(bucket, eng.plans[bucket], z)
        torch.cuda.synchronize()
    finally:
        deconv_kernel._tc_launch_params = real
    return seen


def gate_drill(label, cfg, params, plan, want_rule, **kw):
    """``from_config`` must refuse ``plan`` with `PlanCheckError` naming
    ``want_rule``, having planned, built, captured and launched nothing."""
    calls = {"plan": 0, "build": 0}
    real_plan, real_build = (DcnnServeEngine._plan_for,
                             DcnnServeEngine._build_shard)

    def plan_for(self, *a):
        calls["plan"] += 1
        return real_plan(self, *a)

    def build(self, *a):
        calls["build"] += 1
        return real_build(self, *a)

    DcnnServeEngine._plan_for, DcnnServeEngine._build_shard = plan_for, build
    before = launch_counts()
    try:
        DcnnServeEngine.from_config(EngineConfig(
            model=cfg, max_batch=64, warmup=True, **kw), params, plan=plan)
    except PlanCheckError as e:
        rules = sorted({v.rule_id for v in e.violations})
    else:
        raise AssertionError(f"{label}: the engine accepted the plan")
    finally:
        DcnnServeEngine._plan_for, DcnnServeEngine._build_shard = (
            real_plan, real_build)
    if want_rule not in rules or any(calls.values()) \
            or launch_counts() != before:
        raise AssertionError(f"{label}: rules {rules}, engine work {calls}, "
                             f"launches {before} -> {launch_counts()}")
    print(f"  gate: {label}: refused before any planning or capture "
          f"({', '.join(rules)})", flush=True)


def with_tiles(plan, layer, **kw):
    l = plan.layers[layer]
    return dataclasses.replace(plan, layers=plan.layers[:layer] + (
        dataclasses.replace(l, tiles=dataclasses.replace(l.tiles, **kw)),)
        + plan.layers[layer + 1:])


def example_plan_json(tmp):
    """``examples/serve_dcnn_torch.py --plan-json`` on the card: write the
    largest bucket's plan, reload, DRC and serve it, then exit 2 on a
    mutated document."""
    path = os.path.join(tmp, "plan.json")
    cmd = [sys.executable, os.path.join(ROOT, "examples",
                                        "serve_dcnn_torch.py"),
           "--net", "mnist", "--batch", "16", "--reqs", "3",
           "--plan-json", path]

    def run(want_rc):
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
        if res.returncode != want_rc:
            raise AssertionError(f"serve_dcnn_torch.py --plan-json: rc "
                                 f"{res.returncode}, expected {want_rc}:\n"
                                 f"{res.stdout[-2000:]}{res.stderr[-2000:]}")
        return res.stdout

    out = run(0)
    if f"-> {path}" not in out:
        raise AssertionError(f"the example wrote no plan:\n{out}")
    out = run(0)
    if "DRC clean" not in out:
        raise AssertionError(f"the example did not DRC the pinned plan:\n{out}")
    with open(path) as f:
        doc = json.load(f)
    doc["layers"][1]["tiles"]["t_ci"] = 12
    doc.pop("stable_hash")
    with open(path, "w") as f:
        json.dump(doc, f)
    out = run(2)
    if "drc.tile_alignment" not in out:
        raise AssertionError(f"the refusal names no rule:\n{out}")
    print("  examples/serve_dcnn_torch.py --plan-json: wrote, reloaded, "
          "DRC'd and served mnist's bucket-16 plan; exit 2 on a t_ci of 12",
          flush=True)


def phase_drc(engines, smi):
    """Every plan the serving phase's engines built DRC-clean against
    `H100_SXM` (each tower's bucket-64 zero-skip plan also against the
    weights it serves); per tiled layer the DRC's shared memory, threads
    and split equal to the launcher's parameter array and the library's
    ``deconv2d_tc_smem_bytes`` for the same launch; the engine's gate on
    the card; the example's ``--plan-json``."""
    plans = layers = 0
    largest = 0
    for path, by_net in engines.items():
        for name, eng in by_net.items():
            for b in eng.buckets:
                plan = eng.plans[b]
                sparse = eng.backend == "cuda_sparse" and b == 64
                rep = check_network_plan(
                    plan, n_devices=eng.n_devices, buckets=eng.buckets,
                    params=eng.params if sparse else None)
                if not rep.ok(strict=True):
                    raise AssertionError(f"{path} {name} bucket {b}:\n"
                                         f"{rep.render(strict=True)}")
                plans += 1
                got = recorded_launches(eng, b)
                if len(got) != len(plan.layers):
                    raise AssertionError(f"{path} {name} bucket {b}: "
                                         f"{len(got)} launches recorded")
                for i, (l, params) in enumerate(zip(plan.layers, got)):
                    drc, lib = launch_resources(l), \
                        deconv_kernel.launch_report(params)
                    if drc != lib:
                        raise AssertionError(
                            f"{path} {name} bucket {b} layer {i}: the DRC "
                            f"says {drc}, the launcher and library {lib}")
                    largest = max(largest, drc["smem_bytes"])
                    layers += 1
    print(f"  {plans} plans DRC-clean against {H100_SXM.name} (budget "
          f"{H100_SXM.onchip_bytes} B); {layers} tiled launches: the DRC's "
          f"shared memory, threads and split == the launcher's and "
          f"deconv2d_tc_smem_bytes's (largest {largest} B) [{smi}]",
          flush=True)
    cfg = CELEBA_DCNN
    fp32 = engines["fp32"][cfg.name]
    plan = fp32.plans[64]
    gate_drill("tile 512/512/2048/2048 on layer 1", cfg, fp32.params,
               with_tiles(plan, 1, t_oh=512, t_ow=512, t_ci=2048, t_co=2048),
               "drc.smem_budget")
    pallas = dataclasses.replace(plan, backend="pallas", layers=tuple(
        dataclasses.replace(l, backend="pallas") for l in plan.layers))
    gate_drill("a plan named for the JAX package's pallas backend", cfg,
               fp32.params, pallas, "drc.backend")
    int8 = engines["int8"][cfg.name]
    qplan = int8.plans[64]
    broken = dataclasses.replace(qplan, layers=(dataclasses.replace(
        qplan.layers[0], out_scale=123.0),) + qplan.layers[1:])
    gate_drill("int8 layer 0 requantised at 123.0", cfg, fp32.params, broken,
               "drc.scale_chain", precision="int8")
    mapped = pallas.for_hopper()
    eng = DcnnServeEngine.from_config(EngineConfig(model=cfg, buckets=(64,)),
                                      fp32.params, plan=mapped)
    z = tower_inputs(cfg, 64, np.random.default_rng(9))
    err = float(np.abs(eng.generate(z) - fp32.generate(z)).max())
    if err > SERVE_TOL:
        raise AssertionError(f"the for_hopper plan serves {err} off")
    print(f"  gate: the same plan through NetworkPlan.for_hopper serves "
          f"(max |diff| vs the fp32 engine {err:.2e})", flush=True)
    tmp = tempfile.mkdtemp(prefix="repro_torch_plan_")
    try:
        example_plan_json(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 10: the mesh
# ---------------------------------------------------------------------------
def dispatch_ms(eng, z):
    """Mean and CV of MESH_RUNS bucket-64 dispatches (the engine's clock)."""
    eng.bucket_stats.clear()
    for _ in range(MESH_RUNS):
        eng.generate(z)
    tp = eng.throughput()[64]
    return tp["mean_s"] * 1e3, tp["cv"]


def mesh_path(path, single, params, reqs, want):
    """One path on a MESH_SHARDS mesh of cuda:0: the requests traced with
    every count at 0 just before; returns (engine, injector, traced
    launches of the path's kernel)."""
    cfg, kernel = single.cfg, PATHS[path][0]
    inj = FaultInjector()
    eng = DcnnServeEngine.from_config(EngineConfig(
        model=cfg, buckets=(1, 64), precision=single.precision,
        quant_cfg=single.quant_cfg,
        mesh=make_test_mesh(MESH_SHARDS, device="cuda:0")), params,
        fault_injector=inj)
    if eng.buckets != (MESH_SHARDS, 64) or eng.shard_batch(64) != 32:
        raise AssertionError(f"mesh buckets {eng.buckets}")
    eng._warmup_bucket(64)
    torch.cuda.synchronize()
    with profiled() as prof:
        zero_launch_counts()
        eng.launch_counts.clear()
        outs = [eng.collect(eng.submit(r)) for r in reqs]
        torch.cuda.synchronize()
        engine = sum(eng.launch_counts.values())
        wrappers = launch_counts()
    traced = traced_launches(prof)[0]
    n = len(cfg.layers) * MESH_SHARDS * len(reqs)
    exact = engine == n and not any(wrappers.values())
    if (traced[kernel] != n or not exact
            or any(v for k, v in traced.items() if k != kernel)):
        raise failure(traced, {kernel: n}, exact)(
            f"mesh {path}: traced {traced}, engine {engine}, wrappers "
            f"{wrappers}; expected {n} of {kernel}")
    got = np.concatenate(outs)
    err = float(np.abs(got - want).max())
    if (path == "int8" and not np.array_equal(got, want)) or err > MESH_TOL:
        raise AssertionError(f"mesh {path}: images {err} from one device")
    for b, plan in eng.plans.items():
        rep = check_network_plan(plan, n_devices=MESH_SHARDS,
                                 buckets=eng.buckets)
        if not rep.ok(strict=True):
            raise AssertionError(rep.render(strict=True))
    print(f"  mesh {path}: {MESH_SHARDS} shards of cuda:0 at bucket 64 "
          f"(32 rows a shard), {len(reqs)} dispatches: traced {kernel} "
          f"launches {traced[kernel]} == {len(cfg.layers)} layers x "
          f"{MESH_SHARDS} x {len(reqs)}, engine {engine}, wrappers 0; "
          f"capture_counts {eng.capture_counts}; max |mesh - one device| "
          f"{err:.2e}{' (bit-equal)' if path == 'int8' else ''}; per-shard "
          "plans DRC-clean", flush=True)
    return eng, inj, traced[kernel]


def mesh_training(smi):
    """MNIST WGAN-GP at full width, MESH_TRAIN_STEPS steps on a 2-shard
    mesh against z_shards=2 from the same state and keys: per-step losses
    rtol 1e-4, Adam's moments 1e-4 as a tree-norm ratio; returns the mesh
    run's traced B1 launches (layers x shards per generator forward)."""
    cfg = MNIST_DCNN
    src = image_source("mnist", seed=0, batch=TRAIN_BATCH)

    def run(**kw):
        t = WganTrainer(cfg, AdamW(lr=TRAIN_LR, b1=0.5, b2=0.9),
                        AdamW(lr=TRAIN_LR, b1=0.5, b2=0.9),
                        n_critic=TRAIN_N_CRITIC, backend="cuda", **kw)
        gp, dp, gs, ds = t.init_state(0)
        hist = []
        for step in range(MESH_TRAIN_STEPS):
            for j in range(TRAIN_N_CRITIC):
                dp, ds, dm = t.critic_step(dp, ds, gp,
                                           src.batch(step)["images"],
                                           (0, step, j))
            gp, gs, gm = t.gen_step(gp, gs, dp, (0, step, TRAIN_N_CRITIC),
                                    TRAIN_BATCH)
            hist.append({k: float(v) for k, v in {**dm, **gm}.items()})
        return hist, gs, ds

    with cudnn_deterministic():
        torch.cuda.synchronize()
        with profiled() as prof:
            zero_launch_counts()
            hm, gsm, dsm = run(mesh=make_test_mesh(MESH_SHARDS,
                                                   device="cuda:0"))
            torch.cuda.synchronize()
            wrappers = launch_counts()
        h1, gs1, ds1 = run(z_shards=MESH_SHARDS, device="cuda")
    traced = traced_launches(prof)[0]
    want = (len(cfg.layers) * MESH_SHARDS * (TRAIN_N_CRITIC + 1)
            * MESH_TRAIN_STEPS)
    check_b1_only("mesh training", traced, wrappers, want)
    rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
              for a, b in zip(hm, h1) for k in b)
    mom = max(moment_diff(gsm, gs1), moment_diff(dsm, ds1))
    print(f"  mesh training: mnist WGAN-GP, batch {TRAIN_BATCH}, "
          f"{MESH_TRAIN_STEPS} steps on {MESH_SHARDS} shards vs z_shards="
          f"{MESH_SHARDS}: losses rel {rel:.2e} (tol 1e-4), Adam moments "
          f"{mom:.2e} (tol {WGAN_MOMENT_TOL:.0e}); traced B1 {want} == "
          f"{len(cfg.layers)} layers x {MESH_SHARDS} shards x "
          f"{TRAIN_N_CRITIC + 1} x {MESH_TRAIN_STEPS} [{smi}]", flush=True)
    if rel > 1e-4 or mom > WGAN_MOMENT_TOL or len(hm) != MESH_TRAIN_STEPS:
        raise AssertionError(f"mesh training: losses {rel}, moments {mom}")
    return traced[("deconv2d_kernel", "fp32")]


def phase_mesh(engines, smi):
    """CelebA fp32 (B1) and int8 (B2) on a 2-shard mesh of one card, the
    times of its dispatches against one device, an elastic drill, a serve
    over every visible card, and MESH_SHARDS-shard WGAN-GP training;
    returns the traced launches per kernel."""
    cfg = CELEBA_DCNN
    fp32, int8 = engines["fp32"][cfg.name], engines["int8"][cfg.name]
    rng = np.random.default_rng(7)
    reqs = [tower_inputs(cfg, n, rng) for n in MESH_REQUESTS]
    z = np.concatenate(reqs)
    launches, meshes = {}, {}
    for path, single in (("fp32", fp32), ("int8", int8)):
        eng, inj, n = mesh_path(path, single, fp32.params, reqs,
                                single.generate(z))
        launches[PATHS[path][0]] = n
        meshes[path] = (eng, inj)
    every = DcnnServeEngine.from_config(EngineConfig(
        model=cfg, buckets=(64,), mesh=make_serving_mesh()), fp32.params)
    z64 = z[:64]
    err = float(np.abs(every.generate(z64) - fp32.generate(z64)).max())
    if err > MESH_TOL:
        raise AssertionError(f"make_serving_mesh(): images {err} off")
    print(f"  make_serving_mesh(): {every.n_devices} card(s) "
          f"{[str(d) for d in every.mesh.devices]}, max |diff| vs one "
          f"device {err:.2e}", flush=True)
    rows = {}
    for label, eng in (("fp32 one device", fp32),
                       (f"fp32 {MESH_SHARDS} shards", meshes["fp32"][0]),
                       ("int8 one device", int8),
                       (f"int8 {MESH_SHARDS} shards", meshes["int8"][0]),
                       (f"fp32 make_serving_mesh ({every.n_devices})",
                        every)):
        ms, cv = dispatch_ms(eng, z64)
        rows[label] = {"ms": ms, "cv": cv}
    print(json.dumps({"mesh_dispatch_ms": rows, "bucket": 64,
                      "runs": MESH_RUNS, "card": smi}), flush=True)
    eng, inj = meshes["fp32"]
    before = eng.generate(z64)
    inj.schedule(DeviceLoss(at_call=inj.calls, keep=1))
    after = eng.generate(z64)
    events = eng.fault_stats["remesh_events"]
    if (len(events) != 1 or eng.n_devices != 1 or eng.buckets != (1, 64)
            or events[0]["devices_before"] != MESH_SHARDS
            or events[0]["devices_after"] != 1
            or events[0]["buckets"] != [1, 64]
            or not all(events[0]["plan_hash_matches"].values())):
        raise AssertionError(f"elastic drill: {events}, {eng.buckets}")
    err = max(float(np.abs(after - before).max()),
              float(np.abs(after - fp32.generate(z64)).max()))
    if err > MESH_TOL:
        raise AssertionError(f"elastic drill: images moved by {err}")
    for plan in eng.plans.values():
        if not check_network_plan(plan, buckets=eng.buckets).ok(strict=True):
            raise AssertionError("elastic drill: a re-plan fails the DRC")
    print(f"  elastic drill: device loss keep=1 -> 1 shard, buckets "
          f"{list(eng.buckets)}, one remesh event in "
          f"{events[0]['seconds'] * 1e3:.1f} ms, images within {err:.2e}",
          flush=True)
    launches[("deconv2d_kernel", "fp32")] += mesh_training(smi)
    return launches


def main() -> int:
    smi, name, peaks = device_info()
    # no run reads another's tile timings
    cache_dir = tempfile.mkdtemp(prefix="repro_torch_tiles_")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(cache_dir,
                                                            "autotune.json")
    try:
        return run(smi, name, peaks)
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)


def run(smi, name, peaks) -> int:
    print(f"[1] device: {smi} | torch: {name} | peaks: fp32 "
          f"{peaks['fp32'] / 1e12} TFLOP/s, int8 {peaks['int8'] / 1e12} "
          f"TOP/s, bf16 {peaks['bf16'] / 1e12} TFLOP/s, memory "
          f"{peaks['bw'] / 1e12} TB/s", flush=True)

    t0 = time.perf_counter()
    report = deconv_kernel.build()
    print(f"[2] build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(sorted(set(SOURCES.values())))}: "
          f"{', '.join(k for k, _, _ in KERNELS)})", flush=True)
    for lib, rows in report.items():
        for r in rows:
            print(f"  {lib}: {demangle(r['kernel'])}: {r['registers']} "
                  f"registers, spill stores {r['spill_stores']} B, spill "
                  f"loads {r['spill_loads']} B", flush=True)

    print(f"[3] each kernel vs its plain version on the card (at "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    int8_nets = {cfg.name: int8_net(cfg) for cfg in TOWERS}
    dense, int8, sparse = phase_kernel_checks(int8_nets)

    phase_bit_identity(int8_nets)

    print(f"[4] serving (at {time.perf_counter() - t0:.1f} s)", flush=True)
    engines, launches = once_more_on_trace_loss("serving", phase_serving)

    print(f"[5] times (at {time.perf_counter() - t0:.1f} s)", flush=True)
    rows = phase_times(smi, peaks, int8_nets, report)
    phase_end_to_end(engines, smi)

    print(f"[6] async frontend (at {time.perf_counter() - t0:.1f} s)",
          flush=True)
    launches["frontend"] = once_more_on_trace_loss("frontend",
                                                   phase_frontend, smi)

    print(f"[7] refine (at {time.perf_counter() - t0:.1f} s)", flush=True)
    phase_refine(smi)

    print(f"[8] training (at {time.perf_counter() - t0:.1f} s)", flush=True)
    launches["train"] = once_more_on_trace_loss("training", phase_training,
                                                smi)

    print(f"[9] plan DRC (at {time.perf_counter() - t0:.1f} s)", flush=True)
    phase_drc(engines, smi)

    print(f"[10] mesh (at {time.perf_counter() - t0:.1f} s)", flush=True)
    launches["mesh"] = once_more_on_trace_loss("mesh", phase_mesh, engines,
                                               smi)
    print(f"[11] kernels line (at {time.perf_counter() - t0:.1f} s)",
          flush=True)

    print(json.dumps({"kernels": kernel_entries(rows, launches, dense, int8,
                                                sparse, smi)}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def kernel_entries(rows, launches, dense, int8, sparse, smi):
    """The kernels line: per kernel its traced launches over every serving
    path, its largest error against its plain version, and its times
    summed at bucket 64 (the generators' fp32 or int8 rows; bf16 and the
    zoo towers' rows under their own keys)."""
    errs = {"deconv2d_kernel": (max(dense[torch.float32]),
                                {"max_abs_err_bf16": max(dense[torch.bfloat16])}),
            "deconv2d_int8_kernel": (max(int8), {}),
            "deconv2d_sparse_kernel": (max(sparse[torch.float32]),
                                       {"max_abs_err_bf16":
                                        max(sparse[torch.bfloat16])})}
    gens, zoo = {c.name for c in NETS}, {c.name for c in ZOO}

    def at64(kname, nets, dtypes):
        return [r for r in rows if r["kernel"] == kname and r["bucket"] == 64
                and r["net"] in nets and r["dtype"] in dtypes]

    def sums(prefix, b64):
        lib = [r["library_ms"] for r in b64]
        return {f"{prefix}ms": sum(r["ms"] for r in b64),
                f"{prefix}plain_ms": sum(r["plain_call_ms"] for r in b64),
                f"{prefix}bound_ms": sum(r["bound_ms"] for r in b64),
                f"{prefix}library_ms": None if None in lib else sum(lib)}

    entries = []
    for kname, _, replaces in KERNELS:
        b64 = at64(kname, gens, ("float32", "int8"))
        by = {k: sum(r["bound_ms"] for r in b64 if r["bound_by"] == k)
              for k in ("operations", "bytes")}
        # traced on the device, over every path that runs one of its
        # instances
        by_path = {path: n for path, got in launches.items()
                   for (k, _), n in got.items() if k == kname}
        launched = sum(by_path.values())
        if launched == 0:
            raise AssertionError(f"the main path launched no {kname}")
        bf16 = at64(kname, gens, ("bfloat16",))
        entries.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": replaces, "launches": launched,
            "launches_by_path": by_path,
            "max_abs_err": errs[kname][0], **errs[kname][1],
            **sums("", b64),
            "bound_by": max(by, key=by.get),
            **({"bound_fp32_fma_ms": sum(r["bound_fp32_fma_ms"] for r in b64)}
               if "bound_fp32_fma_ms" in b64[0] else {}),
            "splits": [r["split"] for r in rows if r["kernel"] == kname
                       and "split" in r],
            **({"library_note": b64[0]["library_note"]}
               if "library_note" in b64[0] else {}),
            "times_are": "sum over every layer of both generators at bucket "
                         "64 (fp32, or int8 for B2)",
            **({"bf16_source": "src/repro_torch/csrc/deconv2d_tc.cu",
                **sums("bf16_", bf16)} if bf16 else {}),
            **sums("zoo_", at64(kname, zoo, ("float32", "int8"))),
            "ms_is_device_time": all(r["ms_is_device_time"] for r in rows
                                     if r["kernel"] == kname),
            "card": smi,
        })
    return entries


if __name__ == "__main__":
    sys.exit(main())
