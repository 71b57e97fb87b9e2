"""Pass 1 — plan design-rule check (DRC) over pinned execution plans,
against the H100.

The paper's FPGA toolchain proves DSP/BRAM/LUT budgets and timing
*before* a bitstream exists; a `plan.NetworkPlan` is this repo's
bitstream analogue.  This pass verifies a plan (in memory or pinned as
JSON) **without launching anything**, for the Hopper kernels of
``csrc/deconv2d_tc.cu``.  It keeps the JAX package's rule ids (one
renamed, for the card has no VMEM):

* ``drc.smem_budget``    — every resolved tile's dynamic shared memory
  (`core.tiling.kernel_smem_bytes` at the cluster split the launcher
  picks) fits the device's budget (`H100_SXM.onchip_bytes`, the
  kernel's ``KERNEL_MAX_SMEM``), and its block's threads fit
  ``KERNEL_MAX_THREADS``: the figures the kernel's own launch check
  compares (`launch_resources`);
* ``drc.tile_alignment`` — stride-aligned, positive tiles; the padded
  halo geometry resolvable and consistent; and the kernel's launch
  checks: stride and taps per phase within its limits, CI chunks a
  multiple of the dtype's mma k-step, the split within a cluster, padded
  extents tile multiples, and for int8 the channels the engine packs
  weights to (`int8.packed_ci_width`, `packed_width`) split into the
  tiles;
* ``drc.geometry_chain`` — layer i's output feeds layer i+1's input;
* ``drc.input_root``     — the tower's root and head match the plan's
  declared `repro_torch.workloads` entry;
* ``drc.scale_chain``    — the int8 requant chain: ``out_scale[i]`` is
  layer i+1's input scale, intermediates int8, the last layer f32;
* ``drc.sparse_digest``  — zero-skip schedule hashes match the tables
  and (given params) the weights that will be served;
* ``drc.bucket_mesh``    — per-layer batches agree with the network
  batch, batch tiles fit it, and the implied global bucket is in the
  engine's bucket set for its device count;
* ``drc.epilogue``       — fused activation / output-width legality;
* ``drc.roofline``       — modeled attainable throughput positive and
  the traffic model self-consistent;
* ``drc.backend``        — the backend/precision/dtype combination is
  one the port executes; a JAX package backend name ("pallas", ...) is
  an error whose fix is `NetworkPlan.for_hopper`;
* ``drc.schema``         — a JSON document that cannot be loaded
  reports as a violation instead of a traceback.

Entry points: `check_network_plan` (in-memory) and `check_plan_json`
(pinned artifact).  `DcnnServeEngine.from_config` runs
`check_network_plan` on a pinned plan before anything is planned,
prepared, built or captured, and rejects on ERROR with a typed
`PlanCheckError`: the launch check that would otherwise fail inside a
graph capture fails at load, with the rule-by-rule report.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

from ...core.dse import H100_SXM, Device
from ...core.offsets import make_phase_plan
from ...core.tiling import (CI_STEP, KERNEL_MAX_STRIDE, KERNEL_MAX_TAPS,
                            KERNEL_MAX_THREADS, halo_tile, kernel_smem_bytes,
                            launch_threads)
from .rules import CheckReport, PlanRuleViolation, Severity, rule

KNOWN_BACKENDS = ("cuda", "cuda_sparse", "reverse_loop", "cudnn")
TILED_BACKENDS = ("cuda", "cuda_sparse")
# the JAX package's backends: a plan pinned there runs here after
# `NetworkPlan.for_hopper` maps them and re-resolves the tiles
REFERENCE_BACKENDS = ("pallas", "pallas_sparse", "xla")
# the dtypes each backend has a kernel (or a plain formulation) for
BACKEND_DTYPES = {"cuda": ("float32", "bfloat16", "int8"),
                  "cuda_sparse": ("float32", "bfloat16"),
                  "reverse_loop": ("float32", "bfloat16"),
                  "cudnn": ("float32", "bfloat16")}
KNOWN_ACTIVATIONS = (None, "relu", "tanh")
_REL_TOL = 1e-9


def _close(a: float, b: float) -> bool:
    return math.isclose(a, b, rel_tol=_REL_TOL, abs_tol=0.0)


def _aligned_positive(layer) -> bool:
    t, s = layer.tiles, layer.geometry.stride
    return (all(isinstance(getattr(t, n), int) and getattr(t, n) >= 1
                for n in ("t_oh", "t_ow", "t_ci", "t_co", "t_n"))
            and t.t_oh % s == 0 and t.t_ow % s == 0)


def launch_channels(layer):
    """``(cip, cop)``: the padded channels of the engine's launch of a
    tiled layer: the tile multiples, or for int8 the channels its weights
    are packed to once (`int8.packed_ci_width`, `int8.packed_width`)."""
    g, t = layer.geometry, layer.tiles
    if layer.dtype == "int8":
        from ...kernels.deconv2d.int8 import packed_ci_width, packed_width

        return packed_ci_width(g.c_in), packed_width(g.c_out)
    return -(-g.c_in // t.t_ci) * t.t_ci, -(-g.c_out // t.t_co) * t.t_co


def launch_resources(layer) -> Dict[str, int]:
    """What the kernel's launch of one tiled layer needs: ``smem_bytes``
    (dynamic shared memory, `core.tiling.kernel_smem_bytes`), ``threads``
    (`launch_threads`) and ``split`` (the CI chunks' cluster split the
    launcher picks, `kernels.deconv2d.kernel.launch_split`), at the
    layer's batch, with the batch tile clamped to it and the channels of
    `launch_channels`.  On the card these equal what the launcher's
    parameter array and the library's ``deconv2d_tc_smem_bytes`` say for
    the same launch (``chip_smoke.py`` holds them equal)."""
    from ...kernels.deconv2d.kernel import launch_split

    g, t = layer.geometry, layer.tiles
    (_, _, ohp, owp, _, _, _, _, _, t_n, np_) = layer.padded_geometry()
    cip, cop = launch_channels(layer)
    split = launch_split(np_, cip, cop, ohp, owp, t.t_oh, t.t_ow, t.t_ci,
                         t.t_co, t_n)
    return {"smem_bytes": kernel_smem_bytes(
                g, t.t_oh, t.t_ow, t.t_ci, t.t_co, t_n=t_n, split=split,
                dtype=layer.dtype),
            "threads": launch_threads(g.stride, t.t_oh, t.t_ow, t.t_co, t_n),
            "split": split}


# ---------------------------------------------------------------------------
# per-rule checks (each returns a violation list; the registry gives them
# stable ids the mutation-fixture tests assert on)
# ---------------------------------------------------------------------------
@rule("drc.backend", "backend/precision/dtype combination is executable")
def check_backend(r, plan) -> List[PlanRuleViolation]:
    out: List[PlanRuleViolation] = []
    if plan.backend in REFERENCE_BACKENDS:
        out.append(r.violation(
            f"backend {plan.backend!r} is the JAX package's: its tiles were "
            "resolved for a TPU",
            fix_hint="map it with NetworkPlan.for_hopper(params) (params: "
                     "the pruned weights of a zero-skip plan)"))
    elif plan.backend not in KNOWN_BACKENDS:
        out.append(r.violation(
            f"unknown backend {plan.backend!r}",
            fix_hint=f"one of {KNOWN_BACKENDS}"))
    if plan.precision == "int8" and plan.backend != "cuda":
        out.append(r.violation(
            f"precision='int8' with backend={plan.backend!r}: only the "
            "dense kernel has a quantized variant",
            fix_hint="re-plan with backend='cuda' or precision='fp32'"))
    want_dtype = "int8" if plan.precision == "int8" else None
    for i, l in enumerate(plan.layers):
        if l.backend != plan.backend:
            out.append(r.violation(
                f"layer backend {l.backend!r} != network backend "
                f"{plan.backend!r}", layer=i,
                fix_hint="re-plan; layers cannot mix backends"))
        if want_dtype is not None and l.dtype != want_dtype:
            out.append(r.violation(
                f"int8 plan streams dtype {l.dtype!r}", layer=i,
                fix_hint="int8 chains stream int8 between layers"))
        elif want_dtype is None and l.dtype == "int8":
            out.append(r.violation(
                "fp32 plan streams int8", layer=i,
                fix_hint="re-plan at precision='int8'"))
        dtypes = BACKEND_DTYPES.get(l.backend)
        if dtypes is not None and l.dtype not in dtypes:
            out.append(r.violation(
                f"backend {l.backend!r} has no kernel for dtype "
                f"{l.dtype!r}", layer=i,
                fix_hint=f"{l.backend!r} runs {dtypes}"))
        if plan.backend in TILED_BACKENDS and l.tiles is None:
            out.append(r.violation(
                "tiled backend but no resolved TileChoice", layer=i,
                fix_hint="re-plan with autotune (or model) tiles"))
    return out


@rule("drc.smem_budget",
      "every resolved tile fits the device's shared memory and the "
      "kernel's threads per block")
def check_smem_budget(r, plan, device: Device = H100_SXM
                      ) -> List[PlanRuleViolation]:
    out: List[PlanRuleViolation] = []
    for i, l in enumerate(plan.layers):
        t = l.tiles
        if t is None or l.dtype not in CI_STEP or not _aligned_positive(l):
            continue  # drc.backend / drc.tile_alignment report these
        try:
            res = launch_resources(l)
        except Exception:
            continue  # unresolvable tiling: drc.tile_alignment reports it
        tile = f"({t.t_oh}x{t.t_ow}/{t.t_ci}/{t.t_co}/n{t.t_n})"
        if res["smem_bytes"] > device.onchip_bytes:
            out.append(r.violation(
                f"tile {tile} needs {res['smem_bytes']} B of shared memory "
                f"(split {res['split']}) against the {device.name} budget "
                f"of {device.onchip_bytes} B",
                layer=i,
                fix_hint="re-resolve the tiles for this card "
                         "(NetworkPlan.for_hopper or a re-plan); a tile "
                         "pinned for another part cannot launch here"))
        if res["threads"] > KERNEL_MAX_THREADS:
            out.append(r.violation(
                f"tile {tile} launches {res['threads']} threads per block; "
                f"the kernel takes at most {KERNEL_MAX_THREADS}", layer=i,
                fix_hint="re-resolve the tiles for this card"))
    return out


@rule("drc.tile_alignment",
      "tiles stride-aligned, positive, halo geometry resolvable and within "
      "the kernel's launch checks")
def check_tile_alignment(r, plan) -> List[PlanRuleViolation]:
    from ...kernels.autotune import MAX_SPLIT

    out: List[PlanRuleViolation] = []
    for i, l in enumerate(plan.layers):
        t = l.tiles
        if t is None:
            continue
        g = l.geometry
        for name in ("t_oh", "t_ow", "t_ci", "t_co", "t_n"):
            v = getattr(t, name)
            if not isinstance(v, int) or v < 1:
                out.append(r.violation(
                    f"{name}={v!r} is not a positive integer", layer=i,
                    fix_hint="re-plan; tile factors are positive ints"))
        if t.t_oh % g.stride or t.t_ow % g.stride:
            out.append(r.violation(
                f"spatial tile {t.t_oh}x{t.t_ow} is not stride-aligned "
                f"(S={g.stride}): the Eq. 5 constant-extent window (and "
                "uniform per-tile phase structure) requires S | T_OH",
                layer=i,
                fix_hint="round the spatial tile to a stride multiple"))
            continue  # padded_geometry asserts on misaligned tiles
        if not _aligned_positive(l):
            continue
        if g.stride > KERNEL_MAX_STRIDE:
            out.append(r.violation(
                f"stride {g.stride} > {KERNEL_MAX_STRIDE}, the kernel's "
                "largest", layer=i,
                fix_hint="serve this layer on 'cudnn' or 'reverse_loop'"))
        taps = max(len(v) for v in make_phase_plan(
            g.kernel, g.stride, g.padding).taps.values())
        if taps > KERNEL_MAX_TAPS:
            out.append(r.violation(
                f"{taps} taps per output phase; the kernel takes at most "
                f"{KERNEL_MAX_TAPS}", layer=i,
                fix_hint="serve this layer on 'cudnn' or 'reverse_loop'"))
        step = CI_STEP.get(l.dtype)
        if step is not None and t.t_ci % step:
            out.append(r.violation(
                f"t_ci={t.t_ci}: the {l.dtype} kernel takes CI chunks of a "
                f"multiple of {step} channels (one mma k-step)", layer=i,
                fix_hint="re-resolve the tiles for this dtype "
                         "(NetworkPlan.for_hopper)"))
        try:
            (oh, ow, ohp, owp, pad_l, pad_rh, pad_rw, cip, cop, t_n, np_
             ) = l.padded_geometry()
        except Exception as e:
            out.append(r.violation(
                f"padded_geometry() unresolvable: {e}", layer=i,
                fix_hint="the pinned tiles do not form a legal halo "
                         "grid for this geometry; re-plan"))
            continue
        if (oh, ow) != (g.out_h, g.out_w):
            out.append(r.violation(
                f"halo geometry disagrees with the layer geometry: "
                f"padded grid solves {oh}x{ow}, layer says "
                f"{g.out_h}x{g.out_w}", layer=i,
                fix_hint="geometry and tiles were pinned from different "
                         "configs; re-plan"))
        if ohp % t.t_oh or owp % t.t_ow:
            out.append(r.violation(
                f"padded output {ohp}x{owp} is not tiled exactly by "
                f"{t.t_oh}x{t.t_ow}", layer=i,
                fix_hint="re-plan; the grid must cover the padded output "
                         "in whole tiles"))
        if cip % t.t_ci or cop % t.t_co:
            out.append(r.violation(
                f"padded channels ({cip}, {cop}) not divisible by the "
                f"channel tiles ({t.t_ci}, {t.t_co})", layer=i,
                fix_hint="re-plan; channel padding must be tile-exact"))
        if pad_l < 0 or pad_rh < 0 or pad_rw < 0:
            out.append(r.violation(
                f"negative halo padding ({pad_l}, {pad_rh}, {pad_rw})",
                layer=i, fix_hint="re-plan against this geometry"))
        elif (pad_l + g.in_h + pad_rh < halo_tile(
                t.t_oh, g.kernel, g.stride, g.padding).min_padded_extent(
                    ohp // t.t_oh)
              or pad_l + g.in_w + pad_rw < halo_tile(
                t.t_ow, g.kernel, g.stride, g.padding).min_padded_extent(
                    owp // t.t_ow)):
            out.append(r.violation(
                "the padded input does not cover every tile's halo window",
                layer=i, fix_hint="re-plan against this geometry"))
        if l.dtype == "int8":
            pci, pco = launch_channels(l)
            if pci % t.t_ci or pco % t.t_co:
                out.append(r.violation(
                    f"int8 weights are packed once at ({pci}, {pco}) "
                    f"channels, which CI chunks of {t.t_ci} / CO tiles of "
                    f"{t.t_co} do not divide", layer=i,
                    fix_hint="re-resolve the int8 tiles (their CI chunks "
                             "divide int8.packed_ci_width)"))
        try:
            split = launch_resources(l)["split"]
        except Exception:
            continue
        if split > MAX_SPLIT:
            out.append(r.violation(
                f"cluster split {split} > {MAX_SPLIT}", layer=i,
                fix_hint="re-resolve the tiles for this card"))
    return out


@rule("drc.geometry_chain",
      "layer i's output feeds layer i+1's input exactly")
def check_geometry_chain(r, plan) -> List[PlanRuleViolation]:
    out: List[PlanRuleViolation] = []
    for i in range(len(plan.layers) - 1):
        g, nxt = plan.layers[i].geometry, plan.layers[i + 1].geometry
        if (g.out_h, g.out_w, g.c_out) != (nxt.in_h, nxt.in_w, nxt.c_in):
            out.append(r.violation(
                f"layer {i} emits {g.out_h}x{g.out_w}x{g.c_out} but "
                f"layer {i + 1} expects {nxt.in_h}x{nxt.in_w}x{nxt.c_in}",
                layer=i + 1,
                fix_hint="the layer list was edited after pinning; "
                         "re-plan from the network config"))
    return out


@rule("drc.input_root",
      "tower root/head geometry matches the plan's declared workload")
def check_input_root(r, plan) -> List[PlanRuleViolation]:
    """Image-rooted towers (SR heads, denoising decoders) enter at
    in_hw x in_hw x in_c rather than the WGAN 1x1 latent root; this rule
    pins the first layer's input and the last layer's output to whatever
    the plan's registered workload declares, so a plan relabeled or
    spliced across workloads fails offline instead of reshaping wrong."""
    out: List[PlanRuleViolation] = []
    if not plan.layers:
        return [r.violation("plan has no layers",
                            fix_hint="re-plan from the network config")]
    g0 = plan.layers[0].geometry
    if g0.in_h != g0.in_w or g0.in_h < 1:
        out.append(r.violation(
            f"tower root is {g0.in_h}x{g0.in_w}: roots are square "
            "(1x1 latent or in_hw x in_hw image)", layer=0,
            fix_hint="re-plan from the network config"))
    wname = getattr(plan, "workload", None)
    if wname is None:
        return out  # legacy plan: no declared workload to check against
    try:
        from ...workloads import get as get_workload
        cfg = get_workload(wname).cfg
    except Exception:
        # the registry is open (third-party towers register at runtime);
        # an id this process doesn't know is not provably wrong
        return out
    root = (cfg.in_hw, cfg.in_hw, cfg.in_c)
    if (g0.in_h, g0.in_w, g0.c_in) != root:
        out.append(r.violation(
            f"first layer consumes {g0.in_h}x{g0.in_w}x{g0.c_in} but "
            f"workload {wname!r} declares the input root "
            f"{root[0]}x{root[1]}x{root[2]}", layer=0,
            fix_hint="the plan was edited or relabeled after pinning; "
                     "re-plan from the workload's config"))
    gl = plan.layers[-1].geometry
    head = (cfg.img_hw, cfg.img_hw, cfg.img_c)
    if (gl.out_h, gl.out_w, gl.c_out) != head:
        out.append(r.violation(
            f"last layer emits {gl.out_h}x{gl.out_w}x{gl.c_out} but "
            f"workload {wname!r} declares the output head "
            f"{head[0]}x{head[1]}x{head[2]}",
            layer=len(plan.layers) - 1,
            fix_hint="the plan was edited or relabeled after pinning; "
                     "re-plan from the workload's config"))
    return out


@rule("drc.scale_chain",
      "int8 requant chain: out_scale[i] == input scale of layer i+1")
def check_scale_chain(r, plan) -> List[PlanRuleViolation]:
    out: List[PlanRuleViolation] = []
    layers = plan.layers
    if plan.precision != "int8":
        for i, l in enumerate(layers):
            if l.quant is not None or l.out_scale is not None:
                out.append(r.violation(
                    f"fp32 plan carries quantization state "
                    f"(quant={l.quant is not None}, "
                    f"out_scale={l.out_scale})", layer=i,
                    fix_hint="re-plan at precision='int8' or drop the "
                             "stale scales"))
        return out
    last = len(layers) - 1
    for i, l in enumerate(layers):
        if l.quant is None:
            out.append(r.violation(
                "int8 layer has no calibrated LayerQuant scales",
                layer=i, fix_hint="re-calibrate and re-plan"))
            continue
        if i < last:
            nxt = layers[i + 1].quant
            if l.out_scale is None:
                out.append(r.violation(
                    "intermediate int8 layer has no requant out_scale: "
                    "its epilogue could not re-quantize into the next "
                    "layer's range", layer=i,
                    fix_hint="re-plan; out_scale must be layer "
                             f"{i + 1}'s input scale"))
            elif nxt is not None and not _close(l.out_scale, nxt.x_scale):
                out.append(r.violation(
                    f"requant chain broken: layer {i} re-quantizes at "
                    f"out_scale={l.out_scale!r} but layer {i + 1} was "
                    f"calibrated for x_scale={nxt.x_scale!r} — the "
                    "served images would be silently wrong", layer=i,
                    fix_hint="the plan mixes two calibrations; re-plan "
                             "from one QuantConfig"))
            if l.out_dtype_bytes is not None:
                out.append(r.violation(
                    f"intermediate int8 layer widens its output to "
                    f"{l.out_dtype_bytes} B: activations must stay int8 "
                    "in device memory between layers", layer=i,
                    fix_hint="only the last layer emits f32 "
                             "(out_dtype_bytes=4)"))
        else:
            if l.out_scale is not None:
                out.append(r.violation(
                    f"last int8 layer has out_scale={l.out_scale!r}: "
                    "there is no next layer to re-quantize into",
                    layer=i, fix_hint="the final epilogue dequantizes "
                                      "to f32; out_scale must be None"))
            if l.out_dtype_bytes != 4:
                out.append(r.violation(
                    f"last int8 layer emits out_dtype_bytes="
                    f"{l.out_dtype_bytes!r}; the chain's final epilogue "
                    "writes f32 images (4 B)", layer=i,
                    fix_hint="re-plan; tiles priced for the wrong output "
                             "width are also stale"))
    return out


@rule("drc.sparse_digest",
      "zero-skip schedule digests match tables and served weights")
def check_sparse_digest(r, plan, params=None) -> List[PlanRuleViolation]:
    out: List[PlanRuleViolation] = []
    if plan.backend != "cuda_sparse":
        return out
    from ...plan.deconv_plan import _sparse_digest
    from ...plan.network_plan import _weights

    for i, l in enumerate(plan.layers):
        if l.sparse_digest is None:
            out.append(r.violation(
                "cuda_sparse layer has no pinned schedule digest: "
                "staleness against the served weights is unverifiable",
                layer=i, severity=Severity.WARNING,
                fix_hint="re-plan with the pruned weights so the "
                         "schedule is content-hashed"))
            continue
        if l.sparse_tables is not None:
            got = _sparse_digest(l.sparse_tables)
            if got != l.sparse_digest:
                out.append(r.violation(
                    f"serialized zero-skip tables hash to {got} but the "
                    f"plan pinned {l.sparse_digest}", layer=i,
                    fix_hint="the tables were edited after pinning; "
                             "re-plan from the weights"))
        if params is not None and l.tiles is not None:
            from ...kernels.deconv2d_sparse import make_sparse_plan

            g = l.geometry
            want = _sparse_digest(make_sparse_plan(
                _weights(params, i), g.stride, g.padding, l.tiles.t_ci,
                l.tiles.t_co))
            if want != l.sparse_digest:
                out.append(r.violation(
                    f"pinned schedule ({l.sparse_digest}) does not match "
                    f"the schedule of the weights being served ({want}): "
                    "a stale schedule silently skips now-nonzero blocks",
                    layer=i,
                    fix_hint="the checkpoint was re-pruned after the "
                             "plan was pinned; re-plan against it"))
    return out


@rule("drc.bucket_mesh",
      "batches consistent across layers and aligned to the mesh")
def check_bucket_mesh(r, plan, n_devices: int = 1,
                      buckets: Optional[Sequence[int]] = None
                      ) -> List[PlanRuleViolation]:
    out: List[PlanRuleViolation] = []
    if plan.batch < 1:
        out.append(r.violation(
            f"network batch {plan.batch} is not positive",
            fix_hint="plans are fitted to a concrete serving bucket"))
        return out
    for i, l in enumerate(plan.layers):
        if l.batch != plan.batch:
            out.append(r.violation(
                f"layer batch {l.batch} != network batch {plan.batch}: "
                "the layer's tiles were fitted to a different bucket",
                layer=i, fix_hint="re-plan; all layers of one plan "
                                  "serve one per-device sub-batch"))
        if l.tiles is not None and l.tiles.t_n > l.batch:
            out.append(r.violation(
                f"batch tile t_n={l.tiles.t_n} exceeds the layer batch "
                f"{l.batch}: the tiles were scored with rows the clamped "
                "kernel can never fill", layer=i,
                fix_hint="re-plan; the autotuner never emits t_n > "
                         "batch, so this plan was edited or corrupted"))
    if n_devices > 1:
        bucket = plan.batch * n_devices
        if buckets is not None and bucket not in tuple(buckets):
            out.append(r.violation(
                f"per-device batch {plan.batch} x {n_devices} device(s) "
                f"implies global bucket {bucket}, which is not in the "
                f"engine bucket set {tuple(buckets)}",
                fix_hint="re-plan for a shard-aligned bucket "
                         "(shard_aligned_buckets rounds buckets to "
                         "device-count multiples)"))
    return out


@rule("drc.epilogue", "fused epilogue activation/width legality")
def check_epilogue(r, plan) -> List[PlanRuleViolation]:
    out: List[PlanRuleViolation] = []
    for i, l in enumerate(plan.layers):
        if l.activation not in KNOWN_ACTIVATIONS:
            out.append(r.violation(
                f"unknown fused activation {l.activation!r}", layer=i,
                fix_hint=f"kernels implement {KNOWN_ACTIVATIONS}"))
        if l.out_dtype_bytes not in (None, 1, 2, 4):
            out.append(r.violation(
                f"out_dtype_bytes={l.out_dtype_bytes!r} is not a "
                "supported epilogue width", layer=i,
                fix_hint="None (same as stream) or 1/2/4 bytes"))
    return out


@rule("drc.roofline",
      "modeled attainable throughput positive, traffic self-consistent")
def check_roofline(r, plan, device: Device = H100_SXM
                   ) -> List[PlanRuleViolation]:
    out: List[PlanRuleViolation] = []
    try:
        points = plan.modeled_attainable(device)
        traffic = plan.traffic_report()
    except Exception as e:
        return [r.violation(
            f"roofline/traffic model unevaluable: {e}",
            fix_hint="the pinned tiles do not form a modelable grid; "
                     "re-plan")]
    for i, pt in points.items():
        if not (pt.attainable_ops > 0.0 and math.isfinite(
                pt.attainable_ops)):
            out.append(r.violation(
                f"modeled attainable throughput is "
                f"{pt.attainable_ops!r} ops/s", layer=i,
                fix_hint="a zero/NaN roofline means degenerate tiles or "
                         "geometry; re-plan"))
        if pt.ctc <= 0.0 or not math.isfinite(pt.ctc):
            out.append(r.violation(
                f"computation-to-communication ratio is {pt.ctc!r}",
                layer=i, fix_hint="traffic model degenerate; re-plan"))
    for i, t in traffic.items():
        parts = t.n_tiles * (t.n_ci_steps * (t.in_bytes_per_tile
                                             + t.w_bytes_per_tile)
                             + t.out_bytes_per_tile)
        if t.total_bytes != parts:
            out.append(r.violation(
                f"traffic estimate inconsistent: total_bytes="
                f"{t.total_bytes} but components sum to {parts}",
                layer=i, fix_hint="model drift between plan fields; "
                                  "re-plan with this code version"))
        if min(t.n_tiles, t.n_ci_steps, t.in_bytes_per_tile,
               t.w_bytes_per_tile, t.out_bytes_per_tile) <= 0:
            out.append(r.violation(
                "traffic estimate has non-positive components", layer=i,
                fix_hint="re-plan; every tile moves some bytes"))
    return out


# the schema rule never runs over a live plan — it exists so an unloadable
# JSON document reports through the same chassis as every other violation
@rule("drc.schema", "pinned plan JSON loads under the current schema")
def check_schema(r, error: Exception,
                 location: Optional[str] = None) -> List[PlanRuleViolation]:
    return [r.violation(
        f"plan document rejected at load: {error}", location=location,
        fix_hint="re-pin the plan with this code version (stale schema "
                 "or post-pinning edits are never executed)")]


PLAN_RULES = ("drc.backend", "drc.smem_budget", "drc.tile_alignment",
              "drc.geometry_chain", "drc.input_root", "drc.scale_chain",
              "drc.sparse_digest", "drc.bucket_mesh", "drc.epilogue",
              "drc.roofline")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def check_network_plan(
    plan,
    *,
    device: Device = H100_SXM,
    n_devices: int = 1,
    buckets: Optional[Sequence[int]] = None,
    params: Optional[Dict[str, Any]] = None,
    name: Optional[str] = None,
) -> CheckReport:
    """Run every plan DRC rule over a `plan.NetworkPlan`.

    ``device`` sets the shared-memory budget and the roofline constants;
    ``n_devices`` and ``buckets`` enable the mesh-alignment rule (the
    serving engine passes its own); ``params`` enables the
    weights-vs-digest staleness check of a zero-skip plan.  Nothing is
    launched or built."""
    report = CheckReport(name or f"plan-drc:{plan.name}")
    report.extend(check_backend(plan))
    report.extend(check_smem_budget(plan, device))
    report.extend(check_tile_alignment(plan))
    report.extend(check_geometry_chain(plan))
    report.extend(check_input_root(plan))
    report.extend(check_scale_chain(plan))
    report.extend(check_sparse_digest(plan, params))
    report.extend(check_bucket_mesh(plan, n_devices, buckets))
    report.extend(check_epilogue(plan))
    report.extend(check_roofline(plan, device))
    report.rules_run += list(PLAN_RULES)
    return report


def check_plan_json(path: str, **kwargs) -> CheckReport:
    """DRC a pinned plan artifact.  A document that cannot load (stale
    schema, tampered content hash, not a plan) reports as a
    ``drc.schema`` violation instead of raising; the CLI and the example
    script print rule-by-rule either way."""
    from ...plan import NetworkPlan
    from ...plan.deconv_plan import PlanSchemaError

    try:
        plan = NetworkPlan.load(path)
    except (OSError, PlanSchemaError, KeyError, TypeError,
            ValueError) as e:
        report = CheckReport(f"plan-drc:{path}")
        report.extend(check_schema(e, location=path))
        report.rules_run.append("drc.schema")
        return report
    return check_network_plan(plan, name=f"plan-drc:{path}", **kwargs)
