"""Hill-climb A/B harness: the counted cost of baseline-vs-variant cells
on the production mesh (the counterpart of the JAX package's
``repro.launch.hillclimb``).

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --out experiments/hillclimb_torch
    PYTHONPATH=src python -m repro_torch.launch.hillclimb --only h0

Cells:
  H0  the paper's own workload: the CelebA generator at global batch 4096,
      the batch sharded over ``data`` (256 rows a device), through the
      zero-insertion formulation (``cudnn``, ``F.conv_transpose2d``), the
      reverse loop in plain PyTorch (``reverse_loop``) and the reverse-loop
      kernel B1 (``cuda``).
  H1  qwen2-moe-a2.7b x prefill_32k: the MoE dispatch at capacity factors
      1.0, 1.25 (the config's) and 2.0.
  H2  deepseek-7b x decode_32k: bf16 KV cache vs int8 KV with dequant on
      read.
  H3  deepseek-7b x train_4k: fsdp_tp vs tp, and grad accumulation 4 / 16
      under tp.

Every figure is counted on fake tensors over a fake world of 256 ranks
(`launch.mesh.make_production_mesh`), per device: nothing runs on a
device.  `dcnn_program` is H0's per-device program, which
``chip_smoke.py`` also runs on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time


def _write(rec: dict, out_dir: str, tag: str) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{tag}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def measure(cfg, shape, mesh, tag, out_dir, policy="auto", grad_accum=None):
    from ..analysis.cost import analyze
    from ..analysis.roofline import model_flops
    from ..configs import SHAPES
    from .steps import lower_cell

    suite = SHAPES[shape]
    t0 = time.time()
    cell = lower_cell(cfg, suite, mesh, policy=policy, grad_accum=grad_accum)
    c = analyze(cell.fn, *cell.args, fake_mode=cell.fake_mode)
    rec = {
        "tag": tag, "arch": cfg.name, "shape": shape, "policy": cell.policy,
        "grad_accum": cell.grad_accum,
        "count_s": round(time.time() - t0, 1),
        "flops_per_device": c.flops,
        "bytes_per_device": c.bytes_accessed,
        "collective_bytes_per_device": c.collective_bytes,
        "collectives": {k: list(v) for k, v in c.collectives.items()},
        "n_ops": c.n_ops,
        "temp_gb": max(c.peak_bytes - c.output_bytes, 0) / 1e9,
        "args_gb": c.argument_bytes / 1e9,
        "model_flops": model_flops(cfg, suite),
    }
    print(f"{tag:40s} flops/dev={c.flops:.3e} bytes/dev="
          f"{c.bytes_accessed:.3e} coll/dev={c.collective_bytes:.3e} "
          f"n_ops={c.n_ops} temp={rec['temp_gb']:.1f}GB")
    return _write(rec, out_dir, tag)


def dcnn_program(backend: str, rows: int, device="cpu", fake_mode=None,
                 seed: int = 0):
    """``(fn, (params, z))``: the CelebA generator's per-device program,
    ``fn(params, z)`` on ``rows`` latents through ``backend``, with seeded
    params and z on ``device`` (fake under ``fake_mode``)."""
    import contextlib

    import torch

    from ..models.dcnn import CELEBA_DCNN, generator_apply, generator_init

    cfg = CELEBA_DCNN
    with fake_mode if fake_mode is not None else contextlib.nullcontext():
        gen = torch.Generator(device=device).manual_seed(seed)
        params = generator_init(gen, cfg, device)
        z = torch.randn((rows, cfg.z_dim), generator=gen, device=device)

    @torch.no_grad()
    def fn(params, z):
        return generator_apply(params, cfg, z, backend=backend)

    return fn, (params, z)


def dcnn_model_flops(rows: int) -> float:
    """The generator's useful work on ``rows`` images: the layer
    geometries' ``ops`` (2 per MAC), as the reference counts it."""
    from ..models.dcnn import CELEBA_DCNN

    return float(sum(g.ops for g in CELEBA_DCNN.geometries()) * rows)


def measure_dcnn(backend: str, tag: str, out_dir: str, mesh,
                 global_batch: int = 4096):
    """H0, the paper's own workload at pod scale: batched DCNN inference,
    each device running its batch shard through ``backend`` (the params
    replicate; no collective), the counted FLOPs against the useful
    work."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..analysis.cost import analyze

    dp = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    chips = dp * mesh.shape.get("model", 1)
    rows = global_batch // dp
    fake_mode = FakeTensorMode()
    t0 = time.time()
    fn, args = dcnn_program(backend, rows, fake_mode=fake_mode)
    c = analyze(fn, *args, fake_mode=fake_mode)
    ops = dcnn_model_flops(global_batch)
    rec = {
        "tag": tag, "arch": "dcnn-celeba", "backend": backend,
        "global_batch": global_batch, "rows_per_device": rows,
        "count_s": round(time.time() - t0, 1),
        "flops_per_device": c.flops,
        "bytes_per_device": c.bytes_accessed,
        "collective_bytes_per_device": c.collective_bytes,
        "n_ops": c.n_ops, "kernels": c.kernels,
        "model_flops": ops,
        "useful_ratio": ops / max(c.flops * chips, 1),
    }
    print(f"{tag:40s} flops/dev={c.flops:.3e} bytes/dev="
          f"{c.bytes_accessed:.3e} n_ops={c.n_ops} "
          f"useful={rec['useful_ratio']:.3f}")
    return _write(rec, out_dir, tag)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="experiments/hillclimb_torch")
    ap.add_argument("--only", default=None, help="h0|h1|h2|h3")
    args = ap.parse_args(argv)

    from ..configs import LM_CONFIGS
    from .mesh import make_production_mesh

    mesh = make_production_mesh()

    if args.only in (None, "h0"):
        # H0: the paper's technique itself at pod scale
        for backend in ("cudnn", "reverse_loop", "cuda"):
            measure_dcnn(backend, f"h0_dcnn_serve_{backend}", args.out, mesh)

    if args.only in (None, "h2"):
        # H2: int8 KV cache on deepseek decode
        base = LM_CONFIGS["deepseek-7b"]
        measure(dataclasses.replace(base, kv_quant=False),
                "decode_32k", mesh, "h2_decode_bf16kv_baseline", args.out)
        measure(dataclasses.replace(base, kv_quant=True),
                "decode_32k", mesh, "h2_decode_int8kv", args.out)

    if args.only in (None, "h3"):
        # H3: fsdp_tp vs tp on deepseek train
        base = LM_CONFIGS["deepseek-7b"]
        measure(base, "train_4k", mesh, "h3_train_fsdp_baseline", args.out,
                policy="fsdp_tp")
        measure(base, "train_4k", mesh, "h3_train_tp", args.out, policy="tp")
        measure(base, "train_4k", mesh, "h3_train_tp_ga4", args.out,
                policy="tp", grad_accum=4)
        measure(base, "train_4k", mesh, "h3_train_tp_ga16", args.out,
                policy="tp", grad_accum=16)

    if args.only in (None, "h1"):
        # H1: MoE prefill, the dispatch's capacity factor
        base = LM_CONFIGS["qwen2-moe-a2.7b"]
        measure(base, "prefill_32k", mesh, "h1_moe_prefill_current", args.out)
        measure(dataclasses.replace(base, moe_capacity_factor=1.0),
                "prefill_32k", mesh, "h1_moe_prefill_cf1.0", args.out)
        measure(dataclasses.replace(base, moe_capacity_factor=2.0),
                "prefill_32k", mesh, "h1_moe_prefill_cf2.0", args.out)


if __name__ == "__main__":
    main()
