"""Dry run of every (arch x input-shape x mesh) cell at production scale:
the counterpart of the JAX package's ``repro.launch.dryrun``.

Usage:
    python -m repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k --mesh pod
    python -m repro_torch.launch.dryrun --all [--mesh both] [--out experiments/dryrun_torch]
    python -m repro_torch.launch.dryrun --report --out experiments/dryrun_torch

Each cell builds the production mesh over a fake world of 256 (pod) or
512 (multipod) ranks in this one process (`launch.mesh.
make_production_mesh`), places fake params and inputs on it
(`launch.steps.lower_cell`) and runs rank 0's step under the counter
(`analysis.cost.analyze`): per-device FLOPs, bytes, collectives, op count
and peak bytes, counted on fake tensors, not measured.  Nothing runs on a
device, by design, as the reference's dry run compiles for placeholder
host devices.  Every cell writes a JSON record; a failure (a placement
DTensor cannot propagate, an op the fake tensors refuse) is recorded,
and the sweep exits 1.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import time
import traceback


def _trace_sha1(cost) -> str:
    """A digest of what the counter saw: a cell whose op sequence, shapes
    or placements change counts differently, and its digest changes."""
    key = json.dumps([cost.flops, cost.bytes_accessed, cost.n_ops,
                      sorted(cost.collectives.items()), cost.peak_bytes,
                      sorted(cost.kernels.items())])
    return hashlib.sha1(key.encode()).hexdigest()[:12]


def run_cell(arch: str, shape: str, mesh_kind: str, out_dir: str,
             policy: str = "auto", grad_accum=None) -> dict:
    from ..analysis.cost import analyze
    from ..analysis.roofline import model_flops
    from ..configs import LM_CONFIGS, SHAPES, shape_applicable
    from .mesh import make_production_mesh
    from .steps import lower_cell

    cfg = LM_CONFIGS[arch]
    suite = SHAPES[shape]
    skip = shape_applicable(cfg, suite)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind, "policy": policy}
    if skip is not None:
        rec.update(status="skipped", reason=skip)
        return _write(rec, out_dir)

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"))
    rec["chips"] = mesh.device_mesh.size()
    try:
        t0 = time.time()
        cell = lower_cell(cfg, suite, mesh, policy=policy,
                          grad_accum=grad_accum)
        t1 = time.time()
        cost = analyze(cell.fn, *cell.args, fake_mode=cell.fake_mode)
        t2 = time.time()
        rec.update(
            status="ok",
            lower_s=round(t1 - t0, 2),
            count_s=round(t2 - t1, 2),
            grad_accum=cell.grad_accum,
            # per-device counts on fake tensors (analysis/cost.py)
            flops_per_device=cost.flops,
            bytes_per_device=cost.bytes_accessed,
            collective_bytes_per_device=cost.collective_bytes,
            collectives={k: [v[0], v[1]] for k, v in cost.collectives.items()},
            link_bytes=cost.link_bytes,
            n_ops=cost.n_ops,
            memory_analysis={
                "argument_size_in_bytes": int(cost.argument_bytes),
                "output_size_in_bytes": int(cost.output_bytes),
                "temp_size_in_bytes": int(max(
                    cost.peak_bytes - cost.output_bytes, 0)),
            },
            peak_bytes=cost.peak_bytes,
            model_flops=model_flops(cfg, suite),
            trace_sha1=_trace_sha1(cost),
        )
        print(f"[{arch} x {shape} x {mesh_kind}] memory_analysis:",
              rec["memory_analysis"])
        print(f"[{arch} x {shape} x {mesh_kind}] flops/dev="
              f"{rec['flops_per_device']:.3e} bytes/dev="
              f"{rec['bytes_per_device']:.3e} coll_bytes/dev="
              f"{rec['collective_bytes_per_device']:.3e} "
              f"n_ops={rec['n_ops']} model/counted="
              f"{roofline_of(rec).useful_flops_ratio:.3f}")
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec.update(status="error", error=f"{type(e).__name__}: {e}"[:2000],
                   traceback=traceback.format_exc()[-2000:])
        print(f"[{arch} x {shape} x {mesh_kind}] FAILED: {rec['error'][:500]}")
    return _write(rec, out_dir)


def roofline_of(rec: dict):
    """The `analysis.roofline.Roofline` of an ``ok`` record."""
    from ..analysis.roofline import Roofline

    return Roofline(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        chips=rec["chips"], flops_per_device=rec["flops_per_device"],
        bytes_per_device=rec["bytes_per_device"],
        collective_bytes_per_device=rec["collective_bytes_per_device"],
        collectives={k: tuple(v) for k, v in rec["collectives"].items()},
        peak_bytes_per_device=rec["peak_bytes"],
        model_flops_global=rec["model_flops"],
        link_bytes=rec.get("link_bytes"))


def report(out_dir: str) -> str:
    """A markdown table of the records under ``out_dir``: per cell its
    per-device counts, the GiB a card holds at its peak (arguments plus
    the storages made during the step) and its roofline's bottleneck."""
    rows = ["| arch | shape | mesh | FLOPs/dev | bytes/dev | coll bytes/dev"
            " | ops/dev | peak GiB/card | bound s | bottleneck |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for name in sorted(os.listdir(out_dir)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(out_dir, name)) as f:
            rec = json.load(f)
        head = f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} |"
        if rec["status"] != "ok":
            rows.append(f"{head} {rec['status']} | | | | | | |")
            continue
        r = roofline_of(rec)
        mem = rec["memory_analysis"]["argument_size_in_bytes"]
        rows.append(
            f"{head} {rec['flops_per_device']:.3e} | "
            f"{rec['bytes_per_device']:.3e} | "
            f"{rec['collective_bytes_per_device']:.3e} | {rec['n_ops']} | "
            f"{(mem + rec['peak_bytes']) / 2**30:.1f} | "
            f"{r.step_time_bound:.3g} | {r.bottleneck} |")
    return "\n".join(rows)


def _write(rec: dict, out_dir: str) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--policy", default="auto")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--report", action="store_true",
                    help="print the table of the records under --out")
    args = ap.parse_args(argv)
    if args.report:
        print(report(args.out))
        return

    from ..configs import LM_CONFIGS, SHAPES

    archs = list(LM_CONFIGS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    n_ok = n_skip = n_err = 0
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                path = os.path.join(
                    args.out, f"{arch}__{shape}__{mesh_kind}.json")
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        st = json.load(f).get("status")
                    if st in ("ok", "skipped"):
                        continue
                rec = run_cell(arch, shape, mesh_kind, args.out, args.policy)
                st = rec["status"]
                n_ok += st == "ok"
                n_skip += st == "skipped"
                n_err += st == "error"
    print(f"dryrun complete: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
