"""Workload-zoo walkthrough on the PyTorch/CUDA port: train a
super-resolution head, pin its plan, design-rule-check it, and serve it
(the counterpart of examples/serve_sr.py).

    PYTHONPATH=src python examples/serve_sr_torch.py [--workload sr]
        [--steps 20] [--batch 8] [--plan-json sr_plan.json] [--device cuda]

`SupervisedTrainer` with ``backend="cuda"`` trains through the same
`build_network_plan` executables the serving engine runs (the B1 kernel
in the forward on the card; its plain version with ``--device cpu``), so
the plan pinned from training is the plan serving checks and loads.  The
script

  1. trains the registered workload for a few masked-MSE steps,
  2. writes the trainer's largest-bucket `NetworkPlan` to JSON,
  3. runs the static plan DRC on the document (exit 2 on a violation),
  4. serves one batch through `DcnnServeEngine` pinned to that plan,
  5. checks the served images against the reverse-loop reference (within
     1e-4) and the trainer's plan hash against the engine's (exit 1 on
     either mismatch).
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import repro_torch.workloads as workloads  # noqa: E402
from repro_torch.analysis.check import check_plan_json  # noqa: E402
from repro_torch.kernels.deconv2d import kernel as deconv_kernel  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.plan import NetworkPlan  # noqa: E402
from repro_torch.serve import DcnnServeEngine, EngineConfig  # noqa: E402
from repro_torch.train import train_supervised  # noqa: E402

SERVE_TOL = 1e-4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="sr", metavar="NAME",
                    help="a registered supervised workload "
                         f"({', '.join(workloads.names())})")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--plan-json", default="sr_plan.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA device; pass --device cpu to run on the CPU")
        return 2

    try:
        w = workloads.get(args.workload)
    except workloads.WorkloadError as e:
        print(e)
        return 2
    if w.kind != "supervised":
        print(f"workload {w.name!r} is {w.kind}, not supervised; use "
              "examples/serve_dcnn_torch.py / train_wgan_mnist_torch.py")
        return 2

    # 1. train on the kernel's plan path (the serving executables)
    params, trainer, history = train_supervised(
        w, args.steps, 0, AdamW(lr=1e-3), batch=args.batch, backend="cuda",
        device=args.device)
    print(f"{w.name}: trained {args.steps} steps, "
          f"loss {history[0]['loss']:.4f} -> {history[-1]['loss']:.4f} "
          f"({trainer.total_builds} builds)")

    # 2. pin the largest bucket's plan as the deployment artifact
    bucket = max(trainer.plans)
    plan = trainer.plans[bucket]
    plan.to_json(args.plan_json)
    print(f"pinned plan {plan.stable_hash()} -> {args.plan_json}")

    # 3. static design-rule check before anything serves it
    report = check_plan_json(args.plan_json)
    if not report.ok():
        print(f"pinned plan {args.plan_json} failed design-rule check:")
        print(report.render())
        return 2
    print(f"DRC clean ({len(report.rules_run)} rules, incl. "
          "drc.input_root on the image-rooted tower)")

    # 4. serve one batch through the engine pinned to the same plan
    pinned = NetworkPlan.load(args.plan_json)
    eng = DcnnServeEngine.from_config(
        EngineConfig(model=w.name, backend="cuda", precision="fp32",
                     max_batch=bucket, warmup=True, calib_batch=16,
                     device=args.device),
        params, plan=pinned)
    x, _y = w.training_pairs(123, args.batch)
    x = np.asarray(x, np.float32)
    out = eng.collect(eng.submit(x))

    # 5. served output against the reverse-loop reference, hashes equal
    with torch.no_grad():
        ref = w.ref(params, torch.from_numpy(x).to(eng.device)).cpu().numpy()
    err = float(np.max(np.abs(np.asarray(out) - ref)))
    trained = trainer.plan_fingerprints()[bucket]
    served = eng.plans[bucket].stable_hash()
    print(f"served {out.shape} via plan {served} "
          f"(trainer pinned {trained}); max|serve - ref| = {err:.2e}")
    print(f"plan hashes: trainer {trained} engine {served}")
    print(f"B1 launches: {deconv_kernel.LAUNCHES} by its wrapper, "
          f"{sum(eng.launch_counts.values())} in the engine's dispatches")
    if served != trained:
        print("plan fingerprint mismatch between training and serving")
        return 1
    if not err <= SERVE_TOL:
        print("served output diverged from the reverse-loop reference")
        return 1
    print("ok: train -> pin -> DRC -> serve round trip holds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
