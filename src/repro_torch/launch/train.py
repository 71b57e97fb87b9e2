"""LM training launcher (the JAX package's ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \
        --reduced --steps 100 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

Draws the model from ``--seed`` on ``--device`` ("cuda" unless the caller
asks for "cpu"; a missing card exits 2), trains it with AdamW on a
warmup-cosine schedule over the step-indexed synthetic token source
through `train.TrainDriver`, and checkpoints ``(params, opt_state, ef)``
(``ef`` None without ``--compress-grads``) every ``--ckpt-every`` steps and
at the end; a run with the same ``--ckpt-dir`` resumes from the newest
valid checkpoint.  Prints each step's loss, its time, how many param
leaves moved (and the paths of those that did not: a bf16 norm scale of 1
stays put under a first step of ~lr, below half its ulp) and, on a card,
``max_memory_allocated``.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import torch

from ..configs import LM_CONFIGS, reduced_config
from ..core.tree import tree_leaves, tree_paths
from ..data.pipeline import lm_source
from ..models.nn import tree_size
from ..models.transformer import init_lm
from ..optim.compression import init_error_feedback
from ..optim.optimizer import AdamW
from ..optim.schedule import warmup_cosine
from ..train.lm import make_train_step
from ..train.loop import TrainDriver


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="family-faithful reduced config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def _fingerprint(params) -> torch.Tensor:
    """Each leaf's sum in float64: a leaf moved iff its sum changed."""
    return torch.stack([torch.sum(l, dtype=torch.float64)
                        for l in tree_leaves(params)]).cpu()


def run(args: argparse.Namespace):
    """Train as ``args`` say; returns (the final (params, opt_state, ef),
    the driver)."""
    device = torch.device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else LM_CONFIGS[args.arch]
    print(f"arch={cfg.name} params≈{cfg.param_count() / 1e6:.1f}M "
          f"(full-config count; reduced={args.reduced})", flush=True)

    t0 = time.perf_counter()
    params = init_lm(torch.Generator(device).manual_seed(args.seed), cfg)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"instantiated params: {tree_size(params) / 1e6:.2f}M on "
          f"{device} in {time.perf_counter() - t0:.2f} s", flush=True)

    opt = AdamW(lr=warmup_cosine(3e-4, 20, args.steps), weight_decay=0.1)
    opt_state = opt.init(params)
    ef = init_error_feedback(params) if args.compress_grads else None
    step_inner = make_train_step(cfg, opt, args.grad_accum,
                                 args.compress_grads)
    src = lm_source(args.seed, args.batch, args.seq, cfg.vocab_size)

    def step_fn(state, batch):
        params, opt_state, ef = state
        params, opt_state, ef, met = step_inner(params, opt_state, ef, batch)
        return (params, opt_state, ef), met

    before = _fingerprint(params)
    driver = TrainDriver(step_fn, src, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every)
    state = driver.run((params, opt_state, ef), args.steps)
    still = [("/".join(map(str, path)))
             for path, same in zip(tree_paths(state[0]),
                                   (_fingerprint(state[0]) == before).tolist())
             if same]
    for m in driver.metrics_log:
        if m["step"] % args.log_every == 0 or m["step"] == args.steps - 1:
            print(f"step {m['step']}: loss {m['loss']:.6f} ce {m['ce']:.6f} "
                  f"aux {m['aux']:.6f} in {m['time_s'] * 1e3:.1f} ms",
                  flush=True)
    losses = [m["loss"] for m in driver.metrics_log]
    print("losses: " + " ".join(repr(l) for l in losses), flush=True)
    print("ms per step: " + " ".join(f"{m['time_s'] * 1e3:.3f}"
                                     for m in driver.metrics_log), flush=True)
    print(f"params moved: {len(before) - len(still)} of {len(before)} "
          f"leaves; unmoved: {' '.join(still) or 'none'}", flush=True)
    if device.type == "cuda":
        print(f"max_memory_allocated: "
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB",
              flush=True)
    if losses:
        print(f"done: {len(losses)} steps; loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}; stragglers={len(driver.monitor.flagged)} "
              f"recoveries={driver.recoveries}", flush=True)
    return state, driver


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA device; pass --device cpu to train on the CPU")
        return 2
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
