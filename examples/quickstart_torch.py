"""Quickstart on the PyTorch/CUDA port: the paper's pipeline in a minute
(the counterpart of examples/quickstart.py).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cuda]
        [--wgan-steps 5]

1. the reverse-loop deconvolution kernel (B1) through a per-layer
   DeconvPlan against the zero-insertion oracle, with B1's and cuDNN's
   device times on the card,
2. design-space exploration of the unified tiling factor (Fig. 5) on the
   H100's roofline model,
3. a few WGAN-GP training steps on synthetic digits (B1 in the
   generator's forward),
4. plan/execute serving: build a NetworkPlan once (geometry, tiles and
   precision pinned, as a bitstream is) and serve it through the
   EngineConfig-driven engine.

With ``--device cpu`` every kernel call runs its plain version on the
CPU and nothing is timed.
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core import H100_SXM, optimize_unified_tile  # noqa: E402
from repro_torch.core.deconv import fp32_exact  # noqa: E402
from repro_torch.core.tiling import DeconvGeometry  # noqa: E402
from repro_torch.data import image_source  # noqa: E402
from repro_torch.kernels.deconv2d import deconv2d, deconv2d_ref  # noqa: E402
from repro_torch.kernels.deconv2d import kernel as deconv_kernel  # noqa: E402
from repro_torch.models import MNIST_DCNN  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.plan import build_layer_plan, build_network_plan  # noqa: E402
from repro_torch.serve import DcnnServeEngine, EngineConfig  # noqa: E402
from repro_torch.train import train_wgan  # noqa: E402

KERNEL_TOL = 1e-4
DSE_CO_TILE = 8


def device_ms(fn, runs: int = 20) -> float:
    """Median time between CUDA events recorded around each of ``runs``
    calls of ``fn()``: its kernels and any gap while the host enqueues
    them."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--wgan-steps", type=int, default=5)
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA device; pass --device cpu to run on the CPU")
        return 2
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    fp32_exact(dev)   # the oracle in full float32, as the kernel computes

    # 1 — the kernel, dispatched through a per-layer DeconvPlan
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 7, 7, 256), generator=g).to(dev)
    w = (torch.randn((4, 4, 256, 128), generator=g) * 0.05).to(dev)
    b = torch.zeros((128,), device=dev)
    lplan = build_layer_plan(DeconvGeometry(7, 7, 256, 128, 4, 2, 1),
                             batch=2)
    with torch.no_grad():
        y = deconv2d(x, w, b, plan=lplan)
        y_ref = deconv2d_ref(x, w, b, 2, 1)
    err = float((y - y_ref).abs().max())
    print(f"[kernel] out {tuple(y.shape)} via plan "
          f"{lplan.tiles.as_kwargs()}, max|err| vs oracle = {err:.2e}")
    if not err <= KERNEL_TOL:
        print("the kernel diverged from the oracle")
        return 1
    if on_card:
        with torch.no_grad():
            ms = device_ms(lambda: deconv2d(x, w, b, plan=lplan))
            cudnn_ms = device_ms(lambda: deconv2d_ref(x, w, b, 2, 1))
        print(f"[kernel] {torch.cuda.get_device_name(0)}: B1 op {ms:.4f} "
              f"ms, cuDNN (conv_transpose2d) {cudnn_ms:.4f} ms per call "
              "(CUDA events around each call: the op pads x and w per "
              "call)")

    # 2 — DSE (paper Fig. 5) on the H100's roofline model.  A layer's
    # whole input and a CO tile of its weights must fit the kernel's shared
    # memory; at the reference's CO tile of 128 MNIST's first two layers
    # do not, at the Hopper kernel's narrowest (8 columns a warp) they do.
    best, scores = optimize_unified_tile(MNIST_DCNN.geometries(), H100_SXM,
                                         co_tile=DSE_CO_TILE)
    print(f"[dse] unified T_OH = {best} at a CO tile of {DSE_CO_TILE} "
          f"(modelled {scores[best] / 1e12:.2f} TOps/s on {H100_SXM.name})")

    # 3 — WGAN-GP training (the paper's training framework)
    src = image_source("mnist", seed=0, batch=16)
    gp, _dp, hist = train_wgan(
        MNIST_DCNN, src, steps=args.wgan_steps, seed=0,
        g_opt=AdamW(lr=2e-4, b1=0.5, b2=0.9),
        d_opt=AdamW(lr=2e-4, b1=0.5, b2=0.9),
        n_critic=2, log_every=1, backend="cuda", device=dev)
    print(f"[wgan] d_loss {hist[0]['d_loss']:.3f} -> "
          f"{hist[-1]['d_loss']:.3f}, gp {hist[-1]['gp']:.3f}")

    # 4 — plan/execute serving (the paper's inference workload): the
    # network plan pins tiles and epilogues once; the engine executes it
    nplan = build_network_plan(MNIST_DCNN, batch=8, backend="cuda")
    print(f"[plan] {nplan.name} hash={nplan.stable_hash()} modelled "
          f"{nplan.modeled_network_ops(H100_SXM) / 1e9:.0f} GOps/s at "
          f"batch 8 on {H100_SXM.name}")
    eng = DcnnServeEngine.from_config(
        EngineConfig(model=MNIST_DCNN, backend="cuda", buckets=(1, 2, 4, 8),
                     device=args.device),
        gp, plan=nplan)
    z = np.random.RandomState(0).randn(8, 100).astype(np.float32)
    imgs = eng.generate(z)
    print(f"[serve] generated {imgs.shape} images in "
          f"[{imgs.min():.2f}, {imgs.max():.2f}] "
          f"({eng.plan_stats['builds']} plan builds beyond the pinned one)")
    print(f"B1 launches: {deconv_kernel.LAUNCHES} by its wrapper, "
          f"{sum(eng.launch_counts.values())} in the engine's dispatches")
    if not np.isfinite(imgs).all():
        print("the engine served non-finite images")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
