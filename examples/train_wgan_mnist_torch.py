"""Train the paper's MNIST DCNN with WGAN-GP on synthetic digits through
the PyTorch port, with async checkpointing, and report the final MMD
(the counterpart of examples/train_wgan_mnist.py).

    PYTHONPATH=src python examples/train_wgan_mnist_torch.py [--steps 200]
    PYTHONPATH=src python examples/train_wgan_mnist_torch.py --device cpu --steps 4
    PYTHONPATH=src python examples/train_wgan_mnist_torch.py --mesh --steps 4

``--backend cuda`` runs the generator's forward through the serving
kernel (the plain version of it on the CPU) with the reverse loop's
autograd as the backward.  The default device is the card.  ``--mesh``
shards the critic and generator steps over every visible card
(`launch.mesh.make_serving_mesh`; ``--mesh N`` over the first N, or with
``--device cpu`` over N shards on the CPU).
"""
import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.ckpt import AsyncCheckpointer  # noqa: E402
from repro_torch.core.mmd import mmd  # noqa: E402
from repro_torch.data import image_source  # noqa: E402
from repro_torch.launch import make_serving_mesh, make_test_mesh  # noqa: E402
from repro_torch.models import MNIST_DCNN, generator_apply  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.train import train_wgan  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="resume (params + optimizer states + step) from "
                         "the newest checkpoint in --ckpt-dir")
    ap.add_argument("--backend", default="reverse_loop",
                    choices=["reverse_loop", "cudnn", "cuda"],
                    help="generator forward for the training loss (cuda = "
                         "the serving kernel with the reverse-loop backward)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--mesh", nargs="?", const=0, type=int, default=None,
                    metavar="N",
                    help="shard the steps over N devices (default: every "
                         "visible card; with --device cpu, N CPU shards)")
    args = ap.parse_args()
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("no CUDA device; pass --device cpu to train on the CPU")

    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "wgan_mnist_torch_ckpt")
    cfg = MNIST_DCNN
    src = image_source("mnist", seed=0, batch=args.batch)
    ck = AsyncCheckpointer(ckpt_dir, keep=2)

    mesh = None
    if args.mesh is not None:
        mesh = (make_test_mesh(args.mesh or 2, device="cpu")
                if args.device == "cpu" else make_serving_mesh(args.mesh))
        print(f"mesh: {mesh.shape} over {[str(d) for d in mesh.devices]}")

    gp, dp, hist = train_wgan(
        cfg, src, steps=args.steps, seed=0,
        g_opt=AdamW(lr=2e-4, b1=0.5, b2=0.9),
        d_opt=AdamW(lr=2e-4, b1=0.5, b2=0.9),
        n_critic=5, log_every=max(args.steps // 10, 1),
        ckpt=ck, ckpt_every=max(args.steps // 4, 1),
        backend=args.backend, device=args.device, mesh=mesh,
        resume_from=ckpt_dir if args.resume else None)
    ck.wait()

    for h in hist:
        print(f"step {h['step']:4d}  d_loss {h['d_loss']:+.4f}  "
              f"g_loss {h['g_loss']:+.4f}  wdist {h['wdist']:+.4f}  "
              f"gp {h['gp']:.4f}")

    # quality: MMD between generated samples and held-out synthetic data
    z = torch.randn((64, cfg.z_dim), generator=torch.Generator().manual_seed(7))
    device = gp["l0"]["w"].device
    with torch.no_grad():
        fake = generator_apply(gp, cfg, z.to(device)).reshape(64, -1)
    # enough held-out batches to reach 64 rows whatever --batch is
    held = np.concatenate([src.batch(10_000 + i)["images"]
                           for i in range(-(-64 // args.batch))])[:64]
    real = torch.from_numpy(held).to(device).reshape(64, -1)
    print(f"\nfinal MMD(fake, real) = {float(mmd(real, fake)):.4f}")
    print(f"checkpoints in {ckpt_dir}")


if __name__ == "__main__":
    main()
