"""Train an LM architecture at its reduced, family-faithful config for a
few steps through the port's launcher and its resilient driver (the
counterpart of examples/train_lm.py).

    PYTHONPATH=src python examples/train_lm_torch.py --arch recurrentgemma-2b \
        --steps 50 [--device cpu]

Runs ``python -m repro_torch.launch.train`` in a process of its own with
``--reduced`` appended; ``--arch`` (deepseek-7b), ``--steps`` (50),
``--batch`` (4), ``--seq`` (64) and ``--device`` (cuda) take these
defaults, and every other argument goes to the launcher as it is.
"""
import argparse
import os
import subprocess
import sys

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--steps", default="50")
    ap.add_argument("--batch", default="4")
    ap.add_argument("--seq", default="64")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args, rest = ap.parse_known_args(argv)
    if "--reduced" not in rest:
        rest.append("--reduced")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.abspath(SRC)] + ([env["PYTHONPATH"]]
                                  if env.get("PYTHONPATH") else []))
    return subprocess.call(
        [sys.executable, "-m", "repro_torch.launch.train",
         "--arch", args.arch, "--steps", args.steps, "--batch", args.batch,
         "--seq", args.seq, "--device", args.device, *rest], env=env)


if __name__ == "__main__":
    sys.exit(main())
