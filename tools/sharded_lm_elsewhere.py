#!/usr/bin/env python3
"""The rank cases of ``tests/test_torch_sharded_lm.py`` run under another
installation's torch (a card machine's, whose DTensor may plan otherwise)
and held to the JAX package's results computed where the test runs.

    python tools/sharded_lm_elsewhere.py prepare DIR   # cases, reference
    python tools/sharded_lm_elsewhere.py run DIR       # 4 gloo ranks
    python tools/sharded_lm_elsewhere.py check DIR     # the test's checks

``prepare`` and ``check`` import the test file (and with it JAX and the
reference); ``run`` imports neither: it starts ``tests/sharded_lm_ranks.py``
four times, one thread a rank, as the test's fixture does, and leaves
``rank{r}.pkl`` and ``rank{r}.log`` in DIR with the torch version in
``torch.txt``.  ``check`` calls every test of the file that reads the
ranks' run, with each of its parameters, and exits 1 if one fails.
"""
import importlib.util
import inspect
import os
import pathlib
import pickle
import subprocess
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parents[1]
TESTS = ROOT / "tests"


def test_module():
    sys.path[:0] = [str(ROOT / "src"), str(TESTS)]
    spec = importlib.util.spec_from_file_location(
        "test_torch_sharded_lm", TESTS / "test_torch_sharded_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def prepare(d: pathlib.Path) -> int:
    mod = test_module()
    d.mkdir(parents=True, exist_ok=True)
    cases = mod.make_cases()
    with open(d / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    with open(d / "ref.pkl", "wb") as f:
        pickle.dump(mod.references(cases), f)
    return 0


def run(d: pathlib.Path) -> int:
    import torch

    (d / "torch.txt").write_text(torch.__version__ + "\n")
    for r in range(4):
        (d / f"rank{r}.pkl").unlink(missing_ok=True)
    store = d / "store"
    store.unlink(missing_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, str(TESTS / "sharded_lm_ranks.py"), str(r), "4",
         str(store), str(d)], env=env,
        stdout=open(d / f"rank{r}.log", "w"), stderr=subprocess.STDOUT)
        for r in range(4)]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, t0 + 600 - time.time()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    print(f"ranks exit {rcs} in {time.time() - t0:.1f} s under torch "
          f"{torch.__version__}")
    return 0 if rcs == [0] * 4 else 1


def check(d: pathlib.Path) -> int:
    mod = test_module()
    with open(d / "cases.pkl", "rb") as f:
        cases = pickle.load(f)
    with open(d / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    ranks = []
    for r in range(4):
        with open(d / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    errors = [r["error"] for r in ranks if "error" in r]
    if errors:
        print(errors[0])
        return 1
    params = {"name": mod.NAMES, "cf": mod.MOE_FACTORS}
    failed = passed = 0
    for name, fn in sorted(vars(mod).items()):
        if not name.startswith("test_") or not callable(fn):
            continue
        args = list(inspect.signature(fn).parameters)
        if "run" not in args:
            continue
        extra = [a for a in args if a != "run"]
        values = params[extra[0]] if extra else [None]
        for v in values:
            try:
                fn((cases, ref, ranks), *([v] if extra else []))
                passed += 1
            except Exception:
                failed += 1
                print(f"FAILED {name}[{v}]\n{traceback.format_exc()}")
    version = (d / "torch.txt").read_text().strip()
    print(f"{passed} passed, {failed} failed: the rank cases under torch "
          f"{version} against the reference")
    return 1 if failed else 0


def main() -> int:
    if len(sys.argv) != 3 or sys.argv[1] not in ("prepare", "run", "check"):
        print(__doc__)
        return 2
    return {"prepare": prepare, "run": run, "check": check}[sys.argv[1]](
        pathlib.Path(sys.argv[2]).resolve())


if __name__ == "__main__":
    sys.exit(main())
