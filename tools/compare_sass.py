#!/usr/bin/env python3
"""Compile two versions of a CUDA source and compare the machine code (SASS)
of the kernels they share, on a machine with the CUDA toolkit.

Usage:  python3 tools/compare_sass.py BASE.cu NEW.cu [--match NAME]

Each file is built as the port builds it (`kernels/_build.py`'s nvcc flags)
and disassembled with ``cuobjdump -sass``.  Kernels are paired by their
mangled name from the template name on (so the file-local namespace prefix
does not matter); for each kernel whose name contains ``--match`` it prints
whether the two instruction streams (addresses and encodings dropped) are
identical, and how many instructions differ otherwise.  Exits non-zero when
a matched kernel differs or is missing from NEW.  Shows whether a change to
shared code left a kernel's compiled code as it was.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels._build import NVCC_FLAGS, nvcc  # noqa: E402


def sass(src: str, tmp: str, tag: str) -> dict:
    """Kernel name -> its instructions, from ``src`` built into ``tmp``."""
    lib = os.path.join(tmp, f"{tag}.so")
    subprocess.run([nvcc(), *NVCC_FLAGS, "-o", lib, src], check=True,
                   capture_output=True)
    cuobjdump = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            # from the kernel's own name on: the anonymous namespace's
            # prefix carries the file name (and an 8-digit hash)
            name = re.sub(r"^.*?_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "",
                          m.group(1))
            out[name] = []
            continue
        ins = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).split(";")[0].strip()
        if name and ins and not ins.startswith("/*"):
            out[name].append(ins)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("base")
    ap.add_argument("new")
    ap.add_argument("--match", default="")
    a = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        base, new = sass(a.base, tmp, "base"), sass(a.new, tmp, "new")
    bad = 0
    for name, ins in sorted(base.items()):
        if a.match not in name:
            continue
        other = new.get(name)
        if other is None:
            print(f"missing in NEW: {name}")
            bad += 1
        elif other == ins:
            print(f"identical ({len(ins)} instructions): {name}")
        else:
            n = sum(x != y for x, y in zip(ins, other)) + abs(len(ins) - len(other))
            print(f"differs in {n} of {len(ins)} instructions: {name}")
            bad += 1
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
