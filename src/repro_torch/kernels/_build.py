"""Build and load the port's CUDA kernels.

Each kernel source under ``repro_torch/csrc/`` has a plain C interface.  It
is compiled at first use with ``nvcc`` for ``sm_90a`` into a shared library
in ``repro_torch/build/`` (listed in ``.gitignore``) and loaded with
``ctypes``.  The library's file name carries a hash of the source and the
flags, so an edited source is rebuilt and a stale library is never loaded.
`build_all` starts one ``nvcc`` per source at once.  ``ptxas -v`` reports
each kernel's registers, spills and shared memory; the report is kept
beside the library (``.log``) and parsed by `ptxas_report`.  Nothing is
built when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Iterable, List

PKG_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """A kernel source did not compile or its library did not load."""


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels are built from source at first use")
    return found


def source_digest(name: str) -> str:
    """Hash of ``csrc/<name>.cu`` and the compiler flags: what the library's
    file name carries, and what keys a tile timing to the code it timed."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def library_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}_{source_digest(name)}.so"


def _start(name: str):
    """Start compiling ``csrc/<name>.cu`` unless its library exists:
    ``(library, None)`` or ``(library, (process, temporary output))``.

    The library is written to a temporary name and renamed into place, so
    processes building at once never load a half-written file."""
    out = library_path(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp)


def _finish(name: str, out: pathlib.Path, job) -> pathlib.Path:
    if job is None:
        return out
    proc, tmp = job
    try:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed on {name}.cu ({proc.returncode}):\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_all(names: Iterable[str]) -> List[pathlib.Path]:
    """Compile every ``csrc/<name>.cu`` whose library is missing, one
    ``nvcc`` each, all started before any is waited for."""
    jobs = [(name, *_start(name)) for name in names]
    return [_finish(name, out, job) for name, out, job in jobs]


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless its library already exists."""
    return build_all([name])[0]


def ptxas_report(name: str) -> List[Dict]:
    """Per kernel of ``csrc/<name>.cu``'s library: ``{"kernel", "registers",
    "spill_stores", "spill_loads"}`` (bytes) from the ``ptxas -v`` report
    kept when it was built; [] when the report is missing (a library built
    before reports were kept)."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        return []
    rows, cur = [], None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"kernel": m.group(1), "registers": None,
                   "spill_stores": 0, "spill_loads": 0}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return rows


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build(name)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelBuildError(f"cannot load {path}: {e}") from e
            _loaded[name] = lib
        return lib
