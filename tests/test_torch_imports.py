"""The port imports neither JAX nor the JAX package, nor ml_dtypes (a
JAX dependency that the card's machine need not have)."""
import ast
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "examples" / "serve_dcnn_torch.py",
     ROOT / "examples" / "train_wgan_mnist_torch.py",
     ROOT / "tools" / "probe_mesh.py", ROOT / "tools" / "probe_ab.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_port_file_imports_jax_or_the_jax_package():
    assert len(PORT_FILES) > 30
    bad = [(p.relative_to(ROOT), m) for p in PORT_FILES
           for m in _imported_modules(p)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(ROOT / "src" / "repro_torch")
                                  .with_suffix("").parts)
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    mods = [m.removesuffix(".__init__") for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_every_port_module_is_covered():
    """The static checks, the mesh and the sharding helpers are among the
    files the two tests above read and import."""
    mods = {str(p.relative_to(ROOT / "src" / "repro_torch"))
            for p in PORT_FILES if "repro_torch" in p.parts}
    assert {"analysis/__init__.py", "analysis/check/__init__.py",
            "analysis/check/__main__.py", "analysis/check/rules.py",
            "analysis/check/plan_drc.py", "analysis/check/bench_schema.py",
            "analysis/check/concurrency.py", "launch/__init__.py",
            "launch/mesh.py", "dist/sharding.py"} <= mods

