"""The import guard: whole top-level names, and nothing the benchmark loads
pulls in JAX or the JAX package."""
import os
import subprocess
import sys

from benchkit import guard, spec


def test_names_are_compared_whole():
    assert guard.forbidden_loaded(["repro_torch", "repro_torch.serve",
                                   "jaxtyping", "reproducer", "flaxen"]) == []
    assert guard.forbidden_loaded(["repro.models.dcnn", "repro_torch",
                                   "jax._src.core", "jaxlib", "flax.linen"]) \
        == ["flax", "jax", "jaxlib", "repro"]


def test_the_benchmark_loads_no_jax():
    """Everything a run imports, in a fresh process: the harness, every
    configuration's family, system and metric, and the program."""
    code = """
import sys
sys.path[:0] = [{bench!r}, {src!r}]
from benchkit import energy, guard, harness, spec, trace
bench = spec.load_benchmark()
for cell in bench["workloads"]:
    c = spec.find_cell(bench, cell["name"])
    spec.load_module("configs", c.config["family"])
    spec.load_module("systems", c.config["system"])
    spec.metric_readers(c.end_to_end + c.per_layer)
import repro_torch.serve, repro_torch.models.dcnn, repro_torch.kernels.deconv2d
print(guard.forbidden_loaded())
""".format(bench=str(spec.ROOT / "bench"), src=str(spec.ROOT / "src"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_nothing_reads_the_jax_benchmarks():
    for path in (spec.ROOT / "bench").rglob("*.py"):
        if path.name.startswith("test_"):
            continue
        text = path.read_text()
        assert "BENCH_deconv" not in text, path
        assert "benchmarks/" not in text, path
