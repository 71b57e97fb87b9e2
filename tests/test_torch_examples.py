"""The zoo's train -> pin -> DRC -> serve contract on the port (the
counterparts of tests/test_workloads.py's fp32 and int8 round trips),
and the two examples whose every import is ported,
``examples/serve_sr_torch.py`` and ``examples/quickstart_torch.py``, run
through their ``main`` on the CPU (``--device cpu``: the "cuda" backend
runs the kernel's plain version).

Tolerances, each with its reason:
* served fp32 images against the port's reverse loop: 1e-5 (the plain
  version of the kernel sums the same products in another order);
  against the JAX package's reverse loop on the same params: 1e-4, as in
  tests/test_torch_zoo.py;
* int8: a pinned engine's images equal a self-calibrating engine's (the
  same scales), and within 1e-6 of the port's integer-exact chain oracle
  (only the last layer's tanh can differ, by an ulp).
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.workloads as jworkloads
import repro_torch.workloads as workloads
from repro_torch.analysis.check import check_network_plan, check_plan_json
from repro_torch.optim import AdamW
from repro_torch.plan import NetworkPlan, build_network_plan
from repro_torch.quant import quantize_params, quantized_generator_ref
from repro_torch.serve import DcnnServeEngine, EngineConfig
from repro_torch.train import train_supervised

ROOT = pathlib.Path(__file__).resolve().parents[1]


def load_example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_pin_drc_serve_roundtrip_fp32(tmp_path):
    w = workloads.get("sr")
    params, trainer, history = train_supervised(
        w, 3, 0, AdamW(lr=1e-3), batch=4, backend="cuda", device="cpu")
    assert history[-1]["loss"] < history[0]["loss"]

    path = str(tmp_path / "sr_plan.json")
    trainer.plans[4].to_json(path)
    report = check_plan_json(path)
    assert report.ok(), report.render()
    assert "drc.input_root" in report.rules_run

    pinned = NetworkPlan.load(path)
    eng = DcnnServeEngine.from_config(
        EngineConfig(model="sr", backend="cuda", buckets=(4,),
                     calib_batch=8, device="cpu"),
        params, plan=pinned)
    x, _ = w.training_pairs(7, 4)
    x = np.asarray(x, np.float32)
    out = eng.generate(x)
    with torch.no_grad():
        ref = w.ref(params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.detach().numpy()),
                                params)
    jref = np.asarray(jworkloads.get("sr").ref(jp, jnp.asarray(x)))
    np.testing.assert_allclose(out, jref, rtol=0, atol=1e-4)
    assert eng.plan_stats["builds"] == 0          # pinned, not rebuilt
    assert eng.plans[4].stable_hash() == trainer.plan_fingerprints()[4]


def test_pin_serve_roundtrip_int8():
    w = workloads.get("denoise")
    params = w.init(torch.Generator().manual_seed(0), device="cpu")
    plan = build_network_plan(w.cfg, batch=4, precision="int8",
                              params=params, calib_batch=8)
    report = check_network_plan(plan)
    assert report.ok(), report.render()
    pinned = NetworkPlan.from_json(plan.to_json())
    cfg_e = EngineConfig(model="denoise", precision="int8", buckets=(4,),
                         calib_batch=8, device="cpu")
    eng = DcnnServeEngine.from_config(cfg_e, params, plan=pinned)
    auto = DcnnServeEngine.from_config(cfg_e, params)
    # image-root calibration is deterministic: the self-calibrating
    # engine derives the exact scales the pinned plan carries
    assert eng.quant_cfg == auto.quant_cfg
    x = np.asarray(w.calibration_batch(2, 4), np.float32)
    out = eng.generate(x)
    np.testing.assert_array_equal(out, auto.generate(x))
    # the self-planned bucket is the pinned plan
    assert eng.plans[4].stable_hash() == plan.stable_hash() == \
        auto.plans[4].stable_hash()
    qp = quantize_params(params, w.cfg, eng.quant_cfg)
    ref = quantized_generator_ref(qp, w.cfg, eng.quant_cfg,
                                  torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_serve_sr_example_on_the_cpu(tmp_path, capsys):
    ex = load_example("serve_sr_torch")
    path = str(tmp_path / "plan.json")
    assert ex.main(["--device", "cpu", "--steps", "2", "--batch", "4",
                    "--plan-json", path]) == 0
    out = capsys.readouterr().out
    line = next(l for l in out.splitlines() if l.startswith("plan hashes:"))
    _, _, trained, _, served = line.split()[1:]
    assert trained == served == NetworkPlan.load(path).stable_hash()
    assert "DRC clean" in out and "round trip holds" in out
    # a generative workload has no pairs to train on
    assert ex.main(["--device", "cpu", "--workload", "mnist"]) == 2


def test_quickstart_example_on_the_cpu(capsys):
    ex = load_example("quickstart_torch")
    assert ex.main(["--device", "cpu", "--wgan-steps", "2"]) == 0
    out = capsys.readouterr().out
    for step in ("[kernel]", "[dse]", "[wgan]", "[plan]", "[serve]"):
        assert step in out
    assert "on h100-sxm" in out


@pytest.mark.parametrize("name", ["serve_sr_torch", "quickstart_torch"])
def test_examples_refuse_a_missing_card(name, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the examples run on it")
    assert load_example(name).main(["--device", "cuda"]) == 2
    assert "--device cpu" in capsys.readouterr().out
