"""The port's plan DRC against the JAX package's, and its Hopper rules.

* The reference's mutation fixtures (``tests/test_check_drc.py``),
  applied to port plans of the same towers and to reference plans, fire
  the same rule ids and nothing else (``drc.vmem_budget`` is the port's
  ``drc.smem_budget``: the card has no VMEM).
* Hopper-specific cases each fire, and `NetworkPlan.for_hopper` of the
  mutated plan is clean: a tile over the shared memory or the threads
  per block, a ``t_ci`` off the bf16 or int8 mma step, a JAX-pinned
  ``pallas`` plan, an int8 ``t_ci`` that the packed weight's channels do
  not split into.
* The engine's gate refuses a plan before any planning, static operands
  or capture (the reference test's monkeypatch pattern).
* The plan methods the DRC reads equal the reference's on the same plan
  document at the reference's device.
* The CLI and ``examples/serve_dcnn_torch.py --plan-json``.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.analysis.check import check_network_plan as jcheck
from repro.analysis.check import check_plan_json as jcheck_json
from repro.analysis.check import registered_rules as jrules
from repro.core import dse as jdse
from repro.models import dcnn as jdcnn
from repro.plan import build_network_plan as jbuild
from repro.workloads import DAE_DENOISE as JDAE, SR_X2 as JSR
from repro_torch.analysis.check import (PlanCheckError, check_network_plan,
                                        check_plan_json, registered_rules)
from repro_torch.analysis.check.__main__ import main as cli
from repro_torch.analysis.check.plan_drc import launch_resources
from repro_torch.core import dse
from repro_torch.core.tiling import kernel_smem_bytes
from repro_torch.models import dcnn
from repro_torch.plan import NetworkPlan, build_network_plan
from repro_torch.serve import DcnnServeEngine, EngineConfig
from repro_torch.workloads import DAE_DENOISE, SR_X2

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _small(mod):
    """The reference test's MNIST_SMALL."""
    return mod.DcnnConfig(
        name="dcnn-mnist-small", z_dim=24, img_hw=28, img_c=1,
        layers=(mod.DeconvLayerCfg(24, 32, 7, 1, 0, "relu"),
                mod.DeconvLayerCfg(32, 16, 4, 2, 1, "relu"),
                mod.DeconvLayerCfg(16, 1, 4, 2, 1, "tanh")))


JSMALL, SMALL = _small(jdcnn), _small(dcnn)
TOWERS = {"small": (JSMALL, SMALL), "sr": (JSR, SR_X2),
          "denoise": (JDAE, DAE_DENOISE)}
RENAMED = {"drc.vmem_budget": "drc.smem_budget"}


@pytest.fixture(autouse=True)
def tmp_caches(tmp_path, monkeypatch):
    from repro.kernels import autotune

    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.setattr(autotune, "_cache", None)
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "at_torch.json"))


@pytest.fixture(scope="module")
def params():
    """(reference params, port params) of MNIST_SMALL, one init."""
    jp, _ = jdcnn.generator_init(jax.random.PRNGKey(0), JSMALL)
    npp = jax.tree_util.tree_map(np.asarray, jp)
    return jp, dcnn.generator_params_from_numpy(npp, SMALL, "cpu")


@pytest.fixture(scope="module")
def pruned(params):
    """The reference test's pruning (70 % of each weight) in both."""
    jp, _ = params
    out = {}
    for k, v in jp.items():
        w = np.asarray(v["w"]).copy()
        w[np.abs(w) < np.quantile(np.abs(w), 0.7)] = 0.0
        out[k] = {"w": w, "b": np.asarray(v["b"])}
    return out, dcnn.generator_params_from_numpy(out, SMALL, "cpu")


def _fired(report):
    return sorted({v.rule_id for v in report.failures(strict=True)})


def _port_fired(report):
    return sorted({RENAMED.get(r, r) for r in _fired(report)})


def _ref_fired(report):
    return sorted({RENAMED.get(r, r) for r in _fired(report)})


def _mutate(plan, edit, path):
    """The reference test's drift: the JSON edited, its hash dropped."""
    doc = json.loads(plan.to_json())
    edit(doc)
    doc.pop("stable_hash", None)
    path.write_text(json.dumps(doc))
    return str(path)


def _plans(tower, params, pruned, kind):
    """(reference plan, port plan) of one tower and path at batch 4 (2 for
    zero-skip, as the reference test)."""
    jcfg, cfg = TOWERS[tower]
    if kind == "fp32":
        return (jbuild(jcfg, batch=4, backend="pallas"),
                build_network_plan(cfg, batch=4, backend="cuda"))
    if kind == "int8":
        return (jbuild(jcfg, batch=4, precision="int8", params=params[0],
                       calib_batch=8),
                build_network_plan(cfg, batch=4, precision="int8",
                                   params=params[1], calib_batch=8))
    return (jbuild(jcfg, batch=2, backend="pallas_sparse", params=pruned[0]),
            build_network_plan(cfg, batch=2, backend="cuda_sparse",
                               params=pruned[1]))


def _tiles(doc, layer, **kw):
    doc["layers"][layer]["tiles"].update(kw)


def _geom(doc, layer, **kw):
    doc["layers"][layer]["geometry"].update(kw)


# (tower, path, edit of the pinned document) of each reference fixture
JSON_FIXTURES = {
    "clean_fp32": ("small", "fp32", lambda d: None),
    "clean_int8": ("small", "int8", lambda d: None),
    "clean_sr": ("sr", "fp32", lambda d: None),
    "clean_denoise": ("denoise", "fp32", lambda d: None),
    "oversized_tile": ("small", "fp32", lambda d: _tiles(
        d, 1, t_oh=512, t_ow=512, t_ci=2048, t_co=2048)),
    "stride_misaligned_tile": ("small", "fp32",
                               lambda d: _tiles(d, 1, t_oh=7)),
    "broken_scale_chain": ("small", "int8", lambda d: d["layers"][0].update(
        out_scale=123.0)),
    "latent_root_spliced_into_sr": ("sr", "fp32",
                                    lambda d: _geom(d, 0, in_h=1, in_w=1)),
    "bad_sr_geometry_chain": ("sr", "fp32", lambda d: _geom(d, 1, in_h=28)),
    "relabeled_workload": ("sr", "fp32", lambda d: d.update(
        workload="denoise")),
    "unregistered_workload": ("sr", "fp32", lambda d: d.update(
        workload="some-third-party-tower")),
}


@pytest.mark.parametrize("name", sorted(JSON_FIXTURES))
def test_reference_fixture_fires_the_same_rules(name, params, pruned,
                                                tmp_path):
    tower, kind, edit = JSON_FIXTURES[name]
    jplan, plan = _plans(tower, params, pruned, kind)
    want = _ref_fired(jcheck_json(_mutate(jplan, edit, tmp_path / "j.json")))
    got = _port_fired(check_plan_json(_mutate(plan, edit,
                                              tmp_path / "p.json")))
    assert got == want
    if name.startswith("clean") or name == "unregistered_workload":
        assert got == []
    else:
        assert got


def test_stale_sparse_digest_fires_the_same_rules(params, pruned, tmp_path):
    jplan, plan = _plans("small", params, pruned, "sparse")

    def edit(doc):
        for layer in doc["layers"]:
            layer["sparse_digest"] = "0badc0de0badc0de"
            layer.pop("sparse_tables", None)

    jloaded = type(jplan).load(_mutate(jplan, edit, tmp_path / "j.json"))
    loaded = NetworkPlan.load(_mutate(plan, edit, tmp_path / "p.json"))
    want = _ref_fired(jcheck(jloaded, params=pruned[0]))
    assert _port_fired(check_network_plan(loaded, params=pruned[1])) \
        == want == ["drc.sparse_digest"]
    # the clean zero-skip plans, against the weights they serve
    assert _fired(jcheck(jplan, params=pruned[0])) == []
    assert _fired(check_network_plan(plan, params=pruned[1])) == []


@pytest.mark.parametrize("buckets, fires", [((4, 16), True),
                                            ((8, 16), False)])
def test_misaligned_bucket_fires_the_same_rules(buckets, fires, params,
                                                pruned):
    jplan, plan = _plans("small", params, pruned, "fp32")
    want = _ref_fired(jcheck(jplan, n_devices=2, buckets=buckets))
    got = _port_fired(check_network_plan(plan, n_devices=2, buckets=buckets))
    assert got == want == (["drc.bucket_mesh"] if fires else [])


def test_unknown_activation_fires_the_same_rules(params, pruned):
    jplan, plan = _plans("small", params, pruned, "fp32")

    def swish(p):
        return dataclasses.replace(p, layers=(dataclasses.replace(
            p.layers[0], activation="swish"),) + p.layers[1:])

    assert _port_fired(check_network_plan(swish(plan))) \
        == _ref_fired(jcheck(swish(jplan))) == ["drc.epilogue"]


@pytest.mark.parametrize("doc", ["garbage", "tampered"])
def test_unloadable_plan_fires_schema_in_both(doc, params, pruned, tmp_path):
    jplan, plan = _plans("small", params, pruned, "fp32")
    paths = []
    for p in (jplan, plan):
        path = tmp_path / f"{len(paths)}.json"
        if doc == "garbage":
            path.write_text("{not json")
        else:
            d = json.loads(p.to_json())
            d["layers"][1]["tiles"]["t_oh"] = 512
            path.write_text(json.dumps(d))
        paths.append(str(path))
    assert _fired(jcheck_json(paths[0])) == _fired(check_plan_json(paths[1])) \
        == ["drc.schema"]


def test_rule_registry_is_the_reference_one_renamed():
    want = {RENAMED.get(r, r) for r in jrules()}
    assert set(registered_rules()) == want
    assert "drc.vmem_budget" not in registered_rules()


# ---------------------------------------------------------------------------
# Hopper-specific rules
# ---------------------------------------------------------------------------
def _with_tiles(plan, layer, **kw):
    l = plan.layers[layer]
    return dataclasses.replace(plan, layers=plan.layers[:layer] + (
        dataclasses.replace(l, tiles=dataclasses.replace(l.tiles, **kw)),)
        + plan.layers[layer + 1:])


def _celeba(precision="fp32", dtype="float32"):
    cfg = dataclasses.replace(dcnn.CELEBA_DCNN, dtype=dtype)
    params = dcnn.generator_init(torch.Generator().manual_seed(0), cfg, "cpu")
    return build_network_plan(cfg, batch=8, precision=precision,
                              params=params, calib_batch=8,
                              autotune=False), params


HOPPER_CASES = {
    # CelebA layer 1 (4x4 -> 8x8, 1024 -> 512): 2.4 MB of staged CI chunks
    "smem_overflow": ("fp32", "float32", 1,
                      dict(t_oh=8, t_ow=8, t_ci=256, t_co=64, t_n=1),
                      "drc.smem_budget", "shared memory"),
    "threads_overflow": ("fp32", "float32", 1,
                         dict(t_oh=8, t_ow=8, t_ci=64, t_co=128, t_n=8),
                         "drc.smem_budget", "threads per block"),
    "bf16_t_ci_off_the_mma_step": ("fp32", "bfloat16", 2, dict(t_ci=8),
                                   "drc.tile_alignment", "multiple of 16"),
    "int8_t_ci_off_the_mma_step": ("int8", "float32", 2, dict(t_ci=16),
                                   "drc.tile_alignment", "multiple of 32"),
    # C_in 100 packs to 128 channels, which CI chunks of 96 do not split
    "int8_packed_ci": ("int8", "float32", 0, dict(t_ci=96),
                       "drc.tile_alignment", "packed once"),
}


@pytest.mark.parametrize("name", sorted(HOPPER_CASES))
def test_hopper_rule_fires_and_for_hopper_is_clean(name):
    precision, dtype, layer, tiles, rule_id, words = HOPPER_CASES[name]
    plan, params = _celeba(precision, dtype)
    assert _fired(check_network_plan(plan)) == []
    bad = _with_tiles(plan, layer, **tiles)
    report = check_network_plan(bad)
    assert _fired(report) == [rule_id], report.render()
    assert any(words in v.message and v.layer == layer
               for v in report.by_rule()[rule_id]), report.render()
    fixed = bad.for_hopper(params)
    assert _fired(check_network_plan(fixed)) == []
    assert fixed.layers[layer].tiles == plan.layers[layer].tiles


@pytest.mark.parametrize("kind", ["fp32", "int8", "sparse"])
def test_reference_pinned_plan_needs_for_hopper(kind, params, pruned):
    jplan, _ = _plans("small", params, pruned, kind)
    pinned = NetworkPlan.from_json(jplan.to_json())
    report = check_network_plan(pinned)
    assert "drc.backend" in _fired(report)
    v = next(v for v in report.by_rule()["drc.backend"]
             if "JAX package" in v.message)
    assert "NetworkPlan.for_hopper(params)" in v.fix_hint
    fixed = pinned.for_hopper(pruned[1] if kind == "sparse" else None)
    assert _fired(check_network_plan(
        fixed, params=pruned[1] if kind == "sparse" else None)) == []


def test_launch_resources_are_the_kernel_model():
    """The DRC's figures are `kernel_smem_bytes` at the launch's split and
    clamped batch tile (the card holds them equal to the library's)."""
    for precision, dtype in (("fp32", "float32"), ("fp32", "bfloat16"),
                             ("int8", "float32")):
        plan, _ = _celeba(precision, dtype)
        for l in plan.layers:
            res = launch_resources(l)
            t = l.tiles
            assert res["smem_bytes"] == kernel_smem_bytes(
                l.geometry, t.t_oh, t.t_ow, t.t_ci, t.t_co,
                t_n=min(t.t_n, l.batch), split=res["split"], dtype=l.dtype)
            assert res["smem_bytes"] <= dse.H100_SXM.onchip_bytes
            assert 128 <= res["threads"] <= 512


# ---------------------------------------------------------------------------
# the engine's gate
# ---------------------------------------------------------------------------
def _boom(*a, **k):
    raise AssertionError("engine planned, prepared or captured before the "
                         "DRC verdict")


def _forbid_work(monkeypatch):
    """From here on, planning, static operands, calibration, packing,
    builds and captures raise."""
    import importlib

    qcal = importlib.import_module("repro_torch.quant.calibrate")
    qinfer = importlib.import_module("repro_torch.quant.infer")

    for name in ("_plan_for", "_build", "_build_shard", "_warmup_bucket",
                 "_prepared"):
        monkeypatch.setattr(DcnnServeEngine, name, _boom)
    for mod, name in ((qcal, "calibrate"), (qcal, "quantize_params"),
                      (qinfer, "pack_quantized_params")):
        monkeypatch.setattr(mod, name, _boom)


def _gate(cfg, params, plan, **kw):
    with pytest.raises(PlanCheckError) as ei:
        DcnnServeEngine.from_config(EngineConfig(
            model=cfg, max_batch=4, warmup=True, device="cpu", **kw),
            params, plan=plan)
    err = ei.value
    assert isinstance(err, ValueError)
    return {v.rule_id for v in err.violations}, err


def test_engine_refuses_an_oversized_tile_before_any_work(params,
                                                         monkeypatch):
    plan = build_network_plan(SMALL, batch=4, autotune=False)
    bad = _with_tiles(plan, 1, t_oh=512, t_ow=512, t_ci=2048, t_co=2048)
    _forbid_work(monkeypatch)
    rules, err = _gate(SMALL, params[1], bad)
    assert "drc.smem_budget" in rules
    assert "drc.smem_budget" in err.report()


def test_engine_refuses_a_reference_pinned_plan(params, monkeypatch):
    pinned = NetworkPlan.from_json(jbuild(JSMALL, batch=4,
                                          backend="pallas").to_json())
    _forbid_work(monkeypatch)
    rules, err = _gate(SMALL, params[1], pinned)
    assert "drc.backend" in rules
    assert "for_hopper" in err.report()


def test_engine_refuses_a_broken_scale_chain(params, monkeypatch):
    plan = build_network_plan(SMALL, batch=4, precision="int8",
                              params=params[1], calib_batch=8)
    bad = dataclasses.replace(plan, layers=(dataclasses.replace(
        plan.layers[0], out_scale=123.0),) + plan.layers[1:])
    _forbid_work(monkeypatch)
    rules, _ = _gate(SMALL, params[1], bad, precision="int8")
    assert rules == {"drc.scale_chain"}


def test_engine_serves_a_clean_pinned_plan(params):
    plan = build_network_plan(SMALL, batch=4, autotune=False)
    eng = DcnnServeEngine.from_config(EngineConfig(
        model=SMALL, max_batch=4, device="cpu"), params[1], plan=plan)
    assert eng.plans[eng.max_bucket] is plan
    z = np.random.RandomState(0).randn(3, 24).astype(np.float32)
    assert eng.generate(z).shape == (3, 28, 28, 1)


# ---------------------------------------------------------------------------
# the plan methods the DRC reads
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tower", ["mnist", "celeba", "sr", "denoise"])
@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_plan_models_equal_the_reference(tower, precision):
    from repro import workloads as jw
    from repro_torch import workloads as tw

    jcfg = jw.get(tower).cfg
    jp = None
    if precision == "int8":
        jp, _ = jdcnn.generator_init(jax.random.PRNGKey(0), jcfg)
    jplan = jbuild(jcfg, batch=4, precision=precision, params=jp,
                   calib_batch=8)
    plan = NetworkPlan.from_json(jplan.to_json())
    assert plan.stable_hash() == jplan.stable_hash()
    for i, (a, b) in enumerate(zip(plan.layers, jplan.layers)):
        assert a.dtype_bytes == b.dtype_bytes
        assert a.tile_kwargs() == b.tile_kwargs()
        assert tuple(a.padded_geometry()) == tuple(b.padded_geometry())
    want_t = jplan.traffic_report()
    got_t = plan.traffic_report()
    assert {i: dataclasses.asdict(t) for i, t in got_t.items()} \
        == {i: dataclasses.asdict(t) for i, t in want_t.items()}
    want_p = jplan.modeled_attainable(jdse.TPU_V5E)
    got_p = plan.modeled_attainable(dse.TPU_V5E)
    assert {i: dataclasses.asdict(p) for i, p in got_p.items()} \
        == {i: dataclasses.asdict(p) for i, p in want_p.items()}
    assert plan.modeled_network_ops(dse.TPU_V5E) \
        == pytest.approx(jplan.modeled_network_ops(jdse.TPU_V5E), rel=1e-12)
    # the default is the H100 at the plan's dtype peak
    own = build_network_plan(tw.get(tower).cfg, batch=4, autotune=False)
    for pt in own.modeled_attainable().values():
        assert 0 < pt.attainable_ops <= dse.H100_SXM.peak_ops


def test_bf16_plans_are_modeled_at_the_bf16_peak():
    plan, _ = _celeba("fp32", "bfloat16")
    h100 = dse.H100_SXM
    bf16 = dataclasses.replace(h100, peak_ops=h100.bf16_peak_ops)
    for i, l in enumerate(plan.layers):
        t = l.tiles
        assert plan.modeled_attainable()[i] == dse.tile_attainable(
            l.geometry, t.t_oh, t.t_ow, t.t_ci, t.t_co, bf16, t_n=t.t_n,
            batch=plan.batch, dtype_bytes=2)


def test_to_json_writes_and_load_reads(tmp_path):
    plan = build_network_plan(SMALL, batch=4, autotune=False)
    path = tmp_path / "plan.json"
    assert plan.to_json(str(path)) == path.read_text()
    assert NetworkPlan.load(str(path)) == plan


# ---------------------------------------------------------------------------
# the CLI and the serving example
# ---------------------------------------------------------------------------
def test_cli_gates_on_a_mutated_plan(tmp_path, capsys):
    plan = build_network_plan(SMALL, batch=4, autotune=False)
    good = tmp_path / "good.json"
    plan.to_json(str(good))
    bad = _mutate(plan, lambda d: _tiles(d, 1, t_oh=7), tmp_path / "bad.json")
    assert cli(["--plan-json", str(good), "--lint"]) == 0
    assert cli(["--plan-json", bad, "--lint"]) == 1
    assert "drc.tile_alignment" in capsys.readouterr().out
    assert cli(["--plan-json", bad, "--lint", "--format", "json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] is False and doc["violations"][0]["rule_id"] \
        == "drc.tile_alignment"
    assert cli(["--list-rules"]) == 0
    assert "drc.smem_budget" in capsys.readouterr().out
    # the default lint pass: the port's threaded modules, no ERROR
    assert cli([]) == 0


def test_serving_example_pins_reloads_and_refuses(tmp_path):
    path = tmp_path / "plan.json"
    cmd = [sys.executable, str(ROOT / "examples" / "serve_dcnn_torch.py"),
           "--device", "cpu", "--batch", "4", "--reqs", "2", "--plan-json",
           str(path)]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "REPRO_TORCH_AUTOTUNE_CACHE": str(tmp_path / "at.json")}

    def run():
        return subprocess.run(cmd, env=env, capture_output=True, text=True,
                               timeout=600)

    res = run()
    assert res.returncode == 0, res.stderr[-3000:]
    assert "-> " + str(path) in res.stdout
    written = NetworkPlan.load(str(path))
    assert written.batch == 4 and written.backend == "cuda"
    res = run()
    assert res.returncode == 0, res.stderr[-3000:]
    assert f"pinned plan {written.stable_hash()} <- " in res.stdout
    assert "DRC clean" in res.stdout
    _mutate(written, lambda d: _tiles(d, 1, t_ci=12), path)
    res = run()
    assert res.returncode == 2, res.stdout[-3000:]
    assert "drc.tile_alignment" in res.stdout
