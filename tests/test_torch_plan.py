"""Port plans against the JAX package's plan documents and hashes, and the
Hopper tile choice against the kernel's limits."""
import dataclasses
import json

import pytest

from repro.core.tiling import DeconvGeometry as JGeometry
from repro.kernels.autotune import TileChoice as JTileChoice
from repro.models import dcnn as jdcnn
from repro.plan import DeconvPlan as JDeconvPlan
from repro.plan import build_network_plan as j_build_network_plan
from repro_torch.core.tiling import KERNEL_MAX_SMEM as MAX_SMEM
from repro_torch.core.tiling import KERNEL_MAX_THREADS as MAX_THREADS
from repro_torch.core.tiling import (DeconvGeometry, block_threads,
                                     kernel_smem_bytes)
from repro_torch.kernels.autotune import (SMS, TileChoice, fill_tiles,
                                          grid_blocks, hopper_tiles)
from repro_torch.models import dcnn
from repro_torch.plan import (DeconvPlan, NetworkPlan, PlanSchemaError,
                              build_network_plan)

NETS = [(jdcnn.MNIST_DCNN, dcnn.MNIST_DCNN),
        (jdcnn.CELEBA_DCNN, dcnn.CELEBA_DCNN)]
BUCKETS = (1, 2, 4, 8, 16, 32, 64)


@pytest.mark.parametrize("nets", NETS, ids=["mnist", "celeba"])
def test_reference_pinned_plan_loads_and_verifies(nets):
    jcfg, cfg = nets
    ref = j_build_network_plan(jcfg, batch=4, backend="pallas", autotune=False)
    plan = NetworkPlan.from_json(ref.to_json())
    assert plan.stable_hash() == ref.stable_hash()
    assert [l.stable_hash() for l in plan.layers] == \
        [l.stable_hash() for l in ref.layers]
    plan.validate_for(cfg)

    hop = plan.for_hopper()
    assert hop.backend == "cuda"
    assert (hop.name, hop.batch, hop.precision, hop.workload) == \
        (plan.name, plan.batch, plan.precision, plan.workload)
    for a, b in zip(plan.layers, hop.layers):
        assert (a.geometry, a.activation, a.batch, a.dtype) == \
            (b.geometry, b.activation, b.batch, b.dtype)
        assert b.tiles == hopper_tiles(b.geometry, batch=4)
    # a port-built plan for the same bucket is the same plan
    assert hop == build_network_plan(cfg, batch=4, backend="cuda")


def test_tampered_or_foreign_documents_are_refused():
    ref = j_build_network_plan(jdcnn.MNIST_DCNN, batch=2, backend="pallas",
                               autotune=False)
    d = json.loads(ref.to_json())
    d["layers"][1]["activation"] = "tanh"
    with pytest.raises(PlanSchemaError, match="hash mismatch"):
        NetworkPlan.from_json(json.dumps(d))
    d = json.loads(ref.to_json())
    d["precision"] = "int8"
    with pytest.raises(PlanSchemaError, match="int8"):
        NetworkPlan.from_json(json.dumps(d))
    d = json.loads(ref.to_json())
    d["schema"] = 0
    with pytest.raises(PlanSchemaError, match="schema"):
        NetworkPlan.from_json(json.dumps(d))
    with pytest.raises(PlanSchemaError, match="kind"):
        NetworkPlan.from_json("{}")


def test_layer_plan_hash_is_the_reference_algorithm():
    """Same fields, same digest: request_dict is byte-for-byte the JAX
    package's, tiles included and provenance excluded."""
    jg = JGeometry(4, 4, 1024, 512, 4, 2, 1)
    g = DeconvGeometry(4, 4, 1024, 512, 4, 2, 1)
    for backend in ("pallas", "cuda", "reverse_loop"):
        tiles = None if backend == "reverse_loop" else (8, 8, 16, 64, 2)
        jp = JDeconvPlan(geometry=jg, batch=8, backend=backend,
                         activation="relu",
                         tiles=tiles and JTileChoice(*tiles, source="x"))
        tp = DeconvPlan(geometry=g, batch=8, backend=backend,
                        activation="relu", tiles=tiles and TileChoice(*tiles))
        assert tp.request_dict() == jp.request_dict()
        assert tp.stable_hash() == jp.stable_hash()
        assert tp.stable_hash("tiles") == jp.stable_hash("tiles")


@pytest.mark.parametrize("cfg", [dcnn.MNIST_DCNN, dcnn.CELEBA_DCNN],
                         ids=["mnist", "celeba"])
def test_port_plan_json_round_trip(cfg):
    plan = build_network_plan(cfg, batch=16, backend="cuda")
    back = NetworkPlan.from_json(plan.to_json())
    assert back == plan and back.stable_hash() == plan.stable_hash()


@pytest.mark.parametrize("cfg", [dcnn.MNIST_DCNN, dcnn.CELEBA_DCNN],
                         ids=["mnist", "celeba"])
def test_hopper_tiles_fit_the_kernel(cfg):
    """Every layer at every bucket: S-aligned tiles, at most 512 threads
    (the kernel's launch bound, within the card's 1024) and 227 KB of
    shared memory per block, and at bucket 64 enough blocks for the
    card's 132 SMs."""
    for g in cfg.geometries():
        for batch in BUCKETS:
            t = hopper_tiles(g, batch)
            assert t.t_oh % g.stride == 0 and t.t_ow % g.stride == 0
            assert kernel_smem_bytes(g, t.t_oh, t.t_ow, t.t_ci, t.t_co,
                                     t.t_n) <= MAX_SMEM <= 227 * 1024
            assert block_threads(g.stride, t.t_oh, t.t_ow, t.t_co,
                                 t.t_n) <= MAX_THREADS <= 1024
            assert 1 <= t.t_n <= batch
            if batch == 64:
                assert grid_blocks(g, batch, t.t_oh, t.t_co, t.t_n) >= SMS


def test_tpu_tiles_do_not_fit_a_hopper_block():
    """Why tiles are re-resolved: the JAX plan's 128x128 channel tiles on
    CelebA's wide layers need a 1 MB weight slab."""
    g = DeconvGeometry(4, 4, 1024, 512, 4, 2, 1)
    assert kernel_smem_bytes(g, 8, 8, 128, 128, 1) > MAX_SMEM
    assert dataclasses.replace(hopper_tiles(g, 64), source="x") == \
        hopper_tiles(g, 64)


def test_fill_tiles_keeps_given_tiles_and_fills_the_rest():
    """Tiles given by name stay; those left out or None come from the
    Hopper heuristic at the batch."""
    g = DeconvGeometry(8, 8, 512, 256, 4, 2, 1)
    auto = hopper_tiles(g, 64)
    assert fill_tiles(g, 64) == auto
    got = fill_tiles(g, 64, t_oh=4, t_ow=None, t_ci=8)
    assert (got.t_oh, got.t_ow, got.t_ci, got.t_co, got.t_n) == \
        (4, auto.t_ow, 8, auto.t_co, auto.t_n)
    with pytest.raises(TypeError):
        fill_tiles(g, 64, t_x=2)
