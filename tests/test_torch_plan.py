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
                                     kernel_for, kernel_smem_bytes)
from repro_torch.kernels.autotune import (SMS, TileChoice, ci_split,
                                          fill_tiles, grid_blocks,
                                          hopper_tiles)
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
    """Every layer at every bucket, for every kernel: S-aligned tiles, at
    most 512 threads (the kernels' launch bound, within the card's 1024)
    and 227 KB of shared memory per block.  Every dtype on the tensor-core
    kernels: CI chunks of a multiple of 8 channels (bf16: 16, int8: 32),
    channel tiles of a multiple of 8 (or C_out itself below 8), and at
    bucket 64 enough blocks, cluster split included, for the card's 132
    SMs."""
    for g in cfg.geometries():
        for batch in BUCKETS:
            for dtype in ("float32", "int8", "bfloat16"):
                kern = kernel_for(dtype)
                t = hopper_tiles(g, batch, dtype)
                blocks = grid_blocks(g, batch, t.t_oh, t.t_co, t.t_n)
                assert kern == "tc"
                split = ci_split(blocks, -(-g.c_in // t.t_ci))
                assert t.t_oh % g.stride == 0 and t.t_ow % g.stride == 0
                assert kernel_smem_bytes(g, t.t_oh, t.t_ow, t.t_ci, t.t_co,
                                         t.t_n, kern, split, dtype) \
                    <= MAX_SMEM <= 227 * 1024
                assert block_threads(g.stride, t.t_oh, t.t_ow, t.t_co,
                                     t.t_n, kern, dtype, g.kernel,
                                     t.t_ci) <= MAX_THREADS <= 1024
                assert 1 <= t.t_n <= batch
                step = {"int8": 32, "bfloat16": 16}.get(dtype, 8)
                assert t.t_ci % step == 0
                assert t.t_co % 8 == 0 or t.t_co == g.c_out < 8
                if batch == 64:
                    assert blocks * split >= SMS


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


# -- int8 and zero-skip plans ---------------------------------------------
@pytest.fixture(scope="module")
def mnist_params():
    import jax
    import numpy as np

    from repro.core.sparsity import prune_tree as j_prune_tree

    p, _ = jdcnn.generator_init(jax.random.PRNGKey(0), jdcnn.MNIST_DCNN)
    pp = j_prune_tree(p, 0.9)
    to_port = lambda tree: dcnn.generator_params_from_numpy(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, tree), dcnn.MNIST_DCNN, "cpu")
    return p, pp, to_port(p), to_port(pp)


def test_reference_pinned_int8_plan_loads_and_verifies(mnist_params):
    from repro_torch.quant import QuantConfig

    p, _, _, _ = mnist_params
    ref = j_build_network_plan(jdcnn.MNIST_DCNN, batch=4, backend="pallas",
                               precision="int8", params=p, autotune=False)
    plan = NetworkPlan.from_json(ref.to_json())
    assert plan.stable_hash() == ref.stable_hash()
    assert plan.quant_strategy == ref.quant_strategy
    qcfg = plan.quant_config()
    assert qcfg.to_dict() == dataclasses.asdict(ref.quant_config())
    hop = plan.for_hopper()
    assert (hop.backend, hop.precision, hop.quant_strategy) == \
        ("cuda", "int8", plan.quant_strategy)
    for a, b in zip(plan.layers, hop.layers):
        assert (a.quant, a.out_scale, a.out_dtype_bytes, a.dtype) == \
            (b.quant, b.out_scale, b.out_dtype_bytes, b.dtype)
        # int8 runs on the tensor cores, with its own tiles
        assert b.tiles == hopper_tiles(b.geometry, batch=4, dtype="int8")
    assert hop.layers[-1].out_dtype_bytes == 4 and hop.layers[0].dtype == "int8"
    # the port plans the same bucket from the same calibration identically
    assert hop == build_network_plan(
        dcnn.MNIST_DCNN, batch=4, precision="int8",
        quant_cfg=QuantConfig.from_dict(qcfg.to_dict()))
    assert NetworkPlan.from_json(hop.to_json()) == hop


def test_reference_pinned_sparse_plan_rebuilds_for_hopper(mnist_params):
    import numpy as np

    from repro.core.sparsity import prune_tree as j_prune_tree
    from repro_torch.kernels.deconv2d_sparse import make_sparse_plan
    from repro_torch.plan.deconv_plan import _sparse_digest

    p, pp, _, tpp = mnist_params
    ref = j_build_network_plan(jdcnn.MNIST_DCNN, batch=4,
                               backend="pallas_sparse", params=pp,
                               autotune=False)
    plan = NetworkPlan.from_json(ref.to_json())
    assert plan.stable_hash() == ref.stable_hash()
    for got, want in zip(plan.sparse_plans().values(),
                         ref.sparse_plans().values()):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="params"):
        plan.for_hopper()
    hop = plan.for_hopper(params=tpp)
    assert hop.backend == "cuda_sparse"
    for i, l in enumerate(hop.layers):
        assert l.tiles == hopper_tiles(l.geometry, batch=4)
        want = make_sparse_plan(tpp[f"l{i}"]["w"], l.geometry.stride,
                                l.geometry.padding, l.tiles.t_ci,
                                l.tiles.t_co)
        for g, w in zip(l.sparse_tables, want):
            np.testing.assert_array_equal(g, w)
        assert l.sparse_digest == _sparse_digest(want)
    assert hop == build_network_plan(dcnn.MNIST_DCNN, batch=4,
                                     backend="cuda_sparse", params=tpp)
    hop.verify_sparse_tables(tpp)
    plan.verify_sparse_tables(tpp)
    repruned = dcnn.generator_params_from_numpy(
        {k: {n: np.asarray(v) for n, v in d.items()}
         for k, d in j_prune_tree(p, 0.97).items()}, dcnn.MNIST_DCNN, "cpu")
    with pytest.raises(ValueError, match="stale"):
        hop.verify_sparse_tables(repruned)
    back = NetworkPlan.from_json(hop.to_json())
    assert back == hop and back.sparse_plans() is not None


def test_tampered_sparse_tables_are_refused(mnist_params):
    _, _, _, tpp = mnist_params
    plan = build_network_plan(dcnn.MNIST_DCNN, batch=2, backend="cuda_sparse",
                              params=tpp)
    d = json.loads(plan.to_json())
    d["layers"][1]["sparse_tables"][1][0][0] = 0
    with pytest.raises(PlanSchemaError, match="sparse schedule"):
        NetworkPlan.from_json(json.dumps(d))


def test_int8_and_sparse_layer_hash_is_the_reference_algorithm():
    """The int8 epilogue fields, the calibration and the schedule digest
    enter the hash byte for byte as in the JAX package."""
    import numpy as np

    from repro.plan.deconv_plan import _sparse_digest as j_digest
    from repro.quant import LayerQuant as JLayerQuant
    from repro_torch.plan.deconv_plan import _sparse_digest
    from repro_torch.quant import LayerQuant

    jg = JGeometry(7, 7, 256, 128, 4, 2, 1)
    g = DeconvGeometry(7, 7, 256, 128, 4, 2, 1)
    tables = tuple(np.arange(n, dtype=np.int32).reshape(s)
                   for n, s in ((6, (2, 3)), (6, (2, 3)), (96, (2, 3, 16))))
    assert _sparse_digest(tables) == j_digest(tables)
    ws = tuple(0.001 * (i + 1) for i in range(4))
    jp = JDeconvPlan(geometry=jg, batch=8, dtype="int8", backend="pallas",
                     activation="relu", out_scale=0.0123, out_dtype_bytes=4,
                     quant=JLayerQuant(x_scale=0.05, w_scale=ws),
                     sparse_digest=j_digest(tables),
                     tiles=JTileChoice(8, 8, 16, 64, 2, source="x"))
    tp = DeconvPlan(geometry=g, batch=8, dtype="int8", backend="pallas",
                    activation="relu", out_scale=0.0123, out_dtype_bytes=4,
                    quant=LayerQuant(x_scale=0.05, w_scale=ws),
                    sparse_digest=_sparse_digest(tables),
                    tiles=TileChoice(8, 8, 16, 64, 2))
    assert tp.request_dict() == jp.request_dict()
    assert tp.stable_hash() == jp.stable_hash()


def test_build_network_plan_refuses_what_it_cannot_plan(mnist_params):
    _, _, tp, _ = mnist_params
    with pytest.raises(ValueError, match="no quantized variant"):
        build_network_plan(dcnn.MNIST_DCNN, backend="cudnn", precision="int8",
                           params=tp)
    with pytest.raises(ValueError, match="needs params"):
        build_network_plan(dcnn.MNIST_DCNN, backend="cuda_sparse")
    with pytest.raises(ValueError, match="quant_cfg or params"):
        build_network_plan(dcnn.MNIST_DCNN, precision="int8")
    with pytest.raises(ValueError, match="precision"):
        build_network_plan(dcnn.MNIST_DCNN, precision="fp16")
