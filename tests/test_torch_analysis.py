"""The port's cost analyses (``repro_torch.analysis.cost``, ``.roofline``)
and dry run (``launch.steps.lower_cell``, ``launch.dryrun``,
``launch.hillclimb``) against the JAX package's ``analysis.hlo`` and
``analysis.roofline``, in-process.

Where the port's count differs from the reference's, the difference is a
named term of the test, never a tolerance:

* the reduced gemma2-27b prefill: the port's prefill projects each
  attention layer's keys and values twice (`attention_apply`, then
  ``_fill_cache`` for the cache), and XLA merges the two; the term is
  those projections' FLOPs;
* the loop multiplier (`analysis.cost.trips`) is exact for forward steps
  and for FLOPs and collectives of training steps; in a backward the
  engine's adds of gradients into one another follow the runs' arrival
  order, not the iterations' weights, so a training step's op count and
  bytes are only close to the full loop's and are not compared.

The fake process group is built only in this module's fixture (which
first asserts that no default group exists and destroys the fake one at
teardown), so no other test file on the same worker sees it.
"""
import ast
import dataclasses
import pathlib
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.configs as jconfigs
from repro.analysis import hlo as jhlo
from repro.analysis import roofline as jroofline
from repro.core import tiling as jtiling
from repro.launch import steps as jsteps
from repro.launch.mesh import make_test_mesh
from repro.models import dcnn as jdcnn
from repro.workloads import zoo as jzoo
from repro_torch import configs
from repro_torch.analysis import cost, roofline
from repro_torch.core import tiling
from repro_torch.launch import dryrun, hillclimb, steps
from repro_torch.launch.mesh import (destroy_fake_world, init_fake_world,
                                     make_lm_mesh, make_production_mesh)
from repro_torch.dist.context import constrain, sharding_context
from repro_torch.dist.sharding import make_rules
from repro_torch.models import nn
from repro_torch.models.attention import blocked_attention
from repro_torch.models.transformer import apply_lm, init_lm
from repro_torch.train.lm import VocabParallelNll, token_nll

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def fake_world():
    assert not dist.is_initialized(), "a process group is already running"
    yield
    destroy_fake_world()
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# FLOPs on the reference's three programs (tests/test_hlo_analysis.py)
# ---------------------------------------------------------------------------
def _ref_flops(f, *shapes):
    specs = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return jhlo.analyze(jax.jit(f).lower(*specs).compile().as_text()).flops


def _scan(n):
    def g(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        return jax.lax.scan(body, x, None, length=n)[0]
    return g


def test_flops_no_loop_equal_reference():
    shapes = ((128, 256), (256, 512), (512, 64))
    ref = _ref_flops(lambda a, b, c: (a @ b) @ c, *shapes)
    got = cost.analyze(lambda a, b, c: (a @ b) @ c,
                       *(torch.randn(s) for s in shapes))
    assert got.flops == ref == 2 * 128 * 256 * 512 + 2 * 128 * 512 * 64


@pytest.mark.parametrize("loops", ["multiply", "run"])
def test_flops_37_step_loop_equal_reference(loops):
    ref = _ref_flops(_scan(37), (64, 64), (64, 64))

    def g(x, w):
        for _ in cost.trips(37):
            x = torch.tanh(x @ w)
        return x

    got = cost.analyze(g, torch.randn(64, 64), torch.randn(64, 64),
                       loops=loops)
    assert got.flops == ref == 37 * 2 * 64 ** 3


@pytest.mark.parametrize("loops", ["multiply", "run"])
def test_flops_nested_5x7_loops_equal_reference(loops):
    def h(x, w):
        def outer(c, _):
            return _scan(5)(c, w), None
        return jax.lax.scan(outer, x, None, length=7)[0]

    ref = _ref_flops(h, (64, 64), (64, 64))

    def g(x, w):
        for _ in cost.trips(7):
            for _ in cost.trips(5):
                x = torch.tanh(x @ w)
        return x

    got = cost.analyze(g, torch.randn(64, 64), torch.randn(64, 64),
                       loops=loops)
    assert got.flops == ref == 35 * 2 * 64 ** 3


def test_eager_byte_model_of_a_streaming_chain():
    """``tanh(x) * 2 + 1``: three ops, each reading and writing x's bytes
    once (the reference's fused model counts one read and one write)."""
    n = 1 << 20
    got = cost.analyze(lambda x: torch.tanh(x) * 2.0 + 1.0, torch.randn(n))
    assert got.n_ops == 3
    assert got.bytes_accessed == 3 * 2 * n * 4
    assert got.peak_bytes == 2 * n * 4   # two temporaries at once


# ---------------------------------------------------------------------------
# the reduced gemma2-27b cells on a 1x1 mesh against the reference's
# ---------------------------------------------------------------------------
GEMMA_CELLS = {"train": (8, 64), "prefill": (4, 64), "decode": (8, 64)}


def _fill_cache_flops(cfg, b, s):
    """The prefill's second projection of every attention layer's keys
    and values (``_fill_cache``), which XLA merges with the first."""
    attn = sum(k in ("global", "local") for k in cfg.block_pattern) * \
        cfg.n_units + sum(k in ("global", "local")
                          for k in cfg.block_pattern[:cfg.n_rem])
    return attn * 2 * (2 * b * s * cfg.d_model * cfg.n_kv_heads
                       * cfg.head_dim)


@pytest.fixture(scope="module")
def gemma_reference():
    cfg = jconfigs.reduced_config("gemma2-27b")
    mesh = make_test_mesh(1, 1)
    out = {}
    for kind, (b, s) in GEMMA_CELLS.items():
        suite = jconfigs.ShapeSuite(kind, kind, s, b)
        compiled = jsteps.lower_cell(cfg, suite, mesh).compile()
        out[kind] = (jhlo.analyze(compiled.as_text()),
                     compiled.memory_analysis().argument_size_in_bytes)
    return out


def _gemma_cell_cost(kind, data, model, policy="auto"):
    """This rank's count of a reduced gemma2-27b cell on a fake
    (data, model) world."""
    init_fake_world(data * model)
    mesh = make_lm_mesh(data, model, device_type="cpu")
    cfg = configs.reduced_config("gemma2-27b")
    b, s = GEMMA_CELLS[kind]
    cell = steps.lower_cell(cfg, configs.ShapeSuite(kind, kind, s, b), mesh,
                            policy=policy)
    return cost.analyze(cell.fn, *cell.args, fake_mode=cell.fake_mode)


@pytest.fixture(scope="module")
def gemma_1x1(fake_world):
    return {kind: _gemma_cell_cost(kind, 1, 1) for kind in GEMMA_CELLS}


@pytest.mark.parametrize("kind", sorted(GEMMA_CELLS))
def test_reduced_gemma2_cell_against_reference(gemma_1x1, gemma_reference,
                                               kind):
    cfg = configs.reduced_config("gemma2-27b")
    b, s = GEMMA_CELLS[kind]
    got = gemma_1x1[kind]
    ref, ref_args = gemma_reference[kind]
    named = _fill_cache_flops(cfg, b, s) if kind == "prefill" else 0
    assert got.flops == ref.flops + named
    assert abs(got.argument_bytes - ref_args) <= 1e-3 * ref_args
    assert got.collectives == {} and got.n_ops > 0


# (kind, data, model, policy): "auto" is reduced gemma2-27b's tp, and
# fsdp_tp shards the weights over both axes; on the data-only world an
# FSDP decode runs the FFN's down projection on each rank's batch shard
SHARDED_CELLS = [("train", 2, 2, "fsdp_tp"), ("prefill", 2, 2, "fsdp_tp"),
                 ("decode", 2, 2, "auto"), ("decode", 2, 2, "fsdp_tp"),
                 ("decode", 4, 1, "fsdp_tp")]


@pytest.mark.parametrize("kind,data,model,policy", SHARDED_CELLS)
def test_sharded_flops_times_chips_equal_the_1x1_count(gemma_1x1, kind,
                                                       data, model, policy):
    """Per-device FLOPs x chips on a fake world equal the one-device
    count: no rank computes work that another does too."""
    got = _gemma_cell_cost(kind, data, model, policy)
    assert got.flops * data * model == gemma_1x1[kind].flops


def test_the_named_prefill_term_at_four_by_64():
    cfg = configs.reduced_config("gemma2-27b")
    assert _fill_cache_flops(cfg, 4, 64) == 8388608


# ---------------------------------------------------------------------------
# the vocab-parallel loss and lookup (ROADMAP C6, C7)
# ---------------------------------------------------------------------------
def test_sharded_train_keeps_the_vocabulary_split(fake_world):
    """C6: on a fake (2, 2) world under fsdp_tp the largest storage a rank
    makes in a train step is its own logits shard (its batch half by its
    vocabulary half, float32), never the microbatch's rows x seq x the
    full vocabulary that a gathered log_softmax builds."""
    cfg = configs.reduced_config("gemma2-27b")
    b, s = GEMMA_CELLS["train"]
    got = _gemma_cell_cost("train", 2, 2, "fsdp_tp")
    assert got.largest_bytes < b * s * cfg.vocab_size * 4
    assert got.largest_bytes == (b // 2) * s * (cfg.vocab_size // 2) * 4


def test_embedding_all_reduce_is_the_batch_shard(fake_world):
    """C7: the lookup on a fake (2, 2) prefill all-reduces the rank's
    batch shard only (rows / 2 x seq x d of the table's dtype; the ring
    model counts an all-reduce twice)."""
    init_fake_world(4)
    mesh = make_lm_mesh(2, 2, device_type="cpu")
    cfg = configs.reduced_config("gemma2-27b")
    b, s = GEMMA_CELLS["prefill"]
    cell = steps.lower_cell(cfg, configs.ShapeSuite("prefill", "prefill", s,
                                                    b), mesh,
                            policy="fsdp_tp")
    params, batch = cell.args
    rules = make_rules("fsdp_tp")

    def lookup(table, tokens):
        with sharding_context(mesh, rules):
            return nn.embed({"table": table}, constrain(tokens, "batch",
                                                        None))

    table = params["embed"]["table"]
    got = cost.analyze(lookup, table, batch["tokens"],
                       fake_mode=cell.fake_mode)
    calls, nbytes = got.collectives["all-reduce"]
    assert calls == 1
    assert nbytes == 2 * (b // 2) * s * cfg.d_model * table.element_size()


def test_vocab_parallel_loss_equals_the_1x1_loss():
    """C6's loss on reduced gemma2-27b's train batch, split as a (2, 2)
    world splits it (two batch shards, two vocabulary shards; each rank a
    thread whose all-reduce meets its batch shard's other vocabulary
    shard), equals the 1x1 loss, and so do the logits' gradients."""
    cfg = configs.reduced_config("gemma2-27b")
    b, s = GEMMA_CELLS["train"]
    v = cfg.vocab_size
    params = init_lm(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, v, (b, s + 1)))
    with torch.no_grad():
        logits = apply_lm(params, cfg, toks[:, :s], mode="train")[0].float()
    labels = toks[:, 1:]
    ref_in = logits.clone().requires_grad_(True)
    ref = token_nll(ref_in, labels).mean()
    ref.backward()

    slots = {d: [None, None] for d in range(2)}
    gates = {d: threading.Barrier(2) for d in range(2)}
    out, errors = {}, []

    def rank(d, m):
        def reduce(t, op):
            slots[d][m] = t
            gates[d].wait()
            both = torch.stack(slots[d])
            got = both.amax(0) if op == "max" else both[0] + both[1]
            gates[d].wait()
            return got

        try:
            rows = slice(d * b // 2, (d + 1) * b // 2)
            lg = logits[rows, :, m * v // 2:(m + 1) * v // 2].clone()
            lg.requires_grad_(True)
            nll = VocabParallelNll.apply(lg, labels[rows], m * v // 2,
                                         reduce)
            (nll.sum() / (b * s)).backward()
            out[d, m] = (nll.detach(), lg.grad)
        except BaseException as e:   # a failed rank fails the test
            errors.append(e)
            gates[d].abort()

    threads = [threading.Thread(target=rank, args=(d, m))
               for d in range(2) for m in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for d in range(2):
        assert torch.equal(out[d, 0][0], out[d, 1][0])
    loss = torch.cat([out[d, 0][0] for d in range(2)]).mean()
    torch.testing.assert_close(loss, ref.detach(), rtol=1e-6, atol=0)
    grad = torch.cat([torch.cat([out[d, m][1] for m in range(2)], -1)
                      for d in range(2)])
    torch.testing.assert_close(grad, ref_in.grad, rtol=1e-5, atol=1e-9)


# ---------------------------------------------------------------------------
# the loop multiplier against the fully run loop
# ---------------------------------------------------------------------------
def _both(fn, *args):
    return (cost.analyze(fn, *args),
            cost.analyze(fn, *args, loops="run"))


def _same(a, b):
    assert (a.flops, a.bytes_accessed, a.n_ops, a.collectives,
            a.peak_bytes) == (b.flops, b.bytes_accessed, b.n_ops,
                              b.collectives, b.peak_bytes)


def test_multiplier_equals_full_loop_on_blocked_attention():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 80, h, 16, generator=g) for h in (4, 2, 2))
    fn = lambda q, k, v: blocked_attention(q, k, v, block_q=16, block_k=16,
                                           window=24, softcap_val=30.0)
    _same(*_both(fn, q, k, v))


@pytest.fixture(scope="module")
def recurrent_model():
    """Reduced recurrentgemma at 11 layers: 3 units of (griffin, griffin,
    local) and the remainder, so the units loop, the time loops and the
    local attention's blocks all multiply."""
    cfg = dataclasses.replace(configs.reduced_config("recurrentgemma-2b"),
                              n_layers=11)
    params = init_lm(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 64)).astype(np.int32))
    return cfg, params, toks


def test_multiplier_equals_full_loop_on_recurrent_prefill(recurrent_model):
    cfg, params, toks = recurrent_model
    step = steps.build_prefill_step(cfg, None, None, 2, 64)
    _same(*_both(step, params, {"tokens": toks[:2]}))


def test_multiplier_flops_equal_full_loop_on_recurrent_train(recurrent_model):
    """Four microbatches of one row and 24 tokens."""
    cfg, params, toks = recurrent_model
    step = steps.build_train_step(cfg, None, None, grad_accum=4)
    opt = steps.make_optimizer(cfg).init(params)
    batch = {"tokens": toks[:, :24], "labels": toks[:, :24]}
    a, b = _both(step, params, opt, batch)
    assert a.flops == b.flops and a.collectives == b.collectives


# ---------------------------------------------------------------------------
# model FLOPs and the roofline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", sorted(configs.SHAPES))
@pytest.mark.parametrize("arch", sorted(configs.LM_CONFIGS))
def test_model_flops_equal_reference(arch, shape):
    assert roofline.model_flops(configs.LM_CONFIGS[arch],
                                configs.SHAPES[shape]) == \
        jroofline.model_flops(jconfigs.LM_CONFIGS[arch],
                              jconfigs.SHAPES[shape])


def test_roofline_terms_and_bottleneck():
    r = roofline.Roofline(
        arch="a", shape="s", mesh="pod", chips=256,
        flops_per_device=989e12, bytes_per_device=3.35e12 * 2,
        collective_bytes_per_device=50e9 * 0.5,
        collectives={}, peak_bytes_per_device=1e9,
        model_flops_global=989e12 * 256 * 0.5,
    )
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.IB_BW,
            roofline.NVLINK_BW) == (989e12, 3.35e12, 50e9, 450e9)
    assert r.t_compute == 1.0
    assert r.t_memory == 2.0
    assert r.t_collective == 0.5
    assert r.bottleneck == "memory"
    assert r.useful_flops_ratio == 0.5
    assert r.roofline_fraction == 0.25  # 0.5 useful / 2.0 bound
    # bytes filed by link: NVLink's share at its own rate
    r.link_bytes = {"nvlink": 450e9, "ib": 50e9}
    assert r.t_collective == 2.0
    assert r.row()["bottleneck"] in ("memory", "collective")


# ---------------------------------------------------------------------------
# deconv traffic and the kernels in the counter
# ---------------------------------------------------------------------------
TOWERS = {"mnist": jdcnn.MNIST_DCNN, "celeba": jdcnn.CELEBA_DCNN,
          "sr": jzoo.SR_X2, "denoise": jzoo.DAE_DENOISE}


@pytest.mark.parametrize("tower", sorted(TOWERS))
def test_deconv_traffic_report_equal_reference(tower):
    for g in TOWERS[tower].geometries():
        f = dataclasses.astuple(g)
        for tiles in ((g.stride, g.stride, 8, 3), (2 * g.stride,
                                                  2 * g.stride, 128, 64)):
            assert cost.deconv_traffic_report(
                tiling.DeconvGeometry(*f), *tiles) == \
                jhlo.deconv_traffic_report(jtiling.DeconvGeometry(*f),
                                           *tiles)


def _hook_cases():
    from repro_torch.kernels.deconv2d.int8 import deconv2d_int8
    from repro_torch.kernels.deconv2d.ops import deconv2d
    from repro_torch.kernels.deconv2d_sparse.ops import (deconv2d_sparse,
                                                         make_sparse_plan)

    w_np = np.random.default_rng(0).standard_normal(
        (4, 4, 64, 32)).astype(np.float32)
    w_np[:, :, :32] = 0
    sched = make_sparse_plan(w_np, 2, 1, 16, 32)
    return {
        "B1": (lambda x, w, s, b: deconv2d(x, w, b, 2, 1,
                                           activation="relu"),
               torch.float32),
        "B2": (lambda x, w, s, b: deconv2d_int8(
            x, w, s, b, 2, 1, activation="relu", out_scale=0.1),
            torch.int8),
        "B3": (lambda x, w, s, b: deconv2d_sparse(
            x, w, b, 2, 1, t_ci=16, t_co=32, schedule=sched), torch.float32),
    }


@pytest.mark.parametrize("kernel", ["B1", "B2", "B3"])
def test_kernel_hook_counts_the_geometry_ops_on_fake_inputs(kernel):
    from torch._subclasses.fake_tensor import FakeTensorMode

    fn, dtype = _hook_cases()[kernel]
    fm = FakeTensorMode()
    with fm:
        x = torch.empty(3, 8, 8, 64, dtype=dtype)
        w = torch.empty(4, 4, 64, 32, dtype=dtype)
        s, b = torch.empty(32), torch.empty(32)
    got = cost.analyze(fn, x, w, s, b, fake_mode=fm)
    g = tiling.DeconvGeometry(8, 8, 64, 32, 4, 2, 1)
    assert got.flops == g.ops * 3
    assert got.kernels == {kernel: 1}


def test_kernel_hook_is_silent_on_real_cpu_tensors():
    """A CPU tensor runs the plain version: its own ops are counted and
    no launch is reported."""
    fn, _ = _hook_cases()["B1"]
    got = cost.analyze(fn, torch.randn(1, 4, 4, 8), torch.randn(4, 4, 8, 4),
                       None, torch.zeros(4))
    assert got.kernels == {} and got.n_ops > 0


# ---------------------------------------------------------------------------
# the production mesh: one full-width cell, and H0
# ---------------------------------------------------------------------------
def _reference_record_keys():
    """The keys the reference's ``run_cell`` writes for an ok cell, read
    from its source (its dry run needs 512 forced host devices)."""
    tree = ast.parse((ROOT / "src" / "repro" / "launch" / "dryrun.py")
                     .read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "run_cell")
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys
                     if isinstance(k, ast.Constant)}
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "update"):
            keys |= {k.arg for k in node.keywords}
        elif (isinstance(node, ast.Subscript) and isinstance(
                node.value, ast.Name) and node.value.id == "rec"
              and isinstance(node.slice, ast.Constant)):
            keys.add(node.slice.value)
    return keys - {"reason", "error", "traceback"}


XLA_ONLY = {"compile_s", "xla_flops_per_device", "xla_bytes_per_device",
            "n_while", "hlo_sha1", "hlo_lines"}
PORT_ONLY = {"count_s", "n_ops", "trace_sha1", "grad_accum", "link_bytes",
             "peak_bytes"}


def test_full_width_cell_on_a_fake_256_rank_mesh(fake_world, tmp_path):
    t0 = time.time()
    rec = dryrun.run_cell("deepseek-7b", "decode_32k", "pod", str(tmp_path))
    assert time.time() - t0 < 15
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert set(rec) - PORT_ONLY == _reference_record_keys() - XLA_ONLY
    assert set(rec["memory_analysis"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes"}
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["n_ops"] > 0 and rec["collectives"]["all-reduce"][0] > 0
    # every collective crosses nodes on (16, 16): InfiniBand only
    assert set(rec["link_bytes"]) == {"ib"}
    r = dryrun.roofline_of(rec)
    assert r.bottleneck == "memory" and r.step_time_bound > 0


def test_h0_counts_b1_on_the_production_mesh(fake_world, tmp_path):
    mesh = make_production_mesh()
    rec = hillclimb.measure_dcnn("cuda", "h0", str(tmp_path), mesh)
    assert rec["rows_per_device"] == 256
    assert rec["kernels"] == {"B1": len(jdcnn.CELEBA_DCNN.layers)}
    assert rec["flops_per_device"] == hillclimb.dcnn_model_flops(256)
    assert rec["collective_bytes_per_device"] == 0
