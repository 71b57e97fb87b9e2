"""The LM sharded within a model (``repro_torch.launch.steps``' builders,
``dist.context.constrain`` placing DTensors, the shard-local MoE dispatch,
the replicated attention branch, ``dist.pipeline``) on 4 gloo ranks on the
CPU, against the JAX package's single-device results.

One module fixture draws the params (numpy, from the port's seeded
``init_lm``, which the reference loads as they are; the cases of one model
share them and its reference run), starts the four
ranks (``sharded_lm_ranks.py``, one thread each, a ``FileStore`` rendezvous
under the test's temporary directory, so parallel test workers never race
for a port), computes the reference's results while they run, and reads
what the ranks wrote; every case below checks one piece of that run.

Tolerances, each with its reason (all in float32):
* logits (prefill and two greedy decode steps) and the caches: 1e-5 of
  their largest magnitude (a row-parallel matmul sums its partials across
  ranks in another order); xlstm-1.3b runs two blocks, not the eight of
  its reduced stack that amplify a one-ulp perturbation to 3e-5
  (tests/test_torch_lm.py), and keeps 1e-5;
* with an int8 KV cache (``kv_quant``: deepseek-7b, qwen2-moe-a2.7b), a
  key or value one float32 ulp off a rounding boundary of ``quantize_kv``
  moves one int8 step: the int8 cache entries within 1 of the
  reference's, at most 0.1 % of them off, and the decode logits that
  read them within 5e-5 of their largest magnitude (prefill's logits read
  no int8 entry and keep 1e-5);
* greedy tokens, MoE slots, drops and sort order: equal;
* the train step's loss: rtol 1e-5; its Adam moments: ||diff|| / ||ref||
  <= 1e-4 over the tree (the first moments are the clipped grads);
* the pipeline: 1e-5 against the sequential apply, the reference test's
  tolerance, and equal to the reference's meshless ``pipeline_apply``
  within the same.
"""
import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.dist import pipeline as jpipeline
from repro.launch import steps as jsteps
from repro.models import ffn as jffn
from repro_torch import configs
from repro_torch.models import transformer as ptr

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
WORLD = 4
DECODE_STEPS = 2
TOL = 1e-5
MOE_FACTORS = (1.25, 0.5)

# name: (arch, overrides, policy, (data, model), prompt (B, S))
CASES = {
    "deepseek_tp_1x4": ("deepseek-7b", {}, "tp", (1, 4), (2, 12)),
    "deepseek_fsdp_tp_2x2": ("deepseek-7b", {}, "fsdp_tp", (2, 2), (2, 12)),
    # 4 x 32 = 128 tokens: two dispatch groups over a data axis of 2
    "qwen2_moe_fsdp_tp_2x2": ("qwen2-moe-a2.7b", {}, "fsdp_tp", (2, 2),
                              (4, 32)),
    "recurrentgemma_fsdp_tp_2x2": ("recurrentgemma-2b", {}, "fsdp_tp",
                                   (2, 2), (2, 12)),
    # one mLSTM and one sLSTM block over 128 tokens: the chunkwise mLSTM
    # in prefill and training, the step order in decode
    "xlstm_tp_1x4": ("xlstm-1.3b", {"n_layers": 2,
                                    "block_pattern": ("mlstm", "slstm")},
                     "tp", (1, 4), (2, 128)),
    # 6 experts on a model axis of 4: the experts replicate and the expert
    # FFN shards its hidden dim (partial sums through the down projection)
    "qwen2_moe_6_experts_tp_1x4": ("qwen2-moe-a2.7b", {"n_experts": 6},
                                   "tp", (1, 4), (4, 32)),
    # 6 q-heads on a model axis of 4: the replicated attention branch
    "minitron_6_heads_tp_1x4": ("minitron-4b",
                                {"n_heads": 6, "n_kv_heads": 2}, "tp",
                                (1, 4), (2, 12)),
}


def close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got.astype(np.float64) - want)))
    assert err <= tol * scale, f"max|diff| {err:.3e} vs {tol} x {scale:.3e}"


KV_QUANT_TOL = 5e-5


def kv_quant(name):
    arch, over = CASES[name][:2]
    return dataclasses.replace(configs.reduced_config(arch), **over).kv_quant


def leaves(tree):
    return [np.asarray(l) for l in jax.tree_util.tree_leaves(tree)]


def model_key(name):
    """Cases of one model and prompt shape share params and inputs, and so
    the reference's run."""
    arch, over, _, _, shape = CASES[name]
    return arch, tuple(sorted(over.items())), shape


MODELS = sorted({model_key(n) for n in CASES})


def make_cases():
    lm = {}
    for name, (arch, over, policy, mesh, (b, s)) in sorted(CASES.items()):
        i = MODELS.index(model_key(name))
        jcfg = dataclasses.replace(jconfigs.reduced_config(arch), **over)
        cfg = dataclasses.replace(configs.reduced_config(arch), **over)
        params = ptr.lm_params_to_numpy(ptr.init_lm(
            torch.Generator().manual_seed(i), cfg))
        rng = np.random.RandomState(100 + i)
        tokens = rng.randint(0, jcfg.vocab_size, (b, s + 1)).astype(np.int32)
        c = {"arch": arch, "overrides": over, "policy": policy, "mesh": mesh,
             "params": params,
             "prompt": tokens[:, :s], "decode_steps": DECODE_STEPS,
             "train": {"tokens": tokens[:, :s], "labels": tokens[:, 1:]}}
        if jcfg.n_experts:
            c["moe_x"] = rng.randn(2, 64, jcfg.d_model).astype(np.float32)
            c["moe_factors"] = MOE_FACTORS
        lm[name] = c
    rng = np.random.RandomState(0)
    pipe = {"ws": (rng.randn(4, 16, 16) * 0.3).astype(np.float32),
            "x": rng.randn(8, 16).astype(np.float32), "n_micro": 4}
    return {"lm": lm, "pipeline": pipe}


def ref_dispatch(p, cfg, x, cf):
    """The reference's routing, its own lines of ``moe_apply``: (sort_idx,
    sorted_e, slots with ``cap`` for a drop, cap, groups)."""
    e, k = cfg.n_experts, cfg.moe_top_k
    xf = x.reshape(-1, cfg.d_model)
    probs = jax.nn.softmax((xf @ p["router"]["w"]).astype(jnp.float32), -1)
    _, top_e = jax.lax.top_k(probs, k)
    g = jffn._dispatch_groups(xf.shape[0])
    tg = xf.shape[0] // g
    cap = int(max(1, round(tg * k / e * cf)))
    flat_e = top_e.reshape(g, tg * k)
    sort_idx = jnp.argsort(flat_e, axis=1)
    sorted_e = jnp.take_along_axis(flat_e, sort_idx, axis=1)
    counts = jax.vmap(lambda f: jnp.bincount(f, length=e))(flat_e)
    offsets = jnp.cumsum(counts, axis=1) - counts
    pos = (jnp.arange(tg * k)[None, :]
           - jnp.take_along_axis(offsets, sorted_e, axis=1))
    return (np.asarray(sort_idx), np.asarray(sorted_e),
            np.asarray(jnp.where(pos < cap, pos, cap)), cap, g)


def reference(c):
    jcfg = dataclasses.replace(jconfigs.reduced_config(c["arch"]),
                               **c["overrides"])
    jp = jax.tree_util.tree_map(jnp.asarray, c["params"])
    b, s = c["prompt"].shape
    prefill = jax.jit(jsteps.build_prefill_step(jcfg, None, None, b,
                                                s + DECODE_STEPS))
    decode = jax.jit(jsteps.build_decode_step(jcfg, None, None))
    logits, cache = prefill(jp, {"tokens": jnp.asarray(c["prompt"])})
    got = [np.asarray(logits)]
    for _ in range(DECODE_STEPS):
        tok = jnp.asarray(np.argmax(got[-1], -1)[:, None].astype(np.int32))
        logits, cache = decode(jp, cache, tok)
        got.append(np.asarray(logits))
    out = {"logits": got, "cache": leaves(cache)}
    opt = jsteps.make_optimizer(jcfg).init(jp)
    train = jax.jit(jsteps.build_train_step(jcfg, None, None))
    _, opt, met = train(jp, opt, jax.tree_util.tree_map(jnp.asarray,
                                                        c["train"]))
    out["loss"] = float(met["loss"])
    out["mu"], out["nu"] = leaves(opt.mu), leaves(opt.nu)
    if "moe_x" in c:
        mp = jax.tree_util.tree_map(lambda a: a[0],
                                    jp["units"]["b0"]["moe"])
        x = jnp.asarray(c["moe_x"])
        out["moe"] = []
        for cf in c["moe_factors"]:
            y, aux = jffn.moe_apply(mp, jcfg, x, capacity_factor=cf)
            out["moe"].append((np.asarray(y), float(aux),
                               ref_dispatch(mp, jcfg, x, cf)))
    return out


def references(cases):
    """The reference's results for every case of `make_cases`' ``cases``
    (one run a model), and the pipeline's sequential and meshless ones."""
    by_model = {}
    for name, c in cases["lm"].items():
        if model_key(name) not in by_model:
            by_model[model_key(name)] = reference(c)
    ref = {name: by_model[model_key(name)] for name in cases["lm"]}
    ws, x = cases["pipeline"]["ws"], cases["pipeline"]["x"]
    seq = x
    for i in range(ws.shape[0]):
        seq = np.tanh(seq @ ws[i])
    ref["pipeline_sequential"] = seq
    xm = jpipeline.microbatch(jnp.asarray(x), 4)
    ref["pipeline_meshless"] = np.asarray(jpipeline.pipeline_apply(
        None, None, lambda w, v: jnp.tanh(v @ w), jnp.asarray(ws), xm))
    return ref


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_lm")
    cases = make_cases()
    with open(d / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = []
    for r in range(WORLD):
        log = open(d / f"rank{r}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, str(HERE / "sharded_lm_ranks.py"), str(r),
             str(WORLD), str(d / "store"), str(d)],
            env=env, stdout=log, stderr=subprocess.STDOUT))
    try:
        ref = references(cases)     # the reference runs while the ranks do
        deadline = time.time() + 300
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = []
    for r in range(WORLD):
        path = d / f"rank{r}.pkl"
        if not path.exists():
            pytest.fail(f"rank {r} wrote nothing (rc {procs[r].returncode}):"
                        f"\n{(d / f'rank{r}.log').read_text()[-4000:]}")
        with open(path, "rb") as f:
            ranks.append(pickle.load(f))
    errors = [r["error"] for r in ranks if "error" in r]
    assert not errors, errors[0]
    assert all(p.returncode == 0 for p in procs)
    return cases, ref, ranks


NAMES = sorted(CASES)


@pytest.mark.parametrize("name", NAMES)
def test_every_placed_leaf_carries_its_specs_placements(run, name):
    _, _, ranks = run
    for r in ranks:
        assert r["cases"][name]["faults"] == []


@pytest.mark.parametrize("name", NAMES)
def test_prefill_logits(run, name):
    _, ref, ranks = run
    close(ranks[0]["cases"][name]["logits"][0], ref[name]["logits"][0])


@pytest.mark.parametrize("name", NAMES)
def test_greedy_decode_tokens_and_logits(run, name):
    _, ref, ranks = run
    got, want = ranks[0]["cases"][name]["logits"], ref[name]["logits"]
    assert len(got) == len(want) == DECODE_STEPS + 1
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.argmax(g, -1), np.argmax(w, -1))
        close(g, w, KV_QUANT_TOL if i and kv_quant(name) else TOL)


@pytest.mark.parametrize("name", NAMES)
def test_caches_after_decode(run, name):
    _, ref, ranks = run
    from repro_torch.core.tree import tree_leaves

    got = tree_leaves(ranks[0]["cases"][name]["cache"])
    want = ref[name]["cache"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w.dtype == np.int8:
            off = np.abs(g.astype(np.int32) - w) > 0
            assert np.abs(g.astype(np.int32) - w).max() <= 1
            assert off.mean() <= 1e-3
        elif w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w)
        else:
            close(g, w)


@pytest.mark.parametrize("name", NAMES)
def test_train_step_loss(run, name):
    _, ref, ranks = run
    np.testing.assert_allclose(ranks[0]["cases"][name]["loss"],
                               ref[name]["loss"], rtol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_train_step_adam_moments(run, name):
    from repro_torch.core.tree import tree_leaves

    _, ref, ranks = run
    for m in ("mu", "nu"):
        got = tree_leaves(ranks[0]["cases"][name][m])
        want = ref[name][m]
        diff = np.sqrt(sum(float(np.sum((g.astype(np.float64) - w) ** 2))
                           for g, w in zip(got, want)))
        norm = np.sqrt(sum(float(np.sum(w.astype(np.float64) ** 2))
                           for w in want))
        assert diff <= 1e-4 * norm, (m, diff, norm)


def test_every_rank_holds_the_same_results(run):
    _, _, ranks = run
    for r in ranks[1:]:
        for name in NAMES:
            for a, b in zip(r["cases"][name]["logits"],
                            ranks[0]["cases"][name]["logits"]):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(r["pipeline"], ranks[0]["pipeline"])


@pytest.mark.parametrize("cf", MOE_FACTORS)
def test_moe_shard_local_dispatch(run, cf):
    """Two groups over a data axis of 2: each rank scatters and combines
    its own group; slots, drops and the output equal the reference's."""
    _, ref, ranks = run
    i = MOE_FACTORS.index(cf)
    got = ranks[0]["cases"]["qwen2_moe_fsdp_tp_2x2"]["moe"][i]
    y, aux, (sort_idx, sorted_e, pos, cap, groups) = \
        ref["qwen2_moe_fsdp_tp_2x2"]["moe"][i]
    assert got["groups"] == groups == 2 and got["cap"] == cap
    np.testing.assert_array_equal(got["sort_idx"], sort_idx)
    np.testing.assert_array_equal(got["sorted_e"], sorted_e)
    np.testing.assert_array_equal(got["pos"], pos)
    if cf == 0.5:
        assert (pos == cap).any()        # some assignments are dropped
    close(got["y"], y)
    np.testing.assert_allclose(got["aux"], aux, rtol=1e-6)


def test_pipeline_over_four_stage_ranks_matches_sequential(run):
    _, ref, ranks = run
    np.testing.assert_allclose(ranks[0]["pipeline"].reshape(8, 16),
                               ref["pipeline_sequential"], rtol=1e-5,
                               atol=1e-5)


def test_pipeline_matches_the_reference_meshless_schedule(run):
    _, ref, ranks = run
    np.testing.assert_allclose(ranks[0]["pipeline"], ref["pipeline_meshless"],
                               rtol=1e-5, atol=1e-5)


def test_shard_index_inside_a_local_region(run):
    """Row-major over the batch axes, as the reference's: the data
    coordinate on (2, 2); pod * 2 + data on the multi-pod (2, 2, 1)."""
    _, _, ranks = run
    seen = set()
    for r in ranks:
        m = r["mesh"]
        c = m["2x2"]["coords"]
        assert m["2x2"]["index"] == c["data"]
        c = m["pod2x2x1"]["coords"]
        want = c["pod"] * 2 + c["data"]
        assert m["pod2x2x1"]["index"] == want
        seen.add(want)
    assert seen == {0, 1, 2, 3}
    # the region ran on each batch shard: shard i's rows hold i
    assert ranks[0]["mesh"]["2x2"]["in_region"] == [0, 0, 1, 1]
    assert ranks[0]["mesh"]["pod2x2x1"]["in_region"] == [0, 1, 2, 3]


def test_lm_mesh_refusals(run):
    """A world that is not the mesh's size, and a mesh on the card over
    a process group that is not NCCL, are refused."""
    _, _, ranks = run
    refused = ranks[0]["mesh"]["refused"]
    assert len(refused) == 2
    assert refused[0].startswith("ValueError") and "needs 8 ranks" in \
        refused[0]
    assert refused[1].startswith("RuntimeError") and "NCCL" in refused[1]


def test_global_norm_sums_every_shard(run):
    _, _, ranks = run
    for r in ranks:
        np.testing.assert_allclose(r["mesh"]["global_norm"],
                                   r["mesh"]["global_norm_whole"], rtol=1e-6)


def test_elastic_remesh_of_a_model_sharded_tree(run):
    """A tree placed ``fsdp_tp`` on (2, 2) loses rank 3: `elastic_mesh`
    over the survivors gives (1, 2), the reference's shape rule (data =
    3 // 2), with rank 2 idle; `reshard_tree` moves the tree onto it with
    its specs' placements there, and its values are the original's."""
    _, _, ranks = run
    for r in ranks:
        rm = r["mesh"]["remesh"]
        assert rm["shape"] == {"data": 1, "model": 2}
        assert rm["holds_shards"] == (r["rank"] < 2)
        if r["rank"] < 2:
            assert rm["equal"] and rm["placed"] and rm["leaves"] > 0
        else:
            assert rm["none"]


def test_make_lm_mesh_needs_a_process_group():
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_lm_mesh

    if not dist.is_initialized():
        with pytest.raises(RuntimeError, match="process group"):
            make_lm_mesh(1, 1, device_type="cpu")
