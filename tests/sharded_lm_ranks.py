"""One rank of the sharded-LM checks in ``test_torch_sharded_lm.py``.

Run as ``python sharded_lm_ranks.py RANK WORLD STORE IN_DIR``: the ranks
meet through a ``torch.distributed.FileStore`` at STORE, run gloo on the
CPU with one thread each, read the cases from ``IN_DIR/cases.pkl``
(numpy params and inputs), and write what they found to
``IN_DIR/rank{RANK}.pkl``: rank 0 the results, every rank its placement
checks.  It imports the port only.
"""
import pickle
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist


def full(x):
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().numpy()


def tree_np(tree):
    from repro_torch.core.tree import tree_map

    return tree_map(full, tree)


def local_shape(global_shape, mesh, pl):
    from torch.distributed.tensor import Shard

    shape = list(global_shape)
    for a, p in zip(mesh.axis_names, pl):
        if isinstance(p, Shard):
            shape[p.dim] //= mesh.shape[a]
    return tuple(shape)


def placement_faults(mesh, rules, cfg, placed, what):
    """Leaves whose placements or local shapes are not their specs'."""
    from repro_torch.core.tree import tree_leaves, tree_paths
    from repro_torch.dist.sharding import leaf_pspecs, placements
    from repro_torch.launch.steps import abstract_params

    shapes, specs = abstract_params(cfg)
    bad = []
    for path, t, ps in zip(tree_paths(shapes), tree_leaves(placed),
                           leaf_pspecs(mesh, rules, shapes, specs)):
        pl = placements(mesh, ps)
        want = local_shape(tuple(t.shape), mesh, pl)
        if tuple(t.placements) != pl or tuple(t.to_local().shape) != want:
            bad.append((what, "/".join(path), str(t.placements), str(pl)))
    return bad


def run_case(c):
    import dataclasses

    from repro_torch import configs
    from repro_torch.dist.context import sharding_context
    from repro_torch.dist.sharding import make_rules
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models import ffn
    from repro_torch.models.transformer import lm_params_from_numpy

    cfg = dataclasses.replace(configs.reduced_config(c["arch"]),
                              **c["overrides"])
    data, model = c["mesh"]
    mesh = make_lm_mesh(data, model, device_type="cpu")
    rules = make_rules(c["policy"])
    params = lm_params_from_numpy(c["params"], cfg, device="cpu")
    placed = steps.place_params(mesh, rules, cfg, params)
    out = {"faults": placement_faults(mesh, rules, cfg, placed, "params")}

    b, s = c["prompt"].shape
    prefill = steps.build_prefill_step(cfg, mesh, rules, b,
                                       s + c["decode_steps"])
    logits, cache = prefill(placed, {"tokens": torch.from_numpy(c["prompt"])})
    decode = steps.build_decode_step(cfg, mesh, rules)
    got = [full(logits)]
    for _ in range(c["decode_steps"]):
        tok = torch.from_numpy(np.argmax(got[-1], -1)[:, None].astype(
            np.int32))
        logits, cache = decode(placed, cache, tok)
        got.append(full(logits))
    out["logits"] = got
    out["cache"] = tree_np(cache)
    print("  served", time.time(), flush=True)

    opt = steps.make_optimizer(cfg).init(placed)
    train = steps.build_train_step(cfg, mesh, rules)
    batch = {k: torch.from_numpy(v) for k, v in c["train"].items()}
    new, opt, met = train(placed, opt, batch)
    out["loss"] = float(full(met["loss"]))
    out["mu"], out["nu"] = tree_np(opt.mu), tree_np(opt.nu)
    out["faults"] += placement_faults(mesh, rules, cfg, new, "new params")
    out["faults"] += placement_faults(mesh, rules, cfg, opt.mu, "mu")
    print("  trained", time.time(), flush=True)

    if "moe_x" in c:    # the shard-local dispatch, block 0's MoE alone
        from repro_torch.core.tree import tree_map

        mp = tree_map(lambda v: v[0], placed["units"]["b0"]["moe"])
        out["moe"] = []
        for cf in c["moe_factors"]:
            with sharding_context(mesh, rules):
                x = torch.from_numpy(c["moe_x"])
                y, aux = ffn.moe_apply(mp, cfg, x, capacity_factor=cf)
                r = ffn.moe_route(mp, cfg, x.reshape(-1, cfg.d_model), cf)
            out["moe"].append({"y": full(y), "aux": float(full(aux)),
                               "sort_idx": full(r.sort_idx),
                               "sorted_e": full(r.sorted_e),
                               "pos": full(r.pos), "cap": r.cap,
                               "groups": int(r.sort_idx.shape[0])})
    return out


def run_pipeline(c):
    from repro_torch.dist.pipeline import microbatch, pipeline_apply
    from repro_torch.launch.mesh import make_lm_mesh

    mesh = make_lm_mesh(1, 1, pod=4, device_type="cpu")
    ws = torch.from_numpy(c["ws"])

    def stage_fn(w, x):
        return torch.tanh(x @ w)

    xm = microbatch(torch.from_numpy(c["x"]), c["n_micro"])
    return pipeline_apply(mesh, "pod", stage_fn, ws, xm).numpy()


def run_mesh_checks():
    """This rank's batch-shard index inside a local region, the mesh
    refusals, and the global norm of a placed tree."""
    from repro_torch.dist.context import local_region, sharding_context
    from repro_torch.dist.sharding import make_rules, shard_index
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.optim.optimizer import global_norm
    from repro_torch import configs

    out = {}
    for name, (shape, multi) in {"2x2": ((2, 2, 0), False),
                                 "pod2x2x1": ((2, 1, 2), True)}.items():
        mesh = make_lm_mesh(*shape, device_type="cpu")
        rules = make_rules("tp", multi)
        with sharding_context(mesh, rules):
            got = local_region(
                lambda x: x + shard_index(mesh, rules), [("batch",)],
                ("batch",), torch.zeros(4, dtype=torch.int64))
        out[name] = {"coords": {a: mesh.coordinate(a)
                                for a in mesh.axis_names},
                     "index": shard_index(mesh, rules),
                     "in_region": full(got).tolist()}
    refused = []
    for kw in ({"data": 2, "model": 4}, {"data": 1, "model": 4,
                                          "device_type": "cuda"}):
        try:
            make_lm_mesh(**kw) if "device_type" in kw else make_lm_mesh(
                **kw, device_type="cpu")
        except (ValueError, RuntimeError) as e:
            refused.append(type(e).__name__ + ": " + str(e))
    out["refused"] = refused
    cfg = configs.reduced_config("deepseek-7b")
    mesh = make_lm_mesh(2, 2, device_type="cpu")
    rules = make_rules("fsdp_tp")
    params = steps.init_placed_params(cfg, mesh, rules, 5)
    whole = steps.full_params(params)
    out["global_norm"] = float(full(global_norm(params)))
    out["global_norm_whole"] = float(global_norm(whole))
    out["remesh"] = run_remesh(cfg, rules, params, whole)
    return out


def run_remesh(cfg, rules, params, whole):
    """The (2, 2)-placed tree after rank 3 is lost: `elastic_mesh` over
    the survivors 0, 1 and 2 at model_parallel 2, and the tree moved onto
    it by `reshard_tree` with the specs' placements there."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.dist.fault import elastic_mesh, reshard_tree
    from repro_torch.dist.sharding import tree_shardings
    from repro_torch.launch import steps

    small = elastic_mesh([0, 1, 2], model_parallel=2)
    pls = tree_shardings(small, rules, *steps.abstract_params(cfg))
    moved = reshard_tree(params, small, pls)
    out = {"shape": small.shape, "holds_shards": small.holds_shards}
    if small.holds_shards:
        got = steps.full_params(moved)
        out["equal"] = all(torch.equal(a, b) for a, b in
                           zip(tree_leaves(got), tree_leaves(whole)))
        out["placed"] = all(
            tuple(t.placements) == pl and t.device_mesh is small.device_mesh
            for t, pl in zip(tree_leaves(moved), _pl_leaves(pls)))
        out["leaves"] = len(tree_leaves(got))
    else:
        out["none"] = all(t is None for t in _none_leaves(moved))
    return out


def _pl_leaves(pls):
    """The placement tuples of a placements tree, in leaf order (a tuple
    of placements is one leaf)."""
    from torch.distributed.tensor.placement_types import Placement

    if isinstance(pls, tuple) and all(isinstance(p, Placement) for p in pls):
        return [pls]
    if isinstance(pls, dict):
        return [l for k in sorted(pls) for l in _pl_leaves(pls[k])]
    return [l for c in pls for l in _pl_leaves(c)]


def _none_leaves(tree):
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _none_leaves(tree[k])]
    return [tree]


def main():
    rank, world, store_path, in_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                       sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_distributed

    init_distributed("cpu", store=dist.FileStore(store_path, world),
                     rank=rank, world_size=world)
    with open(f"{in_dir}/cases.pkl", "rb") as f:
        cases = pickle.load(f)
    result = {"rank": rank}
    try:
        result["cases"] = {}
        for name, c in cases["lm"].items():
            print("case", name, time.time(), flush=True)
            result["cases"][name] = run_case(c)
        print("pipeline", time.time(), flush=True)
        result["pipeline"] = run_pipeline(cases["pipeline"])
        result["mesh"] = run_mesh_checks()
        print("done", time.time(), flush=True)
    except Exception:
        result["error"] = traceback.format_exc()
    with open(f"{in_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)
    if "error" in result:
        sys.exit(1)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
