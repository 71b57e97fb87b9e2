#!/usr/bin/env python3
"""The LM sharded within a model over every visible card: one process per
card, NCCL, DTensor placements on an `LmMesh`.

Launch (one rank per card; ``chip_smoke.py`` phase 15 runs ``--smoke``
this way over ``torch.cuda.device_count()`` ranks):

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        tools/probe_tp.py [--smoke] [--out FILE]

``--smoke`` (any N; one card on a one-card machine):

* deepseek-7b at full width (bf16, int8 KV cache, weights drawn on the
  cards) served through `launch.steps.build_prefill_step` and
  `build_decode_step` under ``tp`` on (1, N): 4 x 128 prompt tokens, 16
  greedy decode steps; prefill ms, decode ms per step, tokens/s and
  ``max_memory_allocated`` per card, beside the same figures of the
  meshless path (``apply_lm`` on rank 0's card, the same weights);
* the hard check at 2 layers in float32 (TF32 off, no KV quantization):
  the sharded logits within 1e-4 of max|logits| of the meshless path on
  rank 0's card, and the greedy tokens equal.

Without ``--smoke`` (four cards), also:

* phi3.5-moe-42b-a6.6b at full width (bf16), ``default_policy`` (fsdp_tp)
  on (1, 4): its draw's seconds (each card draws only its shards), peak
  memory per card, prefill 4 x 128 and 16 decode steps; the 2-layer
  float32 check at capacity factor 16 against rank 0;
* `dist.pipeline.pipeline_apply` over 4 stage ranks (width 4096, 16
  microbatches of 8 rows) against the sequential apply on rank 0 (1e-5),
  with the ms of each;
* one `build_train_step` step of deepseek-7b at full width, 2 layers,
  float32, fsdp_tp on (2, 2) against ``make_train_step`` on rank 0 from
  the same params: losses rtol 1e-4, Adam's moments within 1e-4 as a
  tree-norm ratio;
* xlstm-1.3b at full width, one mLSTM and one sLSTM block, float32, tp on
  (1, 4) over 128 tokens (the chunkwise mLSTM): the greedy check of a
  2 x 128 prompt, and one train step of 2 x 128, against rank 0 as above.

Rank 0 prints one JSON line per measurement with the card's name and
power limit (and appends them to ``--out``), and ``{"ok": true}`` last.
A failed check raises on every rank: the launch exits non-zero.

``--device cpu --reduced`` rehearses the same control flow on the CPU
(gloo, the reduced configs, ``torch.distributed.run`` with
``--nproc-per-node 4``); its numbers are no measurement.
``python tools/probe_tp.py --bounds`` prints `decode_bound` for the
probe's meshes with no process group (arithmetic on shapes).
"""
import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.dist.pipeline import microbatch, pipeline_apply  # noqa: E402
from repro_torch.dist.sharding import (leaf_pspecs,  # noqa: E402
                                       make_rules)
from repro_torch.launch.mesh import init_distributed, make_lm_mesh  # noqa: E402
from repro_torch.launch.steps import (abstract_params,  # noqa: E402
                                      build_decode_step,
                                      build_prefill_step, build_train_step,
                                      default_policy, full_params,
                                      init_placed_params, make_optimizer)
from repro_torch.models.nn import tree_bytes, tree_size  # noqa: E402
from repro_torch.train.lm import make_train_step  # noqa: E402

BATCH, PROMPT, DECODE = 4, 128, 16
CHECK_LAYERS, CHECK_BATCH, CHECK_PROMPT, CHECK_NEW = 2, 2, 24, 8
LOGIT_TOL = 1e-4            # of max|logits| of the meshless path
CHECK_CAPACITY = 16.0       # no MoE assignment drops in the check
TRAIN_CHECK = (4, 64)       # batch, seq of the train-step check
TRAIN_TOL = 1e-4            # losses rtol; Adam's moments as a norm ratio
XLSTM_PROMPT = 128          # the chunkwise mLSTM's shortest sequence
XLSTM_PATTERN = ("mlstm", "slstm")
PIPE_WIDTH, PIPE_MICRO, PIPE_ROWS = 4096, 16, 8
PIPE_TOL = 1e-5
HBM_BW = 3.35e12            # B/s, one H100 SXM's HBM3 (NVIDIA's data sheet)
NVLINK_BW = 450e9           # B/s, its NVLink 4 in one direction (900 both)
DEV = "cuda"                # "cpu" for a rehearsal (--device cpu)
REDUCED = False             # the reduced configs (--reduced)


def get_config(name):
    return configs.reduced_config(name) if REDUCED else configs.get_config(
        name)


def card() -> str:
    if DEV == "cpu":
        return "cpu rehearsal"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


class Report:
    """Rank 0's JSON lines, on standard output and appended to a file."""

    def __init__(self, out):
        self.out, self.smi = out, card()
        if out and dist.get_rank() == 0:
            os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)

    def __call__(self, **row):
        if dist.get_rank() != 0:
            return
        line = json.dumps({**row, "card": self.smi})
        print(line, flush=True)
        if self.out:
            with open(self.out, "a") as f:
                f.write(line + "\n")


def cuda_sync():
    if DEV == "cuda":
        torch.cuda.synchronize()


def sync():
    cuda_sync()
    dist.barrier()


def peak_bytes() -> int:
    return torch.cuda.max_memory_allocated() if DEV == "cuda" else 0


def reset_peak():
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()


def free_cache():
    if DEV == "cuda":
        torch.cuda.empty_cache()


def gib(n: int) -> float:
    return n / 2 ** 30


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh as the rule functions read it: its axis extents."""
    shape: dict


def decode_bound(cfg, shape: dict, rules, batch: int = BATCH):
    """The least time of one decode step of ``batch`` tokens on one card
    of a mesh of ``shape``: the weight bytes that card holds, read once at
    the HBM rate, plus the bytes it sends in the step's collectives at the
    NVLink rate (with a model axis of n > 1: a ring all-reduce, 2 (n-1)/n
    of the tensor, of each layer's two row-parallel outputs, attention and
    FFN or expert combine, and of the vocab-parallel lookup; an all-gather,
    (n-1)/n, of the float32 logits).  Returns (s, weight bytes a card,
    collective bytes a card)."""
    mesh = MeshShape(dict(shape))
    shapes, specs = abstract_params(cfg)
    local = 0
    for t, ps in zip(tree_leaves(shapes),
                     leaf_pspecs(mesh, rules, shapes, specs)):
        n = 1
        for axis in ps:
            for a in (axis if isinstance(axis, tuple) else (axis,)):
                n *= shape.get(a, 1) if a is not None else 1
        local += t.numel() // n * t.element_size()
    m = shape.get("model", 1)
    coll = 0.0
    if m > 1:
        act = batch * cfg.d_model * cfg.tdtype.itemsize
        coll = (2 * (m - 1) / m * act * (2 * cfg.n_layers + 1)
                + (m - 1) / m * batch * cfg.vocab_size * 4)
    return local / HBM_BW + coll / NVLINK_BW, local, coll


def whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value (a collective), a plain tensor as it is."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def greedy(cfg, params, mesh, rules, prompts, steps):
    """Prefill ``prompts`` and decode ``steps`` greedy tokens through the
    step builders (``mesh=None``: the meshless path).  Returns (prefill
    ms, decode ms per step (median), tokens (B, steps), the prefill's and
    the first decode step's last logits)."""
    b, s = prompts.shape
    prefill = build_prefill_step(cfg, mesh, rules, b, s + steps)
    decode = build_decode_step(cfg, mesh, rules)
    tok = torch.from_numpy(prompts).to(DEV)
    wait = sync if mesh is not None else cuda_sync   # rank 0 alone: no barrier
    with torch.no_grad():
        wait()
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": tok})
        logits = whole(logits)
        wait()
        pre_ms = (time.perf_counter() - t0) * 1e3
        seen, out, dec = [logits.float().cpu()], [], []
        for i in range(steps):
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{cfg.name}: logits not finite")
            nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
            out.append(nxt.cpu())
            wait()
            t0 = time.perf_counter()
            logits, cache = decode(params, cache, nxt)
            logits = whole(logits)
            wait()
            dec.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                seen.append(logits.float().cpu())
    return (pre_ms, statistics.median(dec), torch.cat(out, 1).numpy(),
            seen)


def serve(report, cfg, mesh, rules, what, meshless=True, seed=0):
    """``cfg`` at full width, drawn on the cards in its shards, served
    sharded; with ``meshless``, the same weights gathered onto every card
    and served without a mesh on rank 0's."""
    reset_peak()
    sync()
    t0 = time.perf_counter()
    params = init_placed_params(cfg, mesh, rules, seed=seed)
    sync()
    draw_s = time.perf_counter() - t0
    local = sum(t.to_local().numel() * t.element_size()
                for t in tree_leaves(params))
    draw_peak = peak_bytes()
    rng = np.random.RandomState(seed)
    prompts = rng.randint(1, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    reset_peak()
    # the first call at these shapes builds DTensor's sharding plans: it
    # is timed apart
    t0 = time.perf_counter()
    greedy(cfg, params, mesh, rules, prompts, 1)
    first_s = time.perf_counter() - t0
    pre, dec, toks, _ = greedy(cfg, params, mesh, rules, prompts, DECODE)
    peak = peak_bytes()
    row = {"what": what, "arch": cfg.name, "mesh": mesh.shape,
           "policy": what.split()[-1], "params": tree_size(params),
           "weight_gb": tree_bytes(params) / 1e9,
           "local_weight_gib": gib(local), "draw_s": draw_s,
           "draw_peak_gib": gib(draw_peak), "first_call_s": first_s,
           "prefill_ms": pre, "decode_ms": dec,
           "decode_tokens_per_s": BATCH * 1e3 / dec,
           "prefill_tokens_per_s": BATCH * PROMPT * 1e3 / pre,
           "max_memory_allocated_gib": gib(peak),
           "batch": BATCH, "prompt": PROMPT, "decode_steps": DECODE}
    bound, wbytes, cbytes = decode_bound(cfg, mesh.shape, rules)
    row.update(decode_bound_ms=bound * 1e3, bound_weight_bytes=wbytes,
               bound_collective_bytes=cbytes)
    if meshless:
        plain = full_params(params)
        del params
        free_cache()
        if dist.get_rank() == 0:
            reset_peak()
            greedy(cfg, plain, None, None, prompts, 1)
            mpre, mdec, mtoks, _ = greedy(cfg, plain, None, None, prompts,
                                          DECODE)
            row.update(meshless_prefill_ms=mpre, meshless_decode_ms=mdec,
                       meshless_decode_tokens_per_s=BATCH * 1e3 / mdec,
                       meshless_max_memory_allocated_gib=gib(
                           peak_bytes()),
                       meshless_tokens_equal_bf16=bool(
                           np.array_equal(mtoks, toks)))
        del plain
    else:
        del params
    sync()
    free_cache()
    report(**row)


def exact_fp32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check(report, cfg, mesh, rules, what, prompt=CHECK_PROMPT):
    """``cfg`` at full width, CHECK_LAYERS layers, float32, no KV
    quantization (a MoE at CHECK_CAPACITY): the sharded greedy tokens and
    logits of a CHECK_BATCH x ``prompt`` prompt against the meshless
    path's on rank 0 from the same weights."""
    exact_fp32()
    cfg = dataclasses.replace(cfg, n_layers=CHECK_LAYERS, dtype="float32",
                              kv_quant=False,
                              moe_capacity_factor=CHECK_CAPACITY)
    params = init_placed_params(cfg, mesh, rules, seed=1)
    prompts = np.random.RandomState(1).randint(
        1, cfg.vocab_size, (CHECK_BATCH, prompt)).astype(np.int32)
    _, _, toks, seen = greedy(cfg, params, mesh, rules, prompts, CHECK_NEW)
    plain = full_params(params)
    del params
    ok, errs = True, {}
    if dist.get_rank() == 0:
        _, _, mtoks, mseen = greedy(cfg, plain, None, None, prompts,
                                    CHECK_NEW)
        ok = bool(np.array_equal(toks, mtoks))
        for name, a, b in zip(("prefill", "decode"), seen, mseen):
            err, scale = float((a - b).abs().max()), float(b.abs().max())
            errs[name] = {"err": err, "max": scale}
            ok = ok and err <= LOGIT_TOL * scale
    del plain
    free_cache()
    flag = torch.tensor([int(ok)], device=DEV)
    dist.broadcast(flag, 0)
    report(what=what, arch=cfg.name, mesh=mesh.shape, layers=CHECK_LAYERS,
           dtype="float32", prompt=prompt, greedy_tokens=CHECK_NEW,
           tokens_equal=ok,
           logits=errs, tol=LOGIT_TOL)
    if not flag.item():
        raise AssertionError(f"{what}: the sharded path disagrees with the "
                             f"meshless one: {errs}")


def train_check(report, cfg, mesh, rules, what, shape=TRAIN_CHECK):
    """One build_train_step step of ``cfg`` at full width, 2 layers,
    float32, on a batch of ``shape``, against make_train_step on rank 0
    from the same params and fresh AdamW states."""
    exact_fp32()
    cfg = dataclasses.replace(cfg, n_layers=CHECK_LAYERS, dtype="float32",
                              kv_quant=False, remat=False)
    params = init_placed_params(cfg, mesh, rules, seed=2)
    b, s = shape
    tokens = np.random.RandomState(2).randint(
        1, cfg.vocab_size, (b, s + 1)).astype(np.int64)
    batch = {"tokens": torch.from_numpy(tokens[:, :-1]).to(DEV),
             "labels": torch.from_numpy(tokens[:, 1:]).to(DEV)}
    opt = make_optimizer(cfg)
    step = build_train_step(cfg, mesh, rules)
    st = opt.init(params)
    sync()
    t0 = time.perf_counter()
    _, st, met = step(params, st, batch)
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    loss = float(whole(met["loss"]))
    mu, nu = full_params(st.mu), full_params(st.nu)
    plain = full_params(params)
    del params, st
    ok, row = True, {}
    if dist.get_rank() == 0:
        ref = make_train_step(cfg, opt)
        _, rst, _, rmet = ref(plain, opt.init(plain), None, batch)
        rloss = float(rmet["loss"])

        def ratio(a, b):
            d = sum(float(((x - y).double() ** 2).sum())
                    for x, y in zip(tree_leaves(a), tree_leaves(b)))
            n = sum(float((y.double() ** 2).sum()) for y in tree_leaves(b))
            return (d / n) ** 0.5

        row = {"loss": loss, "meshless_loss": rloss,
               "mu_ratio": ratio(mu, rst.mu), "nu_ratio": ratio(nu, rst.nu)}
        ok = (abs(loss - rloss) <= TRAIN_TOL * abs(rloss)
              and row["mu_ratio"] <= TRAIN_TOL
              and row["nu_ratio"] <= TRAIN_TOL)
    del plain, mu, nu
    free_cache()
    flag = torch.tensor([int(ok)], device=DEV)
    dist.broadcast(flag, 0)
    report(what=what, arch=cfg.name, mesh=mesh.shape,
           layers=CHECK_LAYERS, dtype="float32", batch=list(shape),
           step_ms_first_call=ms, ok=ok, tol=TRAIN_TOL, **row)
    if not flag.item():
        raise AssertionError(f"{what}: sharded vs meshless {row}")


def pipeline_check(report, mesh):
    """pipeline_apply over the 4 stage ranks of the ``pod`` axis against
    the sequential apply on rank 0, with the ms of each."""
    exact_fp32()
    g = torch.Generator(DEV).manual_seed(3)
    n = mesh.shape["pod"]
    width = 64 if REDUCED else PIPE_WIDTH
    ws = torch.randn((n, width, width), generator=g,
                     device=DEV) / width ** 0.5
    x = torch.randn((PIPE_MICRO * PIPE_ROWS, width), generator=g,
                    device=DEV)

    def stage_fn(w, v):
        return torch.tanh(v @ w)

    xm = microbatch(x, PIPE_MICRO)
    pipeline_apply(mesh, "pod", stage_fn, ws, xm)        # warm
    times = []
    for _ in range(5):
        sync()
        t0 = time.perf_counter()
        y = pipeline_apply(mesh, "pod", stage_fn, ws, xm)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    seq, stimes = x, []
    for _ in range(5):
        cuda_sync()
        t0 = time.perf_counter()
        seq = x
        for i in range(n):
            seq = stage_fn(ws[i], seq)
        cuda_sync()
        stimes.append((time.perf_counter() - t0) * 1e3)
    err = float((y.reshape(seq.shape) - seq).abs().max())
    ok = err <= PIPE_TOL * max(1.0, float(seq.abs().max()))
    report(what="pipeline_apply", stages=n, width=width,
           microbatches=PIPE_MICRO, rows=PIPE_ROWS, max_abs_err=err,
           tol=PIPE_TOL, ok=ok, pipeline_ms=statistics.median(times),
           sequential_one_card_ms=statistics.median(stimes))
    if not ok:
        raise AssertionError(f"pipeline_apply: {err:.3e} off the sequential")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--bounds", action="store_true")
    args = ap.parse_args()
    if args.bounds:
        for name, shape, policy in (
                ("deepseek-7b", {"data": 1, "model": 1}, "tp"),
                ("deepseek-7b", {"data": 1, "model": 4}, "tp"),
                ("phi3.5-moe-42b-a6.6b", {"data": 1, "model": 4},
                 "fsdp_tp")):
            s, w, c = decode_bound(configs.get_config(name), shape,
                                   make_rules(policy))
            print(json.dumps({"arch": name, "mesh": shape, "policy": policy,
                              "batch": BATCH, "decode_bound_ms": s * 1e3,
                              "weight_bytes_per_card": w,
                              "collective_bytes_per_card": c}))
        return
    global DEV, REDUCED
    DEV, REDUCED = args.device, args.reduced
    init_distributed(DEV)
    n = dist.get_world_size()
    report = Report(args.out)
    tp = make_rules("tp")
    mesh = make_lm_mesh(1, n, device_type=DEV)
    ds = get_config("deepseek-7b")
    serve(report, ds, mesh, tp, "serve deepseek-7b tp")
    check(report, ds, mesh, tp, "check deepseek-7b tp")
    if not args.smoke:
        if n != 4:
            raise SystemExit(f"the four-card probe needs 4 ranks, got {n}")
        phi = get_config("phi3.5-moe-42b-a6.6b")
        policy = default_policy(phi)
        rules = make_rules(policy)
        serve(report, phi, mesh, rules, f"serve phi3.5 {policy}",
              meshless=False)
        check(report, phi, mesh, rules, f"check phi3.5 {policy}")
        pipeline_check(report, make_lm_mesh(1, 1, pod=4, device_type=DEV))
        train_check(report, ds, make_lm_mesh(2, 2, device_type=DEV),
                    make_rules("fsdp_tp"), "train step fsdp_tp")
        xl = dataclasses.replace(get_config("xlstm-1.3b"),
                                 block_pattern=XLSTM_PATTERN)
        check(report, xl, mesh, tp, "check xlstm-1.3b tp",
              prompt=XLSTM_PROMPT)
        train_check(report, xl, mesh, tp, "train step xlstm-1.3b tp",
                    shape=(CHECK_BATCH, XLSTM_PROMPT))
    report(ok=True, world=n)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
