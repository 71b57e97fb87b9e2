"""Serving driver of the PyTorch/CUDA port (`src/repro_torch/`): batched
DCNN inference through the bucketed engine, with the paper's throughput
and run-to-run-variation measurement, or through the SLO-aware async
frontend.

    PYTHONPATH=src python examples/serve_dcnn_torch.py [--net celeba]
        [--reqs 20] [--batch 16] [--precision int8] [--backend cuda]
        [--async [--slo-ms 50]] [--trace out.json] [--device cuda]
        [--plan-json plan.json]

The engine runs on the card (``--device cuda``, the default; without a
card it raises instead of running on the CPU) unless ``--device cpu``
asks for the CPU, where the "cuda" backend runs each kernel's plain
version.  Each bucket is one pinned plan and, on the card, one captured
CUDA graph; mixed request sizes never build another.

``--plan-json`` writes the engine's largest-bucket NetworkPlan to disk:
the artifact a deployment pins next to its checkpoint and reloads with
``NetworkPlan.load`` to serve exactly the validated configuration.  If
the file already exists it is loaded instead: the static plan DRC
(`repro_torch.analysis.check`, against the H100) runs before the engine
is built, and a plan that fails prints the rule-by-rule report and exits
2 (a plan pinned by the JAX package fails until `NetworkPlan.for_hopper`
has mapped it).

``--async`` routes the stream through `AsyncServeFrontend`: requests carry
a per-tenant deadline (``--slo-ms``), admission control sheds typed what
cannot make it, and the scheduler downgrades fp32 requests onto the int8
chain when that is the only way to hold the SLO (int8 needs
``--backend cuda``; other backends serve fp32 only).

``--trace out.json`` turns on the `repro_torch.obs` span tracer and writes
a Chrome/Perfetto ``trace_event`` JSON on exit (open it at
https://ui.perfetto.dev): admission, queue wait, wave dispatch,
per-bucket dispatches and collect on one timeline, with retries and
stragglers as instant markers.
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import repro_torch.workloads as workloads  # noqa: E402
from repro_torch.models.dcnn import BACKENDS, generator_init  # noqa: E402
from repro_torch.obs import trace as obstrace  # noqa: E402
from repro_torch.serve import (AdmissionRejected,  # noqa: E402
                               AsyncServeFrontend, DcnnServeEngine,
                               EngineConfig, TenantClass)


def request_sizes(args):
    """Mixed sizes: full batches interleaved with ragged stragglers."""
    return [args.batch if i % 3 else max(1, args.batch - i % 5)
            for i in range(args.reqs)]


def run_async(cfg, params, args):
    """Mixed gold/std tenant stream through the async frontend; returns
    its ``stats()``."""
    precisions = ("fp32", "int8") if args.backend == "cuda" else ("fp32",)
    fe = AsyncServeFrontend.from_config(
        EngineConfig(model=cfg, backend=args.backend, max_batch=args.batch,
                     calib_batch=32, device=args.device),
        params,
        [TenantClass("gold", slo_ms=args.slo_ms, priority=0),
         TenantClass("std", slo_ms=None, priority=1)],
        precisions=precisions, prime=1)
    try:
        rng = np.random.RandomState(0)
        rids, rejected = [], 0
        for i, n in enumerate(request_sizes(args)):
            z = rng.randn(n, *cfg.input_shape).astype(np.float32)
            try:
                rids.append(fe.submit(z, "gold" if i % 2 == 0 else "std"))
            except AdmissionRejected as e:
                rejected += 1
                print(f"  req {i}: shed at admission ({e.stage})")
        for rid in rids:
            try:
                fe.result(rid, timeout_s=300)
            except AdmissionRejected as e:
                print(f"  req {rid}: shed in queue ({e.stage})")
        st = fe.stats()
        print(f"{cfg.name} async serving on {args.device}, gold slo="
              f"{args.slo_ms} ms (admission rejected {rejected}):")
        for name, t in st["tenants"].items():
            p99 = f"{t['p99_ms']:.1f} ms" if "p99_ms" in t else "n/a"
            print(f"  {name}: completed={t['completed']} "
                  f"downgraded={t['downgraded']} shed={t['shed']} "
                  f"p99={p99}")
        print(f"  pinned plans: {sorted(fe.plan_fingerprints())}")
        return st
    finally:
        fe.close()


def load_pinned(path):
    """The pinned plan at ``path`` after a clean DRC; prints the report and
    exits 2 when the check fails."""
    from repro_torch.analysis.check import check_plan_json
    from repro_torch.plan import NetworkPlan

    report = check_plan_json(path)
    if not report.ok():
        print(f"pinned plan {path} failed design-rule check:")
        print(report.render())
        sys.exit(2)
    pinned = NetworkPlan.load(path)
    print(f"pinned plan {pinned.stable_hash()} <- {path} "
          f"(DRC clean: {len(report.rules_run)} rules)")
    return pinned


def run_sync(cfg, params, args):
    """The request stream through one engine's submit/collect queue;
    returns the engine.  A pre-existing ``--plan-json`` is a pinned
    deployment artifact: DRC'd and served; a fresh path is written at the
    end instead."""
    pinned = None
    if args.plan_json and os.path.exists(args.plan_json):
        pinned = load_pinned(args.plan_json)
    eng = DcnnServeEngine.from_config(
        EngineConfig(model=cfg, backend=args.backend,
                     precision=args.precision, max_batch=args.batch,
                     warmup=True, calib_batch=32, device=args.device),
        params, plan=pinned)
    ops_per_img = sum(g.ops for g in cfg.geometries())
    rng = np.random.RandomState(0)
    lat, imgs = [], None
    for n in request_sizes(args):
        z = rng.randn(n, *cfg.input_shape).astype(np.float32)
        t0 = time.perf_counter()
        imgs = eng.collect(eng.submit(z))
        lat.append((time.perf_counter() - t0) / n)
    lat = np.array(lat)
    gops = ops_per_img / lat / 1e9
    print(f"{cfg.name} x<= {args.batch} via {args.backend}/{args.precision} "
          f"on {args.device}: {gops.mean():.2f} GOps/s (std "
          f"{gops.std():.2f}; cv {lat.std() / lat.mean():.3f}) — "
          f"{1000 * lat.mean():.2f} ms/image, last images {imgs.shape}, "
          f"{eng.total_captures} executables / {eng.plan_stats['builds']} "
          f"plan builds over {len(eng.buckets)} buckets")
    if args.plan_json and pinned is None:
        plan = eng.plans[eng.max_bucket]
        plan.to_json(args.plan_json)
        print(f"pinned plan {plan.stable_hash()} -> {args.plan_json}")
    eng.close()
    return eng


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--net", default="mnist", metavar="WORKLOAD",
                    help="a registered repro_torch.workloads name "
                         f"({', '.join(workloads.names())}); unknown "
                         "names fail typed, never fall back")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--reqs", type=int, default=20)
    ap.add_argument("--backend", default="cuda", choices=list(BACKENDS))
    ap.add_argument("--precision", default="fp32", choices=["fp32", "int8"])
    ap.add_argument("--device", default="cuda",
                    help="where the engines run: cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random params")
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="serve through the SLO-aware async frontend")
    ap.add_argument("--slo-ms", type=float, default=200.0,
                    help="gold-tenant latency SLO for --async (ms)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record a Perfetto trace of the run to this path")
    ap.add_argument("--plan-json", default=None, metavar="PATH",
                    help="write the largest bucket's NetworkPlan here, or "
                         "DRC and serve the plan pinned there")
    args = ap.parse_args(argv)

    try:
        cfg = workloads.resolve_model(args.net)
    except workloads.WorkloadError as e:
        print(e)
        sys.exit(2)
    # a missing card raises here, before anything runs on the CPU
    device = EngineConfig(model=cfg, device=args.device).torch_device()
    params = generator_init(torch.Generator().manual_seed(args.seed), cfg,
                            device)
    if args.trace:
        obstrace.enable(clear=True)
    try:
        if args.use_async:
            return run_async(cfg, params, args)
        return run_sync(cfg, params, args)
    finally:
        if args.trace:
            obstrace.disable()
            n = obstrace.get_tracer().export(args.trace)
            print(f"trace: {n} events -> {args.trace} "
                  f"(open at https://ui.perfetto.dev)")


if __name__ == "__main__":
    main()
