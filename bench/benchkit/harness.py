"""One run of one cell: set-up, the measured window, the check, the report.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as ``setup_s`` from the first line of ``run.py``): imports,
the card, the weights drawn on the card from the seed, the latent pool and
the request sizes drawn on the host from the seed, the system built and
every bucket of the cell's traffic captured and run once.  The window
drives the traffic for ``--seconds``: one closed-loop client, each request
timed from the call to its images on the host.  With ``--trace 1`` a
stretch of whole requests in the window runs under the profiler and the
per-layer metrics are read from it instead of the end-to-end ones.  Then
the check: a sample of the window's requests, drawn from the seed with the
longest request in it, against the plain reference, run once the
program's state is freed.  The last line of standard output is the JSON
result; the numbers compared, each beside its limit, are the last lines of
standard error."""
from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import json
import math
import sys
import time
import traceback
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import guard, spec, stats, traffic as traffic_mod
from .trace import IncompleteTrace, Span, Stretch, reduce

TRACE_MAX_S = 2.0
# stretches tried before a traced run gives up: the profiler can lose records
TRACE_TRIES = 3
CHECK_NAME = "max_abs_err"


@dataclasses.dataclass
class Run:
    """What the metric readers see."""
    config: dict
    family: object
    setup_s: float
    window_s: float
    attempted: int
    failed: int
    images: int
    latencies_s: List[float]
    energy_j: Optional[float]
    counters: Dict[str, int]
    trace: Optional[object]
    flops_per_image: float
    bound_s: Optional[float]
    memory_peak_bytes: int
    sample: List[Tuple[int, int, np.ndarray]]
    pool: np.ndarray


def parse(argv):
    ap = argparse.ArgumentParser(prog="bench/run.py",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def require_cards(n: int) -> None:
    """Refuse to measure without ``n`` CUDA cards: no CPU fallback."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device; the benchmark measures the "
                         "card and never falls back to the CPU")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"bench: the cell needs {n} CUDA devices, "
                         f"{torch.cuda.device_count()} are present")


def say(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def execute(cell: spec.Cell, seed: int, seconds: float, trace: bool,
            t_start: float, device: str = "cuda") -> Run:
    """Set-up, window and the program's state freed; the check is `check`.
    ``device="cpu"`` serves on the CPU (the kernels' plain versions); only
    tests ask for it."""
    import torch

    cfg, mix = cell.config, cell.traffic
    family = spec.load_module("configs", cfg["family"])
    system_mod = spec.load_module("systems", cfg["system"])
    torch.set_num_threads(1)
    dev = torch.device(device)
    sizes = traffic_mod.request_cycle(mix, seed)
    pool_rows, max_size = traffic_mod.pool_shape(mix, sizes)
    pool = traffic_mod.latent_pool(seed, pool_rows, cfg["z_dim"])
    u = traffic_mod.rng(seed, 3).random(1 << 16)
    system = system_mod.System(cfg, mix, family.make_weights(cfg, seed, dev),
                               dev)
    meter = None
    if dev.type == "cuda" and not trace:
        from .energy import open_meter

        props = torch.cuda.get_device_properties(dev)
        uuid = getattr(props, "uuid", None)
        meter = open_meter(uuid=f"GPU-{uuid}" if uuid else None,
                           index=dev.index or 0)
        name, limit = meter.describe()
        say(f"card {name}, power.limit {limit:.2f} W, energy from "
            f"{meter.source}")
    stretch = None
    if trace:
        stretch = Stretch()
        stretch.warm(lambda: system.serve(pool[:int(sizes[0])]))
    k = int(mix["check_requests"])
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    lat: List[float] = []
    reservoir: List[Tuple[int, int, np.ndarray]] = []
    longest: Optional[Tuple[int, int, np.ndarray]] = None
    attempted = failed = images = 0
    offset = 0
    c0 = system.counters()
    if meter is not None:
        meter.start()
    t0 = time.perf_counter()
    t_end = t0 + seconds
    stretch_s = min(TRACE_MAX_S, seconds / 2)
    next_trace = t0 + seconds / 4
    tracing = False
    tries = 0
    reading = None
    while True:
        n = int(sizes[attempted % len(sizes)])
        if (stretch is not None and reading is None and not tracing
                and tries < TRACE_TRIES
                and time.perf_counter() >= next_trace):
            system.spans_on()
            stretch.start()
            tracing, traced, dispatches = True, [], []
            trace_stop = time.perf_counter() + stretch_s
        z = pool[offset:offset + n]
        a = time.perf_counter_ns()
        try:
            y = system.serve(z)
        except Exception:
            failed += 1
            y = None
            if failed == 1:
                traceback.print_exc()
        b = time.perf_counter_ns()
        lat.append((b - a) / 1e9)
        if y is not None:
            images += n
            entry = (offset, n, y)
            if len(reservoir) < k:
                reservoir.append(entry)
            else:
                j = int(u[attempted % len(u)] * (attempted + 1))
                if j < k:
                    reservoir[j] = entry
            if longest is None or n > longest[1]:
                longest = entry
        if tracing:
            traced.append((a, b, n))
            dispatches += system.dispatches(n)
        attempted += 1
        offset = traffic_mod.next_offset(offset, n, pool_rows, max_size)
        now = b / 1e9
        if tracing and now >= trace_stop:
            events = stretch.stop()
            spans = [Span(*s) for s in system.spans_off()]
            tracing = False
            tries += 1
            try:
                reading = reduce(events, stretch.offset_ns, traced, spans,
                                 dispatches, system_mod.MAIN_KERNEL,
                                 system.launches_per_dispatch)
            except IncompleteTrace as e:
                say(f"stretch {tries} of {TRACE_TRIES}: {e}")
                next_trace = time.perf_counter()
        if (now >= t_end and not tracing
                and (stretch is None or reading is not None
                     or tries >= TRACE_TRIES)):
            break
    window_s = b / 1e9 - t0
    energy_j = meter.stop() if meter is not None else None
    if meter is not None:
        meter.close()
    c1 = system.counters()
    counters = {key: c1[key] - c0[key] for key in c1}
    bound_s = None
    if stretch is not None:
        if reading is None:
            raise IncompleteTrace(f"no complete trace in {tries} stretches")
        say(f"trace: {reading.main_launches} main-kernel launches found, "
            f"{system.launches_per_dispatch} x {len(reading.dispatches)} "
            "dispatches expected")
        bound_s = sum(count * stats.bound_seconds(f, nb)
                      for bucket, count in
                      collections.Counter(reading.dispatches).items()
                      for f, nb in family.layer_counts(cfg, bucket))
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    system.close()
    del system
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sample = list(reservoir)
    if longest is not None and all(e[2] is not longest[2] for e in sample):
        sample.append(longest)
    return Run(config=cfg, family=family, setup_s=setup_s,
               window_s=window_s, attempted=attempted, failed=failed,
               images=images, latencies_s=lat, energy_j=energy_j,
               counters=counters, trace=reading,
               flops_per_image=family.flops_per_image(cfg), bound_s=bound_s,
               memory_peak_bytes=int(peak), sample=sample, pool=pool)


def sample_inputs(run: Run) -> Tuple[np.ndarray, np.ndarray]:
    """The sampled requests' latents and images, stacked."""
    z = np.concatenate([run.pool[o:o + n] for o, n, _ in run.sample])
    y = np.concatenate([img for _, _, img in run.sample])
    return z, y


def check(run: Run, seed: int, device: str = "cuda",
          control: bool = False) -> float:
    """The widest gap between the sampled images and the reference's, from
    weights drawn again from the seed.  ``control=True`` judges the
    control (the reference in the precision below) in the program's place
    on the same requests; the benchmark's runs never do."""
    import torch

    dev = torch.device(device)
    weights = run.family.make_weights(run.config, seed, dev)
    z, y = sample_inputs(run)
    if control:
        y = run.family.control_images(run.config, weights, z, dev)
    return run.family.max_abs_err(run.config, weights, z, y, dev)


def result_line(run: Run, metrics: List[dict], readers, err: float,
                limit: float, device_info: dict) -> dict:
    values = {}
    for m in metrics:
        v = readers[m["name"]](run)
        if v is None:
            continue
        values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    correct = (run.failed == 0 and run.images > 0 and math.isfinite(err)
               and err <= limit)
    line = {"correct": correct, "attempted": run.attempted,
            "failed": run.failed, "metrics": values, "device": device_info}
    if run.trace is not None:
        line["breakdown"] = {
            "device_ops": [[n, s] for n, s in run.trace.device_ops],
            "idle_gaps": [[n, s] for n, s in run.trace.idle_gaps]}
    line["check"] = {CHECK_NAME: {"value": err, "limit": limit},
                     "failed_requests": {"value": run.failed, "limit": 0}}
    return line


def main(argv, t_start: float) -> int:
    args = parse(argv)
    bench = spec.load_benchmark()
    cell = spec.find_cell(bench, args.workload)
    require_cards(cell.chips)
    import torch

    try:
        run = execute(cell, args.seed, args.seconds, bool(args.trace),
                      t_start)
    except IncompleteTrace as e:
        say(str(e))
        return 4
    metrics = cell.per_layer if args.trace else cell.end_to_end
    readers = spec.metric_readers(metrics)
    err = check(run, args.seed)
    limit = float(cell.config["limits"][CHECK_NAME])
    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(0),
                   "count": cell.chips,
                   "memory_peak_bytes": run.memory_peak_bytes}
    if run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
    line = result_line(run, metrics, readers, err, limit, device_info)
    missing = [m["name"] for m in metrics if m["name"] not in line["metrics"]]
    if missing and not args.trace:
        say(f"no reading of {', '.join(missing)}")
        return 5
    loaded = guard.forbidden_loaded()
    if loaded:
        say(f"the process loaded {', '.join(loaded)}; the benchmark measures "
            "the PyTorch port alone")
        return 3
    print(json.dumps(line), flush=True)
    for name, v in line["check"].items():
        say(f"check {name} {v['value']!r} limit {v['limit']!r}")
    return 0
