"""Card-only check of the tracer's profiler mirror (marker ``cuda``; it
skips without a card).  Run on a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_obs_cuda.py

With ``trace.enable(profiler=True)`` the serve engine's scoped spans are
``record_function`` ranges in the profiler's trace, on its clock.  For
every dispatch of a hundred a tower (CelebA and MNIST, buckets 1 and 64)
the device-wide synchronise falls inside ``sync``, the graph launch and
both copies inside ``enqueue``, the stream synchronise inside ``wait``,
and no host-to-device copy starts on the card before its ``enqueue``
range begins."""
import bisect

import numpy as np
import pytest
import torch

from repro_torch.models import dcnn
from repro_torch.obs import trace
from repro_torch.serve import DcnnServeEngine, EngineConfig

pytestmark = pytest.mark.cuda
ROUNDS = 50           # requests a bucket: 100 dispatches a tower
# each runtime call, the span that must hold it, and how many a dispatch
CALLS = {"cudaDeviceSynchronize": ("sync", 1),
         "cudaGraphLaunch": ("enqueue", 1),
         "cudaMemcpyAsync": ("enqueue", 2),
         "cudaStreamSynchronize": ("wait", 1)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _holder(ranges, a, b):
    """The range of the sorted, disjoint ``ranges`` that holds ``[a, b]``,
    or None."""
    i = bisect.bisect_right(ranges, (a, float("inf"))) - 1
    if i >= 0 and ranges[i][0] <= a and b <= ranges[i][1]:
        return ranges[i]
    return None


@pytest.mark.parametrize("tower", ["celeba", "mnist"])
def test_mirrored_spans_hold_their_runtime_calls(card, tower):
    from torch.profiler import ProfilerActivity, profile

    cfg = {"celeba": dcnn.CELEBA_DCNN, "mnist": dcnn.MNIST_DCNN}[tower]
    params = dcnn.generator_init(torch.Generator().manual_seed(0), cfg, card)
    eng = DcnnServeEngine.from_config(
        EngineConfig(model=tower, buckets=(1, 64), warmup=True), params)
    z = np.random.RandomState(0).randn(64, cfg.z_dim).astype(np.float32)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):       # the profiler's start-up
        eng.generate(z[:1])
    trace.enable(clear=True, profiler=True)
    try:
        prof = profile(activities=activities)
        prof.start()
        for _ in range(ROUNDS):
            eng.generate(z[:1])
            eng.generate(z)
        torch.cuda.synchronize()
        prof.stop()
    finally:
        trace.disable()
        eng.close()
    dispatches = 2 * ROUNDS
    spans = [e for e in trace.get_tracer().events() if e["ph"] == "X"]
    assert sum(e["name"].startswith("dispatch b") for e in spans) \
        == dispatches
    events = prof.profiler.kineto_results.events()
    host, h2d = [], []
    for e in events:
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.name().startswith("Memcpy HtoD"):
                h2d.append(a)
        else:
            host.append((e.name(), a, b))
    ranges = {name: sorted((a, b) for n, a, b in host if n == name)
              for name in ("generate", "sync", "enqueue", "wait")}
    for name, got in ranges.items():
        assert len(got) == dispatches, name
    counted = dict.fromkeys(CALLS, 0)
    for name, a, b in host:
        if name not in CALLS or _holder(ranges["generate"], a, b) is None:
            continue
        span, _ = CALLS[name]
        assert _holder(ranges[span], a, b) is not None, (name, span, a)
        counted[name] += 1
    assert counted == {name: n * dispatches
                       for name, (_, n) in CALLS.items()}
    h2d.sort()
    assert len(h2d) == dispatches
    for (start, _), copy in zip(ranges["enqueue"], h2d):
        assert copy >= start
