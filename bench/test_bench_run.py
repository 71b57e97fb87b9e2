"""A run without its look for a card: the harness drives the program on
the CPU (the kernels' plain versions) at a tiny size, and the check says
correct; with the answer altered where the program produces it, the
check says not correct.  Without a card, the command refuses to measure."""
import json
import subprocess
import sys
import time

import numpy as np
import pytest

from benchkit import harness, spec, traffic

TINY = {"name": "tiny", "family": "dcnn_tower", "system": "dcnn_serve",
        "dtype": "float32", "z_dim": 16, "img_hw": 8, "img_c": 3,
        "layers": [
            {"c_in": 16, "c_out": 32, "kernel": 4, "stride": 1, "padding": 0,
             "activation": "relu"},
            {"c_in": 32, "c_out": 3, "kernel": 4, "stride": 2, "padding": 1,
             "activation": "tanh"}],
        "limits": {"max_abs_err": 1e-4}}
MIX = {"loop": "closed", "clients": 1,
       "rows": {"kind": "log_uniform", "low": 1, "high": 12, "cycle": 16},
       "buckets": None, "max_batch": 8, "pool_rows": 128,
       "check_requests": 4}


def run_tiny(seed=2**31 + 99):
    bench = spec.load_benchmark()
    cell = spec.Cell("tiny.mixed", 1, TINY, MIX, bench["end_to_end"],
                     [m for m in bench["per_layer"]
                      if m["name"] == "engine.padded_share"])
    run = harness.execute(cell, seed, 0.3, False, time.perf_counter(),
                          device="cpu")
    err = harness.check(run, seed, device="cpu")
    readers = spec.metric_readers(cell.end_to_end)
    return run, harness.result_line(run, cell.end_to_end, readers, err,
                                    TINY["limits"]["max_abs_err"], {})


def test_a_sound_run_is_correct():
    run, line = run_tiny()
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == len(run.latencies_s) > 0
    assert list(line)[-1] == "check"
    assert line["check"]["max_abs_err"]["value"] < 1e-5
    m = line["metrics"]
    assert m["images_per_s"]["value"] == run.images / run.window_s
    assert "images_per_j" not in m          # no card, no energy reading
    # the sample holds the longest request, and its latents are the pool's
    longest = int(traffic.request_cycle(MIX, 2**31 + 99).max())
    assert max(n for _, n, _ in run.sample) == longest
    assert run.counters["images"] == run.images
    assert run.counters["padded_images"] > 0


def test_an_answer_altered_where_it_is_produced_is_caught(monkeypatch):
    from repro_torch.serve.engine import DcnnServeEngine

    real = DcnnServeEngine.generate

    def altered(self, z):
        images = np.array(real(self, z))
        images[0, 0, 0, 0] += 1e-3
        return images

    monkeypatch.setattr(DcnnServeEngine, "generate", altered)
    _, line = run_tiny()
    assert line["correct"] is False
    assert line["check"]["max_abs_err"]["value"] > 5e-4


def test_without_a_card_nothing_is_measured():
    out = subprocess.run(
        [sys.executable, str(spec.ROOT / "bench" / "run.py"), "--workload",
         "celeba.batch64", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=spec.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card):
    out = subprocess.run(
        [sys.executable, str(spec.ROOT / "bench" / "run.py"), "--workload",
         "mnist.batch64", "--seed", str(2**31 + 7), "--seconds", "2",
         "--trace", "0"], capture_output=True, text=True, timeout=600,
        cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
