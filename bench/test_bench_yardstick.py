"""The yardstick's counts, peaks and request statistics."""
import numpy as np
import pytest

from benchkit import spec, stats

CELEBA_LAYER_FLOPS = (3_276_800, 205_520_896, 235_929_600, 251_920_384,
                      12_192_768)
MNIST_LAYER_FLOPS = (2_508_800, 44_302_336, 746_496)


def family_and_config(name):
    cfg = spec.load_config(spec.load_benchmark(), name)
    return spec.load_module("configs", cfg["family"]), cfg


def test_taps_match_a_brute_force_count():
    fam, _ = family_and_config("dcnn-celeba")
    for in_size, k, s, p in [(1, 4, 1, 0), (4, 4, 2, 1), (7, 4, 2, 1),
                             (1, 7, 1, 0), (5, 3, 2, 0), (3, 5, 3, 2)]:
        out = (in_size - 1) * s - 2 * p + k
        hits = np.zeros(out, int)
        for i in range(in_size):
            for kk in range(k):
                o = i * s - p + kk
                if 0 <= o < out:
                    hits[o] += 1
        assert fam.taps_1d(in_size, k, s, p, out) == hits.sum()


@pytest.mark.parametrize("name,layer_flops,total", [
    ("dcnn-celeba", CELEBA_LAYER_FLOPS, 0.709e9),
    ("dcnn-mnist", MNIST_LAYER_FLOPS, 47.6e6)])
def test_flops_per_image(name, layer_flops, total):
    fam, cfg = family_and_config(name)
    counts = fam.layer_counts(cfg, 1)
    assert tuple(int(f) for f, _ in counts) == layer_flops
    assert fam.flops_per_image(cfg) == pytest.approx(total, rel=1e-3)
    assert fam.layer_counts(cfg, 64)[2][0] == 64 * layer_flops[2]


def test_bytes_read_and_written_once():
    fam, cfg = family_and_config("dcnn-celeba")
    _, nbytes = fam.layer_counts(cfg, 64)[1]
    x = 64 * 4 * 4 * 1024
    w = 4 * 4 * 1024 * 512
    y = 64 * 8 * 8 * 512
    assert nbytes == 4 * (x + w + 512 + y)


def test_bound_takes_the_slower_roof():
    assert stats.bound_seconds(495e12, 0) == pytest.approx(1.0)
    assert stats.bound_seconds(0, 3.35e12) == pytest.approx(1.0)
    fam, cfg = family_and_config("dcnn-celeba")
    # bucket 64 on the wide layers is bound by FLOPs, bucket 1 by weights
    f, b = fam.layer_counts(cfg, 64)[1]
    assert stats.bound_seconds(f, b) == f / stats.TF32_FLOPS
    f, b = fam.layer_counts(cfg, 1)[1]
    assert stats.bound_seconds(f, b) == b / stats.HBM_BYTES_PER_S


def test_quantile_interpolates_over_all_values():
    rng = np.random.default_rng(0)
    xs = list(rng.exponential(1.0, 1001))
    for q in (0.0, 0.5, 0.95, 1.0):
        assert stats.quantile(xs, q) == pytest.approx(np.quantile(xs, q))
    # one slow request among twenty sets the tail, never a chunk median
    lat = [1.0] * 19 + [100.0]
    assert stats.quantile(lat, 0.95) == pytest.approx(1.0 + 0.05 * 99.0)
    with pytest.raises(ValueError):
        stats.quantile([], 0.5)


class FakeTrace:
    images, window_s, busy_s = 640, 0.5, 0.4
    main_s, copy_s, other_s = 0.2, 0.01, 0.02


class FakeRun:
    images, window_s, energy_j, setup_s = 12800, 2.0, 400.0, 9.5
    latencies_s = [0.001] * 99 + [0.5]
    counters = {"images": 12800, "padded_images": 3200}
    flops_per_image, bound_s = 0.7e9, 0.05
    trace = FakeTrace


def test_metric_readers_take_all_requests_and_all_time():
    bench = spec.load_benchmark()
    read = spec.metric_readers(bench["end_to_end"] + bench["per_layer"])
    assert read["images_per_s"](FakeRun) == 6400.0
    assert read["latency_p95_ms"](FakeRun) == pytest.approx(1.0)
    assert read["images_per_j"](FakeRun) == 32.0
    assert read["setup_s"](FakeRun) == 9.5
    assert read["b1.us_per_image"](FakeRun) == pytest.approx(312.5)
    assert read["engine.copy_us_per_image"](FakeRun) == pytest.approx(15.625)
    assert read["layer.other_us_per_image"](FakeRun) == pytest.approx(31.25)
    assert read["b1.roofline_share"](FakeRun) == pytest.approx(25.0)
    assert read["device.idle_share"](FakeRun) == pytest.approx(20.0)
    assert read["engine.padded_share"](FakeRun) == pytest.approx(20.0)
    assert read["mfu"](FakeRun) == pytest.approx(
        100 * 640 * 0.7e9 / 0.5 / stats.TF32_FLOPS)

    class Untraced(FakeRun):
        trace, energy_j = None, None

    for name in ("images_per_j", "b1.us_per_image", "b1.roofline_share",
                 "device.idle_share", "mfu", "engine.padded_share"):
        assert read[name](Untraced) is None
