"""The traffic generator: the same work for every seed, in its own order."""
import collections

import numpy as np
import pytest

from benchkit import spec, traffic


@pytest.mark.parametrize("mix", ["batch64", "single", "mixed"])
def test_every_seed_gets_the_same_sizes(mix):
    t = spec.load_traffic(mix)
    a = traffic.request_cycle(t, 1)
    b = traffic.request_cycle(t, 2**31 + 17)
    assert sorted(a) == sorted(b)
    assert (traffic.request_cycle(t, 1) == a).all()


def test_log_uniform_covers_its_range_by_quantiles():
    t = spec.load_traffic("mixed")
    sizes = traffic.request_cycle(t, 5)
    rows = t["rows"]
    assert len(sizes) == rows["cycle"]
    assert sizes.min() == rows["low"] and sizes.max() == rows["high"]
    # log-uniform: each doubling of the size holds about as many requests
    counts = collections.Counter(int(np.log2(n)) for n in sizes)
    per_octave = [counts[k] for k in range(7)]
    assert max(per_octave) - min(per_octave) <= 2
    assert not (sizes == np.sort(sizes)).all()


def test_unknown_or_open_loop_mixes_are_refused():
    with pytest.raises(ValueError):
        traffic.request_cycle({"rows": {"kind": "poisson"}}, 1)
    with pytest.raises(ValueError):
        traffic.request_cycle({"loop": "open", "rows": {"kind": "fixed",
                                                        "value": 1}}, 1)


def test_pool_offsets_wrap_and_stay_inside():
    t = spec.load_traffic("mixed")
    sizes = traffic.request_cycle(t, 3)
    pool_rows, biggest = traffic.pool_shape(t, sizes)
    off = 0
    for n in list(sizes) * 20:
        assert 0 <= off and off + n <= pool_rows
        off = traffic.next_offset(off, int(n), pool_rows, biggest)
    with pytest.raises(ValueError):
        traffic.pool_shape(dict(t, pool_rows=200), sizes)


def test_latent_pool_is_drawn_from_the_seed():
    a = traffic.latent_pool(2**33 + 1, 64, 100)
    assert a.dtype == np.float32 and a.shape == (64, 100)
    assert (a == traffic.latent_pool(2**33 + 1, 64, 100)).all()
    assert not (a == traffic.latent_pool(2**33 + 2, 64, 100)).all()
    assert abs(float(a.mean())) < 0.05 and abs(float(a.std()) - 1) < 0.05
