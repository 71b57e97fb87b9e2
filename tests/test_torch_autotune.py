"""The port's tile tuner: its own cache of timed choices, the model stage,
``refine=True`` (timing mocked here: a CPU clock says nothing about the
kernel) and the plumbing through plans and the engine.  Cases mirror the
JAX package's ``tests/test_autotune.py`` where they carry over."""
import json

import numpy as np
import pytest
import torch

from repro.kernels import autotune as j_autotune
from repro_torch.core.tiling import (KERNEL_MAX_SMEM, KERNEL_MAX_THREADS,
                                     DeconvGeometry, block_threads,
                                     kernel_for, tc_smem_layout)
from repro_torch.kernels import _build, autotune
from repro_torch.kernels.autotune import (SMS, TileChoice, cache_key,
                                          choose_tiles, clear_cache,
                                          grid_blocks, hopper_tiles,
                                          refine_candidates)
from repro_torch.models import dcnn
from repro_torch.plan import DeconvPlan, build_layer_plan, build_network_plan

CELEBA_L1 = DeconvGeometry(4, 4, 1024, 512, 4, 2, 1)
MNIST_L1 = DeconvGeometry(7, 7, 256, 128, 4, 2, 1)
ROOT = DeconvGeometry(1, 1, 100, 1024, 4, 1, 0)
THIN = DeconvGeometry(32, 32, 128, 3, 4, 2, 1)
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    """The tile cache in the test's directory, the in-memory copy reset."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "t.json"))
    monkeypatch.setattr(autotune, "_cache", None)
    yield tmp_path / "t.json"
    monkeypatch.setattr(autotune, "_cache", None)


@pytest.fixture
def card(monkeypatch):
    """A named card for the keys and ``refine``; the timing is mocked per
    test."""
    monkeypatch.setattr(autotune, "card_name", lambda: H100)
    return H100


def fake_times(monkeypatch, ms_of):
    """``_time_candidate`` replaced by ``ms_of(choice)``; returns the list
    of choices it was asked to time."""
    asked = []

    def timed(geom, choice, dtype, backend, batch=1, runs=25):
        asked.append(choice)
        return ms_of(choice)

    monkeypatch.setattr(autotune, "_time_candidate", timed)
    return asked


def fills(g, batch, c):
    blocks = grid_blocks(g, batch, c.t_oh, c.t_co, c.t_n)
    return blocks * autotune.ci_split(blocks, -(-g.c_in // c.t_ci)) >= SMS


# -- the cache file ----------------------------------------------------------
def test_cache_path_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE", raising=False)
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
    mine = autotune.cache_path()
    assert mine != j_autotune.cache_path()
    assert mine.name == "autotune.json" and mine.parent.name == "repro_torch"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax.json"))
    assert autotune.cache_path() == mine
    assert j_autotune.cache_path() == tmp_path / "jax.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "t.json"))
    assert autotune.cache_path() == tmp_path / "t.json"


def test_timed_entry_round_trips_and_clear_cache_wipes_it(tmp_cache, card,
                                                          monkeypatch):
    fake_times(monkeypatch, lambda c: 1.0 / c.t_ci)
    c = choose_tiles(MNIST_L1, "float32", "cuda", refine=True, batch=4)
    assert c.source == "timed" and tmp_cache.exists()
    blob = json.loads(tmp_cache.read_text())
    (key, entry), = blob.items()
    assert key == cache_key(MNIST_L1, "float32", "cuda", 4)
    assert entry["source"] == "timed" and entry["k"] == 3
    assert entry["model"] == hopper_tiles(MNIST_L1, 4).as_kwargs()
    assert len(entry["timed"]) == 3
    # a fresh process reads it back and serves it without timing
    monkeypatch.setattr(autotune, "_cache", None)
    asked = fake_times(monkeypatch, lambda c: pytest.fail("timed again"))
    hit = choose_tiles(MNIST_L1, "float32", "cuda", batch=4)
    assert hit.source == "cache" and hit == c and not asked
    assert choose_tiles(MNIST_L1, "float32", "cuda", refine=True,
                        batch=4).source == "cache"
    clear_cache()
    assert not tmp_cache.exists()
    assert choose_tiles(MNIST_L1, "float32", "cuda", batch=4) == \
        hopper_tiles(MNIST_L1, 4)


@pytest.mark.parametrize("order", ["last", "first"])
def test_refine_picks_the_fastest_and_times_a_non_filling_tile(
        tmp_cache, card, monkeypatch, order):
    """CelebA layer 1 at bucket 1: the model's pick is one wave that does
    not fill the card (`autotune._bucket1_tiles`); refine times it and
    the tiles the model's clock ranks next, which fill it, and keeps
    whichever runs fastest."""
    cands = refine_candidates(CELEBA_L1, 1, "float32", 3)
    model = hopper_tiles(CELEBA_L1, 1)
    assert cands[0] == model and len(cands) == 3 == len(set(cands))
    assert not fills(CELEBA_L1, 1, model)
    assert any(fills(CELEBA_L1, 1, c) for c in cands[1:])
    fastest = cands[-1] if order == "last" else cands[0]
    ms = {c: 0.5 if c == fastest else 1.0 + i for i, c in enumerate(cands)}
    asked = fake_times(monkeypatch, ms.get)
    got = choose_tiles(CELEBA_L1, "float32", "cuda", refine=True, batch=1)
    assert asked == cands
    assert got == fastest and got.source == "timed"
    e = autotune.cached_entry(CELEBA_L1, "float32", "cuda", 1)
    assert e["ms"] == 0.5 and e["model_ms"] == (0.5 if order == "first"
                                                else 1.0)
    assert [d["tiles"] for d in e["timed"]] == [c.as_kwargs() for c in cands]


def test_refine_skips_a_refused_candidate(tmp_cache, card, monkeypatch):
    cands = refine_candidates(MNIST_L1, 8, "float32", 3)
    fake_times(monkeypatch, lambda c: None if c == cands[0] else 2.0)
    got = choose_tiles(MNIST_L1, "float32", "cuda", refine=True, batch=8)
    assert got == cands[1]
    e = autotune.cached_entry(MNIST_L1, "float32", "cuda", 8)
    assert e["model_ms"] is None and len(e["timed"]) == 2


def test_key_changes_with_card_source_and_plan(tmp_cache, monkeypatch):
    plan = DeconvPlan(geometry=MNIST_L1, batch=8, dtype="float32",
                      backend="cuda")
    monkeypatch.setattr(autotune, "card_name", lambda: H100)
    key = cache_key(MNIST_L1, "float32", "cuda", 8)
    assert key.startswith(f"v{autotune.CACHE_VERSION}|{H100}|")
    assert key.endswith(plan.stable_hash(scope="tiles"))
    assert _build.source_digest("deconv2d_tc") in key
    monkeypatch.setattr(autotune, "card_name", lambda: "NVIDIA H200")
    other_card = cache_key(MNIST_L1, "float32", "cuda", 8)
    monkeypatch.setattr(autotune, "card_name", lambda: H100)
    real = _build.source_digest
    monkeypatch.setattr(_build, "source_digest", lambda name: "0" * 16)
    other_source = cache_key(MNIST_L1, "float32", "cuda", 8)
    monkeypatch.setattr(_build, "source_digest", real)
    variants = [cache_key(MNIST_L1, "int8", "cuda", 8),
                cache_key(MNIST_L1, "float32", "cuda_sparse", 8),
                cache_key(MNIST_L1, "float32", "cuda", 64),
                cache_key(MNIST_L1, "float32", "cuda", 8, out_dtype_bytes=4),
                cache_key(CELEBA_L1, "float32", "cuda", 8)]
    keys = [key, other_card, other_source] + variants
    assert len(set(keys)) == len(keys)


@pytest.mark.parametrize("dtype,lib", [("float32", "deconv2d_tc"),
                                       ("int8", "deconv2d_tc"),
                                       ("bfloat16", "deconv2d_tc")])
def test_key_carries_the_digest_of_the_library_that_runs_the_dtype(
        tmp_cache, dtype, lib):
    assert _build.source_digest(lib) in cache_key(MNIST_L1, dtype, "cuda")
    assert _build.library_path(lib).name == \
        f"lib{lib}_{_build.source_digest(lib)}.so"


def test_corrupt_file_and_foreign_entries_are_ignored(tmp_cache, card,
                                                      monkeypatch):
    tmp_cache.write_text("{not json")
    assert choose_tiles(MNIST_L1, "float32", "cuda", batch=4) == \
        hopper_tiles(MNIST_L1, 4)
    good = {"t_oh": 4, "t_ow": 4, "t_ci": 16, "t_co": 16, "t_n": 1,
            "source": "timed", "ms": 0.1}
    key = cache_key(MNIST_L1, "float32", "cuda", 4)
    tmp_cache.write_text(json.dumps({
        key.replace(f"v{autotune.CACHE_VERSION}|", "v0|"): good,
        cache_key(CELEBA_L1, "float32", "cuda", 4): {**good, "t_oh": "4"},
        cache_key(ROOT, "float32", "cuda", 4): {**good, "source": "model"},
        cache_key(THIN, "float32", "cuda", 4): "bogus"}))
    monkeypatch.setattr(autotune, "_cache", None)
    for g in (MNIST_L1, CELEBA_L1, ROOT, THIN):
        assert choose_tiles(g, "float32", "cuda", batch=4).source == "hopper"
    tmp_cache.write_text(json.dumps([good]))          # not a mapping
    monkeypatch.setattr(autotune, "_cache", None)
    assert choose_tiles(MNIST_L1, "float32", "cuda", batch=4).source == \
        "hopper"
    tmp_cache.write_text(json.dumps({key: good}))
    monkeypatch.setattr(autotune, "_cache", None)
    hit = choose_tiles(MNIST_L1, "float32", "cuda", batch=4)
    assert hit.source == "cache" and hit == TileChoice(4, 4, 16, 16, 1)
    # the next store rewrites a clean file: the corrupt entries are gone
    fake_times(monkeypatch, lambda c: 1.0)
    choose_tiles(CELEBA_L1, "float32", "cuda", refine=True, batch=4)
    blob = json.loads(tmp_cache.read_text())
    assert sorted(blob) == sorted([key, cache_key(CELEBA_L1, "float32",
                                                  "cuda", 4)])


def test_an_unwritable_cache_never_fails_the_call(tmp_path, card,
                                                  monkeypatch):
    blocker = tmp_path / "file"
    blocker.write_text("")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(blocker / "sub" / "t.json"))
    monkeypatch.setattr(autotune, "_cache", None)
    fake_times(monkeypatch, lambda c: 1.0)
    got = choose_tiles(MNIST_L1, "float32", "cuda", refine=True, batch=2)
    assert got.source == "timed"
    monkeypatch.setattr(autotune, "_cache", None)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_int8_and_bf16_keep_the_models_pick_under_refine(tmp_cache, card,
                                                         monkeypatch, dtype):
    asked = fake_times(monkeypatch, lambda c: pytest.fail("timed"))
    got = choose_tiles(MNIST_L1, dtype, "cuda", refine=True, batch=8)
    assert got == hopper_tiles(MNIST_L1, 8, dtype) and not asked
    assert not tmp_cache.exists()


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_refine_without_a_card_raises(tmp_cache, dtype):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA card"):
        choose_tiles(MNIST_L1, dtype, "cuda", refine=True)
    with pytest.raises(RuntimeError, match="CUDA card"):
        build_network_plan(dcnn.MNIST_DCNN, batch=2, refine=True,
                           precision="fp32")


def test_the_model_stage_never_writes(tmp_cache):
    """A model pick costs microseconds and is never stored (a stored one
    would hide a later change of the model)."""
    for g in (MNIST_L1, CELEBA_L1, ROOT, THIN):
        c = choose_tiles(g, "float32", "cuda", batch=64)
        assert c == hopper_tiles(g, 64) and c.source == "hopper"
    assert not tmp_cache.exists()


def test_autotune_false_never_touches_the_file(tmp_cache, card, monkeypatch):
    def no_cache():
        raise AssertionError("the cache was read")

    monkeypatch.setattr(autotune, "_load_cache", no_cache)
    monkeypatch.setattr(autotune, "_store", no_cache)
    plan = build_network_plan(dcnn.CELEBA_DCNN, batch=64, autotune=False)
    assert [l.tiles for l in plan.layers] == \
        [hopper_tiles(g, 64) for g in dcnn.CELEBA_DCNN.geometries()]
    build_layer_plan(MNIST_L1, batch=4, autotune=False, refine=True)
    assert not tmp_cache.exists()


@pytest.mark.parametrize("net", ["mnist", "celeba"])
@pytest.mark.parametrize("precision", ["fp32", "int8"])
@pytest.mark.parametrize("batch", [1, 64])
def test_autotune_false_plans_are_todays_plans(tmp_cache, net, precision,
                                               batch):
    """``autotune=False`` gives the model's tiles, and so does the default
    on an empty cache: the same plans and stable hashes as before the
    cache existed."""
    cfg = {"mnist": dcnn.MNIST_DCNN, "celeba": dcnn.CELEBA_DCNN}[net]
    from repro_torch.quant import QuantConfig, LayerQuant

    qcfg = None
    if precision == "int8":
        qcfg = QuantConfig(name=cfg.name, strategy="mean_ksigma", layers=tuple(
            LayerQuant(x_scale=0.05, w_scale=(0.01,) * l.c_out)
            for l in cfg.layers))
    off = build_network_plan(cfg, batch=batch, precision=precision,
                             quant_cfg=qcfg, autotune=False)
    on = build_network_plan(cfg, batch=batch, precision=precision,
                            quant_cfg=qcfg)
    assert off.stable_hash() == on.stable_hash()
    dt = "int8" if precision == "int8" else "float32"
    assert [l.tiles for l in off.layers] == \
        [hopper_tiles(g, batch, dt) for g in cfg.geometries()]
    assert not tmp_cache.exists()


def test_pinned_plan_keeps_its_tiles_whatever_the_cache_holds(tmp_cache,
                                                              monkeypatch):
    from repro_torch.serve import DcnnServeEngine, EngineConfig

    params = dcnn.generator_init(torch.Generator().manual_seed(0),
                                 dcnn.MNIST_DCNN, "cpu")
    plan = build_network_plan(dcnn.MNIST_DCNN, batch=2, autotune=False)
    entry = {**TileChoice(8, 8, 16, 8, 1).as_kwargs(), "source": "timed"}
    geoms = dcnn.MNIST_DCNN.geometries()
    tmp_cache.write_text(json.dumps({cache_key(g, "float32", "cuda", b): entry
                                     for g in geoms for b in (1, 2)}))
    monkeypatch.setattr(autotune, "_cache", None)
    eng = DcnnServeEngine.from_config(EngineConfig(
        model="mnist", device="cpu", max_batch=2, warmup=True), params,
        plan=plan)
    assert eng.plans[2] is plan
    # the unpinned bucket took the cache's timed entry for its layer 1
    assert eng.plans[1].layers[1].tiles == TileChoice(8, 8, 16, 8, 1)
    assert eng.plans[1].layers[1].tiles.source == "cache"


# the fp32 picks at bucket 1 (`autotune._bucket1_tiles`): on the H100 each
# ran within 6 % of the fastest tile of its layer (`tools/sweep_tiles.py
# --dtype float32 --buckets 1`; MNIST layer 1 at 1.059, the others at the
# fastest), where the picks of the full-card rule ran 1.07-1.97x of it
BUCKET1_PICKS = {
    ("mnist", 0): (1, 32, 128),
    ("mnist", 1): (14, 32, 16),
    ("mnist", 2): (16, 16, 1),
    ("celeba", 0): (1, 32, 128),
    ("celeba", 1): (8, 16, 64),
    ("celeba", 2): (16, 32, 32),
    ("celeba", 3): (16, 16, 64),
    ("celeba", 4): (16, 16, 3),
}


@pytest.mark.parametrize("net,layer", sorted(BUCKET1_PICKS))
def test_bucket1_fp32_picks_are_pinned(net, layer):
    """(spatial tile, t_ci, t_co) of every generator layer at bucket 1, one
    image a tile; the 1x1 roots keep the full-card rule's pick."""
    cfg = {"mnist": dcnn.MNIST_DCNN, "celeba": dcnn.CELEBA_DCNN}[net]
    t = hopper_tiles(cfg.geometries()[layer], 1)
    assert (t.t_oh, t.t_ci, t.t_co) == BUCKET1_PICKS[net, layer]
    assert t.t_oh == t.t_ow and t.t_n == 1


def test_bucket1_rule_is_fp32_only_and_bucket_2_keeps_its_tiles():
    """bf16 and int8 at bucket 1, and fp32 at bucket 2, keep the cheapest
    tile by `tc_cost` among those that fill the SMs."""
    for dtype in ("bfloat16", "int8"):
        scored = autotune._tc_scored(CELEBA_L1, 1, dtype)
        assert hopper_tiles(CELEBA_L1, 1, dtype) == min(
            scored, key=lambda e: (not e[0], e[1]))[2]
    scored = autotune._tc_scored(CELEBA_L1, 2, "float32")
    assert hopper_tiles(CELEBA_L1, 2) == min(
        scored, key=lambda e: (not e[0], e[1]))[2]


# -- mirrored from the JAX package's autotune tests -------------------------
@pytest.mark.parametrize("geom", [CELEBA_L1, MNIST_L1, ROOT, THIN])
@pytest.mark.parametrize("batch", [1, 16, 64])
def test_chosen_tiles_legal_and_within_the_kernels_limits(tmp_cache, geom,
                                                          batch):
    c = choose_tiles(geom, "float32", "cuda", batch=batch)
    s = geom.stride
    assert c.t_oh % s == 0 and c.t_ow % s == 0 and 1 <= c.t_n <= batch
    assert block_threads(s, c.t_oh, c.t_ow, c.t_co, c.t_n,
                         k_size=geom.kernel, t_ci=c.t_ci) <= KERNEL_MAX_THREADS
    assert kernel_for("float32") == "tc"
    for cand in refine_candidates(geom, batch, "float32", 5):
        ohp = -(-geom.out_h // cand.t_oh) * cand.t_oh
        owp = -(-geom.out_w // cand.t_ow) * cand.t_ow
        blocks = grid_blocks(geom, batch, cand.t_oh, cand.t_co, cand.t_n)
        split = autotune.ci_split(blocks, -(-geom.c_in // cand.t_ci))
        assert tc_smem_layout(geom.in_h, geom.in_w, geom.kernel, s,
                              geom.padding, ohp, owp, cand.t_oh, cand.t_ow,
                              cand.t_ci, cand.t_co, cand.t_n, split,
                              "float32")[1] <= KERNEL_MAX_SMEM


@pytest.mark.parametrize("batch", [1, 6, 64])
def test_candidates_never_exceed_the_batch(batch):
    for c in refine_candidates(ROOT, batch, "float32", 10):
        assert c.t_n <= batch


def test_cache_round_trip_keeps_the_batch_tile(tmp_cache, card, monkeypatch):
    fake_times(monkeypatch, lambda c: 1.0 / c.t_n)
    c = choose_tiles(ROOT, "float32", "cuda", refine=True, batch=64)
    assert c.t_n > 1
    monkeypatch.setattr(autotune, "_cache", None)
    hit = choose_tiles(ROOT, "float32", "cuda", batch=64)
    assert hit.source == "cache" and hit.as_kwargs() == c.as_kwargs()
    # distinct entries per batch: another bucket is not served this one
    assert choose_tiles(ROOT, "float32", "cuda", batch=32).source == "hopper"


def test_timed_tiles_serve_the_same_function(tmp_cache, card, monkeypatch,
                                             rng):
    """End to end: the tiles a timing picks (here the slowest by the model)
    run the layer to the reference's result."""
    from repro.kernels.deconv2d import deconv2d_ref as j_ref
    from repro_torch.kernels.deconv2d import deconv2d

    g = DeconvGeometry(7, 7, 16, 24, 4, 2, 1)
    cands = refine_candidates(g, 2, "float32", 3)
    fake_times(monkeypatch, lambda c: 0.1 if c == cands[-1] else 1.0)
    plan = build_layer_plan(g, batch=2, refine=True, activation="relu")
    assert plan.tiles == cands[-1]
    x = rng.randn(2, 7, 7, 16).astype(np.float32)
    w = (rng.randn(4, 4, 16, 24) * 0.1).astype(np.float32)
    b = rng.randn(24).astype(np.float32)
    y = deconv2d(torch.from_numpy(x), torch.from_numpy(w),
                 torch.from_numpy(b), plan=plan)
    want = np.maximum(np.asarray(j_ref(x, w, b, 2, 1)), 0)
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-4, atol=1e-4)
