"""Card-only checks of the CUDA deconv kernels (marker ``cuda``; they skip
without a card).  Run on a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances as in the CPU tests: fp32 1e-4, bf16 8e-2; the int8 kernel's
int8 outputs equal its plain version's bit for bit, f32 ones within 1e-6;
the fp32 and int8 kernels' repeated launches equal each other bit for
bit."""
import numpy as np
import pytest
import torch

from repro_torch.core.sparsity import magnitude_prune, prune_tree
from repro_torch.kernels import autotune
from repro_torch.kernels.autotune import hopper_tiles
from repro_torch.kernels.deconv2d import int8 as int8_kernel
from repro_torch.kernels.deconv2d import kernel as deconv_kernel
from repro_torch.kernels.deconv2d.ops import deconv2d, launch_args
from repro_torch.kernels.deconv2d_sparse import kernel as sparse_kernel
from repro_torch.kernels.deconv2d_sparse import (make_sparse_plan,
                                                 schedule_tensors)
from repro_torch.models import dcnn
from repro_torch.quant import quantized_generator_apply, quantized_generator_ref
from repro_torch.serve import DcnnServeEngine, EngineConfig

pytestmark = pytest.mark.cuda

CASES = [(7, 7, 8, 16, 4, 2, 1, 4), (1, 1, 100, 1024, 4, 1, 0, 4),
         (5, 3, 4, 7, 4, 2, 1, 6), (8, 8, 16, 8, 3, 3, 1, 9)]
# the smallest CI chunk of each dtype's kernel (one mma k-step)
T_CI = {torch.float32: 8, torch.bfloat16: 16}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", CASES)
def test_kernel_matches_plain_version(card, geom, dtype, rng):
    ih, iw, ci, co, k, s, p, t = geom
    x = torch.from_numpy(rng.randn(3, ih, iw, ci).astype(np.float32))
    w = torch.from_numpy((rng.randn(k, k, ci, co) * 0.1).astype(np.float32))
    b = torch.from_numpy((rng.randn(co) * 0.1).astype(np.float32))
    xp, wp, bp, kw, _ = launch_args(x.to(card, dtype), w.to(card, dtype),
                                    b.to(card, dtype), s, p, t, t,
                                    T_CI[dtype], 8, 2, "tanh")
    before = deconv_kernel.LAUNCHES
    y = deconv_kernel.deconv2d_launch(xp, wp, bp, **kw)
    torch.cuda.synchronize()
    assert deconv_kernel.LAUNCHES == before + 1
    want = deconv_kernel.deconv2d_launch_plain(xp, wp, bp, **kw)
    tol = 1e-4 if dtype == torch.float32 else 8e-2
    torch.testing.assert_close(y.float(), want.float(), rtol=tol, atol=tol)


def test_refused_launch_raises(card):
    x = torch.zeros(1, 4, 4, 8, device=card)
    w = torch.zeros(4, 4, 8, 64, device=card)
    with pytest.raises(RuntimeError, match="512 threads"):
        deconv2d(x, w, None, 1, 0, t_oh=32, t_ow=32, t_ci=8, t_co=64, t_n=1)


def test_engine_serves_on_the_card_through_the_kernel(card):
    cfg = dcnn.MNIST_DCNN
    params = dcnn.generator_init(torch.Generator().manual_seed(0), cfg, card)
    eng = DcnnServeEngine.from_config(EngineConfig(model="mnist",
                                                   max_batch=8), params)
    z = np.random.RandomState(0).randn(11, cfg.z_dim).astype(np.float32)
    y = eng.generate(z)
    assert sum(eng.launch_counts.values()) == \
        len(cfg.layers) * len(eng.plan_chunks(11))
    want = dcnn.generator_apply(eng.params, cfg, torch.from_numpy(z).to(card),
                                backend="reverse_loop").cpu().numpy()
    np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-4)


def _int8_check(card, rng, batch, geom, tiles, act, out_scale, split=None):
    """The int8 kernel against its plain version (at the launch's cluster
    split) on random int8 data: int8 outputs bit for bit, f32 within 1e-6;
    two launches bit-identical.  Returns the split."""
    ih, iw, ci, co, k, s, p = geom
    x = torch.from_numpy(rng.randint(-127, 128, (batch, ih, iw, ci)).astype(np.int8))
    w = torch.from_numpy(rng.randint(-127, 128, (k, k, ci, co)).astype(np.int8))
    sc = torch.from_numpy((rng.rand(co) * 1e-4 / np.sqrt(ci)).astype(np.float32))
    b = torch.from_numpy((rng.randn(co) * 0.1).astype(np.float32))
    xp, wpk, sp, bp, kw, _ = int8_kernel.launch_args_int8(
        x.to(card), w.to(card), sc.to(card), b.to(card), s, p, *tiles, act,
        out_scale)
    got_split = int8_kernel.launch_split_int8(xp, wpk, kw)
    assert split is None or got_split == split
    before = int8_kernel.LAUNCHES
    y = int8_kernel.deconv2d_int8_launch(xp, wpk, sp, bp, **kw)
    y1 = int8_kernel.deconv2d_int8_launch(xp, wpk, sp, bp, **kw)
    torch.cuda.synchronize()
    assert int8_kernel.LAUNCHES == before + 2
    assert torch.equal(y, y1)
    want = int8_kernel.deconv2d_int8_launch_plain(
        xp, int8_kernel.unpack_int8_weights(wpk), sp, bp, split=got_split,
        **kw)
    assert y.dtype == want.dtype
    if out_scale is None:
        torch.testing.assert_close(y, want, rtol=0, atol=1e-6)
    else:
        torch.testing.assert_close(y, want, rtol=0, atol=0)
    return got_split


@pytest.mark.parametrize("out_scale,act", [(0.02, "relu"), (None, "tanh")])
@pytest.mark.parametrize("geom", CASES)
def test_int8_kernel_matches_plain_version(card, geom, out_scale, act, rng):
    """The synthetic cases at 32-channel CI chunks, 8-channel tiles and a
    batch tile of 2, each at the split its grid gives."""
    ih, iw, ci, co, k, s, p, t = geom
    _int8_check(card, rng, 3, (ih, iw, ci, co, k, s, p), (t, t, 32, 8, 2),
                act, out_scale)


@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_int8_kernel_at_each_cluster_split(card, split, rng):
    """One 16x16 output tile and 64 channels: the grid is one block, so the
    split is the count of 32-channel CI chunks, up to 8."""
    _int8_check(card, rng, 1, (8, 8, 32 * split, 64, 4, 2, 1),
                (16, 16, 32, 64, 1), "relu", 0.05, split)


@pytest.mark.parametrize("cfg,layer", [(dcnn.MNIST_DCNN, 2),
                                       (dcnn.CELEBA_DCNN, 4)],
                         ids=["mnist_l2", "celeba_l4"])
@pytest.mark.parametrize("batch", [1, 8])
def test_int8_kernel_on_thin_tanh_layers(card, cfg, layer, batch, rng):
    """The 1- and 3-channel tanh layers at their int8 tiles, f32 out: zero
    weight rows pad the n8 column tile, stores masked to the real
    channels."""
    g = cfg.geometries()[layer]
    t = hopper_tiles(g, batch, "int8")
    assert t.t_co == g.c_out
    _int8_check(card, rng, batch, (g.in_h, g.in_w, g.c_in, g.c_out, g.kernel,
                                   g.stride, g.padding),
                tuple(t.as_kwargs().values()), "tanh", None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", CASES)
def test_sparse_kernel_matches_plain_version(card, geom, dtype, rng):
    """Pruned at 0.9 with the first half of the input channels zeroed by
    hand, so that whole slabs drop out of the schedule."""
    ih, iw, ci, co, k, s, p, t = geom
    x = torch.from_numpy(rng.randn(3, ih, iw, ci).astype(np.float32))
    w = magnitude_prune(torch.from_numpy(
        (rng.randn(k, k, ci, co) * 0.1).astype(np.float32)), 0.9)[0]
    w[:, :, : ci // 2] = 0.0
    b = torch.from_numpy((rng.randn(co) * 0.1).astype(np.float32))
    xp, wp, bp, kw, _ = launch_args(x.to(card, dtype), w.to(card, dtype),
                                    b.to(card, dtype), s, p, t, t,
                                    T_CI[dtype], 8, 2, "tanh")
    sched = schedule_tensors(make_sparse_plan(w, s, p, T_CI[dtype], 8), card)
    before = sparse_kernel.LAUNCHES
    y = sparse_kernel.deconv2d_sparse_launch(xp, wp, bp, *sched, **kw)
    torch.cuda.synchronize()
    assert sparse_kernel.LAUNCHES == before + 1
    want = sparse_kernel.deconv2d_sparse_launch_plain(xp, wp, bp, *sched, **kw)
    tol = 1e-4 if dtype == torch.float32 else 8e-2
    torch.testing.assert_close(y.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("kind", ["int8", "cuda_sparse"])
def test_int8_and_sparse_engines_launch_their_kernel(card, kind):
    cfg = dcnn.MNIST_DCNN
    params = dcnn.generator_init(torch.Generator().manual_seed(0), cfg, card)
    if kind == "int8":
        conf = EngineConfig(model="mnist", precision="int8", max_batch=8)
        mod = int8_kernel
    else:
        params = prune_tree(params, 0.9)
        conf = EngineConfig(model="mnist", backend="cuda_sparse", max_batch=8)
        mod = sparse_kernel
    eng = DcnnServeEngine.from_config(conf, params)
    z = np.random.RandomState(0).randn(11, cfg.z_dim).astype(np.float32)
    counts = {m: m.LAUNCHES for m in (deconv_kernel, int8_kernel,
                                      sparse_kernel)}
    y = eng.generate(z)
    want_launches = len(cfg.layers) * len(eng.plan_chunks(11))
    assert sum(eng.launch_counts.values()) == want_launches
    # the wrappers see each built bucket's eager pass and capture only;
    # its dispatches are replays
    built = len(cfg.layers) * 2 * len(eng.capture_counts)
    for m, n in counts.items():
        assert m.LAUNCHES - n == (built if m is mod else 0)
    zt = torch.from_numpy(z).to(card)
    if kind == "int8":
        want = quantized_generator_ref(eng.params, cfg, eng.quant_cfg, zt)
        np.testing.assert_allclose(y, want.cpu().numpy(), rtol=0, atol=1e-6)
    else:
        want = dcnn.generator_apply(eng.params, cfg, zt,
                                    backend="reverse_loop")
        np.testing.assert_allclose(y, want.cpu().numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "zero_skip"])
@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_tc_kernel_at_each_cluster_split(card, split, sparse, rng):
    """One 16x16 output tile and 64 channels: the grid is one block, so the
    split is the CI chunks' count (8 channels each), up to 8.  The fp32
    kernel against its plain version, zero-skip on hand-zeroed slabs, and
    two launches bit-identical."""
    ci = 8 * split if split > 1 else 8
    x = torch.from_numpy(rng.randn(1, 8, 8, ci).astype(np.float32)).to(card)
    w = torch.from_numpy((rng.randn(4, 4, ci, 64) * 0.1).astype(np.float32))
    if sparse:
        w[:, :, : ci // 2] = 0.0
        w[1] = 0.0
    w = w.to(card)
    b = torch.from_numpy((rng.randn(64) * 0.1).astype(np.float32)).to(card)
    xp, wp, bp, kw, _ = launch_args(x, w, b, 2, 1, 16, 16, 8, 64, 1, "relu")
    assert deconv_kernel.launch_split(1, ci, 64, 16, 16, 16, 16, 8, 64,
                                      1) == split
    if sparse:
        sched = schedule_tensors(make_sparse_plan(w, 2, 1, 8, 64), card)
        run = lambda: sparse_kernel.deconv2d_sparse_launch(  # noqa: E731
            xp, wp, bp, *sched, **kw)
        want = sparse_kernel.deconv2d_sparse_launch_plain(xp, wp, bp, *sched,
                                                          **kw)
    else:
        run = lambda: deconv_kernel.deconv2d_launch(xp, wp, bp, **kw)  # noqa: E731
        want = deconv_kernel.deconv2d_launch_plain(xp, wp, bp, split=split,
                                                   **kw)
    y0, y1 = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(y0, y1)
    torch.testing.assert_close(y0, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cfg,layer", [(dcnn.MNIST_DCNN, 2),
                                       (dcnn.CELEBA_DCNN, 4)],
                         ids=["mnist_l2", "celeba_l4"])
@pytest.mark.parametrize("batch", [1, 8])
def test_tc_kernel_on_thin_tanh_layers(card, cfg, layer, batch, rng):
    """The 1- and 3-channel tanh layers at their fp32 tiles: zero-padded
    weight columns in shared memory, stores masked to the real channels."""
    g = cfg.geometries()[layer]
    t = hopper_tiles(g, batch)
    x = torch.from_numpy(rng.randn(batch, g.in_h, g.in_w, g.c_in)
                         .astype(np.float32)).to(card)
    w = torch.from_numpy((rng.randn(4, 4, g.c_in, g.c_out) * 0.05)
                         .astype(np.float32)).to(card)
    xp, wp, bp, kw, _ = launch_args(x, w, None, g.stride, g.padding,
                                    *t.as_kwargs().values(), "tanh")
    assert wp.shape[3] == g.c_out
    y = deconv_kernel.deconv2d_launch(xp, wp, bp, **kw)
    torch.cuda.synchronize()
    want = deconv_kernel.deconv2d_launch_plain(xp, wp, bp, **kw)
    torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-4)


# -- the per-bucket CUDA graphs ------------------------------------------
PATHS = {"fp32": {}, "int8": {"precision": "int8"},
         "cuda_sparse": {"backend": "cuda_sparse"}}


def _eager(path, eng, z):
    """One bucket of rows through the public ops at the bucket's plan,
    eagerly, every operand prepared per call (int8 from ``w_q``)."""
    plan = eng.plans[z.shape[0]]
    with torch.no_grad():
        if path == "int8":
            qp = {k: {n: v[n] for n in ("w_q", "scale", "b")}
                  for k, v in eng.params.items()}
            return quantized_generator_apply(qp, eng.cfg, None, z,
                                             plan=plan).cpu().numpy()
        return dcnn.generator_apply(eng.params, eng.cfg, z,
                                    plan=plan).float().cpu().numpy()


@pytest.mark.parametrize("net", ["mnist", "celeba"])
@pytest.mark.parametrize("bucket", [1, 2, 64])
@pytest.mark.parametrize("path", list(PATHS))
def test_replayed_graph_equals_an_eager_run_of_the_same_plan(card, path,
                                                             bucket, net):
    """Replayed images bit-identical to the eager ops at the same plan (at
    bucket 1 the cluster splits of 4 and 8 run inside the graph), one
    capture per bucket, and the launches of layers x dispatches."""
    cfg = {"mnist": dcnn.MNIST_DCNN, "celeba": dcnn.CELEBA_DCNN}[net]
    params = dcnn.generator_init(torch.Generator().manual_seed(0), cfg, card)
    if path == "cuda_sparse":
        params = prune_tree(params, 0.9)
    eng = DcnnServeEngine.from_config(
        EngineConfig(model=net, buckets=(bucket,), **PATHS[path]), params)
    rng = np.random.RandomState(bucket)
    for _ in range(3):
        z = rng.randn(bucket, cfg.z_dim).astype(np.float32)
        got = eng.generate(z)
        want = _eager(path, eng, torch.from_numpy(z).to(card))
        np.testing.assert_array_equal(got, want)
    assert eng.capture_counts == {bucket: 1} and eng.total_captures == 1
    assert eng.launch_counts == {bucket: 3 * len(cfg.layers)}


@pytest.mark.parametrize("bucket", [1, 64])
@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("tower", ["sr", "denoise"])
def test_zoo_towers_serve_from_graphs_like_eager(card, tower, path, bucket):
    """The image-rooted towers (stride 1, K = 5, one-channel roots) on each
    path: replay bit-identical to eager, images within 1e-4 of
    reverse_loop (fp32 paths)."""
    from repro_torch.workloads import get

    w = get(tower)
    params = w.init(torch.Generator().manual_seed(0), card)
    if path == "cuda_sparse":
        params = prune_tree(params, 0.9)
    eng = DcnnServeEngine.from_config(
        EngineConfig(model=tower, buckets=(bucket,), **PATHS[path]), params)
    x = np.asarray(w.training_pairs(bucket, bucket)[0], np.float32)
    got = eng.generate(x)
    xt = torch.from_numpy(x).to(card)
    np.testing.assert_array_equal(got, _eager(path, eng, xt))
    if path != "int8":
        with torch.no_grad():
            want = w.ref(eng.params, xt).cpu().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert eng.capture_counts == {bucket: 1}
    assert eng.launch_counts == {bucket: len(w.cfg.layers)}


@pytest.mark.parametrize("bucket", [1, 64])
@pytest.mark.parametrize("backend", ["cuda", "cuda_sparse"])
@pytest.mark.parametrize("net", ["mnist", "celeba"])
def test_bf16_towers_serve_from_graphs_like_eager(card, net, backend,
                                                  bucket):
    """bf16 chains on the tensor-core kernels: float32 results of bf16 values,
    replay bit-identical to eager, within 8e-2 of bf16 reverse_loop."""
    import dataclasses

    cfg = dataclasses.replace(
        {"mnist": dcnn.MNIST_DCNN, "celeba": dcnn.CELEBA_DCNN}[net],
        dtype="bfloat16")
    params = dcnn.generator_init(torch.Generator().manual_seed(0), cfg, card)
    if backend == "cuda_sparse":
        params = prune_tree(params, 0.9)
    eng = DcnnServeEngine.from_config(
        EngineConfig(model=cfg, backend=backend, buckets=(bucket,)), params)
    z = np.random.RandomState(bucket).randn(bucket, 100).astype(np.float32)
    got = eng.generate(z)
    assert got.dtype == np.float32
    zt = torch.from_numpy(z).to(card)
    np.testing.assert_array_equal(got, _eager("fp32", eng, zt))
    np.testing.assert_array_equal(
        got, torch.from_numpy(got).to(torch.bfloat16).float().numpy())
    with torch.no_grad():
        want = dcnn.generator_apply(eng.params, cfg, zt,
                                    backend="reverse_loop").float()
    np.testing.assert_allclose(got, want.cpu().numpy(), rtol=8e-2, atol=8e-2)
    assert eng.launch_counts == {bucket: len(cfg.layers)}


def test_refine_writes_a_timed_entry_that_a_second_engine_serves(
        card, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "t.json"))
    monkeypatch.setattr(autotune, "_cache", None)
    cfg = dcnn.MNIST_DCNN
    params = dcnn.generator_init(torch.Generator().manual_seed(0), cfg, card)
    eng = DcnnServeEngine.from_config(EngineConfig(
        model="mnist", buckets=(1,), warmup=True, refine=True), params)
    tiles = [l.tiles for l in eng.plans[1].layers]
    assert all(t.source == "timed" for t in tiles)
    for l in eng.plans[1].layers:
        e = autotune.cached_entry(l.geometry, "float32", "cuda", 1)
        assert e["model"] == hopper_tiles(l.geometry, 1).as_kwargs()
        assert e["model_ms"] > 0 and len(e["timed"]) >= 2
        assert e["ms"] == min(c["ms"] for c in e["timed"])
    assert (tmp_path / "t.json").exists()

    def timed_again(*a, **k):
        raise AssertionError("a cached choice was timed again")

    monkeypatch.setattr(autotune, "_time_candidate", timed_again)
    monkeypatch.setattr(autotune, "_cache", None)      # read the file back
    again = DcnnServeEngine.from_config(EngineConfig(
        model="mnist", buckets=(1,), warmup=True), params)
    assert [l.tiles for l in again.plans[1].layers] == tiles
    assert all(l.tiles.source == "cache" for l in again.plans[1].layers)
    z = np.random.RandomState(1).randn(1, cfg.z_dim).astype(np.float32)
    want = dcnn.generator_apply(again.params, cfg,
                                torch.from_numpy(z).to(card),
                                backend="reverse_loop").cpu().numpy()
    np.testing.assert_allclose(again.generate(z), want, rtol=1e-4, atol=1e-4)


def _run_threads(targets, timeout=300):
    """Start one thread per ``(function, args)``; the errors they raised."""
    import threading

    errors = []

    def guarded(fn, *a):
        try:
            fn(*a)
        except Exception as e:   # reported by the caller
            errors.append(e)

    threads = [threading.Thread(target=guarded, args=(fn, *a))
               for fn, *a in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads)
    return errors


def test_engines_capture_lazily_on_two_threads(card):
    """Two engines capturing their buckets lazily on two threads, while a
    third thread builds int8 engines (calibrating on the card), serves one
    request on each and drops it (garbage holding a graph and pinned
    buffers): no capture or dispatch fails, each bucket is captured once,
    and the images equal those of the same engines run one at a time."""
    cfg = dcnn.MNIST_DCNN
    params = dcnn.generator_init(torch.Generator().manual_seed(0), cfg, card)
    kinds = {"fp32": {}, "int8": {"precision": "int8"}}

    def engine(kind):
        return DcnnServeEngine.from_config(EngineConfig(
            model="mnist", buckets=(1, 2, 4, 8), **kinds[kind]), params)

    zs = [np.random.RandomState(i).randn(1 + 3 * i % 8, cfg.z_dim)
          .astype(np.float32) for i in range(8)]
    want = {k: [engine(k).generate(z) for z in zs] for k in kinds}
    engines = {k: engine(k) for k in kinds}

    def serve(k):
        for z, w in zip(zs, want[k]):
            np.testing.assert_array_equal(engines[k].generate(z), w)

    def construct():
        for z, w in zip(zs[:4], want["int8"]):
            np.testing.assert_array_equal(engine("int8").generate(z), w)

    errors = _run_threads([(serve, "fp32"), (serve, "int8"), (construct,)])
    assert errors == []
    for eng in engines.values():
        assert eng.capture_counts == {b: 1 for b in eng.buckets}


def test_other_threads_stream_work_does_not_break_a_capture(card):
    """A capture runs in thread-local mode: another thread allocating,
    launching and synchronising on a stream of its own (no random draws:
    the default generator belongs to the capture) meanwhile breaks
    neither the captures nor its own work, and the captured images equal
    those of engines captured with the card to themselves."""
    import threading

    cfg = dcnn.MNIST_DCNN
    params = dcnn.generator_init(torch.Generator().manual_seed(0), cfg, card)
    z = np.random.RandomState(0).randn(8, cfg.z_dim).astype(np.float32)
    buckets = (1, 2, 4, 8)

    def engine(b):
        return DcnnServeEngine.from_config(EngineConfig(
            model="mnist", buckets=(b,)), params)

    want = {b: engine(b).generate(z[:b]) for b in buckets}
    done = threading.Event()

    def stream_work():
        s = torch.cuda.Stream(card)
        with torch.cuda.stream(s):
            while not done.is_set():
                y = torch.full((1 << 16,), 0.5, device=card)
                y.mul_(2).add_(1)
                s.synchronize()

    def serve():
        try:
            for b in buckets:
                eng = engine(b)
                np.testing.assert_array_equal(eng.generate(z[:b]), want[b])
                assert eng.capture_counts == {b: 1}
        finally:
            done.set()

    assert _run_threads([(stream_work,), (serve,)]) == []


def test_results_past_the_pinned_budget_are_copies(card, monkeypatch):
    """Within the process-wide pinned budget a result keeps a pinned tensor
    of its own; past it the images are copied out of the bucket's pinned
    buffer.  Either way a kept result never changes after later
    dispatches, and dropping the results gives their bytes back."""
    import gc

    from repro_torch.serve import engine as engine_mod

    cfg = dcnn.MNIST_DCNN
    params = dcnn.generator_init(torch.Generator().manual_seed(0), cfg, card)
    eng = DcnnServeEngine.from_config(EngineConfig(
        model="mnist", buckets=(4,), warmup=True), params)
    block = 1 << (4 * 28 * 28 * 4 - 1).bit_length()
    budget = engine_mod._PinnedBudget(block)
    monkeypatch.setattr(engine_mod, "PINNED_RESULTS", budget)
    rng = np.random.RandomState(0)
    zs = [rng.randn(4, cfg.z_dim).astype(np.float32) for _ in range(4)]
    kept = [eng.generate(z) for z in zs[:2]]
    want = [k.copy() for k in kept]
    assert budget.held == block                 # the first one is pinned
    out_host = eng._fns[4].out_host.numpy()
    assert not any(np.shares_memory(k, out_host) for k in kept)
    for z in zs[2:]:
        eng.generate(z)
    for k, w in zip(kept, want):
        np.testing.assert_array_equal(k, w)
    del kept
    gc.collect()
    assert budget.held == 0
