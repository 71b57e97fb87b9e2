"""The engine's per-bucket executables on the CPU (``device="cpu"``, where
they run eagerly): built once per bucket, results that never alias the
staging buffers, the held static operands passed to the launchers, and the
images against the JAX package's generator.  Their capture as CUDA graphs
is checked on a card (``tests/test_torch_cuda.py``)."""
import jax
import numpy as np
import pytest
import torch

from repro.core.sparsity import prune_tree as j_prune_tree
from repro.models import dcnn as jdcnn
from repro_torch.kernels.deconv2d import int8 as int8_kernel
from repro_torch.kernels.deconv2d import ops
from repro_torch.kernels.deconv2d_sparse import ops as sparse_ops
from repro_torch.models import dcnn
from repro_torch.serve import DcnnServeEngine, EngineConfig
from repro_torch.serve.engine import (BucketExecutable, _CaptureGate,
                                      _PinnedBudget)

TOL = 1e-4  # fp32, the same products summed in another order
PATHS = {"fp32": {}, "int8": {"precision": "int8"},
         "cuda_sparse": {"backend": "cuda_sparse"}}
SIZES = [3, 5, 1, 8, 2, 3, 7, 5, 1, 6]


@pytest.fixture(scope="module")
def mnist():
    p, _ = jdcnn.generator_init(jax.random.PRNGKey(0), jdcnn.MNIST_DCNN)
    pp = j_prune_tree(p, 0.9)
    trees = {}
    for name, tree in (("dense", p), ("pruned", pp)):
        pn = jax.tree_util.tree_map(np.asarray, tree)
        trees[name] = (tree, dcnn.generator_params_from_numpy(
            pn, dcnn.MNIST_DCNN, "cpu"))
    return trees


def _engine(mnist, path, **kw):
    _, params = mnist["pruned" if path == "cuda_sparse" else "dense"]
    return DcnnServeEngine.from_config(
        EngineConfig(model="mnist", device="cpu", **PATHS[path], **kw), params)


@pytest.mark.parametrize("path", list(PATHS))
def test_mixed_stream_builds_one_executable_per_bucket(mnist, path, rng):
    """A mixed-size stream builds at most one executable per bucket, and
    repeating it builds nothing new (the JAX engine's compile-once
    check)."""
    eng = _engine(mnist, path, buckets=(1, 2, 4, 8))
    for n in SIZES:
        assert eng.generate(rng.randn(n, 100).astype(np.float32)).shape == \
            (n, 28, 28, 1)
    assert set(eng.capture_counts.values()) == {1}
    assert eng.total_captures <= len(eng.buckets)
    assert eng.total_captures == len(eng.plans)
    before = dict(eng.capture_counts)
    for n in SIZES:
        eng.generate(rng.randn(n, 100).astype(np.float32))
    assert eng.capture_counts == before


def test_warmup_builds_every_bucket_and_traffic_builds_nothing(mnist, rng):
    eng = _engine(mnist, "fp32", buckets=(1, 2), warmup=True)
    assert eng.capture_counts == {1: 1, 2: 1}
    assert sorted(eng._fns) == [1, 2]
    out = eng.collect(eng.submit(rng.randn(100).astype(np.float32)))
    assert out.shape == (1, 28, 28, 1)
    out = eng.collect(eng.submit(rng.randn(2, 100).astype(np.float32)))
    assert eng.capture_counts == {1: 1, 2: 1} and eng.total_captures == 2
    # warmup dispatches stay out of the timing stats
    assert eng.throughput()[1]["calls"] == 1


def test_a_pinned_plan_is_built_like_any_other(mnist):
    from repro_torch.plan import build_network_plan

    plan = build_network_plan(dcnn.MNIST_DCNN, batch=4)
    eng = DcnnServeEngine.from_config(EngineConfig(
        model="mnist", device="cpu", max_batch=4), mnist["dense"][1],
        plan=plan)
    eng.generate(np.zeros((4, 100), np.float32))
    assert eng.plans[4] is plan and eng.capture_counts == {4: 1}
    assert eng.plan_stats["builds"] == 0


@pytest.mark.parametrize("path", list(PATHS))
def test_collected_results_are_copies(mnist, path, rng):
    """The staging buffers are reused by the next dispatch of the bucket:
    a result handed out must not change after it."""
    eng = _engine(mnist, path, buckets=(4,))
    a = eng.generate(rng.randn(3, 100).astype(np.float32))
    kept = a.copy()
    t = eng.submit(rng.randn(4, 100).astype(np.float32))
    b = eng.collect(t)
    eng.generate(rng.randn(4, 100).astype(np.float32))
    np.testing.assert_array_equal(a, kept)
    assert not np.array_equal(a, b[:3])
    ex, = eng._fns[4].shards
    for r in (a, b):
        for buf in (ex.out_dev, ex.out_host, ex.z_host):
            assert not np.shares_memory(r, buf.numpy())


def test_rows_past_the_request_are_zeroed(mnist, rng):
    """A short request after a full one sees zeros, not the last request's
    rows, in the padded part of the static input (the JAX engine pads
    with zeros)."""
    eng = _engine(mnist, "fp32", buckets=(4,))
    eng.generate(rng.randn(4, 100).astype(np.float32))
    z = rng.randn(1, 100).astype(np.float32)
    eng.generate(z)
    staged = eng._fns[4].shards[0].z_host
    np.testing.assert_array_equal(staged[0].numpy(), z[0])
    assert not staged[1:].any()


def _record(monkeypatch, path):
    """Patch the path's launcher to record the operand tensors it gets, and
    the static preparations to count themselves."""
    seen, prepared = [], []
    if path == "int8":
        real = int8_kernel.deconv2d_int8_launch

        def launch(xp, wpk, sp, bp, **kw):
            seen.append((wpk.data.data_ptr(), sp.data_ptr(), bp.data_ptr()))
            return real(xp, wpk, sp, bp, **kw)

        monkeypatch.setattr(int8_kernel, "deconv2d_int8_launch", launch)
        for name in ("prepare_int8_static", "pack_int8_weights"):
            fn = getattr(int8_kernel, name)
            monkeypatch.setattr(int8_kernel, name,
                                lambda *a, _f=fn, **k: prepared.append(1)
                                or _f(*a, **k))
        return seen, prepared
    mod = sparse_ops if path == "cuda_sparse" else ops
    name = "deconv2d_sparse_launch" if path == "cuda_sparse" \
        else "deconv2d_launch"
    real = getattr(mod, name)

    def launch(xp, wp, bp, *rest, **kw):
        seen.append((wp.data_ptr(), bp.data_ptr()))
        return real(xp, wp, bp, *rest, **kw)

    monkeypatch.setattr(mod, name, launch)
    real_prep = ops.prepare_static
    monkeypatch.setattr(ops, "prepare_static",
                        lambda *a, **k: prepared.append(1)
                        or real_prep(*a, **k))
    return seen, prepared


@pytest.mark.parametrize("path", list(PATHS))
def test_launchers_get_the_held_static_operands(mnist, path, monkeypatch,
                                                rng):
    """After a bucket's first dispatch, no dispatch prepares or pads a
    weight, bias or scale: every launch gets the tensors the engine holds
    (the same addresses a captured graph would keep)."""
    eng = _engine(mnist, path, buckets=(2, 4))
    eng.generate(rng.randn(6, 100).astype(np.float32))    # builds 4 and 2
    seen, prepared = _record(monkeypatch, path)
    for _ in range(3):
        eng.generate(rng.randn(6, 100).astype(np.float32))
    assert prepared == []
    per_dispatch = [tuple(seen[i:i + 3]) for i in range(0, len(seen), 3)]
    assert len(per_dispatch) == 6
    assert len({d for d in per_dispatch[0::2]}) == 1      # bucket 4
    assert len({d for d in per_dispatch[1::2]}) == 1      # bucket 2
    if path == "int8":
        held = [(eng.params[f"l{i}"]["static"].w.data.data_ptr(),
                 eng.params[f"l{i}"]["static"].scale.data_ptr(),
                 eng.params[f"l{i}"]["static"].b.data_ptr())
                for i in range(3)]
    else:
        held = [(st.w.data_ptr(), st.b.data_ptr())
                for st in eng._prepared(eng.plans[4]).values()]
    assert list(per_dispatch[0]) == held


def test_static_operands_are_prepared_once_per_layer_and_tiles(mnist):
    eng = _engine(mnist, "fp32", buckets=(1, 2, 4, 8), warmup=True)
    keys = set()
    for b, plan in eng.plans.items():
        for i, l in enumerate(plan.layers):
            g, t = l.geometry, l.tiles
            keys.add((i, -(-g.c_in // t.t_ci) * t.t_ci,
                      -(-g.c_out // t.t_co) * t.t_co))
    assert set(eng._static) == keys
    for (i, cip, cop), st in eng._static.items():
        k = dcnn.MNIST_DCNN.layers[i].kernel
        assert tuple(st.w.shape) == (k, k, cip, cop) and st.w.is_contiguous()
        assert tuple(st.b.shape) == (1, cop)


@pytest.mark.parametrize("path", ["fp32", "cuda_sparse"])
def test_engine_images_match_reference_generator(mnist, path, rng):
    """Mixed requests through buckets 1..4 against the JAX package's
    reverse loop on the same numpy params and z."""
    jp, _ = mnist["pruned" if path == "cuda_sparse" else "dense"]
    eng = _engine(mnist, path, max_batch=4)
    reqs = [rng.randn(n, 100).astype(np.float32) for n in (3, 1, 5, 4)]
    outs = [eng.collect(t) for t in [eng.submit(r) for r in reqs]]
    want = np.asarray(jdcnn.generator_apply(jp, jdcnn.MNIST_DCNN,
                                            np.concatenate(reqs),
                                            backend="reverse_loop"))
    np.testing.assert_allclose(np.concatenate(outs), want, rtol=TOL, atol=TOL)
    assert set(eng.capture_counts.values()) == {1}


def test_a_failed_replay_raises_naming_the_bucket():
    class Broken:
        def replay(self):
            raise RuntimeError("an illegal memory access")

    z = torch.zeros(8, 100)
    ex = BucketExecutable(8, None, z, z, z, z, graph=Broken(), launches=3)
    with pytest.raises(RuntimeError, match="bucket 8: CUDA graph replay"):
        ex.replay()


def test_concurrent_generate_calls_never_mix_their_rows(mnist):
    """Threads calling `generate` outside `drain` share each bucket's static
    buffers; the dispatch lock keeps every thread's images its own."""
    import sys
    import threading

    eng = _engine(mnist, "fp32", buckets=(2, 4))
    zs = [np.random.RandomState(i).randn(3 + i % 3, 100).astype(np.float32)
          for i in range(8)]
    want = [eng.generate(z) for z in zs]
    got, errors = [None] * len(zs), []

    def work(i):
        try:
            for _ in range(3):
                got[i] = eng.generate(zs[i])
                np.testing.assert_array_equal(got[i], want[i])
        except Exception as e:   # reported below, from the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(len(zs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert eng.capture_counts == {2: 1, 4: 1}


def test_prepared_operands_for_other_tiles_are_refused(mnist):
    """The ops take a prepared weight only at the launch's padded channels
    (a stale one would read the wrong channels)."""
    from repro_torch.plan import build_network_plan

    _, params = mnist["dense"]
    plan = build_network_plan(dcnn.MNIST_DCNN, batch=2)
    l1 = plan.layers[1]
    w, b = params["l1"]["w"], params["l1"]["b"]
    x = torch.zeros(2, 7, 7, 256)
    good = ops.prepare_static(w, b, 256, 128)
    y = ops.deconv2d(x, w, b, plan=l1, static=good)
    torch.testing.assert_close(y, ops.deconv2d(x, w, b, plan=l1))
    with pytest.raises(ValueError, match="prepared weight"):
        ops.deconv2d(x, w, b, plan=l1,
                     static=ops.prepare_static(w, b, 512, 128))


def test_a_build_waits_for_dispatches_and_holds_new_ones_back():
    """The capture gate: a build (exclusive) waits for the dispatch in
    flight (shared), and a dispatch that arrives meanwhile waits for the
    build to end."""
    import threading

    gate = _CaptureGate()
    order, release = [], threading.Event()

    def dispatch(name, hold=None):
        with gate.shared():
            order.append(name)
            if hold is not None:
                hold.wait(5)

    def build():
        with gate.exclusive():
            order.append("build")

    first = threading.Thread(target=dispatch, args=("first", release))
    first.start()
    while "first" not in order:
        pass
    builder = threading.Thread(target=build)
    builder.start()
    while not gate._building:
        pass
    late = threading.Thread(target=dispatch, args=("late",))
    late.start()
    builder.join(0.2)
    late.join(0.2)
    assert order == ["first"]           # both wait on the first dispatch
    release.set()
    for t in (first, builder, late):
        t.join(5)
    assert order == ["first", "build", "late"]


def test_engines_on_two_threads_build_lazily_and_agree(mnist):
    """Two engines built lazily on two threads (each bucket's build, on a
    card its capture, under the process-wide gate while the other engine
    dispatches) give the images of the same engines run one at a time."""
    import sys
    import threading

    zs = [np.random.RandomState(i).randn(1 + 3 * i % 8, 100)
          .astype(np.float32) for i in range(8)]
    want = {p: [_engine(mnist, p, buckets=(1, 2, 4, 8)).generate(z)
                for z in zs] for p in ("fp32", "int8")}
    engines = {p: _engine(mnist, p, buckets=(1, 2, 4, 8)) for p in want}
    errors = []

    def work(p):
        try:
            for z, w in zip(zs, want[p]):
                np.testing.assert_array_equal(engines[p].generate(z), w)
        except Exception as e:   # reported below, from the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(p,)) for p in want]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    for eng in engines.values():
        assert set(eng.capture_counts.values()) == {1}


def test_pinned_budget_refuses_past_its_limit_and_takes_bytes_back():
    budget = _PinnedBudget(8 << 20)
    assert budget.take(4 << 20) and budget.take(4 << 20)
    assert not budget.take(1)
    budget.give(4 << 20)
    assert budget.take(2 << 20) and budget.held == 6 << 20
