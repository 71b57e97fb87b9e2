"""The port's zero-skip path against the JAX package, on the CPU: pruning
and slab statistics, schedules and their digests, the zero-skip layer
(whose CPU path is the kernel's plain version) and the generator on
``cuda_sparse``.

Tolerances: pruning masks, block masks, schedules and digests bit for bit
(the same host arithmetic); fp32 outputs 1e-4 (the same products summed in
another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparsity as jsparsity
from repro.kernels.deconv2d import deconv2d_ref as j_deconv2d_ref
from repro.kernels.deconv2d_sparse import make_sparse_plan as j_make_sparse_plan
from repro.kernels.deconv2d_sparse.kernel import build_schedule as j_build
from repro.models import dcnn as jdcnn
from repro.plan.deconv_plan import _sparse_digest as j_digest
from repro_torch.core import sparsity
from repro_torch.kernels.deconv2d.ops import launch_args
from repro_torch.kernels.deconv2d_sparse import (build_schedule,
                                                 deconv2d_sparse,
                                                 deconv2d_sparse_launch,
                                                 make_sparse_plan,
                                                 schedule_tensors)
from repro_torch.kernels.deconv2d_sparse import kernel as sparse_kernel
from repro_torch.models import dcnn
from repro_torch.plan.deconv_plan import _sparse_digest

TOL = 1e-4
SPARSITIES = [0.0, 0.5, 0.9, 0.97]


def _hand_zeroed(w: np.ndarray) -> np.ndarray:
    """Whole CI slabs and one whole tap row zero: what element-level
    pruning rarely produces, so the schedule really drops slabs."""
    w = w.copy()
    w[:, :, 8:, :] = 0.0
    w[1] = 0.0
    return w


@pytest.mark.parametrize("s", SPARSITIES)
def test_magnitude_prune_matches_reference(s, rng):
    w = rng.randn(4, 4, 16, 12).astype(np.float32)
    jw, jm = jsparsity.magnitude_prune(jnp.asarray(w), s)
    tw, tm = sparsity.magnitude_prune(torch.from_numpy(w), s)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_prune_tree_matches_reference():
    p, _ = jdcnn.generator_init(jax.random.PRNGKey(1), jdcnn.MNIST_DCNN)
    pn = jax.tree_util.tree_map(np.asarray, p)
    tp = dcnn.generator_params_from_numpy(pn, dcnn.MNIST_DCNN, "cpu")
    keep_l1 = lambda path: "l1" not in path  # noqa: E731
    for kw in ({}, {"key_filter": keep_l1}):
        want = jsparsity.prune_tree(p, 0.9, **kw)
        got = sparsity.prune_tree(tp, 0.9, **kw)
        for layer in want:
            for name in ("w", "b"):
                np.testing.assert_array_equal(got[layer][name].numpy(),
                                              np.asarray(want[layer][name]))
    assert float((got["l1"]["w"] == 0).float().mean()) < 0.01
    assert float((got["l0"]["w"] == 0).float().mean()) > 0.89


@pytest.mark.parametrize("blocks", [(8, 16), (8, 8), (5, 7), (32, 128)])
def test_block_mask_and_skip_stats_match_reference(blocks, rng):
    w = rng.randn(4, 4, 32, 20).astype(np.float32)
    for arr in (np.asarray(jsparsity.magnitude_prune(jnp.asarray(w), 0.8)[0]),
                _hand_zeroed(w)):
        np.testing.assert_array_equal(sparsity.block_mask(arr, *blocks),
                                      jsparsity.block_mask(arr, *blocks))
        assert sparsity.zero_skip_stats(torch.from_numpy(arr.copy()), *blocks) == \
            sparsity.SkipStats(**vars(jsparsity.zero_skip_stats(arr, *blocks)))


@pytest.mark.parametrize("tiles", [(8, 16), (8, 8), (5, 3), (32, 4)])
def test_schedules_and_digests_match_reference_at_equal_tiles(tiles, rng):
    w = rng.randn(4, 4, 32, 16).astype(np.float32)
    for arr in (np.asarray(jsparsity.magnitude_prune(jnp.asarray(w), 0.97)[0]),
                _hand_zeroed(w)):
        want = j_make_sparse_plan(arr, 2, 1, *tiles)
        got = make_sparse_plan(torch.from_numpy(arr.copy()), 2, 1, *tiles)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g, x)
            assert g.dtype == x.dtype
        assert _sparse_digest(got) == j_digest(want)
    mask = sparsity.block_mask(_hand_zeroed(w), 8, 16)
    for g, x in zip(build_schedule(mask), j_build(mask)):
        np.testing.assert_array_equal(g, x)


@pytest.mark.parametrize("s", SPARSITIES + ["hand"])
def test_sparse_layer_matches_dense_reference_on_pruned_weights(s, rng):
    x = rng.randn(3, 7, 7, 16).astype(np.float32)
    w = rng.randn(4, 4, 16, 12).astype(np.float32)
    b = rng.randn(12).astype(np.float32)
    w = _hand_zeroed(w) if s == "hand" else np.asarray(
        jsparsity.magnitude_prune(jnp.asarray(w), s)[0])
    want = np.asarray(jax.nn.relu(j_deconv2d_ref(jnp.asarray(x),
                                                 jnp.asarray(w),
                                                 jnp.asarray(b), 2, 1)))
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    got = deconv2d_sparse(tx, tw, tb, 2, 1, t_oh=4, t_ow=4, t_ci=4, t_co=4,
                          t_n=2, activation="relu")
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    tables = make_sparse_plan(w, 2, 1, 4, 4)
    print(f"sparsity {s}: {int(tables[1].sum())} of {4 * 3} slabs listed, "
          f"{int((tables[2] == 0).sum())} tap bits off")
    if s == "hand":
        assert tables[1].sum() < 4 * 3


def test_plain_version_honours_the_schedule(rng):
    """Removing one listed nonzero slab from the schedule changes the
    result: the plain version computes what the schedule lists, not the
    dense product."""
    x = torch.from_numpy(rng.randn(2, 5, 5, 8).astype(np.float32))
    w = torch.from_numpy(rng.randn(4, 4, 8, 8).astype(np.float32))
    xp, wp, bp, kw, crop = launch_args(x, w, None, 2, 1, 4, 4, 4, 4, 1,
                                       None)
    ci_idx, valid, tap_mask = make_sparse_plan(w, 2, 1, 4, 4)
    full = deconv2d_sparse_launch(
        xp, wp, bp, *schedule_tensors((ci_idx, valid, tap_mask), "cpu"), **kw)
    dropped = valid.copy()
    dropped[1, 0] = 0
    part = deconv2d_sparse_launch(
        xp, wp, bp, *schedule_tensors((ci_idx, dropped, tap_mask), "cpu"),
        **kw)
    masked = tap_mask.copy()
    masked[0, 1, 5] = 0
    one_tap = deconv2d_sparse_launch(
        xp, wp, bp, *schedule_tensors((ci_idx, valid, masked), "cpu"), **kw)
    for y in (part, one_tap):
        assert float((y - full).abs().max()) > 1e-3
    # channels of the other CO tile do not move
    torch.testing.assert_close(part[..., :4], full[..., :4], rtol=0, atol=0)


def test_schedule_for_other_channel_tiles_is_refused(rng):
    x = torch.zeros((1, 4, 4, 8))
    w = torch.from_numpy(rng.randn(4, 4, 8, 16).astype(np.float32))
    with pytest.raises(ValueError, match="C_out tiles"):
        deconv2d_sparse(x, w, None, 2, 1, t_oh=4, t_ow=4, t_ci=4, t_co=4,
                        t_n=1, schedule=make_sparse_plan(w, 2, 1, 4, 8))
    xp, wp, bp, kw, _ = launch_args(x, w, None, 2, 1, 4, 4, 4, 4, 1, None)
    tabs = schedule_tensors(make_sparse_plan(w, 2, 1, 4, 4), "cpu")
    with pytest.raises(ValueError, match="do not fit"):
        sparse_kernel.deconv2d_sparse_launch_plain(
            xp, wp, bp, tabs.count, tabs.ci,
            torch.cat([tabs.bits, tabs.bits], -1), **kw)


@pytest.mark.parametrize("s", [0.5, 0.9])
def test_generator_on_cuda_sparse_matches_reference(s):
    p, _ = jdcnn.generator_init(jax.random.PRNGKey(2), jdcnn.MNIST_DCNN)
    pp = jsparsity.prune_tree(p, s)
    pn = jax.tree_util.tree_map(np.asarray, pp)
    tp = dcnn.generator_params_from_numpy(pn, dcnn.MNIST_DCNN, "cpu")
    z = np.random.RandomState(4).randn(3, 100).astype(np.float32)
    want = np.asarray(jdcnn.generator_apply(pp, jdcnn.MNIST_DCNN,
                                            jnp.asarray(z),
                                            backend="reverse_loop"))
    got = dcnn.generator_apply(tp, dcnn.MNIST_DCNN, torch.from_numpy(z),
                               backend="cuda_sparse")
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
