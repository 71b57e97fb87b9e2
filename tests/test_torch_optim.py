"""The port's optimizers, schedules and tree helpers against the JAX
package's, on the same numpy params and grads: AdamW (clip on and off,
weight decay, warmup_cosine) and SGD (with and without momentum) over 5
steps, within 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizer as jopt
from repro.optim import schedule as jsched
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import (SGD, AdamState, AdamW, constant, global_norm,
                               warmup_cosine)

TOL = 1e-6
STEPS = 5


def _params(rng):
    return {"l1": {"w": rng.randn(4, 3).astype(np.float32),
                   "b": rng.randn(3).astype(np.float32)},
            "l0": {"w": rng.randn(2, 2, 3, 4).astype(np.float32)}}


def _grads(rng, params):
    # large enough that a clip at 1.0 acts
    return jax.tree_util.tree_map(
        lambda p: (3.0 * rng.randn(*p.shape)).astype(np.float32), params)


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _run_both(jax_opt, port_opt, rng):
    p = _params(rng)
    grads = [_grads(rng, p) for _ in range(STEPS)]
    jp, js = jax.tree_util.tree_map(jnp.asarray, p), None
    js = jax_opt.init(jp)
    tp = _to_torch(p)
    ts = port_opt.init(tp)
    for g in grads:
        jp, js = jax_opt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts = port_opt.update(_to_torch(g), ts, tp)
    return (jp, js), (tp, ts)


def _close(jtree, ttree):
    jl = jax.tree_util.tree_leaves(jtree)
    tl = tree_leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=TOL,
                                   atol=TOL)


ADAMW = {
    "clip": dict(lr=1e-2),
    "no_clip": dict(lr=1e-2, clip_norm=None),
    "weight_decay": dict(lr=1e-2, weight_decay=0.1, b1=0.5, b2=0.9),
}


@pytest.mark.parametrize("case", sorted(ADAMW))
def test_adamw_matches_reference(case, rng):
    kw = ADAMW[case]
    (jp, js), (tp, ts) = _run_both(jopt.AdamW(**kw), AdamW(**kw), rng)
    _close(jp, tp)
    _close(js, ts)          # step, mu, nu in the reference's leaf order
    assert isinstance(ts, AdamState) and ts.step.dtype == torch.int32
    assert int(ts.step) == STEPS


def test_adamw_with_warmup_cosine_matches_reference(rng):
    (jp, js), (tp, ts) = _run_both(
        jopt.AdamW(lr=jsched.warmup_cosine(1e-2, 2, 5)),
        AdamW(lr=warmup_cosine(1e-2, 2, 5)), rng)
    _close(jp, tp)
    _close(js, ts)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_reference(momentum, rng):
    (jp, js), (tp, ts) = _run_both(jopt.SGD(lr=1e-2, momentum=momentum),
                                   SGD(lr=1e-2, momentum=momentum), rng)
    _close(jp, tp)
    _close(js, ts)


def test_update_changes_no_argument(rng):
    """Functional: the old params, grads and state keep their values (a
    tensor held elsewhere, e.g. a serving engine's weight, is not moved)."""
    p = _to_torch(_params(rng))
    g = _to_torch(_grads(rng, _params(rng)))
    before = [t.clone() for t in tree_leaves((p, g))]
    opt = AdamW(lr=1e-2)
    s = opt.init(p)
    new_p, new_s = opt.update(g, s, p)
    for a, b in zip(before, tree_leaves((p, g))):
        assert torch.equal(a, b)
    assert int(s.step) == 0 and int(new_s.step) == 1
    assert not any(torch.equal(a, b) for a, b in
                   zip(tree_leaves(p), tree_leaves(new_p)))


def test_schedules_match_reference():
    steps = np.arange(0, 12, dtype=np.int32)
    want = np.asarray(jax.vmap(jsched.warmup_cosine(3e-3, 3, 10, 0.2))(
        jnp.asarray(steps)))
    fn = warmup_cosine(3e-3, 3, 10, 0.2)
    got = np.array([float(fn(torch.tensor(s))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=TOL, atol=0)
    assert float(constant(0.5)(torch.tensor(7))) == float(
        jsched.constant(0.5)(jnp.asarray(7)))


def test_global_norm_matches_reference(rng):
    g = _grads(rng, _params(rng))
    want = float(jopt.global_norm(jax.tree_util.tree_map(jnp.asarray, g)))
    np.testing.assert_allclose(float(global_norm(_to_torch(g))), want,
                               rtol=TOL)


def test_tree_order_is_the_references(rng):
    """Dict keys sorted, NamedTuple fields in order, None an empty node."""
    p = _params(rng)
    tree = {"ds": jopt.AdamState(np.int32(3), p, p), "a": None, "g": p}
    want = jax.tree_util.tree_leaves(tree)
    ours = {"ds": AdamState(np.int32(3), p, p), "a": None, "g": p}
    got = tree_leaves(ours)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    back = tree_unflatten(ours, [np.asarray(l) * 2 for l in got])
    assert isinstance(back["ds"], AdamState) and back["a"] is None
    np.testing.assert_array_equal(back["g"]["l0"]["w"], 2 * p["l0"]["w"])
    with pytest.raises(ValueError, match="leaves"):
        tree_unflatten(ours, got[:-1])
