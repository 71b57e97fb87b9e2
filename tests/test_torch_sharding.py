"""The port's sharding rules (``repro_torch.dist.sharding``,
``repro_torch.launch.steps``' policy defaults, the models' logical specs)
against the JAX package's, with no process group: every rule function
reads only ``mesh.shape``, so a stand-in with a ``shape`` dict serves as
the mesh for both packages, at the shapes of the four meshes the
reference plans for (``(2, 2)``, ``(4, 2)``, ``(16, 16)`` and the
multi-pod ``(2, 16, 16)``).  The results must be equal, not close.
"""
import dataclasses

import jax
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import repro.configs as jconfigs
from repro.configs import shapes as jshapes
from repro.dist import sharding as jsh
from repro.launch import steps as jsteps
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.core.tree import tree_leaves
from repro_torch.dist import sharding as sh
from repro_torch.launch import steps
from repro_torch.models import transformer

NAMES = tuple(sorted(configs.LM_CONFIGS))
MESHES = {"2x2": {"data": 2, "model": 2}, "4x2": {"data": 4, "model": 2},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


@dataclasses.dataclass(frozen=True)
class StandIn:
    """A mesh as the rule functions see it: the axis extents, in order."""
    dims: tuple

    @property
    def shape(self):
        return dict(self.dims)

    @property
    def axis_names(self):
        return tuple(a for a, _ in self.dims)


def mesh(name):
    return StandIn(tuple(MESHES[name].items()))


def jspec_leaves(specs):
    return jax.tree_util.tree_leaves(specs,
                                     is_leaf=lambda s: isinstance(s, tuple))


@pytest.fixture(scope="module")
def ref_specs():
    """Per config, reduced and full: the reference's (leaf shapes, leaf
    specs) from ``abstract_params`` (``jax.eval_shape``, no allocation)."""
    out = {}
    for name in NAMES:
        for full in (False, True):
            cfg = (jconfigs.get_config(name) if full
                   else jconfigs.reduced_config(name))
            shp, spec = jsteps.abstract_params(cfg)
            out[name, full] = ([tuple(s.shape)
                                for s in jax.tree_util.tree_leaves(shp)],
                               jspec_leaves(spec))
    return out


def port_cfg(name, full):
    return configs.get_config(name) if full else configs.reduced_config(name)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("policy", ["tp", "fsdp_tp"])
def test_make_rules(policy, multi_pod):
    assert sh.make_rules(policy, multi_pod) == jsh.make_rules(policy,
                                                              multi_pod)


def test_make_rules_refuses_an_unknown_policy():
    with pytest.raises(ValueError, match="unknown sharding policy"):
        sh.make_rules("dp")


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("name", NAMES)
def test_param_spec_trees_equal_the_reference(ref_specs, name, full):
    cfg = port_cfg(name, full)
    shapes_tree, specs = steps.abstract_params(cfg)
    want_shapes, want_specs = ref_specs[name, full]
    assert sh._spec_leaves(specs) == want_specs
    assert [tuple(t.shape) for t in tree_leaves(shapes_tree)] == want_shapes
    assert all(t.device.type == "meta" for t in tree_leaves(shapes_tree))
    assert sh._spec_leaves(transformer.lm_specs(cfg)) == want_specs


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_spec_to_pspec_on_every_leaf(ref_specs, name, mesh_name):
    """Both policies, every leaf of the reduced and the full tree."""
    m = mesh(mesh_name)
    multi = "pod" in m.shape
    for full in (False, True):
        shp, specs = ref_specs[name, full]
        port_shapes, port_specs = steps.abstract_params(port_cfg(name, full))
        for policy in ("tp", "fsdp_tp"):
            rules = sh.make_rules(policy, multi)
            jrules = jsh.make_rules(policy, multi)
            want = [tuple(jsh.spec_to_pspec(jrules, s, mesh=m, shape=t))
                    for s, t in zip(specs, shp)]
            got = sh.leaf_pspecs(m, rules, port_shapes, port_specs)
            assert [tuple(g) for g in got] == want
            # and each maps to one placement per mesh dim
            for ps in got:
                pl = sh.placements(m, ps)
                assert len(pl) == len(m.axis_names)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_spec_to_pspec_degradations(mesh_name):
    m = mesh(mesh_name)
    rules = sh.make_rules("fsdp_tp", "pod" in m.shape)
    jrules = jsh.make_rules("fsdp_tp", "pod" in m.shape)
    cases = [(("batch", None, "vocab"), (64, 3, 32000)),
             (("batch", None, "vocab"), (3, 3, 7)),         # nothing divides
             (("heads", "heads"), (64, 64)),                 # axis used twice
             (("mlp", "embed"), (256, 4096)),
             (("layers", "embed", "mlp"), (4, 64, 64)),       # never sharded
             (("rnn", None), (64, 64)),                      # no rule
             (("moe_group", "experts", None, None), (32, 16, 4, 8)),
             ((), ())]
    for spec, shape in cases:
        want = tuple(jsh.spec_to_pspec(jrules, spec, mesh=m, shape=shape))
        assert tuple(sh.spec_to_pspec(rules, spec, mesh=m,
                                      shape=shape)) == want
        assert tuple(sh.spec_to_pspec(rules, spec)) == tuple(
            jsh.spec_to_pspec(jrules, spec))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_pspec_and_data_axis_size(mesh_name):
    m = mesh(mesh_name)
    for policy in ("tp", "fsdp_tp"):
        rules = sh.make_rules(policy, "pod" in m.shape)
        jrules = jsh.make_rules(policy, "pod" in m.shape)
        assert sh.data_axis_size(m, rules) == jsh.data_axis_size(m, jrules)
        for b in (1, 2, 3, 4, 32, 64, 128):
            for ndim in (1, 2, 4):
                assert tuple(sh.batch_pspec(m, rules, b, ndim)) == tuple(
                    jsh.batch_pspec(m, jrules, b, ndim))
    assert sh.data_axis_size(None, {}) == 1
    assert sh.data_axis_size(m, {}) == 1


@pytest.mark.parametrize("name", NAMES)
def test_cache_specs_and_their_pspecs(name):
    for kv_quant in (False, True):
        cfg = dataclasses.replace(configs.reduced_config(name),
                                  kv_quant=kv_quant)
        jcfg = dataclasses.replace(jconfigs.reduced_config(name),
                                   kv_quant=kv_quant)
        got, want = sh.cache_specs(cfg), jsh.cache_specs(jcfg)
        assert sh._spec_leaves(got) == jspec_leaves(want)
        cache = transformer.init_cache(cfg, 4, 32, device="meta")
        assert len(tree_leaves(cache)) == len(sh._spec_leaves(got))
        m = mesh("2x2")
        rules = sh.make_rules("tp")
        pl = sh.leaf_pspecs(m, rules, cache, got)
        jshapes_ = [tuple(t.shape) for t in tree_leaves(cache)]
        assert [tuple(p) for p in pl] == [
            tuple(jsh.spec_to_pspec(jsh.make_rules("tp"), s, mesh=m,
                                    shape=t))
            for s, t in zip(jspec_leaves(want), jshapes_)]


@pytest.mark.parametrize("name", NAMES)
def test_default_policy_on_the_full_configs(name):
    assert steps.default_policy(configs.get_config(name)) == \
        jsteps.default_policy(jconfigs.get_config(name))


@pytest.mark.parametrize("suite", sorted(shapes.SHAPES))
def test_default_grad_accum(suite):
    for name in NAMES:
        for mesh_name in MESHES:
            m = mesh(mesh_name)
            assert steps.default_grad_accum(
                configs.get_config(name), shapes.SHAPES[suite], m) == \
                jsteps.default_grad_accum(jconfigs.get_config(name),
                                          jshapes.SHAPES[suite], m)


def test_placements_by_hand():
    m = mesh("2x16x16")
    assert sh.placements(m, sh.P()) == (Replicate(),) * 3
    assert sh.placements(m, sh.P(("pod", "data"), None)) == (
        Shard(0), Shard(0), Replicate())
    assert sh.placements(m, sh.P(None, "model", "data")) == (
        Replicate(), Shard(2), Shard(1))
    assert sh.placements(mesh("2x2"), ("data", None, "model")) == (
        Shard(0), Shard(2))
    with pytest.raises(ValueError, match="used twice"):
        sh.placements(m, sh.P("model", "model"))
    assert sh.P("data", None) == ("data", None)
    assert tuple(jax.sharding.PartitionSpec("data", None)) == sh.P("data",
                                                                   None)


def test_tree_shardings_and_replicated_specs():
    m = mesh("2x2")
    rules = sh.make_rules("fsdp_tp")
    tree = {"a": torch.empty(4, 6, device="meta"),
            "b": {"c": torch.empty(3, device="meta")}}
    specs = {"a": ("embed", "mlp"), "b": {"c": ("vocab",)}}
    got = sh.tree_shardings(m, rules, tree, specs)
    assert got == {"a": (Shard(0), Shard(1)), "b": {"c": (Replicate(),) * 2}}
    rep = sh.replicated_specs(tree)
    assert rep == {"a": (None, None), "b": {"c": (None,)}}
    assert sh.tree_shardings(m, rules, tree, rep) == {
        "a": (Replicate(),) * 2, "b": {"c": (Replicate(),) * 2}}
    with pytest.raises(ValueError, match="leaves"):
        sh.tree_shardings(m, rules, tree, {"a": (None, None)})


def test_opt_batch_and_cache_shardings():
    cfg = configs.reduced_config("deepseek-7b")
    m = mesh("2x2")
    rules = sh.make_rules("tp")
    p_shapes, specs = steps.abstract_params(cfg)
    o = steps.opt_state_shapes(p_shapes)
    assert o.step.dtype == torch.int32 and all(
        t.dtype == torch.float32 for t in tree_leaves(o.mu))
    osh = steps.opt_shardings(m, rules, p_shapes, specs)
    assert osh.step == (Replicate(), Replicate())
    assert osh.mu == osh.nu == sh.tree_shardings(m, rules, p_shapes, specs)
    ins = shapes.input_specs(cfg, shapes.SHAPES["decode_32k"])
    bsh = steps.batch_shardings(m, rules, ins)
    assert bsh == {"tokens": (Shard(0), Replicate())}
    csh = steps.cache_shardings(m, rules, cfg, ins["cache"])
    assert tree_leaves(csh["units"]["b0"]["k"]) == [Shard(1), Shard(3)]
