"""The port's LM `ServeEngine` against the JAX package's, on the CPU, with
the same params (the reference's, loaded through `lm_params_from_numpy`)
and the same requests: greedy `generate`, and `serve`'s continuous
batching in the four scenarios of the reference's own serve tests
(outputs request by request and the step counters equal), plus sampling;
then `generate` and `serve` per reduced config, the dense family, the MoE
and the hybrid Griffin family.

Greedy tokens are compared for equality: the logits agree to ~1e-6 of
their largest magnitude (tests/test_torch_lm.py), far inside the gaps
between these configs' top logits.  Sampled tokens are not compared with
the reference's: the port draws from a ``torch.Generator``, not
``jax.random``.
"""
import functools

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import transformer as jtr
from repro.serve import engine as jengine
from repro_torch import configs
from repro_torch.models import transformer
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.sampling import sample


@functools.lru_cache(maxsize=None)
def model(arch, seed):
    """(reference cfg and params, port cfg and params) of a reduced
    config, the params drawn by the reference from ``PRNGKey(seed)``."""
    jcfg = jconfigs.reduced_config(arch)
    jp, _ = jtr.init_lm(jax.random.PRNGKey(seed), jcfg)
    cfg = configs.reduced_config(arch)
    pn = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, jp, cfg, transformer.lm_params_from_numpy(pn, cfg, "cpu")


def engines(arch, seed, batch, max_len, **kw):
    jcfg, jp, cfg, p = model(arch, seed)
    return (jengine.ServeEngine(jcfg, jp, batch_size=batch, max_len=max_len),
            ServeEngine(cfg, p, batch_size=batch, max_len=max_len,
                        device="cpu", **kw))


def serve_both(jeng, eng, specs):
    """Serve ``[(prompt, budget), ...]`` on both engines; returns the two
    request lists (in submission order) after checking that both engines
    completed them in the same order, with equal outputs and counters."""
    jreqs = [jengine.Request(prompt=p, max_new_tokens=m) for p, m in specs]
    reqs = [Request(prompt=p, max_new_tokens=m) for p, m in specs]
    jdone, done = jeng.serve(jreqs), eng.serve(reqs)
    jpos = {id(r): i for i, r in enumerate(jreqs)}
    pos = {id(r): i for i, r in enumerate(reqs)}
    assert [jpos[id(r)] for r in jdone] == [pos[id(r)] for r in done]
    for jr, r in zip(jreqs, reqs):
        assert r.out.dtype == np.int32
        np.testing.assert_array_equal(r.out, jr.out)
    assert (eng.prefill_steps, eng.decode_steps, eng.sample_steps) == \
        (jeng.prefill_steps, jeng.decode_steps, jeng.sample_steps)
    return jreqs, reqs


def greedy_oracle(cfg, p, seq, n_new):
    """Token-by-token argmax with a full recompute each step (the port's
    ``apply_lm`` in "train" mode)."""
    seq = torch.as_tensor(np.asarray(seq, np.int32))[None]
    out = []
    for _ in range(n_new):
        logits, _, _ = transformer.apply_lm(p, cfg, seq, mode="train")
        nxt = torch.argmax(logits[:, -1], -1)
        out.append(int(nxt[0]))
        seq = torch.cat([seq, nxt[:, None].to(seq.dtype)], 1)
    return np.asarray(out, np.int32)


def test_greedy_generate_matches_reference_and_full_recompute(rng):
    jeng, eng = engines("deepseek-7b", 0, 2, 12)
    cfg, p = model("deepseek-7b", 0)[2:]
    prompts = rng.randint(1, cfg.vocab_size, (2, 8)).astype(np.int32)
    out = eng.generate(prompts, max_new_tokens=4)
    assert out.shape == (2, 4) and out.dtype == np.int32
    np.testing.assert_array_equal(out, jeng.generate(prompts, 4))
    for i in range(2):
        np.testing.assert_array_equal(out[i],
                                      greedy_oracle(cfg, p, prompts[i], 4))


def test_continuous_batching_slots_matches_reference(rng):
    jeng, eng = engines("chatglm3-6b", 1, 2, 32)
    lengths = np.random.RandomState(1).randint(3, 7, 5)
    specs = [(rng.randint(1, 512, (n,)).astype(np.int32), 3)
             for n in lengths]
    _, reqs = serve_both(jeng, eng, specs)
    assert all(r.out.shape == (3,) for r in reqs)


def test_continuous_batching_midflight_admission_matches_reference(rng):
    jeng, eng = engines("chatglm3-6b", 1, 2, 32)
    cfg, p = model("chatglm3-6b", 1)[2:]
    prompts = [rng.randint(1, cfg.vocab_size, (4,)).astype(np.int32)
               for _ in range(3)]
    _, reqs = serve_both(jeng, eng, list(zip(prompts, (1, 5, 3))))
    assert eng.sample_steps == 5 and eng.prefill_steps == 2
    np.testing.assert_array_equal(reqs[0].out,
                                  greedy_oracle(cfg, p, prompts[0], 1))
    np.testing.assert_array_equal(reqs[1].out,
                                  greedy_oracle(cfg, p, prompts[1], 5))
    # admitted beside a history of 5: its 1-token-left-padded history
    np.testing.assert_array_equal(
        reqs[2].out, greedy_oracle(cfg, p, [0] + list(prompts[2]), 3))


def test_continuous_batching_heterogeneous_budgets_matches_reference(rng):
    jeng, eng = engines("chatglm3-6b", 2, 3, 48)
    budgets = [2, 7, 1, 4, 3, 1, 5]
    specs = [(rng.randint(1, 512, (5,)).astype(np.int32), m)
             for m in budgets]
    _, reqs = serve_both(jeng, eng, specs)
    assert [r.out.shape for r in reqs] == [(m,) for m in budgets]
    assert eng.sample_steps < 7 + 3 + 5   # the chunked schedule's sum


def test_continuous_batching_zero_budget_and_overflow_match_reference(rng):
    jeng, eng = engines("chatglm3-6b", 1, 2, 32)
    prompt = rng.randint(1, 512, (4,)).astype(np.int32)
    _, reqs = serve_both(jeng, eng, [(prompt, 0), (prompt, 2), (prompt, 0)])
    assert [r.out.shape for r in reqs] == [(0,), (2,), (0,)]
    serve_both(jeng, eng, [(prompt, 0)])
    assert eng.sample_steps == 0
    with pytest.raises(AssertionError, match="max_len"):
        eng.serve([Request(prompt=prompt, max_new_tokens=40)])


def test_sampling_is_deterministic_per_seed_and_obeys_top_k(rng):
    logits = torch.as_tensor(rng.randn(256, 50).astype(np.float32))
    np.testing.assert_array_equal(sample(logits).numpy(),
                                  np.argmax(logits.numpy(), -1))

    def draw(seed, **kw):
        return sample(logits, torch.Generator().manual_seed(seed),
                      temperature=1.0, **kw).numpy()

    np.testing.assert_array_equal(draw(7, top_k=5), draw(7, top_k=5))
    assert (draw(7) != draw(8)).any()
    topk = np.argsort(logits.numpy(), -1)[:, -5:]
    got = draw(3, top_k=5)
    assert got.dtype == np.int32
    assert all(got[i] in topk[i] for i in range(len(got)))
    # top_k=1 at any temperature is greedy
    np.testing.assert_array_equal(draw(4, top_k=1), sample(logits).numpy())


def test_sampled_generation_repeats_per_engine_seed(rng):
    cfg, p = model("deepseek-7b", 0)[2:]
    prompts = rng.randint(1, cfg.vocab_size, (2, 6)).astype(np.int32)

    def gen(seed):
        return ServeEngine(cfg, p, 2, 16, temperature=1.0, seed=seed,
                           device="cpu").generate(prompts, 6)

    np.testing.assert_array_equal(gen(3), gen(3))
    assert (gen(3) != gen(4)).any()


DENSE = ("deepseek-7b", "chatglm3-6b", "minitron-4b", "gemma2-27b",
         "qwen2-vl-7b", "musicgen-medium")
# the MoE (capacity drops at decode: 2 slots x top-4 of 8 experts into a
# capacity of 1) and the hybrid Griffin family, whose recurrences run
# through the left pads of every re-prefill
NEW_FAMILIES = ("qwen2-moe-a2.7b", "recurrentgemma-2b")


@pytest.mark.parametrize("arch", DENSE + NEW_FAMILIES)
def test_generate_and_serve_match_reference_per_arch(arch):
    """Every dense-family reduced config, the MoE and the hybrid: greedy
    `generate` and a `serve` with a mid-flight admission, tokens and
    counters equal."""
    rng = np.random.RandomState(11)
    jeng, eng = engines(arch, 0, 2, 24)
    prompts = rng.randint(1, 512, (2, 6)).astype(np.int32)
    np.testing.assert_array_equal(eng.generate(prompts, 3),
                                  jeng.generate(prompts, 3))
    specs = [(rng.randint(1, 512, (n,)).astype(np.int32), m)
             for n, m in ((4, 2), (6, 3), (5, 2))]
    serve_both(jeng, eng, specs)
    assert eng.prefill_steps == 2
