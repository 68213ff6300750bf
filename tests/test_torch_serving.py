"""Port parity: the serving Engine of petit_kernel_tpu_torch against
petit_kernel_tpu's Engine on the same weights and prompts (tiny config,
CPU, greedy).

The rule: the token streams are equal, except that a stream may diverge
at a step where the JAX model's top-2 logit gap is below the logits
tolerance of test_torch_llama.py (2^-5 * max|logits|); such a near-tie can
flip under the port's other summation order. The test computes that gap at
the first divergence and asserts the rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petit_kernel_tpu.models import llama as jllama
from petit_kernel_tpu.models import serving as jserving
from petit_kernel_tpu_torch.models import convert
from petit_kernel_tpu_torch.models import llama as tllama
from petit_kernel_tpu_torch.models import serving as tserving

# xdist workers share the host's cores: one torch thread each keeps
# the port's CPU ops from oversubscribing them
torch.set_num_threads(1)

_PROMPTS = [
    np.array([5, 9, 42, 7], np.int32),
    np.array([100, 3], np.int32),
    np.array([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18],
             np.int32),
]


@pytest.fixture(scope="module")
def models():
    cfg = jllama.LlamaConfig.tiny()
    quant = jllama.quantize_params(
        jllama.init_params(cfg, jax.random.PRNGKey(1)), "nvfp4")
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, quant),
                                      device="cpu")
    return cfg, quant, tparams


def _requests(mod, max_new):
    return [mod.Request(uid=i, tokens=p, max_new_tokens=max_new)
            for i, p in enumerate(_PROMPTS)]


def test_engine_streams_match_jax_engine(models):
    """3 requests through max_batch=2 (batched admission of the first two,
    then a slot reuse for the third), greedy."""
    cfg, quant, tparams = models
    max_new = 6
    want = jserving.Engine(quant, cfg, max_batch=2).run(
        _requests(jserving, max_new))
    eng = tserving.Engine(tparams, cfg, max_batch=2)
    got = eng.run(_requests(tserving, max_new))
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for uid, prompt in enumerate(_PROMPTS):
        sj, st = want[uid], got[uid]
        assert len(st) == len(sj) == max_new
        diff = [i for i, (a, b) in enumerate(zip(sj, st)) if a != b]
        if not diff:
            continue
        i = diff[0]
        toks = np.concatenate([prompt, np.asarray(sj[:i], np.int32)])
        logits, _ = jllama.forward(quant, jnp.asarray(toks)[None], cfg)
        lg = np.asarray(logits[0, -1], np.float32)
        top2 = np.sort(lg)[-2:]
        gap = float(top2[1] - top2[0])
        bound = 2 ** -5 * float(np.abs(lg).max())
        assert gap < bound, (f"request {uid} diverges at token {i} with a "
                             f"top-2 gap {gap} >= {bound}")
    assert not eng.active.any() and not eng._pf


def test_engine_prefills_long_prompt_in_chunks(models):
    """A prompt longer than the prefill chunk admits over several ticks and
    decodes as if prefilled at once (same tokens as a one-chunk engine)."""
    cfg, _, tparams = models
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, size=40
                                               ).astype(np.int32)
    req = [tserving.Request(uid=0, tokens=prompt, max_new_tokens=4)]
    chunked = tserving.Engine(tparams, cfg, max_batch=1, prefill_chunk=16)
    out = chunked.run(req)[0]
    whole = tserving.Engine(tparams, cfg, max_batch=1).run(
        [tserving.Request(uid=0, tokens=prompt, max_new_tokens=4)])[0]
    assert len(out) == 4
    assert out == whole


def test_last_chunk_never_writes_past_max_seq_len():
    """A last chunk whose bucket would run past max_seq_len is cut to fit.
    (The JAX engine's dynamic_update_slice clamps such a write's start and
    overwrites earlier KV instead.) The first token then equals the
    full-sequence forward's argmax."""
    cfg = tllama.LlamaConfig.tiny(max_seq_len=40)
    params = tllama.quantize_params(
        tllama.init_params(cfg, torch.Generator().manual_seed(3)))
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, size=36
                                               ).astype(np.int32)
    eng = tserving.Engine(params, cfg, max_batch=1, prefill_chunk=32)
    out = eng.run([tserving.Request(uid=0, tokens=prompt,
                                    max_new_tokens=3)])[0]
    logits, _ = tllama.forward(params, torch.from_numpy(prompt)[None], cfg)
    assert out[0] == int(logits[0, -1].argmax())


def test_sample_next_greedy_and_gumbel():
    g = torch.Generator().manual_seed(0)
    logits = torch.tensor([[0.0, 3.0, 1.0], [2.0, 0.0, 1.0]])
    greedy = tserving.sample_next(logits, g, torch.zeros(2))
    assert greedy.tolist() == [1, 0] and greedy.dtype == torch.int32
    hot = torch.full((2,), 100.0)
    draws = torch.stack([tserving.sample_next(logits, g, hot)
                         for _ in range(200)])
    assert len(set(draws[:, 0].tolist())) == 3      # temperature spreads it
    top1 = torch.stack([tserving.sample_next(logits, g, hot, top_k=1)
                        for _ in range(20)])
    assert (top1 == greedy).all()


def test_bucket_len_and_request_limits(models):
    cfg, _, tparams = models
    assert tserving._bucket_len(1) == 16
    assert tserving._bucket_len(17) == 32
    assert tserving._bucket_len(300) == 256
    assert tserving._bucket_len(40, cap=48) == 48
    eng = tserving.Engine(tparams, cfg, max_batch=1)
    with pytest.raises(ValueError):
        eng.add_request(tserving.Request(uid=0, tokens=np.zeros(120,
                                                                np.int32),
                                         max_new_tokens=20))
