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
    _assert_tie_rule(got, want, _PROMPTS, quant, cfg, max_new)
    assert not eng.active.any() and not eng._pf


def _assert_tie_rule(got, want, prompts, quant, cfg, max_new):
    """The module's rule: equal streams of max_new tokens, or a first
    divergence where the JAX model's top-2 logit gap is below 2^-5 *
    max|logits|."""
    for uid, prompt in enumerate(prompts):
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


# ---------------------------------------------------------------------------
# A forward_fn without kv_window and write_mask (the JAX engine's fallback)
# ---------------------------------------------------------------------------

# prompts that start with token 0 at position 0, as the JAX package's
# cluster tests use: there the JAX fallback's write into a fresh slot
# mid-prefill (token 0's KV at position 0) rewrites what the prompt wrote,
# so its streams are right and parity holds
_ZERO_PROMPTS = [(np.arange(2 + i) % 50).astype(np.int32) for i in range(3)]


def _jax_fallback(cfg):
    return lambda p, t, c, q: jllama.forward(p, t, cfg, c, q,
                                             interpret=True)


def _port_fallback(cfg):
    """A window-less forward_fn: the port's cached attention needs a
    window, so it attends through the whole cache."""
    return lambda p, t, c, q: tllama.forward(p, t, cfg, c, q,
                                             kv_window=cfg.max_seq_len)


@pytest.mark.parametrize("block", [1, 4])
def test_fallback_engine_matches_jax_fallback_engine(models, block):
    """Engine(forward_fn=f), f taking neither kv_window nor write_mask, in
    both packages: 3 requests through max_batch=2 (a slot reused), eager
    and run(decode_block=4). The port's streams meet the module's rule
    against the JAX fallback Engine's and equal the port's own Engine's
    (llama.forward with windows and masks) token for token."""
    cfg, quant, tparams = models
    max_new = 6
    reqs = [(i, p) for i, p in enumerate(_ZERO_PROMPTS)]
    want = jserving.Engine(quant, cfg, max_batch=2,
                           forward_fn=_jax_fallback(cfg)).run(
        [jserving.Request(uid=i, tokens=p, max_new_tokens=max_new)
         for i, p in reqs], decode_block=block)
    eng = tserving.Engine(tparams, cfg, max_batch=2,
                          forward_fn=_port_fallback(cfg))
    assert not eng._admission_batchable()
    got = eng.run([tserving.Request(uid=i, tokens=p, max_new_tokens=max_new)
                   for i, p in reqs], decode_block=block)
    _assert_tie_rule(got, want, _ZERO_PROMPTS, quant, cfg, max_new)
    plain = tserving.Engine(tparams, cfg, max_batch=2).run(
        [tserving.Request(uid=i, tokens=p, max_new_tokens=max_new)
         for i, p in reqs], decode_block=block)
    assert got == plain
    assert not eng.active.any() and not eng._pf


def test_fallback_engine_keeps_the_kv_of_a_prompt_mid_prefill():
    """A reference fault the port does not carry. The JAX engine, with a
    forward_fn that takes no write_mask, advances one prefill chunk of a
    slot and then runs the batched decode step over every row at the
    slot's stale position (0 until its prompt completes), which overwrites
    the KV of the prompt being prefilled. Request 0 decodes while request
    1's 21-token prompt prefills in chunks of 8: the JAX engine gives
    request 1 [476, 476, 476, 353] where greedy_decode of its prompt alone
    gives [405, 267, 287, 260]. The port's engine parks the rows that may
    not write at max_seq_len - 1 and gives greedy_decode's tokens, as an
    engine whose forward_fn takes write_mask does."""
    cfg = jllama.LlamaConfig.tiny()
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                      device="cpu")
    p0 = np.array([7, 9, 11, 13], np.int32)
    p1 = (np.array([5] + list(range(20, 40))) % 50 + 1).astype(np.int32)

    def drive(mod, eng):
        eng.add_request(mod.Request(uid=0, tokens=p0, max_new_tokens=12))
        for _ in range(3):
            eng.step()
        eng.add_request(mod.Request(uid=1, tokens=p1, max_new_tokens=4))
        return eng.run([])

    greedy = np.asarray(jllama.greedy_decode(params, cfg, p1[None], 4,
                                             interpret=True))[0].tolist()
    assert greedy == [405, 267, 287, 260]
    jax_out = drive(jserving, jserving.Engine(
        params, cfg, max_batch=2, prefill_chunk=8,
        forward_fn=_jax_fallback(cfg)))
    assert jax_out[1] == [476, 476, 476, 353]           # the fault
    port = tserving.Engine(tparams, cfg, max_batch=2, prefill_chunk=8,
                           forward_fn=_port_fallback(cfg))
    got = drive(tserving, port)
    want = tllama.greedy_decode(tparams, cfg, torch.from_numpy(p1)[None], 4)
    assert got[1] == want[0].tolist() == greedy
    masked = tserving.Engine(
        tparams, cfg, max_batch=2, prefill_chunk=8,
        forward_fn=lambda p, t, c, q, write_mask=None: tllama.forward(
            p, t, cfg, c, q, kv_window=cfg.max_seq_len,
            write_mask=write_mask))
    assert drive(tserving, masked) == got


@pytest.mark.parametrize("takes", ["neither", "kv_window", "write_mask"])
def test_forward_fn_without_window_or_mask_is_served(models, takes):
    """A forward_fn that takes neither argument, or one of the two, is
    served without the one it lacks: no window (_kv_window None, score
    without one), no batched admission without write_mask; tokens eager
    and in decode blocks of 4, and score_forward's logits, equal the
    port's own Engine's."""
    cfg, _, tparams = models
    S = cfg.max_seq_len

    def neither(p, t, c, q):
        return tllama.forward(p, t, cfg, c, q, kv_window=S)

    def kv_window(p, t, c, q, kv_window=None):
        return tllama.forward(p, t, cfg, c, q, kv_window=kv_window or S)

    def write_mask(p, t, c, q, write_mask=None):
        return tllama.forward(p, t, cfg, c, q, kv_window=S,
                              write_mask=write_mask)

    fn = {"neither": neither, "kv_window": kv_window,
          "write_mask": write_mask}[takes]
    reqs = [(i, p) for i, p in enumerate(_PROMPTS)]
    plain = tserving.Engine(tparams, cfg, max_batch=2)
    for block in (1, 4):
        eng = tserving.Engine(tparams, cfg, max_batch=2, forward_fn=fn)
        assert eng._admission_batchable() == (takes == "write_mask")
        got = eng.run([tserving.Request(uid=i, tokens=p, max_new_tokens=5)
                       for i, p in reqs], decode_block=block)
        want = plain.run([tserving.Request(uid=i, tokens=p,
                                           max_new_tokens=5)
                          for i, p in reqs], decode_block=block)
        plain.reset()
        assert got == want, (takes, block)
    eng.add_request(tserving.Request(uid=9, tokens=_PROMPTS[0],
                                     max_new_tokens=3))
    eng.step()
    assert (eng._kv_window() is None) == (takes != "kv_window")
    toks = np.stack([_PROMPTS[2][:9], _PROMPTS[2][9:]])
    got = eng.score_forward(toks)
    want = plain.score_forward(toks)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
