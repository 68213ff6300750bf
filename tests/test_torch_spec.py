"""Port parity: SpecEngine of petit_kernel_tpu_torch against
petit_kernel_tpu's SpecEngine and against the port's plain Engine, on the
same converted weights and prompts (tiny config, nvfp4, CPU, greedy).

The rule, test_torch_serving.py's: two token streams are equal, except
that they may diverge at a step where the JAX target's top-2 logit gap
(its full-sequence forward over the prompt and the tokens before) is
below 2^-5 * max|logits|; such a near-tie can flip under another
summation order. Where a stream equals the JAX engine's, so do
spec_stats and the draft depth the engine ends at.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petit_kernel_tpu.models import llama as jllama
from petit_kernel_tpu.models import serving as jserving
from petit_kernel_tpu_torch.models import convert
from petit_kernel_tpu_torch.models import serving as tserving

# xdist workers share the host's cores: one torch thread each keeps
# the port's CPU ops from oversubscribing them
torch.set_num_threads(1)

_PROMPTS = [
    np.array([5, 9, 42, 7], np.int32),
    np.array([100, 3], np.int32),
    np.array([1, 2, 3, 4, 5, 6], np.int32),
]


def _quantized(cfg, seed):
    """(JAX nvfp4 params, the port's copy on the CPU) from PRNGKey(seed)."""
    quant = jllama.quantize_params(
        jllama.init_params(cfg, jax.random.PRNGKey(seed)), "nvfp4")
    return quant, convert.params_from_jax(jax.tree.map(np.asarray, quant),
                                          device="cpu")


@pytest.fixture(scope="module")
def models():
    cfg = jllama.LlamaConfig.tiny()
    target = _quantized(cfg, 1)
    draft = _quantized(cfg, 99)
    return cfg, target, draft


def _reqs(mod, max_new, prompts=_PROMPTS):
    return [mod.Request(uid=i, tokens=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]


def _tie_rule(got, want, prompts, quant, cfg):
    """Assert the near-tie rule between two {uid: tokens} results; returns
    the uids whose streams are equal."""
    assert sorted(got) == sorted(want)
    same = []
    for uid in sorted(want):
        sj, st = want[uid], got[uid]
        diff = [i for i, (a, b) in enumerate(zip(sj, st)) if a != b]
        if not diff:
            assert len(st) == len(sj), uid
            same.append(uid)
            continue
        i = diff[0]
        toks = np.concatenate([prompts[uid], np.asarray(sj[:i], np.int32)])
        logits, _ = jllama.forward(quant, jnp.asarray(toks)[None], cfg)
        lg = np.asarray(logits[0, -1], np.float32)
        top2 = np.sort(lg)[-2:]
        gap = float(top2[1] - top2[0])
        bound = 2 ** -5 * float(np.abs(lg).max())
        assert gap < bound, (f"request {uid} diverges at token {i} with a "
                             f"top-2 gap {gap} >= {bound}")
    return same


def _against_jax(eng, jeng, got, want, prompts, quant, cfg):
    """The tie rule against the JAX engine's streams; with every stream
    equal, equal spec_stats and gamma too."""
    same = _tie_rule(got, want, prompts, quant, cfg)
    if len(same) == len(want):
        assert eng.spec_stats == jeng.spec_stats
        assert eng.gamma == jeng.gamma
    return same


@pytest.fixture(scope="module")
def plain(models):
    """The port's plain Engine on the target: 6 and 24 new tokens."""
    cfg, (_, tp), _ = models
    return {n: tserving.Engine(tp, cfg, max_batch=2).run(
        _reqs(tserving, n)) for n in (6, 24)}


@pytest.mark.parametrize("which", ["draft=target", "random draft"])
def test_spec_streams_match_jax_and_plain(models, plain, which):
    """test_serving.py:441: the port's SpecEngine (gamma 4, max_batch 2,
    three requests of 6 tokens) against the JAX SpecEngine and against the
    port's plain Engine, for a perfect draft (the target itself: accepted
    tokens > 0) and an unrelated random draft."""
    cfg, (quant, tp), (dquant, dtp) = models
    if which == "draft=target":
        dquant, dtp = quant, tp
    eng = tserving.SpecEngine(tp, cfg, dtp, gamma=4, max_batch=2,
                              draft_fmt="nvfp4")
    got = eng.run(_reqs(tserving, 6))
    jeng = jserving.SpecEngine(quant, cfg, dquant, gamma=4, max_batch=2,
                               draft_fmt="nvfp4")
    want = jeng.run(_reqs(jserving, 6))
    _against_jax(eng, jeng, got, want, _PROMPTS, quant, cfg)
    _tie_rule(got, plain[6], _PROMPTS, quant, cfg)
    if which == "draft=target":
        assert eng.spec_stats["accepted"] > 0
    assert not eng.active.any() and not eng._pf


def test_spec_engine_fp8_cache(models):
    """Both caches headed fp8: the port's SpecEngine against the JAX
    SpecEngine over fp8 caches and against the port's plain fp8 Engine,
    under the tie rule; both caches are headed fp8."""
    cfg, (quant, tp), _ = models
    fp8 = torch.float8_e4m3fn
    eng = tserving.SpecEngine(tp, cfg, tp, gamma=4, max_batch=2,
                              draft_fmt="nvfp4", cache_dtype=fp8)
    assert all(k.dtype == fp8 and k.shape[1] == cfg.num_kv_heads
               for kv in (eng.cache, eng.dcache) for k, _ in kv)
    got = eng.run(_reqs(tserving, 6))
    jeng = jserving.SpecEngine(quant, cfg, quant, gamma=4, max_batch=2,
                               draft_fmt="nvfp4",
                               cache_dtype=jnp.float8_e4m3fn)
    want = jeng.run(_reqs(jserving, 6))
    _against_jax(eng, jeng, got, want, _PROMPTS, quant, cfg)
    single = tserving.Engine(tp, cfg, max_batch=2, cache_dtype=fp8).run(
        _reqs(tserving, 6))
    _tie_rule(got, single, _PROMPTS, quant, cfg)


def _tick_outputs(eng):
    """Wrap eng's tick so that it keeps (g, active mask, output) of every
    tick."""
    eng._ticks = tserving._SpecTicks(eng)
    seen, inner = [], eng._ticks.run

    def run(g, window):
        out = inner(g, window)
        seen.append((g, eng.active.copy(), out))
        return out

    eng._ticks.run = run
    return seen


def test_force_accept_one_accepts_the_cap(models):
    """force_accept = 1.0: every tick accepts g - 1 drafts in every active
    slot, whatever the draft (a random one), and spec_stats count them."""
    cfg, (_, tp), (_, dtp) = models
    eng = tserving.SpecEngine(tp, cfg, dtp, gamma=5, max_batch=2,
                              draft_fmt="nvfp4", gamma_adaptive=False)
    eng.force_accept = 1.0
    seen = _tick_outputs(eng)
    out = eng.run(_reqs(tserving, 12))
    assert all(len(v) == 12 for v in out.values())
    assert seen
    acc = 0
    for g, active, o in seen:
        assert (o[active, g + 1] == g - 1).all(), (g, o[:, g + 1])
        acc += (g - 1) * int(active.sum())
    assert eng.spec_stats["accepted"] == acc


def test_run_decode_block_equals_decode_block_1(models):
    """run(decode_block=8) (the burst admission, then ticks: step_block is
    step()) gives decode_block=1's streams; no decode block is made."""
    cfg, (quant, tp), (_, dtp) = models

    def make():
        return tserving.SpecEngine(tp, cfg, dtp, gamma=4, max_batch=2,
                                   draft_fmt="nvfp4")

    eng = make()
    blocked = eng.run(_reqs(tserving, 8), decode_block=8)
    assert eng._blocks is None
    _tie_rule(blocked, make().run(_reqs(tserving, 8)), _PROMPTS, quant, cfg)


def test_spec_engine_is_greedy_only(models):
    cfg, (_, tp), _ = models
    eng = tserving.SpecEngine(tp, cfg, tp, gamma=3, max_batch=1,
                              draft_fmt="nvfp4")
    eng.add_request(tserving.Request(uid=0, tokens=_PROMPTS[0],
                                     max_new_tokens=4, temperature=0.7))
    with pytest.raises(ValueError, match="greedy"):
        eng.run([])


def test_spec_engine_checks_its_draft(models):
    """A draft of another vocabulary or a shorter max_seq_len raises
    ValueError (the JAX engine asserts)."""
    cfg, (_, tp), _ = models
    for bad in (dict(vocab_size=256), dict(max_seq_len=64)):
        dcfg = dataclasses.replace(cfg, **bad)
        with pytest.raises(ValueError):
            tserving.SpecEngine(tp, cfg, tp, dcfg, max_batch=1)


def test_admission_batchable_gate(models):
    """Engine and PagedEngine admit same-key prompts in one batched
    forward; SpecEngine, which routes each chunk through its draft cache
    too, admits them one by one and fills both caches' rows; so does any
    subclass that re-routes _prefill_chunk."""
    cfg, (_, tp), _ = models

    class Rerouted(tserving.Engine):
        def _prefill_chunk(self, slot, toks, pos, kv_window):
            return super()._prefill_chunk(slot, toks, pos, kv_window)

    engines = {
        "Engine": tserving.Engine(tp, cfg, max_batch=2),
        "PagedEngine": tserving.PagedEngine(tp, cfg, max_batch=2,
                                            page_size=16),
        "SpecEngine": tserving.SpecEngine(tp, cfg, tp, max_batch=2,
                                          draft_fmt="nvfp4"),
        "rerouted": Rerouted(tp, cfg, max_batch=2)}
    want = {"Engine": True, "PagedEngine": True, "SpecEngine": False,
            "rerouted": False}
    for name, eng in engines.items():
        assert eng._admission_batchable() is want[name], name
        batched = []
        inner = eng._run_batched_admission

        def counted(*a, inner=inner, batched=batched):
            batched.append(1)
            return inner(*a)

        eng._run_batched_admission = counted
        for r in _reqs(tserving, 4)[:2]:
            eng.add_request(r)
        eng._advance_prefill()
        assert len(batched) == int(want[name]), name
        assert len(eng._pf) == (0 if want[name] else 1), name
    spec = engines["SpecEngine"]
    spec._advance_prefill()
    assert spec.active.all()
    for kv in (spec.cache, spec.dcache):
        for slot in range(2):
            n = len(_PROMPTS[slot])
            assert kv[0][0][slot, :n].float().abs().sum() > 0, slot


def test_pick_gamma_and_window_match_jax(models):
    """_pick_gamma over a table of states (adaptive or fixed, gamma, the
    acceptance EMA, the remaining budgets) and _next_pow2_128 equal the JAX
    engine's."""
    cfg, (quant, tp), _ = models
    for adaptive in (True, False):
        for gamma in (2, 3, 4, 7, 11, 13):
            for ema in (0.1, 0.5, 0.8):
                for remaining in ((1,), (2, 9), (30, 4)):
                    picks = []
                    for mod, p in ((tserving, tp), (jserving, quant)):
                        eng = mod.SpecEngine(p, cfg, p, gamma=gamma,
                                             gamma_adaptive=adaptive,
                                             max_batch=2)
                        eng._acc_ema = ema
                        for slot, r in enumerate(remaining):
                            eng.slot_req[slot] = mod.Request(
                                uid=slot, tokens=_PROMPTS[0],
                                max_new_tokens=r + 1)
                            eng.generated[slot] = [0]
                            eng.active[slot] = True
                        picks.append((eng._pick_gamma(), eng.gamma))
                    assert picks[0] == picks[1], (adaptive, gamma, ema,
                                                  remaining)
    for n in (1, 128, 129, 300, 1025, 5000):
        assert tserving._next_pow2_128(n) == jserving._next_pow2_128(n)


def test_reset_keeps_both_caches(models):
    """reset() keeps the storage of both caches and the tick buffers, and
    puts the draft depth, the acceptance EMA and spec_stats back: a second
    run on the same engine gives the first run's streams and stats."""
    cfg, (_, tp), _ = models
    eng = tserving.SpecEngine(tp, cfg, tp, gamma=11, max_batch=2,
                              draft_fmt="nvfp4")
    first = eng.run(_reqs(tserving, 10))
    stats, ptrs = dict(eng.spec_stats), [
        t.data_ptr() for kv in eng.cache + eng.dcache for t in kv]
    ticks = eng._ticks
    eng.reset()
    assert eng.spec_stats == {"proposed": 0, "accepted": 0, "ticks": 0}
    assert eng.gamma == 11 and eng._acc_ema == 0.5
    assert eng.run(_reqs(tserving, 10)) == first
    assert eng.spec_stats == stats and eng._ticks is ticks
    assert ptrs == [t.data_ptr() for kv in eng.cache + eng.dcache
                    for t in kv]
