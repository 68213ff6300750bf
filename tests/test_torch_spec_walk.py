"""Port parity, SpecEngine continued: the JAX package's remaining spec
tests (tests/test_serving.py:416-510) against the port, with
tests/test_torch_spec.py's models, plain-Engine streams and rule (the
near-tie rule; equal spec_stats and gamma where every stream equals the
JAX engine's): concurrent prefill and ticks, a smaller draft, the
adaptive draft depth and the budget cap. Apart from test_torch_spec.py so
that the two halves of the JAX engine runs share the workers.
"""

import dataclasses

import numpy as np
import pytest
import torch

from petit_kernel_tpu.models import serving as jserving
from petit_kernel_tpu_torch.models import serving as tserving
from test_torch_spec import (_PROMPTS, _against_jax, _quantized, _reqs,
                             _tie_rule, models, plain)  # noqa: F401

# xdist workers share the host's cores: one torch thread each keeps
# the port's CPU ops from oversubscribing them
torch.set_num_threads(1)


def test_spec_concurrent_decode_does_not_corrupt_prefill(models,
                                                         monkeypatch):
    """test_serving.py:416: with 16-token prefill chunks, a 40-token
    prompt admits over three ticks while another slot runs speculative
    ticks, whose verify writes KV at pos .. pos + g in every row with the
    admitting row masked: its stream equals the one it gets alone, and
    the JAX engine's under the tie rule."""
    cfg, (quant, tp), _ = models
    for mod in (tserving, jserving):
        monkeypatch.setattr(mod, "PREFILL_CHUNK", 16)
        monkeypatch.setattr(mod, "PREFILL_BUCKETS", (16,))
    rng = np.random.default_rng(3)
    long_p = rng.integers(0, cfg.vocab_size, size=40).astype(np.int32)
    prompts = [np.array([7, 2], np.int32), long_p]

    def reqs(mod):
        return [mod.Request(uid=0, tokens=prompts[0], max_new_tokens=10),
                mod.Request(uid=1, tokens=long_p, max_new_tokens=4)]

    together = tserving.SpecEngine(tp, cfg, tp, gamma=3, max_batch=2,
                                   draft_fmt="nvfp4").run(reqs(tserving))
    alone = tserving.SpecEngine(tp, cfg, tp, gamma=3, max_batch=2,
                                draft_fmt="nvfp4").run(
        [tserving.Request(uid=1, tokens=long_p, max_new_tokens=4)])
    assert together[1] == alone[1]
    want = jserving.SpecEngine(quant, cfg, quant, gamma=3, max_batch=2,
                               draft_fmt="nvfp4").run(reqs(jserving))
    _tie_rule(together, want, prompts, quant, cfg)


def test_spec_engine_draft_smaller_model(models, plain):
    """test_serving.py:464: a 1-layer draft sharing the vocabulary."""
    cfg, (quant, tp), _ = models
    dcfg = dataclasses.replace(cfg, num_layers=1)
    dquant, dtp = _quantized(dcfg, 3)
    reqs = lambda mod: [mod.Request(uid=0, tokens=_PROMPTS[0],  # noqa: E731
                                    max_new_tokens=6)]
    eng = tserving.SpecEngine(tp, cfg, dtp, dcfg, gamma=3, max_batch=1,
                              draft_fmt="nvfp4")
    got = eng.run(reqs(tserving))
    jeng = jserving.SpecEngine(quant, cfg, dquant, dcfg, gamma=3,
                               max_batch=1, draft_fmt="nvfp4")
    want = jeng.run(reqs(jserving))
    _against_jax(eng, jeng, got, want, _PROMPTS, quant, cfg)
    _tie_rule(got, {0: plain[6][0]}, _PROMPTS, quant, cfg)
    assert len(eng.dcache) == 1


@pytest.mark.parametrize("walk", ["up", "down"])
def test_spec_engine_adaptive_gamma(models, plain, walk):
    """test_serving.py:479: the acceptance-adaptive draft depth walks up
    toward the ceiling (11) for a perfect draft whose history says
    acceptance is high, and down to the smallest bucket (3) for a random
    draft; the streams stay the target's (24 new tokens) and equal the
    JAX engine's, gamma included."""
    cfg, (quant, tp), (dquant, dtp) = models
    if walk == "up":
        dquant, dtp = quant, tp
    prompt = [_PROMPTS[2]]
    eng = tserving.SpecEngine(tp, cfg, dtp, gamma=11, max_batch=1,
                              draft_fmt="nvfp4")
    jeng = jserving.SpecEngine(quant, cfg, dquant, gamma=11, max_batch=1,
                               draft_fmt="nvfp4")
    if walk == "up":
        for e in (eng, jeng):
            e._acc_ema, e.gamma = 0.9, 3
    got = eng.run(_reqs(tserving, 24, prompt))
    want = jeng.run(_reqs(jserving, 24, prompt))
    _against_jax(eng, jeng, got, want, prompt, quant, cfg)
    _tie_rule(got, {0: plain[24][2]}, prompt, quant, cfg)
    assert eng.gamma > 3 if walk == "up" else eng.gamma == 3


def test_spec_engine_budget_cap(models, plain):
    """test_serving.py:503: 2 tokens wanted caps the first tick's draft
    depth at 3 (remaining budget + 1) whatever gamma is; as the JAX
    engine's."""
    cfg, (quant, tp), _ = models
    prompt = [_PROMPTS[2]]
    eng = tserving.SpecEngine(tp, cfg, tp, gamma=11, max_batch=1,
                              gamma_adaptive=False, draft_fmt="nvfp4")
    got = eng.run(_reqs(tserving, 2, prompt))
    assert got[0] == plain[6][2][:2]
    assert eng.spec_stats["proposed"] <= 3
    jeng = jserving.SpecEngine(quant, cfg, quant, gamma=11, max_batch=1,
                               gamma_adaptive=False, draft_fmt="nvfp4")
    want = jeng.run(_reqs(jserving, 2, prompt))
    _against_jax(eng, jeng, got, want, prompt, quant, cfg)