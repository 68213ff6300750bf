"""Port parity: petit_kernel_tpu_torch's eval harness (models/eval.py) and
the engines' score_forward against petit_kernel_tpu's, on the CPU (the
tiny Llama, dense bf16 and nvfp4, and the tiny Mixtral, quantized by the
JAX package and converted bit for bit).

Mirrors tests/test_eval.py. Tolerances: full-sequence logits within
2^-5 * max|logits|, as tests/test_torch_llama.py; a summed log-likelihood
within 2e-3 relative plus 2e-2 per scored token (the JAX package's own
bucketing jitter is 2e-2 on a few tokens; each token's log-prob moves by
at most twice its logits' error). Picks and accuracies are compared only
where every question's top-2 JAX log-likelihood gap is above that
tolerance, which each test asserts first: a different pick is then a
fault, not a near-tie.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petit_kernel_tpu.models import eval as jev
from petit_kernel_tpu.models import llama as jllama
from petit_kernel_tpu.models import serving as jserving
from petit_kernel_tpu_torch.models import convert
from petit_kernel_tpu_torch.models import eval as tev
from petit_kernel_tpu_torch.models import llama as tllama
from petit_kernel_tpu_torch.models import moe as tmoe
from petit_kernel_tpu_torch.models import serving as tserving

# xdist workers share the host's cores: one torch thread each keeps
# the port's CPU ops from oversubscribing them
torch.set_num_threads(1)

FP8 = torch.float8_e4m3fn
_PAIRS = [([5, 9, 42], [7, 11]), ([1, 2], [3]), ([100], [3, 4, 5, 6]),
          (list(range(40)), [7, 11, 13])]


@pytest.fixture(scope="module")
def models():
    """{fmt: (JAX params, port params)} for "bf16" (dense) and "nvfp4"."""
    cfg = jllama.LlamaConfig.tiny()
    dense = jllama.init_params(cfg, jax.random.PRNGKey(0))
    quant = jllama.quantize_params(dense, "nvfp4")
    out = {fmt: (p, convert.params_from_jax(jax.tree.map(np.asarray, p),
                                            device="cpu"))
           for fmt, p in (("bf16", dense), ("nvfp4", quant))}
    return cfg, tllama.LlamaConfig.tiny(), out


def _ll_close(got, want, pairs):
    n = np.asarray([len(c) for _, c in pairs], np.float64)
    err = np.abs(np.asarray(got) - np.asarray(want))
    bound = 2e-3 * np.abs(want) + 2e-2 * n
    assert (err <= bound).all(), (err, bound)


def _assert_no_near_tie(lls_by_question):
    """Every question's top-2 log-likelihood gap above the tolerance of its
    choices' scores."""
    for lls, conts in lls_by_question:
        order = np.argsort(lls)
        a, b = order[-1], order[-2]
        tol = (2e-3 * (abs(lls[a]) + abs(lls[b]))
               + 2e-2 * (len(conts[a]) + len(conts[b])))
        assert lls[a] - lls[b] > tol, (lls, tol)


def _questions(seed, cfg, n_q, n_choices=4):
    """Seeded questions whose choices have 1 to n_choices tokens, each
    length once: a random model gives every token a log-prob near
    -log(vocab), so choices of one length would tie."""
    rng = np.random.default_rng(seed)
    return [{"context": [int(t) for t in rng.integers(0, cfg.vocab_size, 5)],
             "choices": [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
                         for n in rng.permutation(n_choices) + 1],
             "answer": 0} for _ in range(n_q)]


def _jax_lls(jp, cfg, questions, fmt):
    return [(jev.loglikelihood(jp, cfg, [(q["context"], c)
                                         for c in q["choices"]],
                               fmt=fmt, interpret=True), q["choices"])
            for q in questions]


@pytest.mark.parametrize("fmt", ["bf16", "nvfp4"])
def test_loglikelihood_matches_jax(models, fmt):
    """tests/test_eval.py's manual check, across the packages: the port's
    loglikelihood of 4 pairs (one of 40 context tokens) against the JAX
    package's on the same weights, and against the port's own forward
    summed by hand."""
    cfg, tcfg, m = models
    jp, tp = m[fmt]
    got = tev.loglikelihood(tp, tcfg, _PAIRS, fmt=fmt)
    assert got.dtype == np.float64 and got.shape == (len(_PAIRS),)
    _ll_close(got, jev.loglikelihood(jp, cfg, _PAIRS, fmt=fmt,
                                     interpret=True), _PAIRS)
    for (ctx, cont), g in zip(_PAIRS, got):
        ids = torch.tensor([list(ctx) + list(cont)])
        logits, _ = tllama.forward(tp, ids[:, :-1], tcfg, fmt=fmt)
        logp = torch.log_softmax(logits.float(), -1)[0]
        want = sum(float(logp[t - 1, ids[0, t]])
                   for t in range(len(ctx), ids.shape[1]))
        np.testing.assert_allclose(g, want, rtol=2e-3, atol=2e-2)


@pytest.mark.parametrize("fmt", ["bf16", "nvfp4"])
def test_loglikelihood_bucketing_invariant(models, fmt):
    """A short row padded beside a long one scores as the same row alone
    (the JAX package's tolerance), and as the JAX package scores it."""
    cfg, tcfg, m = models
    jp, tp = m[fmt]
    short, long_ = ([5, 9], [42]), (list(range(40)), [7, 11, 13])
    alone = tev.loglikelihood(tp, tcfg, [short], fmt=fmt, batch=1)
    mixed = tev.loglikelihood(tp, tcfg, [long_, short, short], fmt=fmt,
                              batch=2)
    np.testing.assert_allclose(mixed[1:], [alone[0]] * 2, rtol=2e-3,
                               atol=2e-2)
    _ll_close(alone, jev.loglikelihood(jp, cfg, [short], fmt=fmt, batch=1,
                                       interpret=True), [short])


def test_multiple_choice_matches_jax(models):
    """score_multiple_choice over 4 seeded questions (bf16): the picks are
    the JAX package's and those of the port's own loglikelihood; with the
    picks as answers the accuracy is 1."""
    cfg, tcfg, m = models
    jp, tp = m["bf16"]
    qs = _questions(0, cfg, 4)
    jlls = _jax_lls(jp, cfg, qs, "bf16")
    _assert_no_near_tie(jlls)
    for q, (lls, _) in zip(qs, jlls):
        q["answer"] = int(np.argmax(lls))
    acc, picks = tev.score_multiple_choice(tp, tcfg, qs)
    assert acc == 1.0 and picks == [q["answer"] for q in qs]
    assert (acc, picks) == jev.score_multiple_choice(jp, cfg, qs,
                                                     interpret=True)
    for q, p in zip(qs, picks):
        lls = tev.loglikelihood(tp, tcfg, [(q["context"], c)
                                           for c in q["choices"]])
        assert int(np.argmax(lls)) == p


@pytest.mark.parametrize("fmt", ["bf16", "nvfp4"])
def test_perplexity_matches_jax(models, fmt):
    cfg, tcfg, m = models
    jp, tp = m[fmt]
    ids = [5, 9, 42, 7, 11, 13, 2, 3]
    got = tev.perplexity(tp, tcfg, ids, fmt=fmt)
    want = jev.perplexity(jp, cfg, ids, fmt=fmt, interpret=True)
    assert np.isfinite(got) and isinstance(got, float)
    # exp of a mean log-prob within 2e-2: a relative 2e-2
    np.testing.assert_allclose(got, want, rtol=2e-2)


def test_format_mmlu_matches_jax():
    """The same prompt text and choice texts as the JAX package's, and the
    protocol of tests/test_eval.py."""
    args = ("What is 2+2?", ["3", "4", "5", "22"])
    kw = dict(subject="abstract_algebra",
              few_shot=[("What is 1+1?", ["1", "2", "0", "11"], 1)])
    ctx, conts = tev.format_mmlu(*args, **kw)
    assert (ctx, conts) == jev.format_mmlu(*args, **kw)
    assert ctx.startswith("The following are multiple choice questions")
    assert "abstract algebra" in ctx and "Answer: B\n" in ctx
    assert ctx.endswith("Answer:") and "D. 22" in ctx
    assert conts == [" A", " B", " C", " D"]
    assert tev.MMLU_PREAMBLE == jev.MMLU_PREAMBLE


def test_mmlu_questions_tokenize_and_score(models):
    """A character-level encode: mmlu_questions gives the JAX package's
    questions, the boundary assert fires for an encode that merges across
    it, and scoring them (nvfp4) picks as the JAX package does."""
    cfg, tcfg, m = models
    jp, tp = m["nvfp4"]

    def encode(s):
        return [ord(c) % cfg.vocab_size for c in s]

    rows = [("What is 2+2?", ["3", "4", "5", "22"], 1),
            ("Pick A.", ["yes", "no"], 0)]
    qs = tev.mmlu_questions(rows, encode, subject="tests")
    assert qs == jev.mmlu_questions(rows, encode, subject="tests")
    assert [q["answer"] for q in qs] == [1, 0]
    assert all(len(c) == 2 for c in qs[0]["choices"])      # " A": 2 chars

    def merging(s):            # folds ":" and the space after it into one
        return encode(s.replace(": ", "#"))

    with pytest.raises(AssertionError, match="boundary"):
        tev.mmlu_questions(rows[:1], merging)
    _assert_no_near_tie(_jax_lls(jp, cfg, qs, "nvfp4"))
    got = tev.score_multiple_choice(tp, tcfg, qs, fmt="nvfp4")
    assert got == jev.score_multiple_choice(jp, cfg, qs, fmt="nvfp4",
                                            interpret=True)


def test_fp4_accuracy_delta_matches_jax(models):
    """fp4_accuracy_delta on 3 seeded questions: the port quantizes the
    dense weights itself (llama.quantize_params) and reports the JAX
    package's accuracies and delta."""
    cfg, tcfg, m = models
    (jd, td), (jq, _) = m["bf16"], m["nvfp4"]
    qs = _questions(1, cfg, 3)
    _assert_no_near_tie(_jax_lls(jd, cfg, qs, "bf16"))
    _assert_no_near_tie(_jax_lls(jq, cfg, qs, "nvfp4"))
    got = tev.fp4_accuracy_delta(td, tcfg, qs, fmt="nvfp4")
    assert set(got) == {"bf16", "nvfp4", "delta"}
    assert got == jev.fp4_accuracy_delta(jd, cfg, qs, fmt="nvfp4",
                                         interpret=True)


# engine kind -> (engine class name, KV dtype, page size)
_ENGINES = {"Engine bf16": ("Engine", "bf16", None),
            "Engine fp8": ("Engine", "fp8", None),
            "PagedEngine bf16 ps16": ("PagedEngine", "bf16", 16),
            "PagedEngine fp8 ps8": ("PagedEngine", "fp8", 8)}
_DT = {"bf16": (jnp.bfloat16, torch.bfloat16),
       "fp8": (jnp.float8_e4m3fn, FP8)}


def _engines(kind, cfg, tcfg, jp, tp):
    cls, dtype, ps = _ENGINES[kind]
    jdt, tdt = _DT[dtype]
    kw = {} if ps is None else {"page_size": ps}
    return (getattr(jserving, cls)(jp, cfg, max_batch=4, cache_dtype=jdt,
                                   **kw),
            getattr(tserving, cls)(tp, tcfg, max_batch=4, cache_dtype=tdt,
                                   **kw))


@pytest.mark.parametrize("kind", sorted(_ENGINES))
def test_engine_path_matches_jax(models, kind):
    """loglikelihood(engine=...) through the port's Engine (flat bf16,
    headed fp8) and PagedEngine (bf16 pool at page size 16, fp8 at 8) of
    the nvfp4 model against the same through the JAX engine of the same
    configuration; score_forward's logits (37 tokens, not a multiple of
    16) within the logits tolerance of the JAX engine's; the engine's own
    cache, positions and pages untouched; the picks of
    score_multiple_choice through the engine equal its direct path's."""
    cfg, tcfg, m = models
    jp, tp = m["nvfp4"]
    jeng, teng = _engines(kind, cfg, tcfg, jp, tp)
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab_size, size=(4, 37)).astype(np.int32)
    before = ([t.clone() for kv in teng.cache for t in kv]
              if teng.cache is not None else None)
    got = teng.score_forward(torch.from_numpy(toks))
    want = np.asarray(jeng.score_forward(jnp.asarray(toks)), np.float32)
    assert tuple(got.shape) == want.shape == (4, 37, cfg.vocab_size)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2 ** -5 * np.abs(want).max(), err
    if before is not None:
        assert all(torch.equal(a, b) for a, b in zip(
            before, [t for kv in teng.cache for t in kv]))
    else:
        assert teng.pages_in_use() == 0
    assert not teng.pos.any() and not teng.active.any()
    _ll_close(tev.loglikelihood(None, None, _PAIRS, engine=teng),
              jev.loglikelihood(None, None, _PAIRS, engine=jeng), _PAIRS)
    qs = _questions(2, cfg, 3)
    assert tev.score_multiple_choice(None, None, qs, engine=teng)[1] == \
        tev.score_multiple_choice(tp, tcfg, qs, fmt="nvfp4")[1]


def test_score_forward_checks_its_batch(models):
    _, tcfg, m = models
    eng = tserving.Engine(m["nvfp4"][1], tcfg, max_batch=4)
    with pytest.raises(ValueError, match="max_batch"):
        eng.score_forward(np.zeros((2, 8), np.int32))
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.score_forward(np.zeros((4, tcfg.max_seq_len + 1), np.int32))


@pytest.mark.parametrize("dtype", ["bf16", "fp8"])
def test_score_forward_through_forward_fn(dtype):
    """A Mixtral Engine's score_forward runs its forward_fn over a zeroed
    copy of its own cache (flat bf16, headed fp8) at positions arange(L)
    and kv_window decode_window(L): bit for bit that forward over a fresh
    cache, and over the bf16 cache within the logits tolerance of
    moe.forward's full sequence without a cache (fp8 KV rounds the
    attended K and V, so it is held to the cached forward alone). The
    engine's cache stays zero."""
    cfg = tmoe.MixtralConfig.tiny()
    params = tmoe.quantize_params(
        tmoe.init_params(cfg, torch.Generator().manual_seed(0)), cfg)
    tdt = _DT[dtype][1]
    eng = tserving.Engine(params, cfg, max_batch=2,
                          forward_fn=tmoe.make_engine_forward(cfg),
                          cache=tllama.init_cache(cfg, 2, tdt, device="cpu"))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 21)).astype(np.int64))
    got = eng.score_forward(toks)
    pos = torch.arange(21, dtype=torch.int32).expand(2, 21)
    want, _ = tmoe.forward(params, toks, cfg,
                           tllama.init_cache(cfg, 2, tdt, device="cpu"), pos,
                           kv_window=tllama.decode_window(21,
                                                          cfg.max_seq_len))
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    if dtype == "bf16":
        full, _ = tmoe.forward(params, toks, cfg)
        err = (got.float() - full.float()).abs().max().item()
        assert err <= 2 ** -5 * full.float().abs().max().item(), err
    assert not any(t.float().abs().sum() for kv in eng.cache for t in kv)


@pytest.fixture(scope="module")
def mixtral():
    """moe.MixtralConfig.tiny() quantized by the JAX package (mxfp4
    experts), in both packages."""
    from petit_kernel_tpu.models import moe as jmoe
    cfg = jmoe.MixtralConfig.tiny()
    quant = jmoe.quantize_params(jmoe.init_params(cfg, jax.random.PRNGKey(0)),
                                 cfg, fmt="mxfp4")
    return cfg, quant, convert.params_from_jax(
        jax.tree.map(np.asarray, quant), device="cpu")


@pytest.mark.parametrize("dtype", ["bf16", "fp8"])
def test_mixtral_score_forward_matches_jax_engine(mixtral, dtype):
    """The port's Mixtral Engine (flat bf16 or headed fp8 cache)
    score_forward of 2 rows of 21 tokens against the JAX
    Engine(forward_fn=moe.make_engine_forward(...)).score_forward over the
    same cache dtype, on the same converted weights: logits within 2^-5 *
    max|logits|."""
    from petit_kernel_tpu.models import moe as jmoe
    jcfg, quant, tparams = mixtral
    tcfg = tmoe.MixtralConfig.tiny()
    jdt, tdt = _DT[dtype]
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, size=(2, 21)).astype(np.int32)
    want = np.asarray(jserving.Engine(
        quant, jcfg, max_batch=2,
        forward_fn=jmoe.make_engine_forward(jcfg, interpret=True),
        cache=jllama.init_cache(jcfg, 2, jdt)).score_forward(
            jnp.asarray(toks)), np.float32)
    got = tserving.Engine(
        tparams, tcfg, max_batch=2, forward_fn=tmoe.make_engine_forward(tcfg),
        cache=tllama.init_cache(tcfg, 2, tdt, device="cpu")).score_forward(
            torch.from_numpy(toks))
    assert tuple(got.shape) == want.shape == (2, 21, jcfg.vocab_size)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2 ** -5 * np.abs(want).max(), err
