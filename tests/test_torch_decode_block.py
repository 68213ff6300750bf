"""Port parity: the decode blocks of petit_kernel_tpu_torch's engines
(step_block, run(decode_block=N), the pipelined drain) in the contiguous
Engine, PagedEngine and the Mixtral Engine (forward_fn), and its
llama.greedy_decode, on the CPU (tiny configs, greedy unless stated).

On the CPU a block runs its steps eagerly over the engine's static
buffers (a PagedEngine's block table among them), the same code the card
replays as CUDA graphs. A block is held to the port's own single-step
engine token for token (the same kernels' twins on the same rows), and to
the JAX engines and the JAX greedy_decode under the top-2 gap rule of
tests/test_torch_serving.py: streams are equal, or diverge first at a
token whose JAX top-2 logit gap is below 2^-5 * max|logits|. A paged
block's cache is compared per slot, gathered through the slot's own
table: a block takes a slot's pages up front, so its physical pages
differ from the eager steps'.
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
from petit_kernel_tpu_torch.models import moe as tmoe
from petit_kernel_tpu_torch.models import paged as tpaged
from petit_kernel_tpu_torch.models import serving as tserving

# xdist workers share the host's cores: one torch thread each keeps
# the port's CPU ops from oversubscribing them
torch.set_num_threads(1)

FP8 = torch.float8_e4m3fn
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "fp8": (jnp.float8_e4m3fn, FP8)}

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


@pytest.fixture(scope="module")
def hybrid_params():
    """tests/test_torch_hybrid.py's model: wq, wk and wv fall back to
    nvfp4, wo, w_gate, w_up and w_down split."""
    cfg = tllama.LlamaConfig(
        vocab_size=128, hidden_size=512, intermediate_size=1024,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
        max_seq_len=128)
    dense = tllama.init_params(cfg, torch.Generator().manual_seed(0))
    return cfg, tllama.quantize_params(dense, "hybrid")


def _requests(mod, max_new, prompts=_PROMPTS, **kw):
    return [mod.Request(uid=i, tokens=p, max_new_tokens=max_new, **kw)
            for i, p in enumerate(prompts)]


def _engine(tparams, cfg, dtype="bf16", **kw):
    return tserving.Engine(tparams, cfg, max_batch=2,
                           cache_dtype=DTYPES[dtype][1], **kw)


def _gap_rule(cfg, quant, jdt, want, got, prompts=_PROMPTS,
              last_logits=None):
    """Equal streams, or a first divergence at a JAX near-tie (the model
    over a cache of the engines' dtype; last_logits(tokens) gives another
    model's last logits)."""
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    for uid, prompt in enumerate(prompts):
        sj, st = want[uid], got[uid]
        assert len(st) == len(sj)
        diff = [i for i, (a, b) in enumerate(zip(sj, st)) if a != b]
        if not diff:
            continue
        i = diff[0]
        toks = np.concatenate([prompt, np.asarray(sj[:i], np.int32)])
        if last_logits is None:
            pos = jnp.arange(len(toks), dtype=jnp.int32)[None]
            logits, _ = jllama.forward(quant, jnp.asarray(toks)[None], cfg,
                                       jllama.init_cache(cfg, 1, jdt), pos,
                                       kv_window=128)
            lg = np.asarray(logits[0, -1], np.float32)
        else:
            lg = np.asarray(last_logits(toks), np.float32)
        top2 = np.sort(lg)[-2:]
        gap = float(top2[1] - top2[0])
        bound = 2 ** -5 * float(np.abs(lg).max())
        assert gap < bound, (f"request {uid} diverges at token {i} with a "
                             f"top-2 gap {gap} >= {bound}")


# -- (a) the port's blocks against its single steps --------------------------

@pytest.mark.parametrize("dtype", ["bf16", "fp8"])
def test_block_run_equals_single_step_run(models, dtype):
    """3 requests through max_batch=2 (a batched admission, then a slot
    reuse while a request waits), 9 new tokens: run(decode_block=4) gives
    run(decode_block=1)'s tokens, over the flat bf16 and the headed fp8
    cache."""
    cfg, _, tparams = models
    want = _engine(tparams, cfg, dtype).run(_requests(tserving, 9))
    eng = _engine(tparams, cfg, dtype)
    got = eng.run(_requests(tserving, 9), decode_block=4)
    assert got == want
    assert not eng.active.any() and not eng._pf
    assert eng._blocks is not None and not eng._blocks.graphs


def test_block_run_equals_single_step_run_hybrid(hybrid_params):
    """The hybrid fmt rides along: Engine(fmt="hybrid") with blocks of 4
    gives the single-step engine's tokens."""
    cfg, params = hybrid_params
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (9, 20, 5)]
    want = tserving.Engine(params, cfg, max_batch=2, fmt="hybrid").run(
        _requests(tserving, 7, prompts))
    got = tserving.Engine(params, cfg, max_batch=2, fmt="hybrid").run(
        _requests(tserving, 7, prompts), decode_block=4)
    assert got == want


# -- (b) mirrors of the JAX engine's block tests -----------------------------

def test_decode_block_matches_single_step(models):
    """tests/test_serving.py's test of the same name, for the contiguous
    Engine: blocks of 4 equal single steps; eos on the 5th token, mid-block
    at K = 4, discards the surplus; uneven lengths with no waiters at
    K = 8 (the block capped by the longest request, the short slot's
    surplus discarded) equal K = 1."""
    cfg, _, tparams = models
    want = _engine(tparams, cfg).run(_requests(tserving, 9))
    assert _engine(tparams, cfg).run(_requests(tserving, 9),
                                     decode_block=4) == want
    ref = _engine(tparams, cfg).run(
        [tserving.Request(uid=0, tokens=_PROMPTS[0], max_new_tokens=9)])
    eos = ref[0][4]
    for k in (1, 4):
        out = _engine(tparams, cfg).run(
            [tserving.Request(uid=0, tokens=_PROMPTS[0], max_new_tokens=9,
                              eos_id=eos)], decode_block=k)
        assert out[0] == ref[0][:ref[0].index(eos) + 1], k

    def uneven():
        return [tserving.Request(uid=0, tokens=_PROMPTS[0], max_new_tokens=3),
                tserving.Request(uid=1, tokens=_PROMPTS[1], max_new_tokens=9)]

    want = _engine(tparams, cfg).run(uneven())
    eng = _engine(tparams, cfg)
    assert eng._block_budget(8, waiters=False) == 1     # nothing active yet
    assert eng.run(uneven(), decode_block=8) == want


def test_pipelined_drain_matches_single_step(models):
    """tests/test_serving.py's test of the same name: with no admission
    waiting, run(decode_block=4) drains through _drain_blocks_pipelined
    (about 5 chained blocks of 17 new tokens), each block enqueued from
    the tokens the one before left on the device; tokens equal K = 1."""
    cfg, _, tparams = models
    reqs = lambda: _requests(tserving, 17, _PROMPTS[:2])     # noqa: E731
    want = _engine(tparams, cfg).run(reqs())
    eng = _engine(tparams, cfg)
    dispatched = []
    inner = eng._dispatch_block

    def spy(toks, pos, steps):
        dispatched.append((toks is None, steps))
        return inner(toks, pos, steps)

    eng._dispatch_block = spy
    assert eng.run(reqs(), decode_block=4) == want
    # the first block starts from the host, every later one from the device
    assert dispatched[0][0] is False and all(d for d, _ in dispatched[1:])
    assert len(dispatched) >= 4


def test_pipelined_drain_eos_midflight(models):
    """tests/test_serving.py's test of the same name: slot 0 hits eos on
    its 7th token while the next block is already in flight with the
    stale active mask; its surplus is discarded and slot 1's tokens from
    that block stay exact."""
    cfg, _, tparams = models
    ref = _engine(tparams, cfg).run(
        [tserving.Request(uid=0, tokens=_PROMPTS[0], max_new_tokens=17),
         tserving.Request(uid=1, tokens=_PROMPTS[2], max_new_tokens=17)])
    eos = ref[0][6]

    def reqs():
        return [tserving.Request(uid=0, tokens=_PROMPTS[0],
                                 max_new_tokens=17, eos_id=eos),
                tserving.Request(uid=1, tokens=_PROMPTS[2],
                                 max_new_tokens=17, eos_id=eos)]

    want = _engine(tparams, cfg).run(reqs())
    assert _engine(tparams, cfg).run(reqs(), decode_block=4) == want


def test_pipelined_drain_discards_an_unread_last_block(models):
    """One slot that hits eos inside block 1 while block 2 is in flight:
    block 2 is never read, and the stream equals K = 1's."""
    cfg, _, tparams = models
    ref = _engine(tparams, cfg).run(
        [tserving.Request(uid=0, tokens=_PROMPTS[0], max_new_tokens=12)])
    eos = ref[0][2]
    req = [tserving.Request(uid=0, tokens=_PROMPTS[0], max_new_tokens=12,
                            eos_id=eos)]
    want = _engine(tparams, cfg).run(list(req))
    eng = _engine(tparams, cfg)
    reads = []
    inner = eng._read_block
    eng._read_block = lambda blk: reads.append(blk.steps) or inner(blk)
    dispatched = []
    inner_d = eng._dispatch_block
    eng._dispatch_block = (lambda toks, pos, steps: dispatched.append(steps)
                           or inner_d(toks, pos, steps))
    got = eng.run([tserving.Request(uid=0, tokens=_PROMPTS[0],
                                    max_new_tokens=12, eos_id=eos)],
                  decode_block=4)
    assert got == want
    assert len(dispatched) == len(reads) + 1


# -- the block's steps against eager steps -----------------------------------

def _admitted(tparams, cfg, dtype, temps=(0.0, 0.0)):
    """An engine with both slots decoding after one admission."""
    eng = _engine(tparams, cfg, dtype, seed=5)
    for i, p in enumerate(_PROMPTS[:2]):
        eng.add_request(tserving.Request(uid=i, tokens=p, max_new_tokens=40,
                                         temperature=temps[i]))
    while eng._pf:
        eng._advance_prefill()
    assert eng.active.all()
    return eng


def _snapshot(eng):
    return ([(k.clone(), v.clone()) for k, v in eng.cache], eng.pos.copy(),
            eng.last_tok.copy(), eng.generator.get_state())


def _restore(eng, snap):
    cache, pos, last, gstate = snap
    for (k, v), (k0, v0) in zip(eng.cache, cache):
        k.copy_(k0)
        v.copy_(v0)
    eng.pos[:], eng.last_tok[:] = pos, last
    eng.generator.set_state(gstate)


def _cache_bits(eng):
    return [torch.cat([k.view(torch.uint8).flatten(),
                       v.view(torch.uint8).flatten()]) for k, v in eng.cache]


@pytest.mark.parametrize("dtype", ["bf16", "fp8"])
def test_block_steps_bit_for_bit_eager_steps(models, dtype):
    """From one snapshot: 5 eager decode steps (step()'s forward and
    sample_next, a slot at temperature 0.7) against one dispatched block
    of 5: the same logits each step, the same tokens and the same bytes
    in both caches."""
    cfg, _, tparams = models
    eng = _admitted(tparams, cfg, dtype, temps=(0.0, 0.7))
    snap = _snapshot(eng)
    want_logits, want_toks = [], []
    inner = eng._decode_logits

    def keep():
        lg = inner()
        want_logits.append(lg.clone())
        return lg

    eng._decode_logits = keep
    for _ in range(5):
        want_toks.append(eng._decode())
        eng.pos[eng.active] += 1
        eng.last_tok[eng.active] = want_toks[-1][eng.active]
    want_cache = _cache_bits(eng)
    _restore(eng, snap)
    blocks = tserving._DecodeBlocks(eng)
    got_logits = []
    inner_step = blocks.step

    def step(window):
        lg, nxt = inner_step(window)
        got_logits.append(lg.clone())
        return lg, nxt

    blocks.step = step
    out = eng._read_block(blocks.dispatch(eng.last_tok, eng.pos, 5))
    np.testing.assert_array_equal(out, np.stack(want_toks))
    for g, w in zip(got_logits, want_logits):
        assert torch.equal(g.view(torch.int16), w.view(torch.int16))
    for g, w in zip(_cache_bits(eng), want_cache):
        assert torch.equal(g, w)
    np.testing.assert_array_equal(blocks.pos[:, 0].numpy(), snap[1] + 5)


def test_block_windows_follow_projected_positions(models):
    """A block that crosses the 128-position bucket attends through the
    window step() would take at each step (128 while position 127 is the
    last written, then 256), from
    _kv_window(pos=projected positions)."""
    cfg, _, tparams = models
    cfg = tllama.LlamaConfig.tiny(max_seq_len=512)
    eng = tserving.Engine(tparams, cfg, max_batch=2)
    eng.add_request(tserving.Request(uid=0, tokens=_PROMPTS[0],
                                     max_new_tokens=200))
    eng.step()
    eng.pos[0] = 125             # the positions a long stream would reach
    assert eng._kv_window() == 128
    assert eng._kv_window(pos=eng.pos + 3) == 256
    windows = []
    inner = eng._forward

    def spy(toks, cache, pos, kv_window=None, write_mask=None):
        windows.append(kv_window)
        return inner(toks, cache, pos, kv_window=kv_window,
                     write_mask=write_mask)

    eng._forward = spy
    eng.step_block(5)
    assert windows == [128, 128, 128, 256, 256]
    assert eng.pos[0] == 130 and eng.pos[1] == 0


def test_block_leaves_idle_rows_alone(models):
    """A slot that is not decoding (mid-prefill) keeps its cache rows, its
    position and its token through a block: the active mask is the write
    mask and pos advances by it."""
    cfg, _, tparams = models
    eng = tserving.Engine(tparams, cfg, max_batch=2, prefill_chunk=16)
    eng.add_request(tserving.Request(uid=0, tokens=_PROMPTS[0],
                                     max_new_tokens=20))
    eng.step()
    long = np.arange(1, 41, dtype=np.int32)
    eng.add_request(tserving.Request(uid=1, tokens=long, max_new_tokens=4))
    eng._advance_prefill()                   # one 16-token chunk of slot 1
    assert eng.active.tolist() == [True, False] and eng._pf
    rows = [(k[1].clone(), v[1].clone()) for k, v in eng.cache]
    blk = eng._dispatch_block(eng.last_tok, eng.pos, 4)
    eng._read_block(blk)
    for (k, v), (k0, v0) in zip(eng.cache, rows):
        assert torch.equal(k[1], k0) and torch.equal(v[1], v0)
    assert eng._blocks.pos[1, 0] == 0 and eng._blocks.toks[1, 0] == 0
    assert eng._blocks.pos[0, 0] == eng.pos[0] + 4


# -- (c) against the JAX engine ----------------------------------------------

def test_block_run_matches_jax_engine(models):
    """The port's run(decode_block=4) against the JAX engine's
    run(decode_block=4) on the same converted weights (3 requests,
    max_batch=2, 9 new tokens, flat bf16 cache), under the gap rule."""
    cfg, quant, tparams = models
    want = jserving.Engine(quant, cfg, max_batch=2).run(
        _requests(jserving, 9), decode_block=4)
    got = _engine(tparams, cfg).run(_requests(tserving, 9), decode_block=4)
    _gap_rule(cfg, quant, jnp.bfloat16, want, got)


# -- (d) the budget ----------------------------------------------------------

# (active, pos, max_new_tokens, generated so far) of 4 slots; max_seq_len 128
_BUDGET_STATES = {
    "one slot": ([1, 0, 0, 0], [10, 0, 0, 0], [32, 0, 0, 0], [1, 0, 0, 0]),
    "mixed remaining": ([1, 1, 1, 0], [40, 17, 90, 0], [20, 9, 60, 0],
                        [3, 8, 11, 0]),
    "near max_seq_len": ([1, 1, 0, 1], [126, 30, 0, 60], [40, 40, 0, 40],
                         [5, 5, 0, 5]),
    "last position": ([0, 1, 1, 0], [0, 64, 127, 0], [0, 80, 90, 0],
                      [0, 2, 70, 0]),
    "one token left": ([1, 1, 1, 1], [20, 21, 22, 23], [5, 30, 30, 30],
                       [4, 1, 1, 1]),
}


@pytest.fixture(scope="module")
def budget_engines(models):
    cfg, quant, tparams = models
    return (jserving.Engine(quant, cfg, max_batch=4),
            tserving.Engine(tparams, cfg, max_batch=4))


@pytest.mark.parametrize("max_steps", [1, 4, 8, 64])
@pytest.mark.parametrize("waiters", [True, False])
@pytest.mark.parametrize("state", sorted(_BUDGET_STATES))
def test_block_budget_matches_jax(budget_engines, state, waiters, max_steps):
    """_block_budget of both engines on the same host state."""
    act, pos, max_new, gen = _BUDGET_STATES[state]
    got = []
    for eng, mod in zip(budget_engines, (jserving, tserving)):
        eng.active[:] = np.asarray(act, bool)
        eng.pos[:] = pos
        eng.slot_req = [mod.Request(uid=i, tokens=np.zeros(1, np.int32),
                                    max_new_tokens=max_new[i])
                        if act[i] else None for i in range(4)]
        eng.generated = {i: [0] * gen[i] for i in range(4) if act[i]}
        got.append(eng._block_budget(max_steps, waiters=waiters))
    assert got[0] == got[1]
    assert 1 <= got[1] <= max(1, max_steps)


# -- (e) greedy_decode -------------------------------------------------------

@pytest.mark.parametrize("prompt,dtype", [(0, "bf16"), (2, "fp8")])
def test_greedy_decode_matches_jax(models, prompt, dtype):
    """The port's greedy_decode against the JAX one on the same weights
    and prompt (8 new tokens) over the flat bf16 and the headed fp8 cache,
    under the gap rule."""
    cfg, quant, tparams = models
    jdt, tdt = DTYPES[dtype]
    p = _PROMPTS[prompt]
    want = np.asarray(jllama.greedy_decode(
        quant, cfg, jnp.asarray(p)[None], 8, cache_dtype=jdt))[0].tolist()
    got = tllama.greedy_decode(tparams, cfg, p[None], 8, cache_dtype=tdt)
    assert got.shape == (1, 8) and got.dtype == torch.int32
    _gap_rule(cfg, quant, jdt, {0: want}, {0: got[0].tolist()}, [p])


@pytest.mark.parametrize("decode_block", [1, 4])
def test_engine_matches_greedy_decode(models, decode_block):
    """tests/test_serving.py's test of the same name, in the port: each
    prompt alone through Engine(max_batch=1) gives the port's
    greedy_decode tokens, with single steps and with blocks."""
    cfg, _, tparams = models
    for i, p in enumerate(_PROMPTS):
        eng = tserving.Engine(tparams, cfg, max_batch=1)
        out = eng.run([tserving.Request(uid=i, tokens=p, max_new_tokens=6)],
                      decode_block=decode_block)
        want = tllama.greedy_decode(tparams, cfg, p[None], 6)[0].tolist()
        assert out[i] == want, i


@pytest.mark.parametrize("decode_block", [1, 4])
def test_engine_eos_stops(models, decode_block):
    """tests/test_serving.py's test of the same name, in the port: eos set
    to greedy_decode's 3rd token stops the stream there."""
    cfg, _, tparams = models
    p = _PROMPTS[0]
    ref = tllama.greedy_decode(tparams, cfg, p[None], 8)[0].tolist()
    eos = ref[2]
    out = _engine(tparams, cfg).run(
        [tserving.Request(uid=0, tokens=p, max_new_tokens=8, eos_id=eos)],
        decode_block=decode_block)
    assert out[0] == ref[:ref.index(eos) + 1]


# -- (f) sampling ------------------------------------------------------------

def test_sampled_streams_reproducible_at_decode_block_4(models):
    """Temperature 0.8: the same seed gives the same streams at
    decode_block=4, another seed others; with every prompt admitted in one
    batch the generator's draws come in step()'s order, so the streams
    equal decode_block=1's."""
    cfg, _, tparams = models

    def run(seed, k):
        return _engine(tparams, cfg, seed=seed).run(
            _requests(tserving, 12, _PROMPTS[:2], temperature=0.8),
            decode_block=k)

    a = run(3, 4)
    assert a == run(3, 4)
    assert a != run(4, 4)
    assert a == run(3, 1)


# -- (g) PagedEngine and the Mixtral Engine in blocks ------------------------

# engine kind -> (page size or None for the Mixtral Engine, KV dtype)
_ENGINES = {"paged ps8 bf16": (8, "bf16"), "paged ps16 bf16": (16, "bf16"),
            "paged ps8 fp8": (8, "fp8"), "paged ps16 fp8": (16, "fp8"),
            "mixtral flat bf16": (None, "bf16"),
            "mixtral headed fp8": (None, "fp8")}


@pytest.fixture(scope="module")
def mixtral():
    """moe.MixtralConfig.tiny() (2 layers, 4 experts, top-2, max_seq_len
    64) quantized by the JAX package, mxfp4 experts, in both packages."""
    from petit_kernel_tpu.models import moe as jmoe
    cfg = jmoe.MixtralConfig.tiny()
    quant = jmoe.quantize_params(jmoe.init_params(cfg, jax.random.PRNGKey(0)),
                                 cfg, fmt="mxfp4")
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, quant),
                                      device="cpu")
    return cfg, tmoe.MixtralConfig.tiny(), quant, tparams


def _maker(kind, models, mixtral, **kw):
    """A factory of max_batch=2 engines of `kind` (_ENGINES): PagedEngine
    over the tiny Llama, or Engine(forward_fn=moe.make_engine_forward)
    over the tiny Mixtral with a flat bf16 or headed fp8 cache."""
    ps, dtype = _ENGINES[kind]
    tdt = DTYPES[dtype][1]
    if ps is not None:
        cfg, _, tparams = models
        return lambda: tserving.PagedEngine(tparams, cfg, max_batch=2,
                                            page_size=ps, cache_dtype=tdt,
                                            **kw)
    _, tcfg, _, tparams = mixtral

    def make():
        return tserving.Engine(
            tparams, tcfg, max_batch=2, forward_fn=tmoe.make_engine_forward(
                tcfg), cache=tllama.init_cache(tcfg, 2, tdt, device="cpu"),
            **kw)
    return make


def _all_pages_back(eng):
    if isinstance(eng, tserving.PagedEngine):
        pc = eng.pc
        assert eng.pages_in_use() == 0
        assert sorted(pc.free) == list(range(pc.num_pages))
        assert (pc.tables == pc.scratch_page).all()


# the Mixtral config holds 64 positions: prompts and streams that fit
_SHORT = [_PROMPTS[0], _PROMPTS[1], _PROMPTS[2][:12]]


@pytest.mark.parametrize("kind", sorted(_ENGINES))
def test_engine_blocks_equal_single_steps(models, mixtral, kind):
    """tests/test_serving.py:349 for PagedEngine (page sizes 8 and 16, bf16
    and fp8 pools) and the Mixtral Engine (flat bf16, headed fp8): 3
    requests through max_batch=2, 9 new tokens, run(decode_block=4) gives
    decode_block=1's tokens; eos on the 5th token, mid-block, discards the
    surplus. Every page is back in the pool after each run."""
    make = _maker(kind, models, mixtral)
    want = make().run(_requests(tserving, 9, _SHORT))
    eng = make()
    assert eng.run(_requests(tserving, 9, _SHORT), decode_block=4) == want
    assert eng._blocks is not None and not eng._blocks.graphs
    _all_pages_back(eng)
    eos = want[0][4]
    eng = make()
    out = eng.run([tserving.Request(uid=0, tokens=_SHORT[0], max_new_tokens=9,
                                    eos_id=eos)], decode_block=4)
    assert out[0] == want[0][:want[0].index(eos) + 1]
    _all_pages_back(eng)


# the block length, the eos in flight and uneven lengths each on one pool
# and one Mixtral cache: the four pools share their block code
_ONE_OF_EACH = ["paged ps8 fp8", "mixtral headed fp8"]


@pytest.mark.parametrize("kind", _ONE_OF_EACH)
def test_engine_blocks_of_8_and_uneven_lengths(models, mixtral, kind):
    """tests/test_serving.py:349, the rest: run(decode_block=8) gives
    decode_block=1's tokens for 3 requests through max_batch=2; uneven
    lengths with no waiters at K = 8 equal K = 1. Every page is back in
    the pool after each run."""
    make = _maker(kind, models, mixtral)
    eng = make()
    assert eng.run(_requests(tserving, 9, _SHORT), decode_block=8) == \
        make().run(_requests(tserving, 9, _SHORT))
    _all_pages_back(eng)

    def uneven():
        return [tserving.Request(uid=0, tokens=_SHORT[0], max_new_tokens=3),
                tserving.Request(uid=1, tokens=_SHORT[1], max_new_tokens=9)]

    eng = make()
    assert eng.run(uneven(), decode_block=8) == make().run(uneven())
    _all_pages_back(eng)


@pytest.mark.parametrize("kind", sorted(_ENGINES))
def test_engine_pipelined_drain(models, mixtral, kind):
    """tests/test_serving.py:652 for the same engines: with no admission
    waiting, run(decode_block=4) drains through chained blocks (every
    block after the first enqueued from the device state the one before
    left) and gives decode_block=1's 17 tokens a request."""
    make = _maker(kind, models, mixtral)
    reqs = [_SHORT[0], _SHORT[2]]
    want = make().run(_requests(tserving, 17, reqs))
    eng = make()
    dispatched = []
    inner = eng._dispatch_block
    eng._dispatch_block = (lambda toks, pos, steps: dispatched.append(
        toks is None) or inner(toks, pos, steps))
    assert eng.run(_requests(tserving, 17, reqs), decode_block=4) == want
    assert dispatched[0] is False and all(dispatched[1:])
    assert len(dispatched) >= 4
    _all_pages_back(eng)


@pytest.mark.parametrize("kind", _ONE_OF_EACH)
def test_engine_pipelined_drain_eos_midflight(models, mixtral, kind):
    """tests/test_serving.py:669: slot 0 hitting eos on its 7th token
    while the next block is in flight keeps slot 1's tokens exact, and
    every page comes back (test_drain_hands_freed_pages_to_the_next_block
    has the pages change hands)."""
    make = _maker(kind, models, mixtral)
    reqs = [_SHORT[0], _SHORT[2]]
    eos = make().run(_requests(tserving, 17, reqs))[0][6]
    with_eos = [tserving.Request(uid=i, tokens=p, max_new_tokens=17,
                                 eos_id=eos) for i, p in enumerate(reqs)]
    want = make().run(with_eos)
    eng = make()
    assert eng.run(with_eos, decode_block=4) == want
    _all_pages_back(eng)


def test_paged_block_steps_bit_for_bit_eager_steps(models):
    """From one snapshot of an fp8 PagedEngine (page size 8, slot 1 at
    temperature 0.7, positions 10 and 14): 8 eager decode steps against
    one block of 8 whose steps read the block's static table: the same
    logits each step, the same tokens, and each slot's K and V gathered
    through its own table over its positions the same bytes in both
    pools. Eager steps take a page when a slot reaches it (slot 1 first),
    the block takes each slot's pages for the whole block up front (slot
    0 first), so the two runs write other physical pages."""
    cfg, _, tparams = models
    eng = tserving.PagedEngine(tparams, cfg, max_batch=2, page_size=8,
                               cache_dtype=FP8, seed=5)
    rng = np.random.default_rng(6)
    for i, (n, t) in enumerate(zip((10, 14), (0.0, 0.7))):
        eng.add_request(tserving.Request(
            uid=i, tokens=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
            max_new_tokens=40, temperature=t))
    while eng._pf:
        eng._advance_prefill()
    pc = eng.pc
    snap = ([(k.clone(), v.clone()) for k, v in pc.pages],
            pc.allocator_state(), eng.pos.copy(), eng.last_tok.copy(),
            eng.generator.get_state())
    want_logits, want_toks = [], []
    inner = eng._decode_logits

    def keep():
        lg = inner()
        want_logits.append(lg.clone())
        return lg

    eng._decode_logits = keep
    for _ in range(8):
        want_toks.append(eng._decode())
        eng.pos[eng.active] += 1
        eng.last_tok[eng.active] = want_toks[-1][eng.active]
    del eng._decode_logits
    end, eager_tables = eng.pos.copy(), pc.tables.copy()
    want_kv = _slot_kv(eng, end)
    pages, alloc, pos, last, gstate = snap
    for (k, v), (k0, v0) in zip(pc.pages, pages):
        k.copy_(k0)
        v.copy_(v0)
    pc.restore_allocator(alloc)
    eng.pos[:], eng.last_tok[:] = pos, last
    eng.generator.set_state(gstate)
    blocks = tserving._DecodeBlocks(eng)
    eng._blocks = blocks
    got_logits = []
    inner_step = blocks.step

    def step(window):
        lg, nxt = inner_step(window)
        got_logits.append(lg.clone())
        return lg, nxt

    blocks.step = step
    out = eng._read_block(eng._run_decode_block(eng.last_tok, eng.pos, 8))
    np.testing.assert_array_equal(out, np.stack(want_toks))
    for g, w in zip(got_logits, want_logits):
        assert torch.equal(g.view(torch.int16), w.view(torch.int16))
    for g, w in zip(_slot_kv(eng, end), want_kv):
        assert torch.equal(g, w)
    np.testing.assert_array_equal(blocks.tables.numpy(), pc.tables)
    assert [len(u) for u in pc.used] == [3, 3]
    assert (pc.tables[:, 2] == eager_tables[::-1, 2]).all()
    assert pc.tables[0, 2] != eager_tables[0, 2]


def _slot_kv(eng, end):
    """Each active slot's K and V of every layer, gathered through its own
    block-table row over positions < end[slot], as raw bytes."""
    return [t.view(torch.uint8) for slot in np.flatnonzero(eng.active)
            for t in tpaged.gather_slot_kv(eng.pc, slot, int(end[slot]))]


def test_drain_hands_freed_pages_to_the_next_block(models):
    """A tight pool (6 pages of 8 positions): slot 0 finishes inside a
    block of the pipelined drain while the next is in flight; its pages go
    back at the absorb, and a later block's table gives one of them to
    slot 1, which could not grow otherwise. The tokens equal
    decode_block=1's, and every page is back in the pool after the run."""
    cfg, _, tparams = models

    def make():
        return tserving.PagedEngine(tparams, cfg, max_batch=2, page_size=8,
                                    num_pages=6)

    def reqs():
        return [tserving.Request(uid=0, tokens=_PROMPTS[0], max_new_tokens=6),
                tserving.Request(uid=1, tokens=_PROMPTS[1],
                                 max_new_tokens=36)]

    want = make().run(reqs())
    eng = make()
    freed, handed = [], []
    release, dispatch = eng._release, eng._dispatch_block

    def spy_release(slot):
        freed.append((slot, list(eng.pc.used[slot])))
        release(slot)

    def spy_dispatch(toks, pos, steps):
        if freed:
            gone = set(freed[0][1])
            handed.append(gone & set(eng.pc.tables[1].tolist()))
        return dispatch(toks, pos, steps)

    eng._release, eng._dispatch_block = spy_release, spy_dispatch
    assert eng.run(reqs(), decode_block=4) == want
    assert freed[0][0] == 0 and any(handed)
    _all_pages_back(eng)


# (free pages, [(slot, upto)] allocated first, active, pos, steps)
_GROW_STATES = {
    "fresh": (12, [], [1, 1, 0], [3, 9, 0], 4),
    "across pages": (12, [(0, 8), (1, 16)], [1, 1, 0], [7, 15, 0], 8),
    "projected": (12, [(0, 24), (2, 8)], [1, 0, 1], [28, 0, 6], 5),
    "idle slot keeps its pages": (12, [(1, 16), (2, 5)], [0, 1, 1],
                                  [0, 12, 4], 3),
}


@pytest.mark.parametrize("state", sorted(_GROW_STATES))
def test_grow_for_block_matches_jax(models, state):
    """PagedEngine._grow_for_block of both packages on the same host
    state (page size 8, 3 slots): the same block tables, per-slot pages
    and free list."""
    cfg, quant, tparams = models
    num_pages, first, act, pos, steps = _GROW_STATES[state]
    engines = (jserving.PagedEngine(quant, cfg, max_batch=3, page_size=8,
                                    num_pages=num_pages),
               tserving.PagedEngine(tparams, cfg, max_batch=3, page_size=8,
                                    num_pages=num_pages))
    from petit_kernel_tpu.models import paged as jpaged
    for eng, mod in zip(engines, (jpaged, tpaged)):
        for slot, upto in first:
            mod.ensure_capacity(eng.pc, slot, upto)
        eng.active[:] = np.asarray(act, bool)
        eng._grow_for_block(np.asarray(pos, np.int32), steps)
    jpc, tpc = engines[0].pc, engines[1].pc
    np.testing.assert_array_equal(tpc.tables, np.asarray(jpc.block_tables))
    assert tpc.used == jpc.used and tpc.free == jpc.free
    for slot in np.flatnonzero(act):
        assert len(tpc.used[slot]) >= -(-(pos[slot] + steps) // 8)


def test_grow_for_block_raises_past_max_pages(models):
    """A projected position whose block would need more than max_pages
    pages raises ValueError (the JAX table update drops such a page
    silently); a block that ends at max_seq_len - 1 fits."""
    cfg, _, tparams = models
    eng = tserving.PagedEngine(tparams, cfg, max_batch=2, page_size=16)
    eng.active[:] = [True, False]
    eng._grow_for_block(np.array([cfg.max_seq_len - 9, 0], np.int32), 8)
    assert len(eng.pc.used[0]) == eng.pc.max_pages
    with pytest.raises(ValueError, match="block table"):
        eng._grow_for_block(np.array([cfg.max_seq_len - 8, 0], np.int32), 9)


def test_paged_block_run_matches_jax_engine(models):
    """The port's PagedEngine (page size 16, bf16 pool) run(decode_block=4)
    against the JAX PagedEngine's run(decode_block=4) on the same converted
    weights (3 requests, max_batch=2, 9 new tokens), under the gap rule;
    both pools end empty."""
    cfg, quant, tparams = models
    jeng = jserving.PagedEngine(quant, cfg, max_batch=2, page_size=16)
    want = jeng.run(_requests(jserving, 9), decode_block=4)
    teng = tserving.PagedEngine(tparams, cfg, max_batch=2, page_size=16)
    got = teng.run(_requests(tserving, 9), decode_block=4)
    _gap_rule(cfg, quant, jnp.bfloat16, want, got)
    assert jeng.pages_in_use() == 0
    _all_pages_back(teng)


def test_mixtral_block_run_matches_jax_engine(mixtral):
    """The port's Mixtral Engine (flat bf16 cache) run(decode_block=4)
    against the JAX Engine(forward_fn=moe.make_engine_forward(...)) at
    decode_block=4 on the same converted weights (2 requests, 6 new
    tokens), under the gap rule over the JAX full-sequence forward."""
    from petit_kernel_tpu.models import moe as jmoe
    jcfg, tcfg, quant, tparams = mixtral
    prompts = _SHORT[:2]
    want = jserving.Engine(
        quant, jcfg, max_batch=2,
        forward_fn=jmoe.make_engine_forward(jcfg, interpret=True)).run(
        _requests(jserving, 6, prompts), decode_block=4)
    got = tserving.Engine(
        tparams, tcfg, max_batch=2,
        forward_fn=tmoe.make_engine_forward(tcfg),
        cache=tllama.init_cache(tcfg, 2, device="cpu")).run(
        _requests(tserving, 6, prompts), decode_block=4)

    def last_logits(toks):
        logits, _ = jmoe.forward(quant, jnp.asarray(toks)[None], jcfg,
                                 interpret=True)
        return logits[0, -1]

    _gap_rule(jcfg, quant, jnp.bfloat16, want, got, prompts,
              last_logits=last_logits)
