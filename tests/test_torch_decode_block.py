"""Port parity: the decode blocks of petit_kernel_tpu_torch's Engine
(step_block, run(decode_block=N), the pipelined drain) and its
llama.greedy_decode, on the CPU (tiny config, greedy unless stated).

On the CPU a block runs its steps eagerly over the engine's static
buffers, the same code the card replays as CUDA graphs. A block is held
to the port's own single-step engine token for token (the same kernels'
twins on the same rows), and to the JAX engine and the JAX greedy_decode
under the top-2 gap rule of tests/test_torch_serving.py: streams are
equal, or diverge first at a token whose JAX top-2 logit gap is below
2^-5 * max|logits|.
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


def _gap_rule(cfg, quant, jdt, want, got, prompts=_PROMPTS):
    """Equal streams, or a first divergence at a JAX near-tie (the model
    over a cache of the engines' dtype)."""
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    for uid, prompt in enumerate(prompts):
        sj, st = want[uid], got[uid]
        assert len(st) == len(sj)
        diff = [i for i, (a, b) in enumerate(zip(sj, st)) if a != b]
        if not diff:
            continue
        i = diff[0]
        toks = np.concatenate([prompt, np.asarray(sj[:i], np.int32)])
        pos = jnp.arange(len(toks), dtype=jnp.int32)[None]
        logits, _ = jllama.forward(quant, jnp.asarray(toks)[None], cfg,
                                   jllama.init_cache(cfg, 1, jdt), pos,
                                   kv_window=128)
        lg = np.asarray(logits[0, -1], np.float32)
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


# -- (g) engines without blocks ----------------------------------------------

@pytest.mark.parametrize("kind", ["paged", "forward_fn"])
def test_blocks_refused_by_paged_and_forward_fn_engines(models, kind):
    """PagedEngine and an Engine with forward_fn raise NotImplementedError
    at decode_block=4 and from step_block; decode_block=1 still serves."""
    cfg, _, tparams = models
    if kind == "paged":
        def make():
            return tserving.PagedEngine(tparams, cfg, max_batch=2,
                                        page_size=16)
    else:
        mcfg = tmoe.MixtralConfig.tiny()
        mparams = tmoe.quantize_params(
            tmoe.init_params(mcfg, torch.Generator().manual_seed(0)), mcfg)

        def make():
            cache = tllama.init_cache(mcfg, 2, device="cpu")
            return tserving.Engine(mparams, mcfg, max_batch=2, cache=cache,
                                   forward_fn=tmoe.make_engine_forward(mcfg))
    with pytest.raises(NotImplementedError):
        make().run(_requests(tserving, 3, _PROMPTS[:1]), decode_block=4)
    eng = make()
    eng.add_request(tserving.Request(uid=0, tokens=_PROMPTS[0],
                                     max_new_tokens=3))
    with pytest.raises(NotImplementedError):
        eng.step_block(4)
    out = make().run(_requests(tserving, 3, _PROMPTS[:1]))
    assert len(out[0]) == 3
