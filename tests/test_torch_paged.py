"""Port parity: the paged KV cache, the fp8 headed cache and their engines
(petit_kernel_tpu_torch.models.paged, llama.init_cache(fp8),
serving.PagedEngine, Engine(cache_dtype=fp8)) against petit_kernel_tpu on
the same weights and inputs (tiny config, CPU, Pallas kernels in
interpret mode).

Tolerances: KV writes bit-exact; logits within 2^-5 * max|logits| (as in
test_torch_llama.py); token streams equal up to the near-tie rule of
test_torch_serving.py, with the top-2 gap taken from the JAX model over a
cache of the same dtype. fp8 K/V converts exactly in the port and is
flushed below the smallest normal by the JAX decode kernel (pinned in
test_torch_attention.py); the logits bound covers that difference.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from petit_kernel_tpu.models import llama as jllama
from petit_kernel_tpu.models import paged as jpaged
from petit_kernel_tpu.models import serving as jserving
from petit_kernel_tpu_torch.models import convert
from petit_kernel_tpu_torch.models import llama as tllama
from petit_kernel_tpu_torch.models import paged as tpaged
from petit_kernel_tpu_torch.models import serving as tserving
from petit_kernel_tpu_torch.ops.kernels import attention as tattn

# xdist workers share the host's cores: one torch thread each keeps
# the port's CPU ops from oversubscribing them
torch.set_num_threads(1)

DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


@pytest.fixture(scope="module")
def models():
    cfg = jllama.LlamaConfig.tiny()
    quant = jllama.quantize_params(
        jllama.init_params(cfg, jax.random.PRNGKey(1)), "nvfp4")
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, quant),
                                      device="cpu")
    return cfg, tllama.LlamaConfig.tiny(), quant, tparams


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return tattn._bits(x).numpy()
    x = np.asarray(x)
    return x.view(np.uint8 if x.dtype.itemsize == 1 else np.int16)


def _logits_close(got, want, what):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    bound = 2 ** -5 * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= bound, f"{what}: max abs err {err} > {bound}"


def _pair_caches(cfg, tcfg, B, dtype, page_size=16):
    """One JAX and one port paged cache with the same block tables: slot 0
    takes pages as the allocators hand them out, slot 1 after a release,
    so its pages are not in order."""
    jdt, tdt = DTYPES[dtype]
    jpc = jpaged.init_paged_cache(cfg, B, page_size=page_size, dtype=jdt)
    tpc = tpaged.init_paged_cache(tcfg, B, page_size=page_size, dtype=tdt,
                                  device="cpu")
    for mod, pc in ((jpaged, jpc), (tpaged, tpc)):
        mod.ensure_capacity(pc, 0, 3 * page_size)
        mod.release_slot(pc, 0)
        mod.ensure_capacity(pc, 1, 1)
        mod.ensure_capacity(pc, 0, 2 * page_size)
    np.testing.assert_array_equal(np.asarray(jpc.block_tables),
                                  tpc.block_tables.numpy())
    return jpc, tpc


@pytest.mark.parametrize("dtype", ["bf16", "fp8"])
@pytest.mark.parametrize("T,mask", [(1, None), (1, (0, 1)), (5, None),
                                    (5, (1, 0))])
def test_write_kv_bytes_match_jax(models, dtype, T, mask):
    """paged._write_kv: the written pool bytes equal JAX's. A masked row
    writes into the scratch page only; with T > 1 its T tokens all land on
    scratch offset 0, where which one wins is unordered in both packages,
    so the scratch page is left out there."""
    cfg, tcfg, _, _ = models
    B = 2
    jpc, tpc = _pair_caches(cfg, tcfg, B, dtype)
    rng = np.random.default_rng(T)
    new = [rng.standard_normal((B, T, cfg.num_kv_heads, cfg.head_dim),
                               dtype=np.float32).astype(ml_dtypes.bfloat16)
           for _ in range(2)]
    pos = (np.array([[14], [3]], np.int32) + np.arange(T, dtype=np.int32))
    jm = None if mask is None else jnp.asarray(mask, bool)
    tm = None if mask is None else torch.tensor(mask, dtype=torch.bool)
    want = jpaged._write_kv(jpc.pages[0], jpc.block_tables,
                            *(jnp.asarray(x) for x in new), jnp.asarray(pos),
                            16, write_mask=jm)
    tpaged._write_kv(tpc.pages[0], tpc.block_tables,
                     *(convert.tensor_from_numpy(x, device="cpu")
                       for x in new),
                     torch.from_numpy(pos), 16, write_mask=tm)
    keep = slice(None) if T == 1 or mask is None else slice(0, -1)
    for got, w in zip(tpc.pages[0], want):
        np.testing.assert_array_equal(_bytes(got)[keep], _bytes(w)[keep])
    if mask is not None:
        masked = mask.index(0)
        for page in tpc.used[masked]:
            assert not _bytes(tpc.pages[0][0])[page].any()
        assert _bytes(tpc.pages[0][0])[tpc.scratch_page].any()


@pytest.mark.parametrize("dtype", ["bf16", "fp8"])
def test_forward_paged_matches_jax(models, dtype):
    """A 20-token prefill chunk (crossing a page) then two decode steps
    through forward_paged, page size 16, one row masked in the second step,
    against JAX forward_paged(kv_window=128)."""
    cfg, tcfg, quant, tparams = models
    B, T = 2, 20
    jpc, tpc = _pair_caches(cfg, tcfg, B, dtype)
    rng = np.random.default_rng(21)
    toks = rng.integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, size=(2, B)).astype(np.int32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    lj, jpc.pages = jpaged.forward_paged(
        quant, jnp.asarray(toks), cfg, jpc.pages, jpc.block_tables,
        jnp.asarray(pos), page_size=16, interpret=True, kv_window=128)
    lt, _ = tpaged.forward_paged(tparams, torch.from_numpy(toks), tcfg,
                                 tpc.pages, tpc.block_tables,
                                 torch.from_numpy(pos), page_size=16,
                                 kv_window=128)
    _logits_close(lt, lj, "prefill")
    for i, (s, m) in enumerate(zip(steps, (None, (1, 0)))):
        p = np.full((B, 1), T + i, np.int32)
        jm = None if m is None else jnp.asarray(m, bool)
        tm = None if m is None else torch.tensor(m, dtype=torch.bool)
        lj, jpc.pages = jpaged.forward_paged(
            quant, jnp.asarray(s[:, None]), cfg, jpc.pages,
            jpc.block_tables, jnp.asarray(p), page_size=16, interpret=True,
            kv_window=128, write_mask=jm)
        lt, _ = tpaged.forward_paged(
            tparams, torch.from_numpy(s[:, None]), tcfg, tpc.pages,
            tpc.block_tables, torch.from_numpy(p), page_size=16,
            kv_window=128, write_mask=tm)
        _logits_close(lt, lj, f"decode step {i}")


@pytest.mark.parametrize("dtype", ["bf16", "fp8"])
def test_forward_headed_cache_matches_jax(models, dtype):
    """llama.forward over a headed cache (the fp8 default): a cached
    prefill chunk, then decode steps, against the JAX forward over its own
    headed cache (fp8 S padded to 256 there, 128 here). The cache bytes
    are not compared: K/V of a layer carry that layer's input, whose bf16
    roundings differ across the packages by the logits tolerance."""
    cfg, tcfg, quant, tparams = models
    jdt, tdt = DTYPES[dtype]
    B, T = 2, 16
    rng = np.random.default_rng(22)
    toks = rng.integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, size=(2, B)).astype(np.int32)
    jcache = jllama.init_cache(cfg, B, jdt, headed=True)
    tcache = tllama.init_cache(tcfg, B, tdt, headed=True, device="cpu")
    assert tllama.cache_is_headed(tcache[0][0], tcfg)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    lj, jcache = jllama.forward(quant, jnp.asarray(toks), cfg, jcache,
                                jnp.asarray(pos), kv_window=128)
    lt, _ = tllama.forward(tparams, torch.from_numpy(toks), tcfg, tcache,
                           torch.from_numpy(pos), kv_window=128)
    _logits_close(lt, lj, "prefill")
    for i, s in enumerate(steps):
        p = np.full((B, 1), T + i, np.int32)
        lj, jcache = jllama.forward(quant, jnp.asarray(s[:, None]), cfg,
                                    jcache, jnp.asarray(p), kv_window=128)
        lt, _ = tllama.forward(tparams, torch.from_numpy(s[:, None]), tcfg,
                               tcache, torch.from_numpy(p), kv_window=128)
        _logits_close(lt, lj, f"decode step {i}")
    assert jcache[0][0].shape[2] >= tcache[0][0].shape[2] == tcfg.max_seq_len


_PROMPTS = [
    np.array([5, 9, 42, 7], np.int32),
    np.array([100, 3], np.int32),
    np.array([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18],
             np.int32),
]


def _requests(mod, max_new):
    return [mod.Request(uid=i, tokens=p, max_new_tokens=max_new)
            for i, p in enumerate(_PROMPTS)]


def _assert_near_tie_rule(cfg, quant, jdt, want, got, max_new):
    """Streams are equal, or diverge first at a token whose JAX top-2 logit
    gap (model over a cache of the engines' dtype) is below the logits
    tolerance 2^-5 * max|logits|."""
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for uid, prompt in enumerate(_PROMPTS):
        sj, st = want[uid], got[uid]
        assert len(st) == len(sj) == max_new
        diff = [i for i, (a, b) in enumerate(zip(sj, st)) if a != b]
        if not diff:
            continue
        i = diff[0]
        toks = np.concatenate([prompt, np.asarray(sj[:i], np.int32)])
        L = len(toks)
        pos = jnp.arange(L, dtype=jnp.int32)[None]
        logits, _ = jllama.forward(quant, jnp.asarray(toks)[None], cfg,
                                   jllama.init_cache(cfg, 1, jdt), pos,
                                   kv_window=128)
        lg = np.asarray(logits[0, -1], np.float32)
        top2 = np.sort(lg)[-2:]
        gap = float(top2[1] - top2[0])
        bound = 2 ** -5 * float(np.abs(lg).max())
        assert gap < bound, (f"request {uid} diverges at token {i} with a "
                             f"top-2 gap {gap} >= {bound}")


@pytest.mark.parametrize("engine,dtype", [("paged", "bf16"), ("paged", "fp8"),
                                          ("engine", "fp8")])
def test_engine_streams_match_jax_engine(models, engine, dtype):
    """3 requests through max_batch=2 (batched admission of the first two,
    then a slot reuse for the third), greedy: PagedEngine (page size 16)
    and Engine(cache_dtype=fp8) against the JAX engines of the same
    configuration. Every page is back in the pool at the end."""
    cfg, tcfg, quant, tparams = models
    jdt, tdt = DTYPES[dtype]
    max_new = 6
    if engine == "paged":
        jeng = jserving.PagedEngine(quant, cfg, max_batch=2, page_size=16,
                                    cache_dtype=jdt)
        teng = tserving.PagedEngine(tparams, tcfg, max_batch=2, page_size=16,
                                    cache_dtype=tdt)
    else:
        jeng = jserving.Engine(quant, cfg, max_batch=2, cache_dtype=jdt)
        teng = tserving.Engine(tparams, tcfg, max_batch=2, cache_dtype=tdt)
        assert tllama.cache_is_headed(teng.cache[0][0], tcfg)
        assert teng.cache[0][0].dtype == tdt
    want = jeng.run(_requests(jserving, max_new))
    got = teng.run(_requests(tserving, max_new))
    _assert_near_tie_rule(cfg, quant, jdt, want, got, max_new)
    assert not teng.active.any() and not teng._pf
    if engine == "paged":
        assert teng.pages_in_use() == 0 == jeng.pages_in_use()
        assert sorted(teng.pc.free) == list(range(teng.pc.num_pages))
        assert (teng.pc.tables == teng.pc.scratch_page).all()


def test_allocator_reuse_exhaustion_and_table_limit(models):
    """As test_paged.py's allocator test, plus: ensure_capacity raises past
    max_pages (the JAX table update drops such a write silently), and the
    scratch page is never handed out."""
    _, tcfg, _, _ = models
    pc = tpaged.init_paged_cache(tcfg, batch=2, page_size=16, num_pages=4,
                                 device="cpu")
    assert pc.max_pages == 8 and pc.scratch_page == 4
    assert tuple(pc.pages[0][0].shape) == (5, 2, 16, 64)
    tpaged.ensure_capacity(pc, 0, 33)   # 3 pages
    assert len(pc.used[0]) == 3 and len(pc.free) == 1
    tpaged.ensure_capacity(pc, 1, 16)   # 1 page
    assert not pc.free
    with pytest.raises(RuntimeError, match="exhausted"):
        tpaged.ensure_capacity(pc, 1, 17)
    tpaged.release_slot(pc, 0)
    assert len(pc.free) == 3
    assert (pc.block_tables[0] == pc.scratch_page).all()
    tpaged.ensure_capacity(pc, 1, 33)   # reuses freed pages
    assert len(pc.used[1]) == 3
    assert pc.scratch_page not in pc.used[1] + pc.free
    big = tpaged.init_paged_cache(tcfg, batch=1, page_size=16, num_pages=20,
                                  device="cpu")
    tpaged.ensure_capacity(big, 0, tcfg.max_seq_len)      # 8 pages: fits
    with pytest.raises(ValueError, match="block table"):
        tpaged.ensure_capacity(big, 0, tcfg.max_seq_len + 1)
    assert len(big.used[0]) == 8
    # the reference takes a ninth page off the free list that its table
    # drops (ROADMAP.md, queue 3)
    cfg = models[0]
    jbig = jpaged.init_paged_cache(cfg, 1, page_size=16, num_pages=20)
    jpaged.ensure_capacity(jbig, 0, cfg.max_seq_len + 1)
    assert len(jbig.used[0]) == 9 and jbig.block_tables.shape == (1, 8)


def test_paged_engine_returns_every_page(models):
    """Longer prompts than pages, a pool smaller than max_batch *
    max_seq_len, and reset() after a partial run: the pool ends full."""
    _, tcfg, _, tparams = models
    eng = tserving.PagedEngine(tparams, tcfg, max_batch=2, page_size=16,
                               num_pages=6)
    rng = np.random.default_rng(23)
    reqs = [tserving.Request(uid=i, tokens=rng.integers(
        0, tcfg.vocab_size, size=n).astype(np.int32), max_new_tokens=4)
        for i, n in enumerate((30, 7, 20))]
    out = eng.run(reqs)
    assert sorted(out) == [0, 1, 2] and all(len(v) == 4 for v in out.values())
    assert eng.pages_in_use() == 0 and len(eng.pc.free) == 6
    eng.add_request(reqs[0])
    eng.step()
    assert eng.pages_in_use() == 2
    eng.reset()
    assert eng.pages_in_use() == 0 and len(eng.pc.free) == 6
    with pytest.raises(NotImplementedError):
        eng.score_forward(None)
    # W4A8 prefill serves the same requests and returns every page too
    w8 = tserving.PagedEngine(tparams, tcfg, max_batch=2, page_size=16,
                              num_pages=6, prefill_fmt="w4a8")
    assert w8.prefill_chunk == min(512, tcfg.max_seq_len)
    out = w8.run(reqs)
    assert sorted(out) == [0, 1, 2] and all(len(v) == 4 for v in out.values())
    assert w8.pages_in_use() == 0 and len(w8.pc.free) == 6


def test_convert_carries_fp8_state_bit_for_bit(models):
    """tensor_from_numpy reads float8_e4m3fn through a uint8 view, and
    kv_from_jax carries a JAX page pool and a JAX fp8 cache into the port:
    every byte comes back."""
    cfg, tcfg, _, _ = models
    every = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn)
    t = convert.tensor_from_numpy(every, device="cpu")
    assert t.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(t.view(torch.uint8).numpy(),
                                  np.arange(256, dtype=np.uint8))
    rng = np.random.default_rng(24)
    jpc = jpaged.init_paged_cache(cfg, 2, page_size=16,
                                  dtype=jnp.float8_e4m3fn)
    pool = [tuple(np.asarray(jnp.asarray(rng.standard_normal(k.shape),
                                         jnp.float8_e4m3fn)) for k in kv)
            for kv in jpc.pages]
    jcache = [tuple(np.asarray(x) for x in kv)
              for kv in jllama.init_cache(cfg, 2, jnp.float8_e4m3fn)]
    for state in (pool, jcache):
        got = convert.kv_from_jax(state, device="cpu")
        assert len(got) == len(state) == cfg.num_layers
        for (tk, tv), (nk, nv) in zip(got, state):
            for a, b in ((tk, nk), (tv, nv)):
                assert a.dtype == torch.float8_e4m3fn
                assert tuple(a.shape) == b.shape
                np.testing.assert_array_equal(a.view(torch.uint8).numpy(),
                                              b.view(np.uint8))


def test_init_cache_layouts():
    """fp8 defaults to the headed (B, Hkv, S, d) layout without the JAX
    package's pad of S to 256; bf16 stays flat; a headed cache whose S
    equals Hkv, which cache_is_headed could not tell from flat, raises."""
    cfg = tllama.LlamaConfig.tiny(num_layers=1)
    (k8, v8), = tllama.init_cache(cfg, 2, torch.float8_e4m3fn, device="cpu")
    assert tuple(k8.shape) == (2, 2, 128, 64) == tuple(v8.shape)
    assert k8.dtype == torch.float8_e4m3fn
    assert tllama.cache_is_headed(k8, cfg)
    (kb, _), = tllama.init_cache(cfg, 2, device="cpu")
    assert tuple(kb.shape) == (2, 128, 2, 64)
    assert not tllama.cache_is_headed(kb, cfg)
    (kh, _), = tllama.init_cache(cfg, 2, headed=True, device="cpu")
    assert kh.dtype == torch.bfloat16 and tllama.cache_is_headed(kh, cfg)
    with pytest.raises(ValueError, match="num_kv_heads"):
        tllama.init_cache(tllama.LlamaConfig.tiny(max_seq_len=2), 1,
                          torch.float8_e4m3fn, device="cpu")
