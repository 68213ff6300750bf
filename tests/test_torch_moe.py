"""Port parity: the Mixtral MoE path of petit_kernel_tpu_torch (grouped
expert GEMM, routing, moe_mlp, the Mixtral model and its Engine) against
petit_kernel_tpu's on the same bytes (CPU; the JAX grouped kernel in
Pallas interpret mode, as tests/test_moe.py runs it).

Tolerances: the grouped GEMM at rtol 2^-7 with atol 2^-8 * max|ref|, as
tests/test_torch_gemm.py (both sum exact bf16 products in f32, in other
orders); moe_mlp at the same tolerance; logits within 2^-5 * max|logits|,
as tests/test_torch_llama.py. Routing indices, bucket contents and drop
counts are exactly equal. The two frameworks' f32 router logits may differ
in the last ulp, so every routing comparison first asserts that the
inputs hold no near-tie among the top_k + 1 largest logits: a flip is then
a fault, not noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petit_kernel_tpu.models import llama as jllama
from petit_kernel_tpu.models import moe as jmoe
from petit_kernel_tpu.models import serving as jserving
from petit_kernel_tpu.ops.kernels import grouped as jgrouped
from petit_kernel_tpu.ops.solution import ElementB as JElementB
from petit_kernel_tpu_torch.models import convert
from petit_kernel_tpu_torch.models import llama as tllama
from petit_kernel_tpu_torch.models import moe as tmoe
from petit_kernel_tpu_torch.models import serving as tserving
from petit_kernel_tpu_torch.ops import gemm as tgemm
from petit_kernel_tpu_torch.ops import solution as tsol
from petit_kernel_tpu_torch.ops.kernels import fused as tfused
from petit_kernel_tpu_torch.ops.kernels import grouped as tgrouped

# xdist workers share the host's cores: one torch thread each keeps
# the port's CPU ops from oversubscribing them
torch.set_num_threads(1)

FORMATS = ("nvfp4", "nvfp4p2", "nvfp4p2z", "mxfp4", "mxfp4z")
# smallest gap asserted between neighbouring top_k + 1 router logits, as a
# share of the largest |logit|: far above the f32 rounding of a 128-term
# sum (about 2^-20 of it)
ROUTER_MARGIN = 2 ** -12


def _to_torch(tree):
    return convert.params_from_jax(jax.tree.map(np.asarray, tree),
                                   device="cpu")


def _bf16(a):
    """numpy f32 -> (jnp bf16, torch bf16) with the same bits."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, convert.tensor_from_numpy(np.asarray(j), device="cpu")


def _assert_gemm_close(got, want, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=2 ** -7,
                               atol=2 ** -8 * np.abs(want).max(),
                               err_msg=what)


def _assert_router_margin(x, router, top_k):
    """No near-tie among the top_k + 1 largest router logits of any token
    (x, router: torch tensors)."""
    logits = x.float() @ router.float()
    top = torch.sort(logits, dim=-1, descending=True).values[:, :top_k + 1]
    gap = (top[:, :-1] - top[:, 1:]).min().item()
    bound = ROUTER_MARGIN * logits.abs().max().item()
    assert gap > bound, f"router near-tie: gap {gap} <= {bound}"


def _jax_grouped(xs, ex, fmt):
    """The JAX package's grouped_mul as its moe_mlp calls it."""
    eb = JElementB.MXFP4 if fmt in ("mxfp4", "mxfp4z") else JElementB.NVFP4
    return jgrouped.grouped_mul(
        xs, ex["words"], ex["scales"], ex["gs"], element_b=eb,
        pow2_scale=fmt in ("nvfp4p2", "nvfp4p2z"),
        zero_free=fmt in ("nvfp4p2z", "mxfp4z"), interpret=True)


@pytest.mark.parametrize("fmt", FORMATS)
def test_grouped_mul_matches_jax(fmt):
    """E=4, cap 16, k 512, n 256: the port's grouped_mul (plain twin on the
    CPU) against the JAX kernel on the same bytes, and bit for bit against
    fused_mul_reference on each expert."""
    rng = np.random.default_rng(4)
    E, cap, k, n = 4, 16, 512, 256
    ex = jmoe.quantize_moe_linear(rng.standard_normal((E, k, n)) / 8, fmt)
    xj, xt = _bf16(rng.standard_normal((E, cap, k)))
    want = _jax_grouped(xj, ex, fmt)
    tex = _to_torch(ex)
    assert tex["words"].dtype == torch.int32 and tex["gs"].shape == (E,)
    got = tgrouped.grouped_mul(xt, tex["words"], tex["scales"], tex["gs"])
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (E, cap, n)
    _assert_gemm_close(got.float().numpy(), want, fmt)
    sid = tsol.SolutionId(16, 64)
    for e in range(E):
        one = tfused.fused_mul_reference(xt[e], tex["words"][e],
                                         tex["scales"][e],
                                         tex["gs"][e].reshape(1), sid=sid)
        assert torch.equal(one.view(torch.int16), got[e].view(torch.int16))


def test_resolve_grouped_solution_contract():
    cap, n, k = 8, 256, 512
    mx = tsol.ElementB.MXFP4
    assert (tgemm.resolve_grouped_solution(cap, n, k, mx)
            == tsol.choose_default_solution(cap, n, k, mx))
    assert tgemm.resolve_grouped_solution(128, n, k, mx).block_m == 64
    explicit = tsol.SolutionId(16, 128, mx)
    assert tgemm.resolve_grouped_solution(
        cap, n, k, mx, solution_id=explicit.repr()) == explicit
    with pytest.raises(ValueError, match="element_b"):
        tgemm.resolve_grouped_solution(cap, n, k, tsol.ElementB.NVFP4,
                                       solution_id=explicit.repr())
    with pytest.raises(ValueError, match="infeasible"):
        tgemm.resolve_grouped_solution(
            cap, n, k, mx, solution_id=tsol.SolutionId(64, 128, mx).repr())
    with pytest.raises(ValueError):
        tgemm.resolve_grouped_solution(cap, n, k, mx, solution_id=0x3F << 14)
    # grouped_mul resolves the same way and validates its operands
    rng = np.random.default_rng(0)
    ex = _to_torch(jmoe.quantize_moe_linear(
        rng.standard_normal((2, k, n)) / 8, "mxfp4"))
    xs = torch.zeros((2, cap, k), dtype=torch.bfloat16)
    out = tgrouped.grouped_mul(xs, ex["words"], ex["scales"], ex["gs"],
                               solution_id=explicit.repr(), element_b=mx)
    assert tuple(out.shape) == (2, cap, n) and not out.float().any()
    with pytest.raises(ValueError):
        tgrouped.grouped_mul(xs[:1], ex["words"], ex["scales"], ex["gs"])
    with pytest.raises(ValueError):
        tgrouped.grouped_mul(xs, ex["words"], ex["scales"][:, 1:], ex["gs"])


def _moe_case(seed, T, H, F, E, router_scale):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, H))
    router = rng.standard_normal((H, E)) * router_scale
    ws = {nm: rng.standard_normal((E, kk, nn)) / 16
          for nm, (kk, nn) in dict(w_gate=(H, F), w_up=(H, F),
                                   w_down=(F, H)).items()}
    return x, router, ws


@pytest.mark.parametrize("case", ["routed", "overflow"])
def test_moe_mlp_matches_jax(case):
    """Routing, buckets and drops exactly equal; outputs within the GEMM
    tolerance. 'overflow' forces capacity drops (capacity_factor 0.5)."""
    T, H, F, E = 32, 128, 256, 4
    cf = 2.0 if case == "routed" else 0.5
    x, router, ws = _moe_case(7, T, H, F, E, 0.5)
    xj, xt = _bf16(x)
    rj, rt = _bf16(router)
    _assert_router_margin(xt, rt, 2)
    jex = {nm: jmoe.quantize_moe_linear(w, "mxfp4") for nm, w in ws.items()}
    tex = _to_torch(jex)
    jcfg = jmoe.MoEConfig(num_experts=E, top_k=2, capacity_factor=cf)
    tcfg = tmoe.MoEConfig(num_experts=E, top_k=2, capacity_factor=cf)
    # routing: top-k indices in order, and the drop count
    _, jidx = jax.lax.top_k(jnp.dot(xj.astype(jnp.float32),
                                    rj.astype(jnp.float32)), 2)
    _, tidx = tmoe.route(xt, rt, 2)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    jdrops = int(jmoe.routing_drop_count(xj, rj, jcfg))
    assert int(tmoe.routing_drop_count(xt, rt, tcfg)) == jdrops
    assert (jdrops > 0) == (case == "overflow")
    want = jmoe.moe_mlp(xj, rj, jex, jcfg, fmt="mxfp4", interpret=True)
    got = tmoe.moe_mlp(xt, rt, tex, tcfg, fmt="mxfp4")
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (T, H)
    _assert_gemm_close(got.float().numpy(), want, case)
    # dropped pairs contribute exactly nothing: the port's f32 partial sum
    # has as many all-zero token rows as the JAX package's
    zero_rows = lambda y: int((np.abs(np.asarray(y, np.float32)).sum(-1)
                               == 0).sum())
    assert zero_rows(got.float().numpy()) == zero_rows(want)


def test_moe_mlp_partial_local_experts_sum_to_the_whole():
    """expert_base/num_local (the expert-parallel building block): the two
    halves of the expert stack add up to the whole block."""
    T, H, F, E = 16, 128, 256, 4
    x, router, ws = _moe_case(8, T, H, F, E, 0.5)
    _, xt = _bf16(x)
    _, rt = _bf16(router)
    tex = _to_torch({nm: jmoe.quantize_moe_linear(w, "mxfp4")
                     for nm, w in ws.items()})
    cfg = tmoe.MoEConfig(num_experts=E, top_k=2)
    whole = tmoe.moe_mlp_partial(xt, rt, tex, cfg)
    halves = sum(tmoe.moe_mlp_partial(
        xt, rt, {nm: {key: v[base:base + 2] for key, v in layer.items()}
                 for nm, layer in tex.items()},
        cfg, expert_base=base, num_local=2) for base in (0, 2))
    torch.testing.assert_close(halves, whole, rtol=0, atol=0)


@pytest.fixture(scope="module")
def tiny_mixtral():
    cfg = jmoe.MixtralConfig.tiny()
    dense = jmoe.init_params(cfg, jax.random.PRNGKey(0))
    quant = jmoe.quantize_params(dense, cfg, fmt="mxfp4")
    return cfg, tmoe.MixtralConfig.tiny(), dense, quant, _to_torch(quant)


def test_quantize_params_matches_jax(tiny_mixtral):
    """The port's quantize_params on the converted dense tree gives the JAX
    package's quantized tree bit for bit (separate wq, wk, wv)."""
    _, tcfg, dense, quant, tquant = tiny_mixtral
    got = tmoe.quantize_params(_to_torch(dense), tcfg)
    lp, jlp = got["layers"][1], tquant["layers"][1]
    assert "wqkv" not in lp and set(lp) == set(jlp)
    for nm in ("wq", "wk", "wv", "wo"):
        for key in ("words", "scales", "gs"):
            assert torch.equal(lp[nm][key].reshape(-1).view(torch.uint8),
                               jlp[nm][key].reshape(-1).view(torch.uint8))
    for nm in ("w_gate", "w_up", "w_down"):
        for key in ("words", "scales", "gs"):
            a, b = lp["experts"][nm][key], jlp["experts"][nm][key]
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a.reshape(-1).view(torch.uint8),
                               b.reshape(-1).view(torch.uint8))


def _record_router_inputs(monkeypatch, mod):
    """Wrap mod.moe_mlp to keep each call's (x, router) as numpy."""
    seen, inner = [], mod.moe_mlp

    def spy(x, router_w, *a, **kw):
        seen.append((np.asarray(torch.as_tensor(x).float()
                                if isinstance(x, torch.Tensor)
                                else jnp.asarray(x, jnp.float32)),
                     router_w))
        return inner(x, router_w, *a, **kw)

    monkeypatch.setattr(mod, "moe_mlp", spy)
    return seen


def _check_routing(jseen, tseen, top_k):
    """Equal top-k choices at every MoE block, with the margin asserted on
    the port's router inputs."""
    assert len(jseen) == len(tseen) > 0
    for (jx, jr), (tx, tr) in zip(jseen, tseen):
        _assert_router_margin(torch.from_numpy(tx), tr, top_k)
        _, jidx = jax.lax.top_k(jnp.asarray(jx) @ jnp.asarray(jr, jnp.float32),
                                top_k)
        _, tidx = tmoe.route(torch.from_numpy(tx), tr, top_k)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


def _logits_close(got, want, what):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    bound = 2 ** -5 * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= bound, f"{what}: max abs err {err} > {bound}"


def test_forward_full_sequence_matches_jax(tiny_mixtral, monkeypatch):
    jcfg, tcfg, _, quant, tquant = tiny_mixtral
    toks = np.random.default_rng(11).integers(0, jcfg.vocab_size,
                                              size=(2, 12)).astype(np.int32)
    jseen = _record_router_inputs(monkeypatch, jmoe)
    tseen = _record_router_inputs(monkeypatch, tmoe)
    lj, _ = jmoe.forward(quant, jnp.asarray(toks), jcfg, interpret=True)
    lt, _ = tmoe.forward(tquant, torch.from_numpy(toks), tcfg)
    _check_routing(jseen, tseen, jcfg.top_k)
    _logits_close(lt, lj, "full-sequence forward")


def test_forward_cached_prefill_then_decode_matches_jax(tiny_mixtral,
                                                        monkeypatch):
    """A cached 16-token prefill and a decode step with kv_window, through
    the flash-prefill / decode-attention / kv-append twins, against the
    JAX forward (Pallas kernels in interpret mode)."""
    jcfg, tcfg, _, quant, tquant = tiny_mixtral
    B, T = 2, 16
    rng = np.random.default_rng(12)
    toks = rng.integers(0, jcfg.vocab_size, size=(B, T)).astype(np.int32)
    step = rng.integers(0, jcfg.vocab_size, size=(B, 1)).astype(np.int32)
    jseen = _record_router_inputs(monkeypatch, jmoe)
    tseen = _record_router_inputs(monkeypatch, tmoe)
    jcache = jllama.init_cache(jcfg, B)
    tcache = tllama.init_cache(tcfg, B, device="cpu")
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    lj, jcache = jmoe.forward(quant, jnp.asarray(toks), jcfg, jcache,
                              jnp.asarray(pos), interpret=True, kv_window=64)
    lt, tcache = tmoe.forward(tquant, torch.from_numpy(toks), tcfg, tcache,
                              torch.from_numpy(pos), kv_window=64)
    _logits_close(lt, lj, "prefill")
    p = np.full((B, 1), T, np.int32)
    lj, _ = jmoe.forward(quant, jnp.asarray(step), jcfg, jcache,
                         jnp.asarray(p), interpret=True, kv_window=64)
    lt, _ = tmoe.forward(tquant, torch.from_numpy(step), tcfg, tcache,
                         torch.from_numpy(p), kv_window=64)
    _logits_close(lt, lj, "decode")
    _check_routing(jseen, tseen, jcfg.top_k)


_PROMPTS = [np.array([163, 130, 69, 78, 10, 19, 4, 44, 208, 166], np.int32),
            np.array([76, 123, 108], np.int32)]


def test_engine_streams_match_jax_engine(tiny_mixtral):
    """Two greedy requests through Engine(forward_fn=make_engine_forward)
    in both packages (batched admission, then decode). The streams are
    equal; at every generated token the top-2 logit gap of the
    full-sequence forward (equal to the JAX package's within the logits
    tolerance, test_forward_full_sequence_matches_jax) is above that
    tolerance, 2^-5 * max|logits|, so a different token would be a
    fault."""
    jcfg, tcfg, _, quant, tquant = tiny_mixtral
    max_new = 5
    want = jserving.Engine(
        quant, jcfg, max_batch=2,
        forward_fn=jmoe.make_engine_forward(jcfg, interpret=True)).run(
        [jserving.Request(uid=i, tokens=p, max_new_tokens=max_new)
         for i, p in enumerate(_PROMPTS)])
    eng = tserving.Engine(tquant, tcfg, max_batch=2,
                          forward_fn=tmoe.make_engine_forward(tcfg))
    got = eng.run([tserving.Request(uid=i, tokens=p, max_new_tokens=max_new)
                   for i, p in enumerate(_PROMPTS)])
    assert got == want
    for uid, prompt in enumerate(_PROMPTS):
        seq = np.concatenate([prompt, np.asarray(want[uid][:-1], np.int32)])
        lt, _ = tmoe.forward(tquant, torch.from_numpy(seq)[None], tcfg)
        lt = lt[0, len(prompt) - 1:].float().numpy()
        assert (lt.argmax(-1) == np.asarray(want[uid])).all()
        top2 = np.sort(lt, -1)[:, -2:]
        gap = top2[:, 1] - top2[:, 0]
        bound = 2 ** -5 * np.abs(lt).max(-1)
        assert (gap > bound).all(), (uid, gap, bound)
    assert not eng.active.any() and not eng._pf


def test_engine_takes_a_cache_and_checks_forward_fn(tiny_mixtral):
    """The Engine serves a caller's cache through forward_fn; and a
    window-less Mixtral forward_fn (no kv_window, no write_mask) is served
    as the JAX engine serves one: one prompt a chunk, no window passed,
    the JAX fallback Engine's tokens on the same requests. The port's
    cached attention needs a window, so that forward_fn attends through
    the whole cache."""
    jcfg, tcfg, _, quant, tquant = tiny_mixtral
    cache = tllama.init_cache(tcfg, 2, device="cpu")
    eng = tserving.Engine(tquant, tcfg, max_batch=2, cache=cache,
                          forward_fn=tmoe.make_engine_forward(tcfg),
                          prefill_fmt="w4a8")    # ignored with forward_fn
    assert eng.cache is cache
    out = eng.run([tserving.Request(uid=0, tokens=_PROMPTS[0],
                                    max_new_tokens=2)])
    assert len(out[0]) == 2 and cache[0][0].abs().sum() > 0

    def no_window(p, toks, cache_, pos):
        return tmoe.forward(p, toks, tcfg, cache_, pos,
                            kv_window=tcfg.max_seq_len)

    max_new = 4
    want = jserving.Engine(
        quant, jcfg, max_batch=2,
        forward_fn=lambda p, t, c, q: jmoe.forward(p, t, jcfg, c, q,
                                                   interpret=True)).run(
        [jserving.Request(uid=i, tokens=p, max_new_tokens=max_new)
         for i, p in enumerate(_PROMPTS)])
    eng = tserving.Engine(tquant, tcfg, max_batch=2, forward_fn=no_window)
    assert not eng._admission_batchable()
    got = eng.run([tserving.Request(uid=i, tokens=p, max_new_tokens=max_new)
                   for i, p in enumerate(_PROMPTS)])
    assert got == want


def test_dense_oracle_matches_jax(tiny_mixtral):
    """The dense-expert forward (moe._dense_moe) against the JAX package's
    on the same dense weights."""
    jcfg, tcfg, dense, _, _ = tiny_mixtral
    toks = np.random.default_rng(13).integers(0, jcfg.vocab_size,
                                              size=(1, 10)).astype(np.int32)
    lj, _ = jmoe.forward(dense, jnp.asarray(toks), jcfg)
    lt, _ = tmoe.forward(_to_torch(dense), torch.from_numpy(toks), tcfg)
    _logits_close(lt, lj, "dense forward")


def test_init_params_tree_and_device():
    """init_params builds the JAX package's tree on the generator's device,
    and quantize_params stacks every expert."""
    cfg = tmoe.MixtralConfig.tiny(num_layers=1)
    p = tmoe.init_params(cfg, torch.Generator().manual_seed(0))
    lp = p["layers"][0]
    assert set(lp) == {"attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
                       "router", "experts"}
    assert tuple(lp["experts"]["w_gate"]["w"].shape) == (4, 128, 256)
    assert tuple(lp["experts"]["w_down"]["w"].shape) == (4, 256, 128)
    assert tuple(lp["router"].shape) == (128, 4)
    assert all(t.device.type == "cpu" for t in (p["embed"], lp["router"]))
    q = tmoe.quantize_params(p, cfg)["layers"][0]["experts"]["w_gate"]
    assert tuple(q["words"].shape) == (4, 1024 // 8, 256)
    assert q["gs"].dtype == torch.float32 and tuple(q["gs"].shape) == (4,)
    assert tmoe.capacity(4, tmoe.MoEConfig()) == 8
    assert tmoe.capacity(256, tmoe.MoEConfig()) == 128


def test_params_from_jax_converts_the_moe_tree_as_it_is(tiny_mixtral):
    """Stacked expert words (E, kp/8, n) u32 -> int32, their scales bf16
    and their global scales (E,) f32, every leaf with the JAX bits."""
    _, _, _, quant, tquant = tiny_mixtral
    jlp, tlp = quant["layers"][0], tquant["layers"][0]
    for nm in ("w_gate", "w_up", "w_down"):
        j, t = jlp["experts"][nm], tlp["experts"][nm]
        assert t["words"].dtype == torch.int32
        assert t["scales"].dtype == torch.bfloat16
        assert t["gs"].dtype == torch.float32 and tuple(t["gs"].shape) == (4,)
        for key, view in (("words", np.int32), ("scales", np.int16),
                          ("gs", np.int32)):
            np.testing.assert_array_equal(
                t[key].view({np.int32: torch.int32,
                             np.int16: torch.int16}[view]).numpy(),
                np.asarray(j[key]).view(view))
    assert tlp["router"].dtype == torch.bfloat16
    assert tuple(tlp["router"].shape) == (128, 4)
