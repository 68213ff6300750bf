"""Port parity: the W4A8 path (int8 activations, FP4 weights requantized to
int8) and the weight-cache solution ids of petit_kernel_tpu_torch against
petit_kernel_tpu on the same bytes (CPU; the JAX kernels in interpret
mode, the port's wrappers through their plain twins).

Tolerances: W4A8 bit for bit. Its integer sums are exact, so every bit of
the output follows from the order of the roundings around them, which the
port takes from what XLA compiles for the JAX package: `x / 127.0` there is
a multiply by the f32 reciprocal inside jit, so the comparisons run the
JAX constants jitted, as fused_mul_w4a8 runs them. W4A8 against the exact
a16 GEMM: relative Frobenius error below 0.03, the JAX package's contract.
The bf16 weight-cache GEMM: test_torch_gemm.py's tolerance. Engines: the
first generated token equals the JAX engine's, with the top-2 logit gap
above the logits tolerance 2^-5 * max|logits|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import petit_kernel_tpu_torch as pt
from petit_kernel_tpu.models import llama as jllama
from petit_kernel_tpu.models import serving as jserving
from petit_kernel_tpu.ops import solution as jsol
from petit_kernel_tpu.ops.kernels import fused as jfused
from petit_kernel_tpu.utils.testdata import make_gemm_data
from petit_kernel_tpu_torch.models import convert
from petit_kernel_tpu_torch.models import llama as tllama
from petit_kernel_tpu_torch.models import serving as tserving
from petit_kernel_tpu_torch.ops import gemm as tgemm
from petit_kernel_tpu_torch.ops import solution as tsol
from petit_kernel_tpu_torch.ops.kernels import fused as tfused

# xdist workers share the host's cores: one torch thread each keeps
# the port's CPU ops from oversubscribing them
torch.set_num_threads(1)

SHAPES = [(256, 256, 512), (64, 128, 1024), (33, 128, 640)]
_EB = {"nvfp4": tsol.ElementB.NVFP4, "mxfp4": tsol.ElementB.MXFP4}


def _operands(d):
    words = torch.from_numpy(d.words.view(np.int32))
    st = torch.from_numpy(d.scales_t.view(np.int16)).view(torch.bfloat16)
    return (torch.from_numpy(d.a).to(torch.bfloat16), words, st,
            torch.tensor([d.global_scale], dtype=torch.float32))


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.itemsize == 2 else x


def _bf16_tensor(x):
    return torch.from_numpy(np.array(x).view(np.int16)).view(torch.bfloat16)


@pytest.mark.parametrize("fmt", sorted(_EB))
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_requant_constants_match_jax(fmt, m, n, k):
    """r_t and acol byte for byte, padded k rows included (k = 640 pads to
    1024 in both formats, k = 512 to 1024 in mxfp4)."""
    del m
    d = make_gemm_data(1, n, k, fmt, seed=n + k)
    _, _, st, _ = _operands(d)
    rj, aj = jax.jit(jfused.w4a8_requant_constants)(jnp.asarray(d.scales_t))
    rt, at = tfused.w4a8_requant_constants(st)
    assert tuple(rt.shape) == tuple(st.shape) and tuple(at.shape) == (1, n)
    np.testing.assert_array_equal(_bits(rt), _bits(rj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_activation_quantization_matches_jax(m, n, k):
    """arow and a_i8 equal to the JAX package's per-token quantization
    (fused.py:621-626, jitted as in fused_mul_w4a8), zero rows included."""
    d = make_gemm_data(m, n, k, "nvfp4", seed=m + 1)
    a = d.a.copy()
    a[m // 2] = 0.0

    @jax.jit
    def quantize(a):
        af = a.astype(jnp.float32)
        arow = jnp.max(jnp.abs(af), axis=1, keepdims=True) / 127.0
        arow = jnp.where(arow == 0, 1.0, arow)
        a_i8 = jax.lax.round(af / arow,
                             jax.lax.RoundingMethod.TO_NEAREST_EVEN
                             ).astype(jnp.int8)
        return a_i8, arow

    ji8, jrow = quantize(jnp.asarray(a, jnp.bfloat16))
    ti8, trow = tfused.quantize_activations(
        torch.from_numpy(a).to(torch.bfloat16))
    assert ti8.dtype == torch.int8 and tuple(trow.shape) == (m, 1)
    np.testing.assert_array_equal(ti8.numpy(), np.asarray(ji8))
    np.testing.assert_array_equal(trow.numpy(), np.asarray(jrow))


@pytest.mark.parametrize("precomputed", [False, True])
@pytest.mark.parametrize("fmt", sorted(_EB))
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_fused_mul_w4a8_bit_equal_to_jax(fmt, m, n, k, precomputed):
    d = make_gemm_data(m, n, k, fmt, seed=m + n + k)
    eb = jsol.ElementB(int(_EB[fmt]))
    jsid = jsol.choose_default_solution(m, n, k, eb, jsol.MatmulType.INT8)
    tsid = tsol.choose_default_solution(m, n, k, _EB[fmt],
                                        tsol.MatmulType.INT8)
    a, words, st, gs = _operands(d)
    kw, tkw = {}, {}
    if precomputed:
        r_t, acol = jax.jit(jfused.w4a8_requant_constants)(
            jnp.asarray(d.scales_t))
        kw = dict(r_t=r_t, acol=acol)
        tkw = dict(r_t=_bf16_tensor(r_t), acol=torch.from_numpy(
            np.array(acol)))
    cj = jfused.fused_mul_w4a8(
        jnp.asarray(d.a, jnp.bfloat16), jnp.asarray(d.words),
        jnp.asarray(d.scales_t), jnp.float32(d.global_scale), sid=jsid,
        interpret=True, **kw)
    ct = tfused.fused_mul_w4a8(a, words, st, gs, sid=tsid, **tkw)
    assert ct.dtype == torch.bfloat16 and tuple(ct.shape) == (m, n)
    np.testing.assert_array_equal(_bits(ct), _bits(cj))


@pytest.mark.parametrize("fmt", sorted(_EB))
def test_mul_a8_close_to_a16(fmt):
    """The JAX package's W4A8 contract (test_gemm_api.py:186-201) held by
    the port's entries against the port's exact ones."""
    mul8 = pt.mul_nvfp4_a8 if fmt == "nvfp4" else pt.mul_mxfp4_a8
    mul16 = pt.mul_nvfp4_a16 if fmt == "nvfp4" else pt.mul_mxfp4_a16
    for m, n, k in SHAPES[:2]:
        d = make_gemm_data(m, n, k, fmt, seed=m + len(fmt))
        a, words, st, gs = _operands(d)
        c8 = mul8(a, words, st, gs, m, n, k).float()
        c16 = mul16(a, words, st, gs, m, n, k).float()
        assert tuple(c8.shape) == (m, n)
        rel = float(torch.linalg.norm(c8 - c16) / torch.linalg.norm(c16))
        assert rel < 0.03, (fmt, m, n, k, rel)


def test_mul_a8_solution_ids_and_dtypes():
    m, n, k = 64, 128, 512
    d = make_gemm_data(m, n, k, "nvfp4", seed=2)
    a, words, st, gs = _operands(d)
    args = (a, words, st, gs, m, n, k)
    for mt in (tsol.MatmulType.BF16, tsol.MatmulType.FP16):
        bad = tsol.SolutionId(16, 64, mfma_type=mt).repr()
        with pytest.raises(ValueError, match="INT8"):
            pt.mul_nvfp4_a8(*args, bad)
    int8 = tsol.SolutionId(16, 64, mfma_type=tsol.MatmulType.INT8)
    wc = tsol.SolutionId(16, 64, mfma_type=tsol.MatmulType.INT8,
                         weight_cache=True)
    plain = pt.mul_nvfp4_a8(*args, int8.repr())
    assert torch.equal(pt.mul_nvfp4_a8(*args, wc.repr()).view(torch.int16),
                       plain.view(torch.int16))
    assert torch.equal(pt.mul_nvfp4_a8(*args).view(torch.int16),
                       plain.view(torch.int16))
    with pytest.raises(ValueError, match="infeasible"):
        pt.mul_nvfp4_a8(*args, tsol.SolutionId(
            64, 64, mfma_type=tsol.MatmulType.INT8, weight_cache=True).repr())
    # the output comes back in a's dtype; the empty problem gives zeros
    out = pt.mul_nvfp4_a8(a.float(), words, st, gs, m, n, k)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.to(torch.bfloat16).view(
        torch.int16).numpy(), plain.view(torch.int16).numpy())
    empty = pt.mul_nvfp4_a8(a[:0], None, None, 1.0, 0, n, k)
    assert tuple(empty.shape) == (0, n)
    # mul_fp4_diff("w4a8") runs this entry with solution -1, as in JAX
    diff = tgemm.mul_fp4_diff("w4a8", k, a, words, st, gs)
    assert torch.equal(diff.view(torch.int16), plain.view(torch.int16))


def test_fused_mul_weight_cache_matches_jax():
    """The bf16 weight-cache id through mul_nvfp4_a16 against the JAX
    package's fused_mul with its weight-cache kernel (test_kernels.py:
    183-195's case), and equal to the port's plain tile."""
    m, n, k = 48, 256, 1024
    d = make_gemm_data(m, n, k, "nvfp4", seed=7)
    a, words, st, gs = _operands(d)
    cj = np.asarray(jfused.fused_mul(
        jnp.asarray(d.a, jnp.bfloat16), jnp.asarray(d.words),
        jnp.asarray(d.scales_t), jnp.float32(d.global_scale),
        sid=jsol.SolutionId(16, 128, 512, weight_cache=True),
        interpret=True), np.float32)
    wc = tsol.SolutionId(16, 64, weight_cache=True)
    ct = pt.mul_nvfp4_a16(a, words, st, gs, m, n, k, wc.repr())
    np.testing.assert_allclose(ct.float().numpy(), cj, rtol=2 ** -7,
                               atol=2 ** -8 * np.abs(cj).max())
    plain = pt.mul_nvfp4_a16(a, words, st, gs, m, n, k,
                             tsol.SolutionId(16, 64).repr())
    assert torch.equal(ct.view(torch.int16), plain.view(torch.int16))


def test_weight_cache_solution_rules():
    """The repr round-trips with the bit set; a weight-cache id needs more
    than one m-tile; the heuristic never picks one; get_fp4_solutions
    lists them; the grouped kernel refuses them."""
    for bm, bn in tsol.TILE_SHAPES:
        for mt in tsol.MatmulType:
            sid = tsol.SolutionId(bm, bn, tsol.ElementB.MXFP4, mt,
                                  weight_cache=True)
            assert tsol.SolutionId.from_repr(sid.repr()) == sid
            assert sid.repr() != tsol.SolutionId(bm, bn, tsol.ElementB.MXFP4,
                                                 mt).repr()
            assert not tsol.is_feasible(sid, bm, 4096, 4096)
            assert tsol.is_feasible(sid, bm + 1, 4096, 4096)
    for m in (1, 17, 256, 2048):
        assert not tsol.choose_default_solution(m, 4096, 4096).weight_cache
    sols = [tsol.SolutionId.from_repr(r)
            for r in pt.get_fp4_solutions(100, 256, 512)]
    assert any(s.weight_cache for s in sols)
    assert all(s.block_m < 100 for s in sols if s.weight_cache)
    assert not any(s.weight_cache for s in map(
        tsol.SolutionId.from_repr, pt.get_fp4_solutions(16, 256, 512)))
    wc = tsol.SolutionId(16, 64, weight_cache=True).repr()
    with pytest.raises(ValueError, match="weight_cache"):
        tgemm.resolve_grouped_solution(64, 256, 512, tsol.ElementB.NVFP4, wc)


@pytest.fixture(scope="module")
def tiny():
    cfg = jllama.LlamaConfig.tiny()
    quant = jllama.quantize_params(
        jllama.init_params(cfg, jax.random.PRNGKey(1)), "nvfp4")
    tquant = convert.params_from_jax(jax.tree.map(np.asarray, quant),
                                     device="cpu")
    return cfg, quant, tquant


def test_linear_w4a8_routes_by_rows(tiny, monkeypatch):
    """Below W4A8_MIN_M rows linear(fmt="w4a8") is the exact nvfp4 GEMM bit
    for bit; at or above it, the JAX package's linear(fmt="w4a8") bit for
    bit, with and without precomputed constants (test_serving.py:537-559's
    case, the threshold lowered in the test only)."""
    _, quant, tquant = tiny
    jl, tl = quant["layers"][0]["wqkv"], tquant["layers"][0]["wqkv"]
    x = np.random.default_rng(3).standard_normal((4, 256)) / 8
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    assert tllama.W4A8_MIN_M == 256 == jllama.W4A8_MIN_M
    y8 = tllama.linear(xt, tl, fmt="w4a8")
    y4 = tllama.linear(xt, tl, fmt="nvfp4")
    assert torch.equal(y8.view(torch.int16), y4.view(torch.int16))
    monkeypatch.setattr(tllama, "W4A8_MIN_M", 4)
    monkeypatch.setattr(jllama, "W4A8_MIN_M", 4)
    y8 = tllama.linear(xt, tl, fmt="w4a8")
    assert not torch.equal(y8.view(torch.int16), y4.view(torch.int16))
    want = jllama.linear(xj, jl, fmt="w4a8", interpret=True)
    np.testing.assert_array_equal(_bits(y8), _bits(want))
    r_t, acol = tfused.w4a8_requant_constants(tl["scales"])
    got = tllama.linear(xt, {**tl, "r_t": r_t, "acol": acol}, fmt="w4a8")
    want = jllama.linear(xj, {**jl, "r_t": jnp.asarray(_bits(r_t)).view(
        jnp.bfloat16), "acol": jnp.asarray(acol.numpy())}, fmt="w4a8",
        interpret=True)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(y8))


# seeded prompts whose W4A8 prefill logits have a clear top-2 gap on the
# tiny model
_PROMPTS = [np.array([8, 46, 388, 76, 262, 460, 475, 137, 33, 253, 430, 319,
                      34, 332, 176, 115, 220, 447, 494, 72, 287, 389, 132],
                     np.int32),
            np.array([472, 497, 136, 218, 275, 336, 226, 76, 476, 354, 20,
                      416, 374, 93, 314, 256, 14, 474, 368], np.int32)]


@pytest.mark.parametrize("engine", ["Engine", "PagedEngine"])
def test_w4a8_prefill_engine_first_tokens_match_jax(tiny, monkeypatch,
                                                     engine):
    """prefill_fmt="w4a8" with W4A8_MIN_M lowered to 16 in both packages,
    so every prefill chunk (16 rows and more) takes the int8 path and
    decode (2 rows) the exact one. The first token of each request comes
    from W4A8 prefill logits and equals the JAX engine's; the port's
    full-sequence W4A8 forward gives it with a top-2 gap above the logits
    tolerance."""
    cfg, quant, tquant = tiny
    monkeypatch.setattr(tllama, "W4A8_MIN_M", 16)
    monkeypatch.setattr(jllama, "W4A8_MIN_M", 16)
    kw = dict(page_size=16) if engine == "PagedEngine" else {}
    jeng = getattr(jserving, engine)(quant, cfg, max_batch=2,
                                     prefill_fmt="w4a8", **kw)
    want = jeng.run([jserving.Request(uid=i, tokens=p, max_new_tokens=2)
                     for i, p in enumerate(_PROMPTS)])
    teng = getattr(tserving, engine)(tquant, cfg, max_batch=2,
                                     prefill_fmt="w4a8", **kw)
    assert teng.prefill_fmt == "w4a8" and teng.fmt == "nvfp4"
    got = teng.run([tserving.Request(uid=i, tokens=p, max_new_tokens=2)
                    for i, p in enumerate(_PROMPTS)])
    assert sorted(got) == sorted(want) == [0, 1]
    for uid, prompt in enumerate(_PROMPTS):
        assert len(got[uid]) == 2
        assert got[uid][0] == want[uid][0], uid
        lt, _ = tllama.forward(teng.params, torch.from_numpy(prompt)[None],
                               cfg, fmt="w4a8")
        lt = lt[0, -1].float().numpy()
        assert lt.argmax() == got[uid][0]
        top2 = np.sort(lt)[-2:]
        assert top2[1] - top2[0] > 2 ** -5 * np.abs(lt).max(), uid
    if engine == "PagedEngine":
        assert teng.pages_in_use() == 0


def test_w4a8_engine_construction(tiny):
    """The requantization constants are added without copying weights;
    prefill_chunk defaults to min(512, max_seq_len); a prefill_fmt of
    another container raises, as in the JAX package."""
    cfg, _, tquant = tiny
    eng = tserving.Engine(tquant, cfg, max_batch=1, prefill_fmt="w4a8")
    assert eng.prefill_chunk == min(512, cfg.max_seq_len) == 128
    lp, tp = eng.params["layers"][0], tquant["layers"][0]
    for name in ("wqkv", "wo", "w_gateup", "w_down"):
        assert lp[name]["words"] is tp[name]["words"]
        assert lp[name]["scales"] is tp[name]["scales"]
        r_t, acol = tfused.w4a8_requant_constants(tp[name]["scales"])
        assert torch.equal(lp[name]["r_t"].view(torch.int16),
                           r_t.view(torch.int16))
        assert torch.equal(lp[name]["acol"], acol)
        assert "r_t" not in tp[name]
    assert eng.params["embed"] is tquant["embed"]
    big = tllama.LlamaConfig.tiny(max_seq_len=1024)
    assert tserving.Engine(tquant, big, max_batch=1, prefill_fmt="w4a8"
                           ).prefill_chunk == 512
    assert tserving.Engine(tquant, big, max_batch=1).prefill_chunk is None
    for cls in (tserving.Engine, tserving.PagedEngine):
        with pytest.raises(ValueError, match="container"):
            cls(tquant, cfg, fmt="mxfp4", prefill_fmt="w4a8")
