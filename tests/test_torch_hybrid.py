"""Port parity: hybrid FP4 + BF16 serving in petit_kernel_tpu_torch against
petit_kernel_tpu on the same bytes (CPU).

quantize_hybrid is held byte for byte on f32 weights, whose column
saliences do not tie (the JAX package sorts with numpy's unstable default,
so tied columns at the cut could split differently); every other parity
converts the JAX package's own quantized tree (convert.params_from_jax),
so the split is the same by construction. Tolerances: mul_hybrid at the
GEMM's rtol 2^-7 with atol 2^-8 * max|ref| (both halves sum exact bf16
products in f32 in other orders and round once); logits within 2^-5 *
max|logits| (test_torch_llama.py); the engines' greedy streams equal,
except after a step whose JAX top-2 logit gap is below that tolerance
(test_torch_serving.py). The decode kernel's split choice (hybrid_splits:
k ranges of whole 256-deep steps, as many splits as fit one wave of two
CTAs per SM of a 132-SM card) and hybrid_mul's check of an explicit
`splits` need no JAX counterpart: the TPU kernel walks k in one grid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petit_kernel_tpu.models import llama as jllama
from petit_kernel_tpu.models import serving as jserving
from petit_kernel_tpu.ops import hybrid as jhybrid
from petit_kernel_tpu_torch.models import convert
from petit_kernel_tpu_torch.models import llama as tllama
from petit_kernel_tpu_torch.models import serving as tserving
from petit_kernel_tpu_torch.ops import hybrid as thybrid
from petit_kernel_tpu_torch.ops import layout as tlayout
from petit_kernel_tpu_torch.ops import solution as tsol
from petit_kernel_tpu_torch.ops.kernels import hybrid as khybrid

# xdist workers share the host's cores: one torch thread each keeps
# the port's CPU ops from oversubscribing them
torch.set_num_threads(1)

# tests/test_hybrid.py's shapes: (m, n, k, block_nf, block_nd)
_SHAPES = [(16, 512, 512, 256, 256), (16, 1024, 1024, 384, 128),
           (33, 2048, 768, 256, 256)]


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.dtype(f"i{x.element_size()}"))
    x = np.asarray(x)
    return x.view(np.dtype(f"i{x.dtype.itemsize}"))


def _weights(n, k, seed):
    """f32 (k, n) with a few clearly salient columns (test_hybrid.py)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32) / 8
    w[:, rng.choice(n, 5, replace=False)] *= 50
    return w, rng


@pytest.mark.parametrize("m,n,k,bnf,bnd", _SHAPES)
def test_quantize_hybrid_bytes_match_jax(m, n, k, bnf, bnd):
    w, _ = _weights(n, k, m + n + k)
    want = jhybrid.quantize_hybrid(w, block_nf=bnf, block_nd=bnd)
    got = thybrid.quantize_hybrid(torch.from_numpy(w), block_nf=bnf,
                                  block_nd=bnd)
    for key in ("words", "scales", "gs", "inv_perm"):
        np.testing.assert_array_equal(_bits(got[key]), _bits(want[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(
        _bits(got["wd"]), _bits(convert.unpermute_k(np.asarray(want["wd"]))))
    assert got["meta"] == thybrid.HybridMeta(bnf, bnd, k)


@pytest.mark.parametrize("m,n,k,bnf,bnd", _SHAPES)
def test_mul_hybrid_matches_jax(m, n, k, bnf, bnd):
    """Through a JAX hybrid layer converted with params_from_jax: a wd left
    in the JAX kernel's k order would give a wrong product of the right
    shape."""
    w, rng = _weights(n, k, m + n + k)
    hq = jhybrid.quantize_hybrid(w, block_nf=bnf, block_nd=bnd)
    a = rng.standard_normal((m, k)).astype(np.float32)
    want = np.asarray(jhybrid.mul_hybrid(jnp.asarray(a, jnp.bfloat16), hq,
                                         interpret=True), np.float32)
    layer = convert.params_from_jax(jax.tree.map(np.asarray, hq),
                                    device="cpu")
    assert isinstance(layer["meta"], thybrid.HybridMeta)
    assert layer["inv_perm"].dtype == torch.int32
    got = thybrid.mul_hybrid(torch.from_numpy(a).to(torch.bfloat16), layer)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -8 * np.abs(want).max())


# tests/test_hybrid.py's model: wq, wk and wv (n = 256, 128) fall back to
# nvfp4, wo, w_gate, w_up and w_down split
_CFG = dict(vocab_size=128, hidden_size=512, intermediate_size=1024,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64)


@pytest.fixture(scope="module")
def models():
    cfg = jllama.LlamaConfig(max_seq_len=128, **_CFG)
    quant = jllama.quantize_params(
        jllama.init_params(cfg, jax.random.PRNGKey(0)), "hybrid")
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, quant),
                                      device="cpu")
    return cfg, quant, tparams


def test_quantize_params_hybrid_splits_like_jax(models):
    """The port's quantize_params(..., "hybrid") keeps the 7 projections
    unfused and splits the layers the JAX package splits."""
    cfg, quant, _ = models
    dense = tllama.init_params(cfg, torch.Generator().manual_seed(0))
    got = tllama.quantize_params(dense, "hybrid")["layers"][0]
    for name, layer in quant["layers"][0].items():
        if isinstance(layer, dict):
            assert ("wd" in got[name]) == ("wd" in layer), name
    assert "wd" in got["w_up"] and "wd" not in got["wk"]
    assert got["w_up"]["meta"] == thybrid.HybridMeta(768, 256, 512)


def test_llama_forward_hybrid_matches_jax(models):
    cfg, quant, tparams = models
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(1, 8))
    want, _ = jllama.forward(quant, jnp.asarray(toks, jnp.int32), cfg,
                             fmt="hybrid", interpret=True)
    got, _ = tllama.forward(tparams, torch.from_numpy(toks), cfg,
                            fmt="hybrid")
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2 ** -5 * np.abs(want).max(), err


def test_engine_hybrid_streams_match_jax_engine(models):
    """Two greedy requests (9 and 20 prompt tokens, 4 new tokens each)
    through Engine(max_batch=2, fmt="hybrid") in both packages."""
    cfg, quant, tparams = models
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (9, 20)]

    def requests(mod):
        return [mod.Request(uid=i, tokens=p, max_new_tokens=4)
                for i, p in enumerate(prompts)]

    want = jserving.Engine(quant, cfg, max_batch=2, fmt="hybrid").run(
        requests(jserving))
    got = tserving.Engine(tparams, cfg, max_batch=2, fmt="hybrid").run(
        requests(tserving))
    assert sorted(got) == sorted(want) == [0, 1]
    for uid, prompt in enumerate(prompts):
        sj, st = want[uid], got[uid]
        assert len(st) == len(sj) == 4
        diff = [i for i, (a, b) in enumerate(zip(sj, st)) if a != b]
        if not diff:
            continue
        i = diff[0]
        toks = np.concatenate([prompt, np.asarray(sj[:i], np.int32)])
        logits, _ = jllama.forward(quant, jnp.asarray(toks)[None], cfg,
                                   fmt="hybrid", interpret=True)
        lg = np.asarray(logits[0, -1], np.float32)
        top2 = np.sort(lg)[-2:]
        gap = float(top2[1] - top2[0])
        bound = 2 ** -5 * float(np.abs(lg).max())
        assert gap < bound, (f"request {uid} diverges at token {i} with a "
                             f"top-2 gap {gap} >= {bound}")


def test_engine_hybrid_refuses_another_prefill_fmt(models):
    cfg, _, tparams = models
    with pytest.raises(ValueError, match="prefill_fmt"):
        tserving.Engine(tparams, cfg, max_batch=1, fmt="hybrid",
                        prefill_fmt="nvfp4")


# hybrid_splits at the seven unfused Llama-3-8B projections (k, n), split
# 3:1 as quantize_params(..., "hybrid") splits them, and at the card tests'
# shapes (tests/test_torch_cuda.py: (m, n, k, block_nf, block_nd))
_LLAMA8B_UNFUSED_KN = ((4096, 4096), (4096, 1024), (4096, 1024),
                       (4096, 4096), (4096, 14336), (4096, 14336),
                       (14336, 4096))
_CUDA_SHAPES = ((1, 512, 512, 384, 128), (37, 1024, 640, 768, 256),
                (70, 2048, 1024, 1536, 512))
_H100_SMS = 132


def _split_ranges(steps, splits):
    """csrc/hybrid_gemm.cu's k ranges: split s of a tile covers the steps
    [s * steps // splits, (s + 1) * steps // splits)."""
    return [(s * steps // splits, (s + 1) * steps // splits)
            for s in range(splits)]


def _split_cases():
    cases = []
    for k, n in dict.fromkeys(_LLAMA8B_UNFUSED_KN):
        for m in (1, 4, 8, 16):
            cases.append((m, 3 * n // 4, n // 4, k))
    for m, n, k, bnf, bnd in _CUDA_SHAPES:
        nd = n // (bnf + bnd) * bnd
        cases.append((m, n - nd, nd, tlayout.padded_k(k)))
    return cases


@pytest.mark.parametrize("bn", [64, 128])
@pytest.mark.parametrize("m,nf,nd,kp", _split_cases())
def test_hybrid_splits_partition_k_and_fill_two_waves(m, nf, nd, kp, bn):
    steps = kp // khybrid.KSTEP
    sf, sd = khybrid.hybrid_splits(m, nf, nd, kp, 16, bn, _H100_SMS)
    for s in (sf, sd):
        assert 1 <= s <= steps
        ranges = _split_ranges(steps, s)
        assert ranges[0][0] == 0 and ranges[-1][1] == steps
        assert all(r0 < r1 for r0, r1 in ranges)               # none empty
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    def ctas(sf):
        sd = min(steps, max(1, round(3.2 * sf)))
        return -(-m // 16) * (-(-nf // bn) * sf + -(-nd // bn) * sd)

    # the most splits that fit one wave of two CTAs per SM, at least one
    assert ctas(sf) <= 2 * _H100_SMS or sf == 1, (sf, sd, ctas(sf))
    assert sf == steps or ctas(sf + 1) > 2 * _H100_SMS, (sf, sd, ctas(sf))
    # the dense tiles take about 3.2 times the FP4 tiles' splits
    assert sd == min(steps, max(1, round(3.2 * sf)))


@pytest.mark.parametrize("bn", [64, 128])
def test_hybrid_splits_one_at_block_m_64(bn):
    for k, n in dict.fromkeys(_LLAMA8B_UNFUSED_KN):
        assert khybrid.hybrid_splits(512, 3 * n // 4, n // 4, k, 64, bn,
                                     _H100_SMS) == (1, 1)


def test_hybrid_mul_cpu_validates_splits():
    """On CPU tensors an explicit `splits` is checked like on the card and
    the reference comes back unchanged."""
    w, rng = _weights(512, 640, 3)
    hq = thybrid.quantize_hybrid(torch.from_numpy(w), block_nf=384,
                                 block_nd=128)
    a = torch.from_numpy(rng.standard_normal((5, 640)).astype(
        np.float32)).to(torch.bfloat16)
    args = (a, hq["words"], hq["scales"], hq["gs"].reshape(1), hq["wd"])
    want = khybrid.hybrid_mul_reference(*args, sid=tsol.SolutionId(16, 64))
    steps = hq["words"].shape[0] * 8 // khybrid.KSTEP             # kp 1024
    for splits in (1, 3, steps, None):
        got = khybrid.hybrid_mul(*args, sid=tsol.SolutionId(16, 64),
                                 splits=splits)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(_bits(g), _bits(w_))
    for bad in (0, steps + 1, (1, 2), 1.0, "2"):
        with pytest.raises(ValueError, match="splits"):
            khybrid.hybrid_mul(*args, sid=tsol.SolutionId(16, 64),
                               splits=bad)
    assert khybrid.hybrid_mul(*args, sid=tsol.SolutionId(64, 128),
                              splits=1)[0].shape == (5, 384)
    with pytest.raises(ValueError, match="do not split"):
        khybrid.hybrid_mul(*args, sid=tsol.SolutionId(64, 128), splits=2)
