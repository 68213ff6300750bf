"""Llama-3 family inference model with NVFP4/MXFP4 weight-only linears
(torch).

Counterpart of petit_kernel_tpu/models/llama.py. Weights are a plain dict
tree of tensors, as there:
  dense linear    : {"w": bf16 (k, n)} (+ optional "b" bias)
  quantized linear: {"words": int32 (kp/8, n), "scales": bf16 (kp/16, n),
                     "gs": f32 0-dim tensor}
  hybrid linear   : {"words", "scales", "gs" of the FP4 columns, "wd": bf16
                     (kp, nd) dense columns, "inv_perm": int32 (n,),
                     "meta": ops.hybrid.HybridMeta} (quantize_params(...,
                     "hybrid"); ops/hybrid.py)
FP4 projections run through the differentiable GEMM gemm.mul_fp4_diff, so
a forward without a cache is differentiable: gradients reach the
activations, the dense leaves (embed, norms, lm_head) and each layer's
global scale "gs", never the frozen words and scales; the backward runs the
dequant kernel on the card. The serving engines call forward under
torch.inference_mode(). fmt="w4a8" runs the nvfp4 container through the
W4A8 GEMM (int8 activations) at m >= W4A8_MIN_M rows and through the exact
nvfp4 GEMM below it. Hybrid layers run ops/hybrid.mul_hybrid, whatever fmt
is; a fmt outside the pure formats (such as "hybrid" for a layer too
narrow to split) runs nvfp4. The KV cache is a
list of per-layer (k, v) tensors that forward updates IN PLACE (the JAX
package returns new arrays and donates the old): flat (B, S, Hkv, d) bf16,
or headed (B, Hkv, S, d) bf16 or fp8 e4m3 (init_cache). On the card the
decode step runs the decode-attention and KV-append kernels of the cache's
layout, and cached prefill the flash-prefill kernel; on the CPU their plain
twins run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..numerics import reference as ref_numerics
from ..ops import gemm as gemm_mod
from ..ops import hybrid as hybrid_mod
from ..ops import layout as layout_mod
from ..ops.kernels import attention as attn_mod


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    max_seq_len: int = 2048
    attn_bias: bool = False     # Qwen2-style bias on q/k/v projections

    @staticmethod
    def llama3_8b(**kw):
        return LlamaConfig(**{**dict(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128), **kw})

    @staticmethod
    def llama3_70b(**kw):
        return LlamaConfig(**{**dict(
            vocab_size=128256, hidden_size=8192, intermediate_size=28672,
            num_layers=80, num_heads=64, num_kv_heads=8, head_dim=128), **kw})

    @staticmethod
    def qwen2_7b(**kw):
        """Qwen2/Qwen2.5-7B: Llama architecture + QKV bias, 1e6 rope."""
        return LlamaConfig(**{**dict(
            vocab_size=152064, hidden_size=3584, intermediate_size=18944,
            num_layers=28, num_heads=28, num_kv_heads=4, head_dim=128,
            rope_theta=1e6, rms_eps=1e-6, attn_bias=True), **kw})

    @staticmethod
    def tiny(**kw):
        """Small config for tests; same code path."""
        return LlamaConfig(**{**dict(
            vocab_size=512, hidden_size=256, intermediate_size=512,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
            max_seq_len=128), **kw})


# ---------------------------------------------------------------------------
# Linear layers
# ---------------------------------------------------------------------------

_QUANTIZERS = {
    "nvfp4": (ref_numerics.quantize_nvfp4, 16),
    "nvfp4p2": (ref_numerics.quantize_nvfp4_pow2, 16),
    "nvfp4p2z": (ref_numerics.quantize_nvfp4_pow2z, 16),
    "mxfp4": (ref_numerics.quantize_mxfp4, 32),
    "mxfp4z": (ref_numerics.quantize_mxfp4z, 32),
    "w4a8": (ref_numerics.quantize_nvfp4, 16),    # the nvfp4 container
}

# (block_nf, block_nd) of fmt="hybrid", widest first; a layer falls back to
# nvfp4 when no pair divides its n
_HYBRID_BLOCKS = ((1536, 512), (768, 256), (384, 128))

# fmt="w4a8" routes a projection of fewer rows than this to the exact nvfp4
# GEMM. 256 is the JAX package's value, kept for parity; the H100's own
# crossover is measured in chip_smoke.py and recorded in PERF.md.
W4A8_MIN_M = 256


def quantize_linear(w_kn: torch.Tensor, fmt: str = "nvfp4") -> dict:
    """Dense (k, n) -> quantized FP4 layer dict, on w_kn's device.
    fmt="hybrid" keeps the most salient columns dense (ops/hybrid.py) with
    the widest _HYBRID_BLOCKS pair that divides n, and falls back to nvfp4
    for a layer too narrow to split."""
    if fmt == "hybrid":
        n = w_kn.shape[1]
        for bnf, bnd in _HYBRID_BLOCKS:
            if n % (bnf + bnd) == 0:
                return hybrid_mod.quantize_hybrid(w_kn, block_nf=bnf,
                                                  block_nd=bnd)
        fmt = "nvfp4"
    if fmt not in _QUANTIZERS:
        raise ValueError(f"unsupported format {fmt!r}")
    quantize, group = _QUANTIZERS[fmt]
    w = w_kn.float().T                     # (n, k): checkpoint orientation
    qw, scales, gs = quantize(w)
    n, k = w.shape
    words = layout_mod.repack_fp4_weights(
        qw, n, k, pad_to=layout_mod.pad_multiple(group))
    st = layout_mod.process_fp4_scales(scales, n, k, group_size=group)
    return {"words": words, "scales": st, "gs": gs.reshape(())}


def linear(x: torch.Tensor, layer: dict, *, fmt: str = "nvfp4"
           ) -> torch.Tensor:
    """y = x @ W (+ b) for dense, FP4-quantized or hybrid layer dicts; x
    (..., k). A bias ("b", Qwen2 QKV) is added in x.dtype after the matmul.
    FP4 layers run gemm.mul_fp4_diff in fmt, or in nvfp4 when fmt is not a
    pure format. fmt="w4a8": fewer than W4A8_MIN_M rows run the exact
    nvfp4 GEMM, and a layer with precomputed "r_t"/"acol" (serving engines
    add them) runs mul_nvfp4_a8 with them, outside the gradient path.
    Hybrid layers (with "wd") run mul_hybrid."""
    *lead, k = x.shape
    if "w" in layer:
        y = torch.matmul(x, layer["w"].to(x.dtype))
    else:
        m = math.prod(lead)
        x2 = x.reshape(m, k)
        if "wd" in layer:
            y = hybrid_mod.mul_hybrid(x2.to(torch.bfloat16), layer).to(
                x.dtype)
        else:
            n = layer["words"].shape[1]
            pure = fmt if fmt in _QUANTIZERS else "nvfp4"
            if pure == "w4a8" and m < W4A8_MIN_M:
                pure = "nvfp4"
            if pure == "w4a8" and "r_t" in layer:
                y = gemm_mod.mul_nvfp4_a8(
                    x2, layer["words"], layer["scales"], layer["gs"], m, n,
                    k, -1, r_t=layer["r_t"], acol=layer["acol"])
            else:
                y = gemm_mod.mul_fp4_diff(pure, k, x2, layer["words"],
                                          layer["scales"], layer["gs"])
        y = y.reshape(*lead, y.shape[-1])
    if "b" in layer:
        y = y + layer["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def resolve_device(device=None) -> torch.device:
    """The device an entry point builds on: `device` when given, else the
    CUDA card. Without a card and without an explicit device it raises:
    the port's entry points never fall back to the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (or a CPU "
                           "generator) to build on the CPU")
    return torch.device("cuda")


def normal(generator: torch.Generator, shape, scale: float) -> torch.Tensor:
    """bf16(normal * scale) from `generator`, on its device."""
    t = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return (t * scale).to(torch.bfloat16)


def _dense(generator, k, n, scale=None, bias=False) -> dict:
    out = {"w": normal(generator, (k, n), scale or 1.0 / math.sqrt(k))}
    if bias:
        out["b"] = normal(generator, (n,), 0.02)
    return out


def init_layer(cfg: LlamaConfig, generator: torch.Generator, *,
               mlp: bool = True) -> dict:
    """One decoder layer of init_params' tree: unit norms, attention
    projections (normal * 1/sqrt(k), biases normal * 0.02) and, with mlp,
    the SwiGLU projections."""
    h, q = cfg.hidden_size, cfg.num_heads * cfg.head_dim
    kv = cfg.num_kv_heads * cfg.head_dim
    f = cfg.intermediate_size
    g = generator

    def ones():
        return torch.ones((h,), dtype=torch.bfloat16, device=g.device)

    lp = {
        "attn_norm": ones(),
        "wq": _dense(g, h, q, bias=cfg.attn_bias),
        "wk": _dense(g, h, kv, bias=cfg.attn_bias),
        "wv": _dense(g, h, kv, bias=cfg.attn_bias),
        "wo": _dense(g, q, h),
        "mlp_norm": ones(),
    }
    if mlp:
        lp.update(w_gate=_dense(g, h, f), w_up=_dense(g, h, f),
                  w_down=_dense(g, f, h))
    return lp


def init_params(cfg: LlamaConfig, generator: torch.Generator) -> dict:
    """Random dense bf16 params from `generator`, on the generator's device
    (a CPU generator asks for the CPU), in the JAX package's tree and
    scales: init_layer's layers, normal * 0.02 embedding and lm_head, unit
    final norm."""
    layers = [init_layer(cfg, generator) for _ in range(cfg.num_layers)]
    h = cfg.hidden_size
    return {
        "embed": normal(generator, (cfg.vocab_size, h), 0.02),
        "layers": layers,
        "final_norm": torch.ones((h,), dtype=torch.bfloat16,
                                 device=generator.device),
        "lm_head": _dense(generator, h, cfg.vocab_size, scale=0.02),
    }


_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _fused_projections(lp: dict, fmt: str) -> dict:
    """wq|wk|wv and w_gate|w_up concatenated along n and quantized as one
    wide projection each (split back in attention() / mlp())."""
    out = {
        "wqkv": quantize_linear(torch.cat(
            [lp[nm]["w"] for nm in ("wq", "wk", "wv")], dim=1), fmt),
        "w_gateup": quantize_linear(torch.cat(
            [lp["w_gate"]["w"], lp["w_up"]["w"]], dim=1), fmt),
        "wo": quantize_linear(lp["wo"]["w"], fmt),
        "w_down": quantize_linear(lp["w_down"]["w"], fmt),
    }
    if "b" in lp["wq"]:
        out["wqkv"]["b"] = torch.cat([lp[nm]["b"] for nm in ("wq", "wk",
                                                              "wv")])
    return out


def quantize_params(params: dict, fmt: str = "nvfp4") -> dict:
    """Quantize every projection weight to FP4; embed and lm_head stay
    dense. wq|wk|wv and w_gate|w_up are fused along n, so a layer runs 4
    GEMM launches instead of 7; fmt="hybrid" quantizes the 7 projections
    one by one (quantize_linear), as the JAX package does, each with its
    bias where it has one."""
    out = {"embed": params["embed"], "final_norm": params["final_norm"],
           "lm_head": params["lm_head"], "layers": []}
    for lp in params["layers"]:
        for nm in _QUANT_KEYS:
            k, n = lp[nm]["w"].shape
            if k % 128 or n % 16:
                raise ValueError(f"{nm} ({k}, {n}): FP4 layers need k % 128 "
                                 "== 0 and n % 16 == 0")
        q = {k: v for k, v in lp.items() if k not in _QUANT_KEYS}
        if fmt == "hybrid":
            for nm in _QUANT_KEYS:
                q[nm] = quantize_linear(lp[nm]["w"], fmt)
                if "b" in lp[nm]:
                    q[nm]["b"] = lp[nm]["b"]
        else:
            q.update(_fused_projections(lp, fmt))
        out["layers"].append(q)
    return out


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalise in f32, cast to x.dtype, then multiply by the weight (the
    JAX package's order)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def _rope_angles(pos: torch.Tensor, d: int, theta: float):
    """(cos, sin), each (B, T, 1, d/2) f32, for absolute positions (B, T)."""
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=pos.device) / d))
    ang = pos[:, :, None, None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def _rope_apply(x: torch.Tensor, cs) -> torch.Tensor:
    """Rotary embedding on INTERLEAVED pairs x[..., ::2] / x[..., 1::2];
    x (B, T, H, d), computed in f32 and cast back."""
    cos, sin = cs
    x1, x2 = x[..., ::2], x[..., 1::2]
    xr1 = x1 * cos - x2 * sin
    xr2 = x1 * sin + x2 * cos
    return torch.stack([xr1, xr2], dim=-1).reshape(x.shape).to(x.dtype)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, T, H, d), pos: (B, T) absolute positions."""
    return _rope_apply(x, _rope_angles(pos, x.shape[-1], theta))


def _write_kv(ck, cv, k, v, pos, write_mask, headed):
    """Write a T-token chunk's K/V (B, T, Hkv, d) at positions pos (B, T)
    into a flat or headed cache, in place, cast once to the cache dtype:
    one kv_append launch for every T on the card. Rows with write_mask[b]
    False keep their content."""
    attn_mod.kv_append(ck, cv, k, v, pos, write_mask, headed=headed)


def _qkv(x, lp, pos, cfg: LlamaConfig, *, fmt: str, rope_cs=None):
    """q (B, T, H, d), k and v (B, T, Hkv, d) of a block, RoPE applied to
    q and k."""
    B, T, _ = x.shape
    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if "wqkv" in lp:
        qkv = linear(x, lp["wqkv"], fmt=fmt)
        s0, s1 = nq * d, (nq + nkv) * d
        q = qkv[..., :s0].reshape(B, T, nq, d)
        k = qkv[..., s0:s1].reshape(B, T, nkv, d)
        v = qkv[..., s1:].reshape(B, T, nkv, d)
    else:
        q = linear(x, lp["wq"], fmt=fmt).reshape(B, T, nq, d)
        k = linear(x, lp["wk"], fmt=fmt).reshape(B, T, nkv, d)
        v = linear(x, lp["wv"], fmt=fmt).reshape(B, T, nkv, d)
    if rope_cs is None:
        rope_cs = _rope_angles(pos, d, cfg.rope_theta)
    qk = _rope_apply(torch.cat([q, k], dim=2), rope_cs)
    return qk[:, :, :nq], qk[:, :, nq:], v


def attention(x, lp, cache, pos, cfg: LlamaConfig, *, fmt: str,
              kv_window: Optional[int] = None,
              write_mask: Optional[torch.Tensor] = None, rope_cs=None):
    """Self-attention block. With a cache (which needs kv_window), flat or
    headed, a decode step (T == 1) runs decode attention over the first
    window positions and a chunk (T > 1) runs flash prefill; without one, a
    causal f32 softmax over the sequence itself."""
    B, T, _ = x.shape
    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cache is not None and kv_window is None:
        raise ValueError("attention with a cache needs kv_window: the "
                         "cached path runs only the decode and prefill "
                         "kernels")
    q, k, v = _qkv(x, lp, pos, cfg, fmt=fmt, rope_cs=rope_cs)

    if cache is not None:
        ck, cv = cache
        headed = cache_is_headed(ck, cfg)
        _write_kv(ck, cv, k, v, pos, write_mask, headed)
        S = ck.shape[2] if headed else ck.shape[1]
        nblk = min(-(-kv_window // 128), -(-S // 128))
        pos0 = pos[:, 0].to(torch.int32).contiguous()
        if T == 1:
            dec = (attn_mod.decode_attention_contiguous_headed if headed
                   else attn_mod.decode_attention_contiguous)
            o = dec(q.reshape(B, nq, d), ck, cv, pos0, nb=nblk,
                    page_size=128)
        else:
            o = attn_mod.flash_prefill_attention(q, ck, cv, pos0, ns=nblk,
                                                 block_s=128, headed=headed)
        o = o.reshape(B, T, nq * d).to(x.dtype)
        return linear(o, lp["wo"], fmt=fmt)
    attn_mask = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                      device=x.device))[None, None]
    rep = nq // nkv
    k_all = k.repeat_interleave(rep, dim=2)
    v_all = v.repeat_interleave(rep, dim=2)
    qf = q.float() / math.sqrt(d)
    logits = torch.einsum("bthd,bshd->bhts", qf, k_all.float())
    logits = torch.where(attn_mask, logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhts,bshd->bthd", p, v_all.float())
    o = o.reshape(B, T, nq * d).to(x.dtype)
    return linear(o, lp["wo"], fmt=fmt)


def mlp(x, lp, *, fmt: str):
    """SwiGLU: SiLU in f32, cast back before the multiply by u."""
    if "w_gateup" in lp:
        g, u = linear(x, lp["w_gateup"], fmt=fmt).chunk(2, dim=-1)
    else:
        g = linear(x, lp["w_gate"], fmt=fmt)
        u = linear(x, lp["w_up"], fmt=fmt)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return linear(h, lp["w_down"], fmt=fmt)


def forward(params, tokens, cfg: LlamaConfig, cache=None, pos=None, *,
            fmt: str = "nvfp4", kv_window: Optional[int] = None,
            write_mask: Optional[torch.Tensor] = None):
    """tokens (B, T) -> (logits (B, T, V), cache). cache: list of per-layer
    (k, v) tensors, updated in place and returned, or None for a
    full-sequence forward. kv_window, required with a cache: attend
    through the decode (T == 1) or flash-prefill (T > 1) kernel over the
    first ceil(kv_window/128)*128 positions (engines pass the batch's
    bucketed max length). write_mask (B,) bool: rows with False keep their KV cache
    bit-exact."""
    B, T = tokens.shape
    x = params["embed"][tokens.long()]
    if pos is None:
        pos = torch.arange(T, device=tokens.device)[None, :].expand(B, T)
    rope_cs = _rope_angles(pos, cfg.head_dim, cfg.rope_theta)
    for i, lp in enumerate(params["layers"]):
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        x = x + attention(h, lp, None if cache is None else cache[i], pos,
                          cfg, fmt=fmt, kv_window=kv_window,
                          write_mask=write_mask, rope_cs=rope_cs)
        h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        x = x + mlp(h, lp, fmt=fmt)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return linear(x, params["lm_head"], fmt=fmt), cache


def init_cache(cfg: LlamaConfig, batch: int, dtype=torch.bfloat16,
               headed: Optional[bool] = None, device=None):
    """KV cache per layer, zeros on `device` (default the CUDA card;
    resolve_device raises without one). dtype bf16 or
    torch.float8_e4m3fn (half the bytes). fp8 defaults to the headed
    (B, Hkv, S, d) layout, bf16 to flat (B, S, Hkv, d), as in the JAX
    package; headed= overrides. S is cfg.max_seq_len: the JAX package's pad
    of fp8 S to a multiple of 256 serves a TPU lane rule and is not carried
    over."""
    if headed is None:
        headed = dtype == torch.float8_e4m3fn
    S = cfg.max_seq_len
    if headed and S == cfg.num_kv_heads:
        # cache_is_headed reads the layout from the shape; S == Hkv would
        # make a headed cache look flat
        raise ValueError(f"headed cache needs max_seq_len != num_kv_heads "
                         f"(both are {S}); pad max_seq_len")
    shape = ((batch, cfg.num_kv_heads, S, cfg.head_dim) if headed
             else (batch, S, cfg.num_kv_heads, cfg.head_dim))
    device = resolve_device(device)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.num_layers)]


def cache_is_headed(ck: torch.Tensor, cfg: LlamaConfig) -> bool:
    """Layout of a contiguous cache: headed (B, Hkv, S, d) vs flat
    (B, S, Hkv, d); the ambiguous S == num_kv_heads resolves to flat (which
    init_cache never makes headed)."""
    if ck.shape[2] == cfg.num_kv_heads and ck.shape[1] != cfg.num_kv_heads:
        return False
    if ck.shape[1] == cfg.num_kv_heads and ck.shape[2] != cfg.num_kv_heads:
        return True
    return False


def decode_window(n: int, max_seq_len: int) -> int:
    """The kv_window bucket that covers n positions: the smallest
    power-of-two multiple of 128 >= n, capped at max_seq_len (the serving
    engines' rule, so attention traffic tracks the actual context)."""
    w = 128
    while w < n:
        w *= 2
    return min(w, max_seq_len)


@torch.inference_mode()
def greedy_decode(params, cfg: LlamaConfig, prompt_tokens, max_new: int, *,
                  fmt: str = "nvfp4", cache_dtype=torch.bfloat16
                  ) -> torch.Tensor:
    """Greedy generation on the device of params: one cached forward over
    the prompt (B, T0), then token by token with argmax, over a cache
    from init_cache on that device. Every step attends through the window
    that covers T0 + max_new positions (decode_window). Returns the
    max_new tokens, int32 (B, max_new)."""
    dev = params["embed"].device
    toks = torch.as_tensor(prompt_tokens).to(dev)
    B, T0 = toks.shape
    window = decode_window(T0 + max_new, cfg.max_seq_len)
    cache = init_cache(cfg, B, cache_dtype, device=dev)
    pos = torch.arange(T0, dtype=torch.int32, device=dev).expand(
        B, T0).contiguous()
    logits, cache = forward(params, toks, cfg, cache, pos, fmt=fmt,
                            kv_window=window)
    tok = logits[:, -1].argmax(dim=-1).to(torch.int32)
    out = [tok]
    for t in range(max_new - 1):
        p = torch.full((B, 1), T0 + t, dtype=torch.int32, device=dev)
        logits, cache = forward(params, tok[:, None], cfg, cache, p, fmt=fmt,
                                kv_window=window)
        tok = logits[:, -1].argmax(dim=-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out, dim=1)
