"""Mixture-of-Experts with FP4 expert weights, Mixtral-8x7B family (torch).

Counterpart of petit_kernel_tpu/models/moe.py. Tokens are routed on the
device and every expert's capacity bucket runs through one grouped FP4
GEMM launch per projection (ops/kernels/grouped.py): three launches per
layer (w_gate, w_up, w_down) for all experts. Routing is plain torch, as
it is XLA glue in the JAX package: the router matmul in f32, top-k, a
softmax over the top-k values, one stable sort over the (token, expert)
pairs, searchsorted, the bucket scatter, the gather, SiLU * u and one f32
scatter-add back to the tokens. Every shape follows from the token count
on the host, so a block never waits for the device.

Expert weights per layer are stacked: words (E, kp/8, n) int32, scales
(E, kp/16, n) bf16, gs (E,) f32; expert e's slice is exactly a
single-matrix repack. Attention is llama.attention with separate wq, wk
and wv (each its own NVFP4 global scale, as in the JAX package), over the
same KV caches and kernels as the Llama model.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..ops.kernels import grouped as grouped_mod
from ..ops.solution import ElementB
from . import llama


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 2.0


@dataclasses.dataclass(frozen=True)
class MixtralConfig(llama.LlamaConfig):
    num_experts: int = 8
    top_k: int = 2

    @staticmethod
    def mixtral_8x7b(**kw):
        """mistralai/Mixtral-8x7B-v0.1's published widths (max_seq_len
        stays at the port's 2048 unless given)."""
        return MixtralConfig(**{**dict(
            vocab_size=32000, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
            rope_theta=1e6), **kw})

    @staticmethod
    def tiny(**kw):
        """Small config for tests; same code path."""
        return MixtralConfig(**{**dict(
            vocab_size=256, hidden_size=128, intermediate_size=256,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
            max_seq_len=64, num_experts=4, top_k=2), **kw})


def _element_b(fmt: str) -> ElementB:
    return ElementB.MXFP4 if fmt in ("mxfp4", "mxfp4z") else ElementB.NVFP4


def quantize_moe_linear(ws_kn: torch.Tensor, fmt: str = "mxfp4") -> dict:
    """Dense (E, k, n) -> stacked quantized experts, one expert at a time,
    on ws_kn's device: {"words": (E, kp/8, n), "scales": (E, kp/16, n),
    "gs": (E,)}."""
    layers = [llama.quantize_linear(ws_kn[e], fmt)
              for e in range(ws_kn.shape[0])]
    return {"words": torch.stack([q["words"] for q in layers]),
            "scales": torch.stack([q["scales"] for q in layers]),
            "gs": torch.stack([q["gs"] for q in layers])}


def capacity(tokens: int, moe_cfg: MoEConfig) -> int:
    """Rows per expert bucket: ceil(T * top_k / E * capacity_factor),
    rounded up to a multiple of 8, at least 8 (the JAX package's rule)."""
    cap = math.ceil(tokens * moe_cfg.top_k / moe_cfg.num_experts
                    * moe_cfg.capacity_factor)
    return max(8, -(-cap // 8) * 8)


def route(x: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """(gate_w (T, top_k) f32, gate_idx (T, top_k) int64): the top_k router
    logits (f32 matmul) by a stable descending sort, so ties take the
    lower expert first as jax.lax.top_k does, softmaxed over the top_k."""
    logits = x.float() @ router_w.float()
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(vals[:, :top_k], dim=-1), idx[:, :top_k]


def moe_mlp_partial(x: torch.Tensor, router_w: torch.Tensor, experts: dict,
                    moe_cfg: MoEConfig, *, expert_base: int = 0,
                    num_local: Optional[int] = None,
                    fmt: str = "mxfp4") -> torch.Tensor:
    """Contributions of experts [expert_base, expert_base + num_local) to
    the SwiGLU MoE block, (T, H) f32. Routing runs over all experts;
    `experts` holds only the local stack, indexed 0..num_local-1 (the
    building block of expert parallelism, which the port has not yet)."""
    T, H = x.shape
    E, topk = moe_cfg.num_experts, moe_cfg.top_k
    if num_local is None:
        num_local = E
    cap = capacity(T, moe_cfg)
    dev = x.device
    gate_w, gate_idx = route(x, router_w, topk)

    flat_idx = gate_idx.reshape(-1)                          # (T*topk,)
    flat_w = gate_w.reshape(-1)
    flat_tok = torch.arange(T, device=dev).repeat_interleave(topk)
    # one stable sort over all (token, expert) pairs: first come, first
    # served within each expert, as capacity dropping wants
    order = torch.sort(flat_idx, stable=True).indices
    sorted_e = flat_idx[order]
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    rank = torch.arange(T * topk, device=dev) - starts[sorted_e]
    local_e = sorted_e - expert_base
    valid = (local_e >= 0) & (local_e < num_local) & (rank < cap)
    # each pair goes to its (expert, rank) bucket slot; dropped pairs all go
    # to one sacrificial slot past the buckets, so every destination that
    # is kept is unique and the duplicates' order does not matter
    dest = torch.where(valid, local_e * cap + rank, num_local * cap)
    nslot = num_local * cap + 1
    buf_tok = torch.zeros(nslot, dtype=torch.int64, device=dev)
    buf_tok[dest] = flat_tok[order]
    buf_w = torch.zeros(nslot, dtype=torch.float32, device=dev)
    buf_w[dest] = flat_w[order]
    buf_valid = torch.zeros(nslot, dtype=torch.bool, device=dev)
    buf_valid[dest] = valid
    vmask = buf_valid[:num_local * cap].reshape(num_local, cap)
    toks_g = buf_tok[:num_local * cap].reshape(num_local, cap)
    w_g = (buf_w[:num_local * cap] * vmask.reshape(-1)).reshape(num_local,
                                                                cap)
    xsg = x[toks_g] * vmask[..., None].to(x.dtype)          # (El, cap, H)
    # Each bucket fills from row 0 up (rank counts within its expert), so
    # its filled rows are a count, on the device: the grouped kernel skips
    # the 16-row tiles past it, whose rows are zero. The same count holds
    # for the down projection: h is zero where xsg is, silu(0) * 0 = 0.
    rows = vmask.sum(1, dtype=torch.int32)

    def gmul(ys, layer):
        return grouped_mod.grouped_mul(ys, layer["words"], layer["scales"],
                                       layer["gs"],
                                       element_b=_element_b(fmt), rows=rows)

    g = gmul(xsg, experts["w_gate"])
    u = gmul(xsg, experts["w_up"])
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    y = gmul(h, experts["w_down"])                           # (El, cap, H)
    # One scatter-add back to the tokens. At top_k = 2 a token receives at
    # most two nonzero terms; empty slots add exact zeros (zero rows give 0
    # through the GEMM, and their weight is 0). Two terms sum the same in
    # either order, so CUDA's atomic index_add_ is deterministic here; that
    # stops holding for top_k > 2.
    out = torch.zeros((T, H), dtype=torch.float32, device=dev)
    out.index_add_(0, toks_g.reshape(-1),
                   y.reshape(-1, H).float() * w_g.reshape(-1, 1))
    return out


def routing_drop_count(x: torch.Tensor, router_w: torch.Tensor,
                       moe_cfg: MoEConfig) -> torch.Tensor:
    """(token, expert) assignments that capacity overflow drops for this
    batch, a 0-dim int64 tensor on x's device: the observability counter
    for capacity-factor routing (moe_mlp zeroes such contributions)."""
    cap = capacity(x.shape[0], moe_cfg)
    _, gate_idx = route(x, router_w, moe_cfg.top_k)
    idx = gate_idx.reshape(-1)
    counts = torch.zeros(moe_cfg.num_experts, dtype=torch.int64,
                         device=x.device).index_add_(0, idx,
                                                     torch.ones_like(idx))
    return (counts - cap).clamp_min(0).sum()


def moe_mlp(x: torch.Tensor, router_w: torch.Tensor, experts: dict,
            moe_cfg: MoEConfig, *, fmt: str = "mxfp4") -> torch.Tensor:
    """SwiGLU MoE block, x (T, H) -> (T, H) in x.dtype. experts:
    {"w_gate", "w_up", "w_down"}, each stacked. Top-k routing with
    per-expert capacity buckets; overflow pairs drop."""
    return moe_mlp_partial(x, router_w, experts, moe_cfg,
                           fmt=fmt).to(x.dtype)


def _dense_moe(x: torch.Tensor, router_w: torch.Tensor, experts: dict,
               moe_cfg: MoEConfig) -> torch.Tensor:
    """Dense-weight oracle with the same routing and no capacity drop, for
    tiny shapes: experts {"w_gate": {"w": (E, h, f)}, ...} bf16."""
    T, H = x.shape
    gate_w, gate_idx = route(x, router_w, moe_cfg.top_k)
    out = torch.zeros((T, H), dtype=torch.float32, device=x.device)
    xf = x.float()
    for e in range(moe_cfg.num_experts):
        wg, wu, wd = (experts[n]["w"][e].float()
                      for n in ("w_gate", "w_up", "w_down"))
        h = torch.nn.functional.silu(xf @ wg) * (xf @ wu)
        y = h.to(x.dtype).float() @ wd
        w_e = torch.where(gate_idx == e, gate_w, 0.0).sum(-1)    # (T,)
        out = out + y * w_e[:, None]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Mixtral model: llama attention + MoE MLP
# ---------------------------------------------------------------------------

def init_params(cfg: MixtralConfig, generator: torch.Generator) -> dict:
    """Random dense bf16 params from `generator`, on its device (a CPU
    generator asks for the CPU), in the JAX package's tree and scales:
    llama.init_params' embedding, norms, attention and lm_head, and per
    layer a router (h, E) of normal * 0.02 and experts w_gate, w_up (E, h,
    f) of normal / sqrt(h) and w_down (E, f, h) of normal / sqrt(f). Built
    one layer and one expert at a time."""
    h, f, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    g = generator
    params = llama.init_params(dataclasses.replace(cfg, num_layers=0), g)

    def stacked(k, n):
        return {"w": torch.stack([llama.normal(g, (k, n), 1.0 / math.sqrt(k))
                                  for _ in range(E)])}

    for _ in range(cfg.num_layers):
        lp = llama.init_layer(cfg, g, mlp=False)
        lp["router"] = llama.normal(g, (h, E), 0.02)
        lp["experts"] = {"w_gate": stacked(h, f), "w_up": stacked(h, f),
                         "w_down": stacked(f, h)}
        params["layers"].append(lp)
    return params


def quantize_params(params: dict, cfg: MixtralConfig,
                    fmt: str = "mxfp4") -> dict:
    """Quantize wq, wk, wv and wo to NVFP4, each on its own (a fused wqkv
    would share one global scale and leave the JAX package's numbers), and
    the experts to `fmt`; embed, lm_head, norms and routers stay dense."""
    del cfg
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = []
    for lp in params["layers"]:
        q = dict(lp)
        for name in ("wq", "wk", "wv", "wo"):
            w = lp[name]["w"]
            if w.shape[0] % 128 == 0 and w.shape[1] % 16 == 0:
                q[name] = llama.quantize_linear(w, "nvfp4")
        q["experts"] = {
            name: quantize_moe_linear(lp["experts"][name]["w"], fmt)
            for name in ("w_gate", "w_up", "w_down")}
        out["layers"].append(q)
    return out


@torch.inference_mode()
def forward(params, tokens, cfg: MixtralConfig, cache=None, pos=None, *,
            attn_fmt: str = "nvfp4", moe_fmt: str = "mxfp4",
            kv_window: Optional[int] = None,
            write_mask: Optional[torch.Tensor] = None):
    """Mixtral forward with llama.forward's serving contract: tokens (B, T)
    -> (logits (B, T, V), cache); the cache (flat or headed, updated in
    place) needs kv_window, and write_mask (B,) bool keeps rows' KV
    bit-exact. Quantized experts run moe_mlp; dense ones the oracle."""
    moe_cfg = MoEConfig(cfg.num_experts, cfg.top_k)
    B, T = tokens.shape
    x = params["embed"][tokens.long()]
    if pos is None:
        pos = torch.arange(T, device=tokens.device)[None, :].expand(B, T)
    rope_cs = llama._rope_angles(pos, cfg.head_dim, cfg.rope_theta)
    for i, lp in enumerate(params["layers"]):
        h = llama.rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        x = x + llama.attention(h, lp, None if cache is None else cache[i],
                                pos, cfg, fmt=attn_fmt, kv_window=kv_window,
                                write_mask=write_mask, rope_cs=rope_cs)
        h = llama.rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        ex = lp["experts"]
        if "words" in ex["w_gate"]:
            y = moe_mlp(h.reshape(B * T, -1), lp["router"], ex, moe_cfg,
                        fmt=moe_fmt)
        else:
            y = _dense_moe(h.reshape(B * T, -1), lp["router"], ex, moe_cfg)
        x = x + y.reshape(B, T, -1)
    x = llama.rms_norm(x, params["final_norm"], cfg.rms_eps)
    return llama.linear(x, params["lm_head"]), cache


def make_engine_forward(cfg: MixtralConfig, *, attn_fmt: str = "nvfp4",
                        moe_fmt: str = "mxfp4"):
    """forward_fn for serving.Engine(params, cfg, forward_fn=...): MoE
    models serve through the same scheduler, attention kernels and masked
    KV writes as the Llama model."""
    def forward_fn(p, toks, cache, pos, kv_window=None, write_mask=None):
        return forward(p, toks, cfg, cache, pos, attn_fmt=attn_fmt,
                       moe_fmt=moe_fmt, kv_window=kv_window,
                       write_mask=write_mask)
    return forward_fn
