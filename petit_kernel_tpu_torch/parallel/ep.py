"""Expert parallelism for FP4 MoE blocks over torch.distributed (torch).

Counterpart of petit_kernel_tpu/parallel/ep.py. Each rank of the "ep"
axis of a DeviceMesh holds E/ep experts of every layer's stacked expert
weights, with the router, attention and KV cache replicated. Every rank
routes all tokens over all experts, evaluates its own experts through the
grouped FP4 GEMM (moe.moe_mlp_partial with a shifted expert base), and one
f32 all_reduce over "ep" sums the contributions: the JAX package's psum
under shard_map, at every world size, one included.
"""

from __future__ import annotations

import torch

from ..models import moe as moe_mod
from .tp import all_reduce, mesh_axis


def _expert_block(num_experts: int, ep: int, rank: int) -> tuple[int, int]:
    """(first expert, experts) of rank `rank` of ep."""
    if num_experts % ep:
        raise ValueError(f"{num_experts} experts do not split over "
                         f"ep = {ep}")
    el = num_experts // ep
    return rank * el, el


def local_experts_ep(experts: dict, ep: int, rank: int) -> dict:
    """Rank `rank`'s E/ep slice of each stacked words (E, kp/8, n), scales
    (E, kp/16, n) and gs (E,), its own copy unless it is the whole
    stack."""
    E = experts["w_gate"]["words"].shape[0]
    base, el = _expert_block(E, ep, rank)

    def keep(t):
        return t if el == E else t[base:base + el].clone()

    return {name: {key: keep(layer[key])
                   for key in ("words", "scales", "gs")}
            for name, layer in experts.items()}


def place_experts_ep(experts: dict, router_w: torch.Tensor, mesh) -> tuple:
    """(local experts, router): the calling rank's experts
    (local_experts_ep); the router stays replicated."""
    ax = mesh_axis(mesh, "ep")
    return local_experts_ep(experts, ax.size, ax.rank), router_w


def make_moe_mlp_ep(moe_cfg: moe_mod.MoEConfig, mesh, *,
                    fmt: str = "mxfp4"):
    """The expert-parallel MoE block: (x (T, H), router_w, local experts)
    -> (T, H) in x.dtype. x is replicated over "ep"; each rank evaluates
    its experts under the global routing (moe_mlp_partial with
    expert_base = rank E/ep, num_local = E/ep), the f32 contributions are
    all-reduced over "ep", then cast to x.dtype."""
    ep = mesh_axis(mesh, "ep")
    base, el = _expert_block(moe_cfg.num_experts, ep.size, ep.rank)

    def block(x, router_w, experts):
        part = moe_mod.moe_mlp_partial(x, router_w, experts, moe_cfg,
                                       expert_base=base, num_local=el,
                                       fmt=fmt)
        return all_reduce(part, ep).to(x.dtype)

    return block


def quantize_params_ep(params: dict, cfg: moe_mod.MixtralConfig, mesh,
                       moe_fmt: str = "mxfp4") -> dict:
    """Quantize a dense Mixtral tree (moe.quantize_params: attention nvfp4,
    experts moe_fmt) one layer at a time and keep the calling rank's
    expert slice of each layer (place_experts_ep); attention, routers,
    embed, norms and lm_head replicated. params["layers"] may be an
    iterator that makes each dense layer."""
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = []
    for lp in params["layers"]:
        q = moe_mod.quantize_params({"layers": [lp]}, cfg,
                                    moe_fmt)["layers"][0]
        q["experts"], q["router"] = place_experts_ep(q["experts"],
                                                     q["router"], mesh)
        out["layers"].append(q)
    return out


def make_ep_step(cfg: moe_mod.MixtralConfig, mesh, *,
                 attn_fmt: str = "nvfp4", moe_fmt: str = "mxfp4"):
    """The serving engines' forward_fn for expert-parallel Mixtral models:
    moe.forward with make_moe_mlp_ep's block, over the rank's local params
    (quantize_params_ep) and a replicated cache (llama.init_cache). Pass it
    to serving.Engine(params, cfg, forward_fn=make_ep_step(...)) on every
    rank, with the same seed."""
    block = make_moe_mlp_ep(moe_mod.MoEConfig(cfg.num_experts, cfg.top_k),
                            mesh, fmt=moe_fmt)

    def forward_fn(p, toks, cache, pos, kv_window=None, write_mask=None):
        return moe_mod.forward(p, toks, cfg, cache, pos, attn_fmt=attn_fmt,
                               moe_fmt=moe_fmt, kv_window=kv_window,
                               write_mask=write_mask, moe_block_fn=block)

    return forward_fn
