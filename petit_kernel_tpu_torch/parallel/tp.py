"""Tensor parallelism for FP4 Llama models over torch.distributed (torch).

Counterpart of petit_kernel_tpu/parallel/tp.py. The JAX package places
global arrays on a jax.sharding.Mesh and runs the Megatron block under
shard_map; here every rank of a torch.distributed job holds only its local
shards and runs the body of that shard_map itself:

  Mesh("dp", "tp")        -> a DeviceMesh from init_device_mesh(device_type,
                             (dp, tp), mesh_dim_names=("dp", "tp"))
  psum / all_gather /     -> dist.all_reduce / dist.all_gather_into_tensor /
  psum_scatter over "tp"     dist.reduce_scatter_tensor on mesh["tp"]'s group

Every collective goes through torch.distributed at every world size, one
included: on the card a world of one runs NCCL (inside the serving
engines' captured decode graphs too), on a "cpu" mesh gloo.

Layout: column-parallel projections (wq, wk, wv, w_gate, w_up; lm_head on
the vocab) shard their output features; the packed weight layout is
column-independent, so a rank's shard is a column slice of one global
quantize and repack. Row-parallel projections (wo, w_down) shard their
input features; the layout interleaves k globally, so each k-slice is
quantized with one shared global scale and repacked on its own, and rank
t's shard is packed-row block t (quantize_linear_tp). Attention heads and
the KV cache shard over "tp" with the columns; the batch shards over "dp".

The projections run the port's FP4 GEMM kernels at the per-shard shapes;
lm_head stays a torch.matmul, as the JAX package's jnp.dot outside any
kernel.

Training: the collectives are torch.autograd.Functions wherever a tensor
that needs a gradient passes them (Megatron's pairs): an all_reduce of
partial sums passes its gradient on as it is, sum_grad (the identity)
before a column block sums its gradient over "tp", an all_gather whose
output feeds work that every rank repeats (the loss of the gathered
logits) keeps the rank's block of the gradient, one whose output feeds
sharded work (the SP gathers) reduce-scatters it, and a reduce_scatter
all-gathers it. So make_tp_forward and make_tp_forward_sp over
shard_dense_params shards whose leaves require grad train: loss.backward()
on every rank leaves on each local leaf the matching slice of the
unsharded gradient, the gradient the JAX package's jax.value_and_grad
over GSPMD-sharded params gives (a leaf that several "dp" ranks share has
its gradient summed over "dp", and in the SP forward a leaf applied to the
token-sharded stream, embed and the norms, over "tp" too). Without such a
leaf they run under torch.inference_mode, as make_tp_step and
mul_fp4_tp_rs always do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..models import llama
from ..numerics import reference as ref_numerics
from ..ops import gemm as gemm_mod
from ..ops import layout as layout_mod

# ---------------------------------------------------------------------------
# Mesh axes and collectives
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Axis:
    """A named mesh axis as the calling rank sees it: its process group,
    its size and the rank's coordinate along it. The entry points resolve
    each axis once (mesh_axis): slicing a DeviceMesh builds a new mesh each
    time, about 0.6 ms of host time on the H100's host, more than a decode
    step's 64 collectives can pay."""
    group: object
    size: int
    rank: int


def mesh_axis(mesh, name: str) -> Axis:
    """The Axis `name` of `mesh` (a DeviceMesh with that dim name)."""
    sub = mesh[name]
    return Axis(sub.get_group(), sub.size(), mesh.get_local_rank(name))


def mesh_device(mesh) -> torch.device:
    """The device an entry point builds on for `mesh`: the CPU for a "cpu"
    mesh, else the current CUDA card (llama.resolve_device raises without
    one)."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    dev = llama.resolve_device()
    return torch.device(dev.type, torch.cuda.current_device())


def _tracked(x: torch.Tensor) -> bool:
    """Whether autograd records an op on x here."""
    return torch.is_grad_enabled() and x.requires_grad


def _gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((axis.size * xt.shape[0], *xt.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, xt, group=axis.group)
    return out.movedim(0, dim).contiguous()


def _scatter(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    xt = x.movedim(dim, 0).contiguous()
    if xt.shape[0] % axis.size:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {axis.size} ranks")
    out = torch.empty((xt.shape[0] // axis.size, *xt.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, xt, op=dist.ReduceOp.SUM,
                               group=axis.group)
    return out.movedim(0, dim).contiguous()


def _summed(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=axis.group)
    return out


class _AllReduce(torch.autograd.Function):
    """Megatron's g: the sum of partial results; what consumes it is the
    same on every rank, so its gradient passes on as it is."""

    @staticmethod
    def forward(ctx, x, axis):
        return _summed(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrad(torch.autograd.Function):
    """Megatron's f: the identity, before sharded work on a replicated
    input, whose ranks' gradients are partial and summed."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.axis), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, grad):
        ctx.axis, ctx.dim, ctx.grad = axis, dim, grad
        return _gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        axis, dim = ctx.axis, ctx.dim
        if ctx.grad == "sum":
            return _scatter(g, axis, dim), None, None, None
        n = g.shape[dim] // axis.size
        return g.narrow(dim, axis.rank * n, n).contiguous(), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _scatter(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.axis, ctx.dim), None, None


def all_reduce(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum of x over the ranks of `axis`: in place (x contiguous), or into
    a new tensor where autograd records it (its gradient passes on as it
    is: what consumes the sum must be the same on every rank)."""
    if _tracked(x):
        return _AllReduce.apply(x, axis)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=axis.group)
    return x


def sum_grad(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """x itself; where autograd records it, its gradient is summed over
    the ranks of `axis` (the input of sharded work, or a leaf that those
    ranks share)."""
    return _SumGrad.apply(x, axis) if _tracked(x) else x


def all_gather(x: torch.Tensor, axis: Axis, dim: int,
               grad: str = "slice") -> torch.Tensor:
    """The ranks' x along `axis` concatenated on `dim` in rank order. The
    collective works on dim 0 of a contiguous tensor, so `dim` moves to the
    front and back: gathering another dim in place would interleave the
    shards. (all_gather_into_tensor and reduce_scatter_tensor: torch 2.13
    deprecates them for *_single, which torch 2.11 lacks.) Where autograd
    records it, the gradient of x is the rank's block of the output's
    gradient with grad="slice" (what consumes the output is the same on
    every rank, such as the loss of gathered logits), the reduce-scatter
    of it with grad="sum" (what consumes it is sharded: the ranks'
    gradients are partial)."""
    if grad not in ("slice", "sum"):
        raise ValueError(f"grad must be 'slice' or 'sum', not {grad!r}")
    if _tracked(x):
        return _AllGather.apply(x, axis, dim, grad)
    return _gather(x, axis, dim)


def reduce_scatter(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """Sum of x over the ranks of `axis`, of which this rank keeps block
    axis.rank of `dim` (x.shape[dim] % axis.size == 0); `dim` moves to the
    front and back, as in all_gather. Its gradient is the all-gather of
    the output's."""
    if _tracked(x):
        return _ReduceScatter.apply(x, axis, dim)
    return _scatter(x, axis, dim)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _trains(params) -> bool:
    """Whether a leaf of params requires grad: then an entry point records
    its forward, else it runs under torch.inference_mode."""
    return any(t.requires_grad for t in _leaves(params))


def map_tensors(tree, fn):
    """tree (dicts, lists and tuples) with fn applied to each tensor leaf;
    other leaves as they are."""
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(v, fn) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _share_grads(tree, axes):
    """tree with each leaf that requires grad through sum_grad over each
    of `axes`: the leaf's gradient summed over the ranks that share it."""
    def share(t):
        for ax in axes:
            t = sum_grad(t, ax)
        return t

    return map_tensors(tree, share)


def _dp_rows(dp: Axis, batch: int) -> slice:
    """The calling rank's rows of a global batch over "dp"."""
    if batch % dp.size:
        raise ValueError(f"batch {batch} does not split over dp = {dp.size}")
    b = batch // dp.size
    return slice(dp.rank * b, (dp.rank + 1) * b)


def _local_cfg(cfg: llama.LlamaConfig, tp: int) -> llama.LlamaConfig:
    """The per-shard config: H/tp query heads and Hkv/tp KV heads."""
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        raise ValueError(f"{cfg.num_heads} heads and {cfg.num_kv_heads} KV "
                         f"heads do not split over tp = {tp}")
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                               num_kv_heads=cfg.num_kv_heads // tp)


# ---------------------------------------------------------------------------
# Dense params (the GSPMD sharding of the JAX package, as local shards)
# ---------------------------------------------------------------------------

_COL_KEYS = ("wq", "wk", "wv", "w_gate", "w_up")
_ROW_KEYS = ("wo", "w_down")


def _cols(t: torch.Tensor, tp: int, rank: int) -> torch.Tensor:
    """Block `rank` of the last dim, tp blocks, as its own tensor."""
    n = t.shape[-1]
    if n % tp:
        raise ValueError(f"{n} columns do not split over tp = {tp}")
    c = n // tp
    return t[..., rank * c:(rank + 1) * c].contiguous()


def _rows(t: torch.Tensor, tp: int, rank: int) -> torch.Tensor:
    """Block `rank` of dim 0, tp blocks, as its own tensor."""
    if t.shape[0] % tp:
        raise ValueError(f"{t.shape[0]} rows do not split over tp = {tp}")
    r = t.shape[0] // tp
    return t[rank * r:(rank + 1) * r].contiguous()


def _dense_shard(layer: dict, tp: int, rank: int, shard: str) -> dict:
    if shard == "n":
        out = {"w": _cols(layer["w"], tp, rank)}
        if "b" in layer:
            out["b"] = _cols(layer["b"], tp, rank)
        return out
    if "b" in layer:
        raise ValueError("a row-parallel projection takes no bias")
    return {"w": _rows(layer["w"], tp, rank)}


def _shard_tree(params: dict, tp: int, rank: int, shard_layer) -> dict:
    """The rank's tree: lm_head column-sharded, each layer's _COL_KEYS and
    _ROW_KEYS through shard_layer(layer, "n" or "k"), embed and norms
    replicated. params["layers"] is read once, so it may be an iterator."""
    out = {"embed": params["embed"], "final_norm": params["final_norm"],
           "lm_head": _dense_shard(params["lm_head"], tp, rank, "n"),
           "layers": []}
    for lp in params["layers"]:
        q = {"attn_norm": lp["attn_norm"], "mlp_norm": lp["mlp_norm"]}
        for name in _COL_KEYS + _ROW_KEYS:
            q[name] = shard_layer(lp[name], "n" if name in _COL_KEYS else "k")
        out["layers"].append(q)
    return out


def shard_dense_params(params: dict, mesh) -> dict:
    """The calling rank's local shards of the dense Llama tree: _COL_KEYS
    and lm_head column-sharded (with their biases), _ROW_KEYS row-sharded,
    embed and norms replicated."""
    ax = mesh_axis(mesh, "tp")
    return _shard_tree(params, ax.size, ax.rank, lambda layer, shard:
                       _dense_shard(layer, ax.size, ax.rank, shard))


# ---------------------------------------------------------------------------
# FP4 quantization for tensor parallelism
# ---------------------------------------------------------------------------

_TP_QUANTIZERS = {
    "nvfp4": (ref_numerics.quantize_nvfp4, 16),
    "nvfp4p2": (ref_numerics.quantize_nvfp4_pow2, 16),
    "nvfp4p2z": (ref_numerics.quantize_nvfp4_pow2z, 16),
    "mxfp4": (ref_numerics.quantize_mxfp4, 32),
}


def quantize_linear_tp(w_kn: torch.Tensor, tp: int, shard: str,
                       fmt: str = "nvfp4") -> dict:
    """Quantize and repack a dense (k, n) weight for tp-way sharding, on
    w_kn's device; returns the global {"words", "scales", "gs"}.

    shard="n" (column parallel): one global quantize and repack; rank t's
      shard is columns [t n/tp, (t+1) n/tp) (local_linear_tp).
    shard="k" (row parallel): each k-slice of k/tp rows is quantized with
      one shared global scale (amax / (6 * 448); 1.0 for mxfp4) and
      repacked on its own, the slices concatenated along packed rows, so
      rank t's shard is packed-row block t: padded_k(k/tp)/8 words and
      /16 scale rows.

    fmt is one of nvfp4, nvfp4p2, nvfp4p2z, mxfp4; any other raises
    ValueError (the JAX package raises a bare KeyError there)."""
    if fmt not in _TP_QUANTIZERS:
        raise ValueError(f"tensor-parallel quantization takes nvfp4, "
                         f"nvfp4p2, nvfp4p2z or mxfp4, not {fmt!r}")
    if shard == "n":
        return llama.quantize_linear(w_kn, fmt)
    if shard != "k":
        raise ValueError(f"shard must be 'n' or 'k', not {shard!r}")
    quant, group = _TP_QUANTIZERS[fmt]
    w = w_kn.float().T                     # (n, k): checkpoint orientation
    n, k = w.shape
    if k % tp:
        raise ValueError(f"k = {k} does not split over tp = {tp}")
    ks = k // tp
    if fmt == "mxfp4":
        gs = torch.ones((), dtype=torch.float32, device=w.device)
    else:
        amax = w.abs().amax()
        gs = torch.where(amax > 0, amax / (6.0 * 448.0), 1.0)
    words, scales = [], []
    for t in range(tp):
        wt = w[:, t * ks:(t + 1) * ks]
        if fmt == "mxfp4":
            qw, st, _ = quant(wt)
        else:
            qw, st, _ = quant(wt, global_scale=gs)
        words.append(layout_mod.repack_fp4_weights(
            qw, n, ks, pad_to=layout_mod.pad_multiple(group)))
        scales.append(layout_mod.process_fp4_scales(st, n, ks,
                                                    group_size=group))
    return {"words": torch.cat(words), "scales": torch.cat(scales),
            "gs": gs.reshape(())}


def local_linear_tp(layer: dict, tp: int, shard: str, rank: int) -> dict:
    """Rank `rank`'s shard of a global quantize_linear_tp layer: columns
    [rank n/tp, (rank+1) n/tp) of words and scales for shard="n",
    packed-row block `rank` for shard="k"; gs is shared. A column shard
    keeps its bias's columns; a row shard takes no bias."""
    if shard not in ("n", "k"):
        raise ValueError(f"shard must be 'n' or 'k', not {shard!r}")
    if shard == "k" and "b" in layer:
        raise ValueError("a row-parallel projection takes no bias")
    cut = _cols if shard == "n" else _rows
    out = {"words": cut(layer["words"], tp, rank),
           "scales": cut(layer["scales"], tp, rank), "gs": layer["gs"]}
    if "b" in layer:
        out["b"] = _cols(layer["b"], tp, rank)
    return out


def local_params_tp(params: dict, tp: int, rank: int) -> dict:
    """Rank `rank`'s local tree of a global TP tree (quantized layers as
    quantize_linear_tp gives them, for example the JAX package's
    quantize_params_tp gathered and converted): _COL_KEYS and lm_head
    column-sharded, _ROW_KEYS packed-row block `rank`, the rest
    replicated."""
    return _shard_tree(params, tp, rank, lambda layer, shard:
                       local_linear_tp(layer, tp, shard, rank))


def quantize_params_tp(params: dict, cfg: llama.LlamaConfig, mesh,
                       fmt: str = "nvfp4") -> dict:
    """Quantize a dense Llama tree for tensor parallelism over mesh["tp"]
    and return the calling rank's local tree, on the device of the dense
    weights: _COL_KEYS unfused and column-sharded, _ROW_KEYS row-sharded
    with a per-shard repack (quantize_linear_tp), embed and norms
    replicated, lm_head column-sharded on the vocab. Layers are quantized
    one at a time and only the rank's shards kept, so params["layers"] may
    be an iterator that makes each dense layer (then only one dense layer
    exists at a time). Biases of wq, wk and wv shard with their columns
    (the JAX package drops them)."""
    ax = mesh_axis(mesh, "tp")
    _local_cfg(cfg, ax.size)

    def shard_layer(layer, shard):
        q = quantize_linear_tp(layer["w"], ax.size, shard, fmt)
        if "b" in layer:
            q["b"] = layer["b"]
        return local_linear_tp(q, ax.size, shard, ax.rank)

    return _shard_tree(params, ax.size, ax.rank, shard_layer)


# ---------------------------------------------------------------------------
# The Megatron block, as one rank runs it
# ---------------------------------------------------------------------------

def _local_forward(params, tokens, cache, pos, cfg, tp: Axis, fmt,
                   write_mask=None, kv_window=None):
    """One rank's Megatron block over its local rows and shards: heads
    column-sharded through llama.attention / llama.mlp with the per-shard
    config, one all_reduce over "tp" after wo and one after w_down, the
    vocab-sharded logits all-gathered over "tp"; each column block's input
    through sum_grad. The cached decode step and chunk (kv_window) and the
    cacheless forward are llama.forward's code paths. Returns (logits
    (b, T, V) bf16, cache)."""
    cfg_l = _local_cfg(cfg, tp.size)
    B, T = tokens.shape
    x = params["embed"][tokens.long()]
    if pos is None:
        pos = torch.arange(T, device=tokens.device)[None, :].expand(B, T)
    rope_cs = llama._rope_angles(pos, cfg.head_dim, cfg.rope_theta)
    for i, lp in enumerate(params["layers"]):
        h = sum_grad(llama.rms_norm(x, lp["attn_norm"], cfg.rms_eps), tp)
        a = llama.attention(h, lp, None if cache is None else cache[i], pos,
                            cfg_l, fmt=fmt, kv_window=kv_window,
                            write_mask=write_mask, rope_cs=rope_cs)
        x = x + all_reduce(a.contiguous(), tp)    # row-parallel wo
        h = sum_grad(llama.rms_norm(x, lp["mlp_norm"], cfg.rms_eps), tp)
        dn = llama.mlp(h, lp, fmt=fmt)
        x = x + all_reduce(dn.contiguous(), tp)   # and w_down
    x = sum_grad(llama.rms_norm(x, params["final_norm"], cfg.rms_eps), tp)
    logits = llama.linear(x, params["lm_head"])
    return all_gather(logits, tp, dim=2), cache


def make_tp_forward(cfg: llama.LlamaConfig, mesh, fmt: str = "nvfp4"):
    """(params, tokens (B, T)) -> logits (B, T, V) bf16, the TP + DP
    prefill-style forward without a cache. Every rank passes the global
    tokens and its local params (quantize_params_tp, or shard_dense_params
    with fmt "bf16"); each computes its "dp" rows, and the logits are
    all-gathered over "dp", so every rank returns the same global logits.
    Where a leaf requires grad the forward is recorded, each leaf's
    gradient summed over "dp" (the module docstring); else it runs under
    torch.inference_mode."""
    dp, tp = mesh_axis(mesh, "dp"), mesh_axis(mesh, "tp")
    _local_cfg(cfg, tp.size)

    def forward(params, tokens):
        train = _trains(params)
        with torch.inference_mode(not train):
            if train:
                params = _share_grads(params, [dp])
            rows = _dp_rows(dp, tokens.shape[0])
            logits, _ = _local_forward(params, tokens[rows], None, None, cfg,
                                       tp, fmt)
            return all_gather(logits, dp, dim=0)

    return forward


def init_cache_tp(cfg: llama.LlamaConfig, batch: int, mesh,
                  dtype=torch.bfloat16, headed: Optional[bool] = None):
    """The calling rank's KV cache of a global batch of `batch` rows: its
    batch // dp rows and num_kv_heads // tp heads, on the mesh's device
    (llama.init_cache of the per-shard config): flat (b, S, Hkv/tp, d), or
    headed (b, Hkv/tp, S, d), by default for float8_e4m3fn."""
    cfg_l = _local_cfg(cfg, mesh_axis(mesh, "tp").size)
    rows = _dp_rows(mesh_axis(mesh, "dp"), batch)
    return llama.init_cache(cfg_l, rows.stop - rows.start, dtype,
                            headed=headed, device=mesh_device(mesh))


def make_tp_step(cfg: llama.LlamaConfig, mesh, fmt: str = "nvfp4"):
    """The serving engines' forward_fn for tensor parallelism:
    (params, tokens (B, T), cache, pos (B, T), write_mask=None,
    kv_window=None) -> (logits (B, T, V), cache), over the rank's local
    params (quantize_params_tp) and cache (init_cache_tp), updated in
    place. Each rank computes its "dp" rows of the global batch (B must be
    dp times the cache's rows) and the logits are all-gathered over "dp".
    Pass it to serving.Engine(params, cfg, forward_fn=make_tp_step(...),
    cache=init_cache_tp(...)) on every rank, with the same seed: the
    gathered logits are the same bytes on every rank, so every rank
    samples the same tokens. The Engine slices its cache by global slot,
    so it serves at dp = 1."""
    dp, tp = mesh_axis(mesh, "dp"), mesh_axis(mesh, "tp")
    _local_cfg(cfg, tp.size)

    def step(params, tokens, cache, pos, write_mask=None, kv_window=None):
        B = tokens.shape[0]
        b = cache[0][0].shape[0]
        if B != b * dp.size:
            raise ValueError(f"tokens of {B} rows against a local cache of "
                             f"{b} rows over dp = {dp.size}")
        rows = _dp_rows(dp, B)
        with torch.inference_mode():
            logits, cache = _local_forward(
                params, tokens[rows], cache, pos[rows], cfg, tp, fmt,
                write_mask=None if write_mask is None else write_mask[rows],
                kv_window=kv_window)
            return all_gather(logits, dp, dim=0), cache

    return step


# ---------------------------------------------------------------------------
# Reduce-scatter epilogue and the sequence-parallel forward
# ---------------------------------------------------------------------------

_MULS = {"nvfp4": gemm_mod.mul_nvfp4_a16,
         "nvfp4p2": gemm_mod.mul_nvfp4p2_a16,
         "nvfp4p2z": gemm_mod.mul_nvfp4p2z_a16,
         "mxfp4": gemm_mod.mul_mxfp4_a16}


@torch.inference_mode()
def mul_fp4_tp_rs(a: torch.Tensor, layer: dict, mesh, size_k: int,
                  fmt: str = "nvfp4") -> torch.Tensor:
    """The k-sharded fused FP4 GEMM with a reduce-scatter epilogue over n:
    a (m, size_k/tp) is the rank's k-slice of the activations and `layer`
    its packed-row block (local_linear_tp(..., "k", rank)); each rank runs
    its local GEMM and the partial sums are reduce-scattered over n, so
    the rank gets its (m, n/tp) column block of the product."""
    tp = mesh_axis(mesh, "tp")
    n = layer["words"].shape[1]
    if n % tp.size or size_k % tp.size:
        raise ValueError(f"(k, n) = {(size_k, n)} does not split over "
                         f"tp = {tp.size}")
    if fmt not in _MULS:
        raise ValueError(f"unsupported format {fmt!r}")
    y = _MULS[fmt](a, layer["words"], layer["scales"], layer["gs"],
                   a.shape[0], n, size_k // tp.size, -1)
    return reduce_scatter(y, tp, dim=1)


def make_tp_forward_sp(cfg: llama.LlamaConfig, mesh, fmt: str = "nvfp4"):
    """Megatron-SP TP forward: (params, tokens (B, T)) -> logits (B, T, V),
    as make_tp_forward, with the residual stream sharded on tokens: each
    rank keeps T/tp tokens of its "dp" rows, all-gathers the normed stream
    over "tp" before each column block and reduce-scatters each row
    block's partial sums over tokens. Needs T % tp == 0. Where a leaf
    requires grad the forward is recorded: the gathers before sharded work
    reduce-scatter their gradients, and embed and the norms, applied to
    the rank's tokens, have their gradients summed over "tp" and "dp", the
    other leaves over "dp"."""
    dp, tp = mesh_axis(mesh, "dp"), mesh_axis(mesh, "tp")
    cfg_l = _local_cfg(cfg, tp.size)

    def forward(params, tokens):
        train = _trains(params)
        with torch.inference_mode(not train):
            if train:
                params = _sp_share_grads(params, dp, tp)
            return _sp_forward(params, tokens, cfg, cfg_l, dp, tp, fmt)

    return forward


def _sp_share_grads(params: dict, dp: Axis, tp: Axis) -> dict:
    """make_tp_forward_sp's params with their gradients shared: embed and
    the norms over "tp" and "dp", the sharded leaves over "dp"."""
    both = [tp, dp]
    out = {"embed": _share_grads(params["embed"], both),
           "final_norm": _share_grads(params["final_norm"], both),
           "lm_head": _share_grads(params["lm_head"], [dp]), "layers": []}
    for lp in params["layers"]:
        out["layers"].append({
            k: _share_grads(v, both if k in ("attn_norm", "mlp_norm")
                            else [dp]) for k, v in lp.items()})
    return out


def _sp_forward(params, tokens, cfg, cfg_l, dp: Axis, tp: Axis, fmt):
    B, T = tokens.shape
    if T % tp.size:
        raise ValueError(f"T = {T} does not split over tp = {tp.size}")
    ts = T // tp.size
    tok = tokens[_dp_rows(dp, B), tp.rank * ts:(tp.rank + 1) * ts]
    b = tok.shape[0]
    x = params["embed"][tok.long()]                # (b, T/tp, H)
    pos = torch.arange(T, device=tok.device)[None, :].expand(b, T)
    rope_cs = llama._rope_angles(pos, cfg.head_dim, cfg.rope_theta)
    for lp in params["layers"]:
        h = llama.rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        hf = all_gather(h, tp, dim=1, grad="sum")  # (b, T, H)
        a = llama.attention(hf, lp, None, pos, cfg_l, fmt=fmt,
                            rope_cs=rope_cs)
        x = x + reduce_scatter(a, tp, dim=1)
        h = llama.rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        hf = all_gather(h, tp, dim=1, grad="sum")
        x = x + reduce_scatter(llama.mlp(hf, lp, fmt=fmt), tp, dim=1)
    x = llama.rms_norm(x, params["final_norm"], cfg.rms_eps)
    # tokens and vocab shard over the same axis: gather the tokens
    # first, then the vocab-sharded logits
    xf = all_gather(x, tp, dim=1, grad="sum")
    logits = all_gather(llama.linear(xf, params["lm_head"]), tp, dim=2)
    return all_gather(logits, dp, dim=0)
