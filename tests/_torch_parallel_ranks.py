"""Rank code of the parallel parity tests (tests/test_torch_parallel*.py).

The tests spawn one process a rank (torch.multiprocessing, spawn), each
joins a gloo process group over a file store and runs one job of this
module on "cpu" DeviceMeshes, then saves its results for the test process
to read. With device="cuda" rank r runs on card r instead, in an NCCL
group, its inputs moved there and its results back to the CPU (the
multi-card tests of tests/test_torch_cuda.py). This module imports torch
and the port only: a spawned child never imports JAX.

    ctx = start(job, world, inputs, tmp_dir)   # returns at once
    results = finish(ctx)                      # [rank 0's, rank 1's, ...]
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh

from petit_kernel_tpu_torch.models import llama, moe, serving
from petit_kernel_tpu_torch.parallel import ep as ep_mod
from petit_kernel_tpu_torch.parallel import pp as pp_mod
from petit_kernel_tpu_torch.parallel import tp as tp_mod


class _Run:
    def __init__(self, ctx, out_dir, world):
        self.ctx, self.out_dir, self.world = ctx, out_dir, world
        self.results = None


def start(job: str, world: int, inputs: dict, tmp_dir: str,
          device: str = "cpu") -> _Run:
    """Spawn `world` ranks running JOBS[job] over `inputs` (a dict of
    torch tensors and plain values, saved to tmp_dir) on `device`;
    returns without waiting."""
    os.makedirs(tmp_dir, exist_ok=True)
    path = os.path.join(tmp_dir, "inputs.pt")
    torch.save(inputs, path)
    ctx = mp.start_processes(
        _main, args=(world, job, path, tmp_dir, device), nprocs=world,
        join=False, start_method="spawn")
    return _Run(ctx, tmp_dir, world)


def finish(run: _Run) -> list:
    """Wait for every rank (a rank's exception is raised here) and return
    the ranks' results in rank order."""
    if run.results is None:
        while not run.ctx.join():
            pass
        run.results = [torch.load(os.path.join(run.out_dir, f"r{r}.pt"),
                                  weights_only=False)
                       for r in range(run.world)]
    return run.results


# the device type of the calling rank's meshes ("cpu" or "cuda")
_DEVICE = "cpu"


def _leaf_tree(tree, fn):
    """tree (dicts, lists and tuples) with fn applied to each leaf."""
    if isinstance(tree, dict):
        return {k: _leaf_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_leaf_tree(v, fn) for v in tree)
    return fn(tree)


def _to(tree, device):
    """tree with each tensor leaf moved to `device`."""
    return _leaf_tree(tree, lambda t: t.to(device)
                      if isinstance(t, torch.Tensor) else t)


def _main(rank: int, world: int, job: str, path: str, out_dir: str,
          device: str):
    global _DEVICE
    _DEVICE = device
    torch.set_num_threads(1)
    kw = {}
    if device == "cuda":
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group(
        "nccl" if device == "cuda" else "gloo",
        init_method="file://" + os.path.join(out_dir, "store"),
        world_size=world, rank=rank, **kw)
    try:
        inputs = torch.load(path, weights_only=False)
        if device == "cuda":
            inputs = _to(inputs, torch.device("cuda", rank))
        out = _to(JOBS[job](world, inputs), "cpu")
        torch.save(out, os.path.join(out_dir, f"r{rank}.pt"))
    finally:
        dist.destroy_process_group()


class _Axis:
    def __init__(self, n):
        self.n = n

    def size(self):
        return self.n

    def get_group(self):
        return None


class StandInMesh:
    """The DeviceMesh surface the port's entry points read, without a
    process group: device_type, mesh[axis].size() and get_local_rank
    (the calling rank's coordinate, `rank` on every axis)."""

    def __init__(self, device_type, rank=0, **sizes):
        self.device_type, self.rank, self.sizes = device_type, rank, sizes

    def __getitem__(self, axis):
        return _Axis(self.sizes[axis])

    def get_local_rank(self, axis):
        return self.rank


def _mesh(shape, names):
    return init_device_mesh(_DEVICE, shape, mesh_dim_names=names)


# ---------------------------------------------------------------------------
# Tensor parallelism
# ---------------------------------------------------------------------------

def _tp_cases(world: int, inp: dict) -> dict:
    """Every TP case of one world size: the forwards over carried params
    at each mesh of inp["meshes"] (with world ranks), the SP forward, the
    reduce-scatter GEMM against the all_reduce path, the dense forward over
    shard_dense_params, the rank's quantize_params_tp tree, and at world 2
    the TP Engine."""
    cfg = llama.LlamaConfig(**inp["cfg"])
    out = {}
    for dp, tp in inp["meshes"][world]:
        mesh = _mesh((dp, tp), ("dp", "tp"))
        t = tp_mod.mesh_axis(mesh, "tp").rank
        key = f"{dp}x{tp}"
        local = tp_mod.local_params_tp(inp["tp_params"][tp], tp, t)
        toks = inp["tokens"]
        out[f"fwd {key}"] = tp_mod.make_tp_forward(cfg, mesh)(local, toks)
        out[f"sp {key}"] = tp_mod.make_tp_forward_sp(cfg, mesh)(local, toks)
        dense = tp_mod.shard_dense_params(inp["dense"], mesh)
        out[f"dense {key}"] = tp_mod.make_tp_forward(cfg, mesh)(dense, toks)
        if dp == 1:
            q = tp_mod.quantize_params_tp(
                {**inp["dense"], "layers": iter(inp["dense"]["layers"])},
                cfg, mesh)
            out[f"qtp {key}"] = q
            a, layer = inp["rs_a"], inp["rs_layers"][tp]
            k = a.shape[1]
            ks = k // tp
            a_l = a[:, t * ks:(t + 1) * ks]
            lay = tp_mod.local_linear_tp(layer, tp, "k", t)
            out[f"rs {key}"] = tp_mod.mul_fp4_tp_rs(a_l, lay, mesh, k)
            y = tp_mod._MULS["nvfp4"](a_l, lay["words"], lay["scales"],
                                      lay["gs"], a.shape[0],
                                      lay["words"].shape[1], ks, -1)
            full = tp_mod.all_reduce(y, tp_mod.mesh_axis(mesh, "tp"))
            out[f"rs all_reduce {key}"] = tp_mod._cols(full, tp, t)
    if world == 2:
        out["engine"] = _tp_engines(inp["engine"])
    return out


def _tp_engines(inp: dict) -> dict:
    """The TP Engine at (dp, tp) = (1, 2) over carried tiny params: the
    flat bf16 cache and the headed fp8 cache, each eager and in decode
    blocks of 4."""
    cfg = llama.LlamaConfig(**inp["cfg"])
    mesh = _mesh((1, 2), ("dp", "tp"))
    local = tp_mod.local_params_tp(inp["params"], 2,
                                   tp_mod.mesh_axis(mesh, "tp").rank)
    out = {}
    for tag, dtype, batch, reqs in (
            ("bf16", torch.bfloat16, 4, inp["reqs bf16"]),
            ("fp8", torch.float8_e4m3fn, 2, inp["reqs fp8"])):
        cache = tp_mod.init_cache_tp(cfg, batch, mesh, dtype=dtype)
        out[f"{tag} cache"] = (tuple(cache[0][0].shape), cache[0][0].dtype,
                               cache[0][0].device.type)
        for block in (1, 4):
            eng = serving.Engine(
                local, cfg, max_batch=batch,
                forward_fn=tp_mod.make_tp_step(cfg, mesh),
                cache=tp_mod.init_cache_tp(cfg, batch, mesh, dtype=dtype))
            out[f"{tag} block {block}"] = eng.run(
                [serving.Request(uid=u, tokens=np.asarray(p),
                                 max_new_tokens=n) for u, p, n in reqs],
                decode_block=block)
    return out


# ---------------------------------------------------------------------------
# Expert parallelism
# ---------------------------------------------------------------------------

def _ep_cases(world: int, inp: dict) -> dict:
    """The EP block over carried experts, moe.forward through it with each
    block's router input recorded, and the EP Engine over carried Mixtral
    params (eager and in decode blocks of 4), on a (1, world) mesh."""
    mesh = _mesh((1, world), ("dp", "ep"))
    blk = inp["block"]
    mcfg = moe.MoEConfig(**blk["moe_cfg"])
    experts, router = ep_mod.place_experts_ep(blk["experts"], blk["router"],
                                              mesh)
    out = {"block": ep_mod.make_moe_mlp_ep(mcfg, mesh)(blk["x"], router,
                                                      experts)}
    cfg = moe.MixtralConfig(**inp["cfg"])
    local = _ep_local(inp["params"], mesh)
    block = ep_mod.make_moe_mlp_ep(moe.MoEConfig(cfg.num_experts, cfg.top_k),
                                   mesh)
    seen = []

    def spy(x, router_w, ex):
        seen.append((x.float().numpy().copy(), router_w))
        return block(x, router_w, ex)

    logits, _ = moe.forward(local, inp["tokens"], cfg, moe_block_fn=spy)
    out.update(forward=logits, seen=seen)
    step = ep_mod.make_ep_step(cfg, mesh)
    for blk_n in (1, 4):
        eng = serving.Engine(local, cfg, max_batch=2, forward_fn=step,
                             cache=llama.init_cache(cfg, 2, device="cpu"))
        out[f"engine block {blk_n}"] = eng.run(
            [serving.Request(uid=u, tokens=np.asarray(p), max_new_tokens=n)
             for u, p, n in inp["reqs"]], decode_block=blk_n)
    return out


def _ep_local(params: dict, mesh) -> dict:
    """The rank's tree of a global EP tree: place_experts_ep per layer."""
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = []
    for lp in params["layers"]:
        q = dict(lp)
        q["experts"], q["router"] = ep_mod.place_experts_ep(
            lp["experts"], lp["router"], mesh)
        out["layers"].append(q)
    return out


# ---------------------------------------------------------------------------
# Pipeline parallelism
# ---------------------------------------------------------------------------

def _pp_cases(world: int, inp: dict) -> dict:
    """Every PP case of one world size: for each (dp, pp) mesh of
    inp["meshes"][world] and each format, the rank's place_params_pp tree
    and make_pp_forward's logits (n_micro 2); on a ("pp",) mesh of the
    world, for each format and each n_micro of inp["n_micro"], the
    pipelined decode of inp["prompt"]: its tokens teacher-forced through
    make_pp_step, then inp["n_new"] greedy tokens, and the stage's cache
    after."""
    cfg = llama.LlamaConfig(**inp["cfg"])
    out = {}
    for dp, pp in inp["meshes"][world]:
        mesh = _mesh((dp, pp), ("dp", "pp"))
        key = f"{dp}x{pp}"
        out[f"stage {key}"] = tp_mod.mesh_axis(mesh, "pp").rank
        for fmt, params in inp["params"].items():
            placed = pp_mod.place_params_pp(params, mesh)
            out[f"place {fmt} {key}"] = placed
            fwd = pp_mod.make_pp_forward(cfg, mesh, 2, fmt=fmt)
            out[f"fwd {fmt} {key}"] = fwd(placed, inp["tokens"])
    mesh = _mesh((world,), ("pp",))
    out["stage"] = tp_mod.mesh_axis(mesh, "pp").rank
    prompt = inp["prompt"]
    B, T0 = prompt.shape

    def pos(t):
        return torch.full((B,), t, dtype=torch.int32, device=prompt.device)

    for fmt, params in inp["params"].items():
        placed = pp_mod.place_params_pp(params, mesh)
        for n_micro in inp["n_micro"]:
            step = pp_mod.make_pp_step(cfg, mesh, n_micro, fmt=fmt)
            cache = pp_mod.init_cache_pp(cfg, B, mesh)
            for t in range(T0):
                logits, cache = step(placed, cache, prompt[:, t], pos(t))
            toks = [logits.argmax(-1).to(torch.int32)]
            for t in range(inp["n_new"] - 1):
                logits, cache = step(placed, cache, toks[-1], pos(T0 + t))
                toks.append(logits.argmax(-1).to(torch.int32))
            out[f"decode {fmt} {n_micro}"] = dict(
                tokens=torch.stack(toks, dim=1), cache=cache,
                logits=logits)
    return out


# ---------------------------------------------------------------------------
# The dense TP and SP training steps
# ---------------------------------------------------------------------------

def nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The JAX dry run's loss: the mean negative log-likelihood of the
    targets under f32 log-softmax of the logits."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long()[..., None]).mean()


def _train_cases(world: int, inp: dict) -> dict:
    """For each (dp, tp) mesh of inp["meshes"][world] and each forward
    (make_tp_forward, make_tp_forward_sp): the rank's shard_dense_params
    shards as leaves that require grad, the loss of inp["tokens"] (inputs
    tokens[:, :-1], targets tokens[:, 1:]), every leaf's gradient after
    loss.backward(), and one SGD step's updated shards (w - lr g, in the
    leaf's dtype, as the JAX dry run's train_step); and whether both
    forwards over shards that require no grad ran under inference mode."""
    cfg = llama.LlamaConfig(**inp["cfg"])
    toks = inp["tokens"]
    out = {}
    for dp, tp in inp["meshes"][world]:
        mesh = _mesh((dp, tp), ("dp", "tp"))
        for kind, make in (("tp", tp_mod.make_tp_forward),
                           ("sp", tp_mod.make_tp_forward_sp)):
            local = _leaf_tree(tp_mod.shard_dense_params(inp["dense"], mesh),
                               lambda t: t.detach().clone().requires_grad_())
            logits = make(cfg, mesh, fmt="bf16")(local, toks[:, :-1])
            loss = nll(logits, toks[:, 1:])
            loss.backward()
            with torch.no_grad():
                new = _leaf_tree(local, lambda w: w - inp["lr"] * w.grad.to(
                    w.dtype))
            out[f"{kind} {dp}x{tp}"] = dict(
                loss=loss.item(), grads=_leaf_tree(local, lambda w: w.grad),
                new=new, tp_rank=tp_mod.mesh_axis(mesh, "tp").rank,
                logits_grad_fn=logits.grad_fn is not None)
        frozen = tp_mod.shard_dense_params(inp["dense"], mesh)
        out[f"frozen {dp}x{tp}"] = [
            make(cfg, mesh, fmt="bf16")(frozen, toks[:, :-1]).is_inference()
            for make in (tp_mod.make_tp_forward, tp_mod.make_tp_forward_sp)]
    return out


JOBS = {"tp": _tp_cases, "ep": _ep_cases, "pp": _pp_cases,
        "train": _train_cases}
