"""GPipe pipeline parallelism for the Llama stack over torch.distributed
(torch).

Counterpart of petit_kernel_tpu/parallel/pp.py. The JAX package stacks
the layers on a leading axis, shards that axis over a Mesh's "pp" axis and
runs the GPipe schedule (n_micro + S - 1 ticks) in one shard_map, moving
each tick's activations to the next stage with lax.ppermute. Here a
DeviceMesh with a "pp" dim (and "dp" for the forward) takes the Mesh's
place, and each rank holds only its stage and runs the shard_map body:

  place_params_pp    the rank's stage: layers [s L/S, (s+1) L/S) stacked
                     on a leading axis (stack_layers); embed, final_norm
                     and lm_head whole
  init_cache_pp      the stage's KV cache, (L/S, B, max_seq_len, Hkv, d)
                     flat, K and V
  make_pp_step       the pipelined decode step over that cache
  make_pp_forward    the pipelined cacheless forward

At tick t stage s runs microbatch m = t - s when 0 <= m < n_micro: its
layers over rows [m mb, (m+1) mb) (mb = B / n_micro), through the port's
kernels (llama.attention and llama.mlp; the decode step's KV written at
pos by the append kernel into a view of the stage's cache). Its output
goes to stage s + 1 at the end of the tick: one dist.batch_isend_irecv a
tick pairs each send with the receive its next stage posts. Inactive
(bubble) ticks are skipped, where the JAX package computes them on zeros
with the KV write masked: the outputs and the cache bytes are the same.
The ring's last hop (stage S - 1 to stage 0, which never reads it) is not
sent, so one stage runs no point-to-point at all (torch.distributed
refuses a send to oneself). The last stage's result is broadcast over
"pp", where the JAX package psums it with every other stage's zeros: every
rank returns the same logits.

A "cpu" mesh (gloo) builds on the CPU, any other on the CUDA card
(tp.mesh_device). Every entry point runs under torch.inference_mode.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models import llama
from .tp import map_tensors, mesh_axis, mesh_device


def stack_layers(layers: list):
    """A list of per-layer trees (dicts and lists of tensors) -> one tree
    of the same structure, each tensor leaf stacked on a new leading layer
    axis: dense {"w"} and quantized {"words", "scales", "gs"} leaves alike,
    fused wqkv / w_gateup included. A non-tensor leaf (a hybrid layer's
    HybridMeta) must be equal in every layer and is kept once."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: stack_layers([lp[k] for lp in layers]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_layers([lp[i] for lp in layers])
                           for i in range(len(first)))
    if isinstance(first, torch.Tensor):
        return torch.stack(layers)
    if any(x != first for x in layers[1:]):
        raise ValueError(f"layers differ in a non-tensor leaf: {first!r}")
    return first


def layer_of(stacked, i: int):
    """Layer i of a stacked tree: each tensor leaf's index i along the
    layer axis, a view (words, scales and norms contiguous; gs 0-dim)."""
    return map_tensors(stacked, lambda t: t[i])


def local_layers_pp(stacked, pp: int, stage: int):
    """Stage `stage`'s block of a stacked tree of every layer: the layers
    [stage L/pp, (stage+1) L/pp) of each tensor leaf, as its own tensor."""
    def block(t):
        if t.shape[0] % pp:
            raise ValueError(f"{t.shape[0]} layers do not split over "
                             f"pp = {pp}")
        per = t.shape[0] // pp
        return t[stage * per:(stage + 1) * per].clone()

    return map_tensors(stacked, block)


def _stages(cfg: llama.LlamaConfig, mesh):
    """The "pp" Axis of the mesh and the layers a stage holds."""
    pp = mesh_axis(mesh, "pp")
    if cfg.num_layers % pp.size:
        raise ValueError(f"{cfg.num_layers} layers do not split over "
                         f"pp = {pp.size}")
    return pp, cfg.num_layers // pp.size


def place_params_pp(params: dict, mesh) -> dict:
    """The calling rank's stage of a Llama tree (dense or quantized), on
    the mesh's device: "layers" its stage's layers stacked (stack_layers),
    embed, final_norm and lm_head whole."""
    pp = mesh_axis(mesh, "pp")
    n = len(params["layers"])
    if n % pp.size:
        raise ValueError(f"{n} layers do not split over pp = {pp.size}")
    per = n // pp.size
    mine = params["layers"][pp.rank * per:(pp.rank + 1) * per]
    out = {"embed": params["embed"], "final_norm": params["final_norm"],
           "lm_head": params["lm_head"], "layers": stack_layers(mine)}
    dev = mesh_device(mesh)
    return map_tensors(out, lambda t: t.to(dev))


def init_cache_pp(cfg: llama.LlamaConfig, batch: int, mesh,
                  dtype=torch.bfloat16):
    """The stage's KV cache for pipelined decode: (k, v), each zeros of
    shape (L/S, batch, max_seq_len, Hkv, d), the flat layout, on the
    mesh's device."""
    _, per = _stages(cfg, mesh)
    shape = (per, batch, cfg.max_seq_len, cfg.num_kv_heads, cfg.head_dim)
    dev = mesh_device(mesh)
    return tuple(torch.zeros(shape, dtype=dtype, device=dev)
                 for _ in range(2))


class _Ring:
    """The calling stage's neighbours on the "pp" group, as global ranks
    (P2POp takes global ranks), and one tick's exchange: the stage's
    output to stage s + 1 when it ran, its next input from stage s - 1
    when that one ran, paired in one batch_isend_irecv."""

    def __init__(self, pp):
        self.pp = pp
        s, S = pp.rank, pp.size
        self.prev = dist.get_global_rank(pp.group, s - 1) if s > 0 else None
        self.next = (dist.get_global_rank(pp.group, s + 1) if s < S - 1
                     else None)
        self.last = dist.get_global_rank(pp.group, S - 1)

    def exchange(self, t: int, n_micro: int, y, recv_like):
        """End of tick t: send y (None when this stage sat idle) on, and
        return the input received for tick t + 1 (None when none comes)."""
        ops, buf = [], None
        if y is not None and self.next is not None:
            ops.append(dist.P2POp(dist.isend, y.contiguous(), self.next,
                                  group=self.pp.group))
        # stage s - 1 ran microbatch t - (s - 1) at this tick
        if self.prev is not None and 0 <= t - self.pp.rank + 1 < n_micro:
            buf = torch.empty_like(recv_like)
            ops.append(dist.P2POp(dist.irecv, buf, self.prev,
                                  group=self.pp.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return buf

    def from_last(self, x: torch.Tensor) -> torch.Tensor:
        """x as the last stage holds it, on every stage (in place)."""
        dist.broadcast(x, src=self.last, group=self.pp.group)
        return x


def _block(h, lp, cfg, cache, pos, fmt, kv_window, rope_cs):
    """One decoder layer: the JAX package's _layer_forward (and its decode
    step's scan body) through llama.attention and llama.mlp."""
    hh = llama.rms_norm(h, lp["attn_norm"], cfg.rms_eps)
    h = h + llama.attention(hh, lp, cache, pos, cfg, fmt=fmt,
                            kv_window=kv_window, rope_cs=rope_cs)
    hh = llama.rms_norm(h, lp["mlp_norm"], cfg.rms_eps)
    return h + llama.mlp(hh, lp, fmt=fmt)


def _check_batch(B: int, n_micro: int) -> int:
    if n_micro < 1 or B % n_micro:
        raise ValueError(f"batch {B} does not split into {n_micro} "
                         "microbatches")
    return B // n_micro


def make_pp_step(cfg: llama.LlamaConfig, mesh, n_micro: int, *,
                 fmt: str = "bf16"):
    """The pipelined decode step: (params_pp, (ck, cv), toks (B,), pos (B,))
    -> (logits (B, V) bf16, (ck, cv)), over the rank's stage
    (place_params_pp) and stage cache (init_cache_pp), which it updates in
    place. One token a sequence flows through the GPipe schedule; each
    stage writes its layers' K/V at each row's pos and attends positions
    <= pos through the whole cache (kv_window = max_seq_len), as the JAX
    step attends it. The last stage applies final_norm and lm_head (a bf16
    product summed in f32, rounded once, as the JAX step's f32 dot cast to
    bf16)."""
    pp, per = _stages(cfg, mesh)
    ring = _Ring(pp)
    s, S = pp.rank, pp.size

    @torch.inference_mode()
    def step(params_pp, cache, toks, pos):
        B = toks.shape[0]
        mb = _check_batch(B, n_micro)
        ck, cv = cache
        layers = [layer_of(params_pp["layers"], i) for i in range(per)]
        embed = params_pp["embed"]
        like = torch.empty((mb, 1, cfg.hidden_size), dtype=embed.dtype,
                           device=embed.device)
        out = torch.empty((B, cfg.vocab_size), dtype=torch.bfloat16,
                          device=embed.device)
        h_in = embed[toks.long()] if s == 0 else None
        buf = None
        for t in range(n_micro + S - 1):
            m = t - s
            y = None
            if 0 <= m < n_micro:
                rows = slice(m * mb, (m + 1) * mb)
                pos_m = pos[rows].reshape(mb, 1)
                rope_cs = llama._rope_angles(pos_m, cfg.head_dim,
                                             cfg.rope_theta)
                y = h_in[rows, None] if s == 0 else buf
                for i, lp in enumerate(layers):
                    y = _block(y, lp, cfg, (ck[i, rows], cv[i, rows]),
                               pos_m, fmt, cfg.max_seq_len, rope_cs)
                if s == S - 1:
                    x = llama.rms_norm(y[:, 0], params_pp["final_norm"],
                                       cfg.rms_eps)
                    out[rows] = llama.linear(x, params_pp["lm_head"],
                                             fmt=fmt)
            buf = ring.exchange(t, n_micro, y, like)
        return ring.from_last(out), (ck, cv)

    return step


def make_pp_forward(cfg: llama.LlamaConfig, mesh, n_micro: int, *,
                    fmt: str = "bf16"):
    """The pipelined cacheless forward: (params_pp, tokens (B, T)) ->
    logits (B, T, V) bf16. Tokens are replicated (every "dp" replica runs
    the same pipeline); microbatches of B / n_micro sequences stream
    through the stages, stage 0 embeds, the last stage's hidden stream is
    broadcast over "pp" and every rank applies final_norm and lm_head."""
    pp, per = _stages(cfg, mesh)
    ring = _Ring(pp)
    s, S = pp.rank, pp.size

    @torch.inference_mode()
    def forward(params_pp, tokens):
        B, T = tokens.shape
        mb = _check_batch(B, n_micro)
        embed = params_pp["embed"]
        dev = embed.device
        layers = [layer_of(params_pp["layers"], i) for i in range(per)]
        pos = torch.arange(T, device=dev)[None, :].expand(mb, T)
        rope_cs = llama._rope_angles(pos, cfg.head_dim, cfg.rope_theta)
        like = torch.empty((mb, T, cfg.hidden_size), dtype=embed.dtype,
                           device=dev)
        hidden = torch.empty((B, T, cfg.hidden_size), dtype=embed.dtype,
                             device=dev)
        h_in = embed[tokens.long()] if s == 0 else None
        buf = None
        for t in range(n_micro + S - 1):
            m = t - s
            y = None
            if 0 <= m < n_micro:
                rows = slice(m * mb, (m + 1) * mb)
                y = h_in[rows] if s == 0 else buf
                for lp in layers:
                    y = _block(y, lp, cfg, None, pos, fmt, None, rope_cs)
                if s == S - 1:
                    hidden[rows] = y
            buf = ring.exchange(t, n_micro, y, like)
        x = llama.rms_norm(ring.from_last(hidden), params_pp["final_norm"],
                           cfg.rms_eps)
        return llama.linear(x, params_pp["lm_head"], fmt=fmt)

    return forward
