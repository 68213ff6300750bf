"""Continuous-batching serving engine for FP4 models (torch).

Counterpart of petit_kernel_tpu/models/serving.py (Request, the prefill
buckets, sample_next, Engine with run(decode_block=N), step_block, the
pipelined block drain and score_forward over a bf16 or fp8 cache, and
PagedEngine). The JAX engine compiles its steps with jit and donates the
cache; this one runs eagerly and updates the cache tensors in place.
Scheduling state lives on the host, as numpy arrays: slots, per-slot
positions, the chunked-prefill queue. step() reads the sampled tokens back
to the host once a step.

Decode blocks (step_block, run(decode_block > 1)) run K decode steps for
one host read of their tokens, in every engine: the contiguous Engine, an
Engine with forward_fn (Mixtral) and PagedEngine. On the card each step of
a block is a replay of one captured CUDA graph of the decode step (the
engine's step forward, _block_forward, at T = 1, sample_next, then the
step's own advance of the device-resident tokens and positions), one graph
a kv_window bucket; step t of a block takes the bucket that step() would
take there, so a block is bit for bit K step() calls from the same state
while no slot finishes inside it. A PagedEngine's steps read a static copy
of its block table, uploaded once a block after _grow_for_block has given
every active slot the pages of the whole block. On the CPU the same steps
run eagerly over the same buffers.

Engine takes a custom forward_fn (models/moe.make_engine_forward serves
Mixtral through it; parallel/tp.make_tp_step and parallel/ep.make_ep_step
serve tensor- and expert-parallel models, an Engine on every rank, their
collectives captured into the decode graphs) and a cache built by the
caller; a forward_fn without kv_window or write_mask is served as the JAX
engine serves it, except that the rows it may not let write are parked at
the last position (Engine.__init__). prefill_fmt="w4a8"
runs prefill chunks and batched admissions through the W4A8 GEMM over the
nvfp4 weights while decode keeps fmt (llama.linear routes chunks of fewer
than llama.W4A8_MIN_M rows to the exact kernel). fmt="hybrid" serves a
model quantized with llama.quantize_params(params, "hybrid"): its split
layers run the hybrid GEMM, layers too narrow to split nvfp4.
score_forward gives full-sequence logits through the engine's own prefill
forward over a zeroed scratch cache (models/eval.py scores through it).
Every forward of an engine runs under torch.inference_mode().

SpecEngine (greedy draft-verify speculative decoding) fills a draft cache
alongside the target's at admission and runs each tick, g draft forwards,
the target's verify at T = g + 1 and the accept count, as one function
over static buffers: on the card one replay of its (g, window) CUDA graph
and one host read, on the CPU eagerly. Engine admits same-key prompts
together only where no subclass re-routes the per-slot chunk
(_admission_batchable; PagedEngine batches through its own hook), and
pipelines its block drain only where _pipeline_blocks holds (not in
SpecEngine).
"""

from __future__ import annotations

import dataclasses
import gc
import inspect
import time
from typing import Optional

import numpy as np
import torch

from . import llama, paged


@dataclasses.dataclass
class Request:
    uid: int
    tokens: np.ndarray          # prompt token ids, (T,)
    max_new_tokens: int = 32
    eos_id: int = -1            # -1: never stops on eos
    temperature: float = 0.0    # 0: greedy; > 0: gumbel-max sampling


# Chunked-prefill geometry: prompts advance at most PREFILL_CHUNK tokens per
# engine tick, each chunk right-padded to a bucket.
PREFILL_BUCKETS = (16, 32, 64, 128, 256)
PREFILL_CHUNK = PREFILL_BUCKETS[-1]
# prefill_fmt="w4a8" admits up to this many tokens a chunk by default: the
# JAX package's value, kept for parity (PERF.md records the H100's
# W4A8-versus-exact crossover)
W4A8_PREFILL_CHUNK = 512


def _bucket_len(n: int, cap: Optional[int] = None) -> int:
    """Smallest bucket >= n; with `cap`, the buckets below cap plus cap."""
    bs = list(PREFILL_BUCKETS)
    if cap is not None:
        bs = [b for b in bs if b < cap] + [cap]
    for b in bs:
        if n <= b:
            return b
    return bs[-1]


@dataclasses.dataclass
class _PrefillJob:
    req: Request
    slot: int
    offset: int = 0             # tokens already written to the cache


def _w4a8_precompute(params: dict) -> dict:
    """params with the W4A8 requantization constants (r_t, acol) of every
    FP4 projection added (fused.w4a8_requant_constants), computed once so
    that a prefill GEMM does not derive them from the scales per call. New
    dicts only: the weight tensors are shared, not copied. llama.linear
    picks the constants up by key."""
    from ..ops.kernels import fused

    def aug(d):
        if isinstance(d, dict) and "words" in d and "r_t" not in d:
            r_t, acol = fused.w4a8_requant_constants(d["scales"])
            return {**d, "r_t": r_t, "acol": acol}
        return d

    out = dict(params)
    out["layers"] = [{k: aug(v) for k, v in lp.items()}
                     for lp in params["layers"]]
    out["lm_head"] = aug(params["lm_head"])
    return out


def _llama_forward(cfg: llama.LlamaConfig, fmt: str):
    def forward(p, toks, cache_, pos, kv_window=None, write_mask=None):
        return llama.forward(p, toks, cfg, cache_, pos, fmt=fmt,
                             kv_window=kv_window, write_mask=write_mask)
    return forward


def sample_next(logits: torch.Tensor, generator: torch.Generator,
                temps: torch.Tensor, top_k: int = 0) -> torch.Tensor:
    """Per-slot next token from (B, V) logits: greedy where temps[b] == 0,
    otherwise gumbel-max sampling at temperature temps[b] with noise from
    `generator` (on the logits' device), optionally within the top_k
    logits. Returns int32 (B,) on the logits' device."""
    lg = logits.float()
    greedy = lg.argmax(dim=-1).to(torch.int32)
    if top_k:
        kth = torch.topk(lg, top_k, dim=-1).values[:, -1:]
        lg = torch.where(lg >= kth, lg, float("-inf"))
    safe_t = torch.where(temps > 0, temps, 1.0)[:, None]
    u = torch.rand(lg.shape, generator=generator, device=lg.device)
    g = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    sampled = (lg / safe_t + g).argmax(dim=-1).to(torch.int32)
    return torch.where(temps > 0, sampled, greedy)


def _capture_graph(eng: "Engine", stream, pool, warm_up, body):
    """Capture body() into a new CUDA graph on `stream`, into the memory
    pool `pool`, with the engine's generator registered (each replay draws
    fresh noise). warm_up(), when given, runs first on the same stream,
    outside the graph, so that what the kernels make at first use (the
    split counters, kept per stream, cuBLAS's per-stream workspace, tables
    cached at first use) exists before the capture. Python's garbage
    collector runs just before the capture and not during it: an engine
    dropped earlier sits in a reference cycle with its graphs (eng._ticks
    or eng._blocks refers back to eng), and a collection inside the
    capture would destroy those graphs there, which invalidates the
    capture. A failed capture raises. Returns (graph, body's outputs)."""
    cur = torch.cuda.current_stream(eng.device)
    stream.wait_stream(cur)
    if warm_up is not None:
        with torch.cuda.stream(stream):
            warm_up()
        cur.wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(eng.generator)
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.inference_mode(), torch.cuda.graph(graph, pool=pool,
                                                      stream=stream):
            out = body()
    finally:
        if enabled:
            gc.enable()
    return graph, out


@dataclasses.dataclass
class _Block:
    """A dispatched decode block: its (steps, B) tokens in host memory and,
    on the card, the event after which they are there."""
    host: torch.Tensor
    steps: int
    done: Optional[torch.cuda.Event] = None


class _DecodeBlocks:
    """The device half of an Engine's decode blocks: four static buffers
    the steps of a block read and advance in place (toks (B, 1) int32, pos
    (B, 1) int32, active (B,) bool as the write mask, temps (B,) f32), one
    more for each of the engine's own step inputs (Engine._block_inputs: a
    PagedEngine's block table `tables`, (B, max_pages) int32), two
    (max_seq_len, B) int32 output buffers a block's tokens go to, and on
    the card one CUDA graph of the decode step a kv_window bucket.

    On the card: host state reaches the static buffers once a block, from
    pinned memory with non_blocking copies in stream order; a block's
    tokens come back once, a non_blocking copy into pinned memory followed
    by an event. The output and staging buffers alternate between blocks,
    so the pipelined drain can enqueue one block while the last is read.
    Graphs are captured lazily at the first use of their bucket on a side
    stream of their own, after one eager warm-up of the engine's step
    forward on that stream (so the split counters, kept per stream,
    cuBLAS's per-stream workspace and the tables the kernels cache at
    first use are made outside any graph), into one memory pool: they
    replay one at a time on the caller's stream, and each keeps its
    outputs alive. A graph holds the engine's params and cache tensors (a
    PagedEngine's pools); replacing them needs a new engine. A failed
    capture raises: there is no eager path on the card. On the CPU each
    step runs eagerly over the same buffers."""

    def __init__(self, eng: "Engine"):
        self.eng = eng
        dev = eng.device
        B, S = eng.B, eng.cfg.max_seq_len
        self.cuda = dev.type == "cuda"
        shapes = dict(toks=((B, 1), torch.int32), pos=((B, 1), torch.int32),
                      active=((B,), torch.bool), temps=((B,), torch.float32))
        inputs = eng._block_inputs()
        self.inputs = list(inputs)
        for name, a in inputs.items():
            shapes[name] = (a.shape, torch.from_numpy(a).dtype)
        with torch.inference_mode():
            for name, (shape, dtype) in shapes.items():
                setattr(self, name, torch.zeros(shape, dtype=dtype,
                                                device=dev))
            self.outs = [torch.zeros((S, B), dtype=torch.int32, device=dev)
                         for _ in range(2)]
        pin = self.cuda
        self.host_outs = [torch.zeros((S, B), dtype=torch.int32,
                                      pin_memory=pin) for _ in range(2)]
        # per parity: host (pinned) copies of the static buffers, and the
        # event after their last upload
        self.staging = [{name: torch.zeros(shape, dtype=dtype, pin_memory=pin)
                         for name, (shape, dtype) in shapes.items()}
                        for _ in range(2)]
        self.uploaded: list[Optional[torch.cuda.Event]] = [None, None]
        self.parity = 0
        # kv_window -> (graph, logits, next tokens); the outputs are static
        self.graphs: dict[int, tuple] = {}
        self.capture_s = 0.0
        self.stream = torch.cuda.Stream(dev) if self.cuda else None
        self.pool = torch.cuda.graph_pool_handle() if self.cuda else None

    def _upload(self, toks, pos) -> None:
        """Copy the engine's active mask, temperatures and block inputs,
        and with toks (host (B,) arrays toks and pos) the tokens and
        positions, into the static buffers, in stream order."""
        eng, p = self.eng, self.parity
        st, ev = self.staging[p], self.uploaded[p]
        if ev is not None and not ev.query():
            ev.synchronize()           # the staging's last upload is read
        names = ["active", "temps", *self.inputs]
        st["active"].numpy()[:] = eng.active
        st["temps"].numpy()[:] = eng.temps
        for name, a in eng._block_inputs().items():
            st[name].numpy()[:] = a
        if toks is not None:
            st["toks"].numpy()[:, 0] = toks
            st["pos"].numpy()[:, 0] = pos
            names += ["toks", "pos"]
        for name in names:
            getattr(self, name).copy_(st[name], non_blocking=self.cuda)
        if self.cuda:
            self.uploaded[p] = torch.cuda.Event()
            self.uploaded[p].record()

    def _step(self, window: int):
        """One decode step over the static buffers: the forward at the
        window, sample_next, then the step's own advance (active rows take
        the sampled token; pos += active, so an idle row never walks past
        the cache). Returns (logits (B, 1, V), next tokens (B,))."""
        eng = self.eng
        logits = eng._block_forward(self, window, self.active)
        nxt = sample_next(logits[:, -1], eng.generator, self.temps,
                          eng.top_k)
        torch.where(self.active[:, None], nxt[:, None], self.toks,
                    out=self.toks)
        self.pos.add_(self.active[:, None])
        return logits, nxt

    def _capture(self, window: int) -> tuple:
        """Capture _step at `window` into a graph (registering the engine's
        generator, so that each replay draws fresh noise) and keep it."""
        eng = self.eng
        t0 = time.perf_counter()
        # before the first graph, the forward alone with every row masked:
        # it writes no cache row (a paged pool's masked rows write its
        # scratch page) and draws no noise. A forward without write_mask
        # would park every row at max_seq_len - 1 there, so it runs on the
        # block's own mask: the first replay rewrites what it writes, with
        # the same bytes
        mask = (torch.zeros_like(self.active) if eng._fwd_takes_mask
                else self.active)
        warm = None if self.graphs else (lambda: eng._block_forward(
            self, window, mask))
        graph, (logits, nxt) = _capture_graph(
            eng, self.stream, self.pool, warm, lambda: self._step(window))
        self.graphs[window] = (graph, logits, nxt)
        self.capture_s += time.perf_counter() - t0
        return self.graphs[window]

    def step(self, window: int):
        """One decode step of a block: on the card a replay of the
        window's graph (captured at its first use), on the CPU _step.
        Returns (logits, next tokens), the graph's static outputs on the
        card."""
        if not self.cuda:
            return self._step(window)
        graph, logits, nxt = (self.graphs.get(window)
                              or self._capture(window))
        graph.replay()
        return logits, nxt

    @torch.inference_mode()
    def dispatch(self, toks, pos: np.ndarray, steps: int) -> _Block:
        """Enqueue `steps` decode steps of the engine's active slots and
        the copy of their tokens to the host; nothing waits on the device
        (unless a bucket's graph is captured). toks None: start from the
        tokens and positions the last block left on the device, whose
        positions the host projects as `pos`. Step t attends through
        eng._kv_window(pos=pos + t * active)."""
        eng = self.eng
        self._upload(toks, None if toks is None else pos)
        out = self.outs[self.parity]
        proj = pos.copy()
        for t in range(steps):
            _, nxt = self.step(eng._kv_window(pos=proj))
            out[t].copy_(nxt)
            proj[eng.active] += 1
        host = self.host_outs[self.parity][:steps]
        host.copy_(out[:steps], non_blocking=self.cuda)
        done = None
        if self.cuda:
            done = torch.cuda.Event()
            done.record()
        self.parity ^= 1
        return _Block(host, steps, done)


class Engine:
    """Slot-based continuous batching over a llama-family FP4 model."""

    # run() keeps one decode block in flight while the last is read
    # (_drain_blocks_pipelined); SpecEngine opts out: its step_block is a
    # speculative tick with its own scheduling
    _pipeline_blocks = True

    def __init__(self, params, cfg: llama.LlamaConfig, *, max_batch: int = 8,
                 fmt: str = "nvfp4", cache_dtype=torch.bfloat16,
                 forward_fn=None, cache=None,
                 top_k: int = 0, seed: int = 0,
                 prefill_fmt: Optional[str] = None,
                 prefill_chunk: Optional[int] = None):
        """The engine runs on the device its params lie on, with a KV cache
        of max_batch slots: `cache` when given, else llama.init_cache on
        that device, flat bf16 or headed fp8 for
        cache_dtype=torch.float8_e4m3fn. forward_fn(params, tokens (B, T),
        cache, pos (B, T), kv_window=, write_mask=) -> (logits, cache)
        replaces llama.forward for prefill, batched admission and decode
        (moe.make_engine_forward, and on every rank of a mesh
        parallel.tp.make_tp_step with cache=parallel.tp.init_cache_tp or
        parallel.ep.make_ep_step). A forward_fn that takes neither
        kv_window nor write_mask, or only one, is served as the JAX engine
        serves it: without the argument it lacks. Without kv_window it
        attends through a window of its own choosing, decode blocks
        capture one graph (no window key) and score_forward passes none;
        without write_mask admissions run one prompt a chunk, and a
        forward that passes write_mask on gives the rows that may not
        write the last position, max_seq_len - 1, instead: a slot writes
        that position in the same forward before it ever attends it (the
        JAX engine lets such rows write at their own position, which
        overwrites the KV of a prompt mid-prefill). Sampling:
        per-request temperature (Request.temperature, 0 = greedy) with an
        engine-wide top_k; the noise comes from a torch.Generator on the
        engine's device seeded with `seed`.

        prefill_fmt (default fmt) runs prefill chunks and batched
        admissions through another GEMM over the same weights: "w4a8" with
        fmt "nvfp4" (or both "w4a8") is the only other pair, and any other
        raises ValueError. Under "w4a8" the engine adds the requantization
        constants to its params once (_w4a8_precompute) and prefill_chunk
        defaults to W4A8_PREFILL_CHUNK. With forward_fn, prefill_fmt
        selects no forward, as in the JAX package; the chunk default
        still follows it there."""
        self.prefill_fmt = prefill_fmt or fmt
        if prefill_chunk is None and self.prefill_fmt == "w4a8":
            prefill_chunk = W4A8_PREFILL_CHUNK
        if forward_fn is None:
            if self.prefill_fmt != fmt \
                    and not {fmt, self.prefill_fmt} <= {"nvfp4", "w4a8"}:
                raise ValueError(f"prefill_fmt={self.prefill_fmt!r} is not "
                                 f"container-compatible with fmt={fmt!r}")
            if self.prefill_fmt == "w4a8":
                params = _w4a8_precompute(params)
            forward_fn = _llama_forward(cfg, fmt)
            prefill_fn = _llama_forward(cfg, self.prefill_fmt)
        else:
            prefill_fn = forward_fn
        takes = inspect.signature(forward_fn).parameters
        self._fwd_takes_window = "kv_window" in takes
        self._fwd_takes_mask = "write_mask" in takes
        self._forward_fn = forward_fn
        self._prefill_fn = prefill_fn
        self.params = params
        self.cfg = cfg
        self.B = max_batch
        self.fmt = fmt
        self.device = params["embed"].device
        self.prefill_chunk = (min(prefill_chunk, cfg.max_seq_len)
                              if prefill_chunk else None)
        self.top_k = top_k
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        if cache is not None:
            self.cache = cache
        else:
            self._init_cache(cache_dtype)
        self.pos = np.zeros(max_batch, np.int32)       # next position
        self.active = np.zeros(max_batch, bool)
        self.last_tok = np.zeros(max_batch, np.int32)
        self.temps = np.zeros(max_batch, np.float32)
        self.slot_req: list[Optional[Request]] = [None] * max_batch
        self.generated: dict[int, list[int]] = {}
        self.finished: dict[int, list[int]] = {}
        self._pf: list[_PrefillJob] = []   # chunked-prefill queue
        self._blocks: Optional[_DecodeBlocks] = None   # made at first use

    def _init_cache(self, cache_dtype) -> None:
        self.cache = llama.init_cache(self.cfg, self.B, cache_dtype,
                                      device=self.device)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    def _call(self, fn, toks, cache, pos, kv_window, write_mask):
        """fn over the engine's params with the arguments it takes: no
        kv_window for a forward without one; for a forward without
        write_mask, the rows that may not write at max_seq_len - 1 (the
        constructor's docstring)."""
        kw = {}
        if self._fwd_takes_window:
            kw["kv_window"] = kv_window
        if self._fwd_takes_mask:
            kw["write_mask"] = write_mask
        elif write_mask is not None:
            pos = torch.where(write_mask[:, None], pos,
                              self.cfg.max_seq_len - 1)
        return fn(self.params, toks, cache, pos, **kw)

    # every forward of the engine (forward_fn or llama.forward) runs under
    # inference mode: no step builds an autograd graph, whatever the params
    # require
    @torch.inference_mode()
    def _forward(self, toks, cache, pos, kv_window=None, write_mask=None):
        return self._call(self._forward_fn, toks, cache, pos, kv_window,
                          write_mask)

    @torch.inference_mode()
    def _prefill_forward(self, toks, cache, pos, kv_window=None,
                         write_mask=None):
        """_forward in prefill_fmt: prefill chunks and batched admission."""
        return self._call(self._prefill_fn, toks, cache, pos, kv_window,
                          write_mask)

    # -- scheduling ---------------------------------------------------------

    def reset(self) -> None:
        """Clear all scheduling state and release every slot; the cache
        storage stays."""
        for slot, r in enumerate(self.slot_req):
            if r is not None:
                self._release(slot)
        self.pos[:] = 0
        self.active[:] = False
        self.last_tok[:] = 0
        self.temps[:] = 0.0
        self.slot_req = [None] * self.B
        self.generated = {}
        self.finished = {}
        self._pf = []

    def has_capacity(self) -> bool:
        return any(r is None for r in self.slot_req)

    def add_request(self, req: Request) -> int:
        """Reserve a free slot and queue the prompt for chunked prefill (one
        chunk per step(); the slot decodes from the tick after its last
        chunk). Returns the slot index."""
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        if not free:
            raise RuntimeError("no free slot")
        slot = free[0]
        if len(req.tokens) + req.max_new_tokens > self.cfg.max_seq_len:
            raise ValueError(f"request {req.uid}: prompt + max_new_tokens "
                             f"exceeds max_seq_len {self.cfg.max_seq_len}")
        self.temps[slot] = req.temperature
        self.slot_req[slot] = req
        self.pos[slot] = 0
        self._pf.append(_PrefillJob(req, slot))
        return slot

    def _chunk_key(self, job) -> tuple:
        """(bucket_len, kv_window) of the job's next chunk: jobs with equal
        keys are admitted together. The bucket never runs past max_seq_len:
        the JAX engine's dynamic_update_slice clamps such a chunk's start
        and overwrites earlier KV (ROADMAP.md, queue 3)."""
        cap = self.prefill_chunk or PREFILL_CHUNK
        n = min(len(job.req.tokens) - job.offset, cap)
        lb = min(_bucket_len(n, self.prefill_chunk),
                 self.cfg.max_seq_len - job.offset)
        return lb, llama.decode_window(job.offset + lb, self.cfg.max_seq_len)

    def _advance_prefill(self) -> None:
        """Advance the prefill queue by one chunk: every queued prompt whose
        next chunk shares the oldest job's (bucket, window) key is admitted
        in one full-batch forward with write_mask (the weights stream once
        per chunk shape, not once per prompt); a lone job runs on its own
        slot."""
        job = self._pf[0]
        cap = self.prefill_chunk or PREFILL_CHUNK
        lb, kv_window = self._chunk_key(job)
        group = ([j for j in self._pf
                  if self._chunk_key(j) == (lb, kv_window)]
                 if self._admission_batchable() else [job])
        if len(group) >= 2:
            self._admit_batched(group, lb, kv_window, cap)
            return
        toks = np.asarray(job.req.tokens)
        chunk = toks[job.offset:job.offset + cap]
        n = len(chunk)
        padded = np.zeros((1, lb), np.int32)
        padded[0, :n] = chunk
        pos = (job.offset + np.arange(lb, dtype=np.int32))[None, :]
        logits = self._prefill_chunk(job.slot, padded, pos, kv_window)
        first = sample_next(logits[:, n - 1], self.generator,
                            self._dev(self.temps[job.slot:job.slot + 1]),
                            self.top_k)
        job.offset += n
        if job.offset == len(toks):
            self._pf.pop(0)
            self._start_decoding(job, int(first[0]))

    def _admission_batchable(self) -> bool:
        """Whether _advance_prefill may admit same-key jobs together through
        _run_batched_admission: not when a subclass re-routes the per-slot
        chunk (_prefill_chunk), as SpecEngine does to fill its draft cache,
        which the batched forward would leave empty, nor when the forward
        takes no write_mask (the JAX engine's rule). PagedEngine batches
        through its own _run_batched_admission."""
        return (self._fwd_takes_mask
                and type(self)._prefill_chunk is Engine._prefill_chunk)

    def _start_decoding(self, job: _PrefillJob, first: int) -> None:
        slot = job.slot
        self.pos[slot] = len(job.req.tokens)
        self.active[slot] = True
        self.last_tok[slot] = first
        self.generated[job.req.uid] = [first]

    def _admit_batched(self, group, lb: int, kv_window: int,
                       cap: int) -> None:
        """One full-batch masked-write forward admits one chunk for every job
        in `group`; the other rows ride along with write_mask False and
        their sampled tokens are discarded."""
        B = self.B
        toks_b = np.zeros((B, lb), np.int32)
        pos_b = np.zeros((B, lb), np.int32)
        last_b = np.zeros(B, np.int64)
        mask_b = np.zeros(B, bool)
        ns = {}
        for j in group:
            chunk = np.asarray(j.req.tokens)[j.offset:j.offset + cap]
            n = len(chunk)
            toks_b[j.slot, :n] = chunk
            pos_b[j.slot] = j.offset + np.arange(lb)
            last_b[j.slot] = n - 1
            mask_b[j.slot] = True
            ns[j.slot] = n
        logits = self._run_batched_admission(group, toks_b, pos_b, mask_b,
                                             kv_window)
        last = self._dev(last_b)
        lg = logits[torch.arange(B, device=self.device), last]    # (B, V)
        first = sample_next(lg, self.generator, self._dev(self.temps),
                            self.top_k)
        firsts = None
        for j in list(group):
            j.offset += ns[j.slot]
            if j.offset == len(j.req.tokens):
                self._pf.remove(j)
                if firsts is None:
                    firsts = first.cpu().numpy()   # one read for the batch
                self._start_decoding(j, int(firsts[j.slot]))

    # -- cache backend hooks (overridden by PagedEngine) ---------------------

    def _prefill_chunk(self, slot: int, toks: np.ndarray, pos: np.ndarray,
                       kv_window: int) -> torch.Tensor:
        """Logits (1, lb, V) of one right-padded chunk toks (1, lb) at
        positions pos (1, lb), written into slot's cache rows. The padded
        tail writes KV past the prompt, which the causal mask hides and
        decode overwrites position by position."""
        rows = [(k[slot:slot + 1], v[slot:slot + 1])
                for (k, v) in self.cache]   # views: written in place
        logits, _ = self._prefill_forward(self._dev(toks), rows,
                                          self._dev(pos), kv_window=kv_window)
        return logits

    def _run_batched_admission(self, group, toks_b, pos_b, mask_b,
                               kv_window) -> torch.Tensor:
        """Logits (B, lb, V) of one full-batch masked admission forward."""
        logits, _ = self._prefill_forward(
            self._dev(toks_b), self.cache, self._dev(pos_b),
            kv_window=kv_window, write_mask=self._dev(mask_b))
        return logits

    def _decode_logits(self) -> torch.Tensor:
        """Logits (B, 1, V) of one batched decode step over every slot
        (inactive rows keep their cache through write_mask)."""
        logits, _ = self._forward(
            self._dev(self.last_tok)[:, None], self.cache,
            self._dev(self.pos)[:, None], kv_window=self._kv_window(),
            write_mask=self._dev(self.active))
        return logits

    def _release(self, slot: int) -> None:
        """Free a slot's cache resources: nothing for the contiguous cache,
        whose next occupant overwrites the rows."""

    def _block_inputs(self) -> dict:
        """Host arrays a decode block's steps read besides the tokens,
        positions, active mask and temperatures, by name: _DecodeBlocks
        keeps a static device copy of each and uploads it once a block.
        Empty for the contiguous cache."""
        return {}

    def _block_forward(self, blocks: _DecodeBlocks, window: int,
                       write_mask: torch.Tensor) -> torch.Tensor:
        """Logits (B, 1, V) of one decode step of a block over the block's
        static buffers (blocks.toks, blocks.pos) and the engine's cache,
        the forward that the card captures into a step graph."""
        logits, _ = self._forward(blocks.toks, self.cache, blocks.pos,
                                  kv_window=window, write_mask=write_mask)
        return logits

    def score_forward(self, toks) -> torch.Tensor:
        """Full-sequence logits (B, L, V) of toks (B, L) through the
        engine's prefill forward, in one chunk at positions arange(L) with
        kv_window = llama.decode_window(L) (the smallest power-of-two
        multiple of 128 >= L, capped at max_seq_len), over a zeroed scratch
        cache of the engine's layout and dtype: models/eval.py scores what
        the engine serves. B must be max_batch (eval pads its batches to
        it); engine state is untouched."""
        toks = self._dev(toks)
        B, L = toks.shape
        if B != self.B or L > self.cfg.max_seq_len:
            raise ValueError(f"score_forward: tokens {tuple(toks.shape)} "
                             f"need B = max_batch {self.B} and L <= "
                             f"max_seq_len {self.cfg.max_seq_len}")
        pos = torch.arange(L, dtype=torch.int32, device=self.device).expand(
            B, L).contiguous()
        return self._score_logits(
            toks, pos, llama.decode_window(L, self.cfg.max_seq_len))

    def _score_logits(self, toks, pos, kv_window: int) -> torch.Tensor:
        cache = [tuple(torch.zeros_like(t) for t in kv) for kv in self.cache]
        logits, _ = self._prefill_forward(toks, cache, pos,
                                          kv_window=kv_window)
        return logits

    # ------------------------------------------------------------------------

    def _kv_window(self, pos: Optional[np.ndarray] = None) -> Optional[int]:
        """Bucketed max attended length over active slots: a power-of-two
        multiple of 128 (llama.decode_window), so attention traffic tracks
        the actual context. `pos` overrides self.pos with projected
        positions (the steps of a decode block, where host state lags the
        device). None for a forward that takes no kv_window."""
        if not self._fwd_takes_window or not self.active.any():
            return None
        p = self.pos if pos is None else pos
        return llama.decode_window(int(p[self.active].max()) + 1,
                                   self.cfg.max_seq_len)

    def _decode(self) -> np.ndarray:
        """One batched decode step; returns next-token ids on the host."""
        nxt = sample_next(self._decode_logits()[:, -1], self.generator,
                          self._dev(self.temps), self.top_k)
        return nxt.cpu().numpy()

    def _finish(self, slot: int):
        req = self.slot_req[slot]
        self.finished[req.uid] = self.generated.pop(req.uid)
        self.active[slot] = False
        self.slot_req[slot] = None
        self.temps[slot] = 0.0
        self._release(slot)

    def step(self) -> int:
        """One engine tick: advance at most one prefill chunk, then one
        batched decode step over all active slots; returns #active+queued."""
        if self._pf:
            self._advance_prefill()
        if self.active.any():
            nxt = self._decode()
            for slot in np.flatnonzero(self.active):
                req = self.slot_req[slot]
                tok = int(nxt[slot])
                self.generated[req.uid].append(tok)
                self.pos[slot] += 1
                self.last_tok[slot] = tok
                done = (len(self.generated[req.uid]) >= req.max_new_tokens
                        or tok == req.eos_id
                        or self.pos[slot] + 1 >= self.cfg.max_seq_len)
                if done:
                    self._finish(slot)
        return int(self.active.sum()) + len(self._pf)

    # -- decode blocks --------------------------------------------------------

    def _block_budget(self, max_steps: int, waiters: bool = True) -> int:
        """Largest decode-block size that never writes KV past max_seq_len
        for any active slot and, with `waiters`, does not overshoot the
        shortest remaining request (so finishing slots free promptly for
        queued admissions). Without waiters the block is capped only by the
        longest remaining request: slots that finish inside it have their
        surplus tokens discarded."""
        k = max_steps
        longest = 1
        for slot in np.flatnonzero(self.active):
            req = self.slot_req[slot]
            k = min(k, self.cfg.max_seq_len - int(self.pos[slot]) - 1)
            remaining = req.max_new_tokens - len(self.generated[req.uid])
            longest = max(longest, remaining)
            if waiters:
                k = min(k, remaining)
        return max(1, min(k, longest))

    def step_block(self, max_steps: int, waiters: bool = True) -> int:
        """Like step(), but decodes up to max_steps tokens for each active
        slot with one host read of their tokens (_run_decode_block). Slots that
        hit eos or max_new_tokens inside the block have their surplus
        tokens discarded; the surplus KV they wrote is overwritten position
        by position before it is ever attended (the chunked-prefill
        contract). A block of at most one step falls back to step();
        prefill chunks still advance one a call. Returns #active+queued."""
        if self._pf:
            self._advance_prefill()
        if not self.active.any():
            return len(self._pf)
        steps = self._block_budget(max_steps, waiters or bool(self._pf))
        if steps <= 1:
            return self.step()
        out = self._read_block(self._run_decode_block(
            self.last_tok, self.pos, steps))
        self._absorb_block(out, steps)
        return int(self.active.sum()) + len(self._pf)

    def _absorb_block(self, out: np.ndarray, steps: int) -> None:
        """Host half of a decode block: append each active slot's tokens,
        advance pos, finish slots at eos, max_new_tokens or max_seq_len
        (the surplus tokens past a finish are discarded)."""
        for slot in np.flatnonzero(self.active):
            req = self.slot_req[slot]
            done = False
            for t in range(steps):
                tok = int(out[t, slot])
                self.generated[req.uid].append(tok)
                self.pos[slot] += 1
                self.last_tok[slot] = tok
                done = (len(self.generated[req.uid]) >= req.max_new_tokens
                        or tok == req.eos_id
                        or self.pos[slot] + 1 >= self.cfg.max_seq_len)
                if done:
                    break
            if done:
                self._finish(slot)

    def _grow_for_block(self, pos: np.ndarray, steps: int) -> None:
        """Pre-dispatch capacity hook, before a block of `steps` from
        positions `pos` (the host's, or the drain's projection): the
        contiguous cache needs nothing (the budget already keeps every
        write below max_seq_len)."""

    def _dispatch_block(self, toks: Optional[np.ndarray], pos: np.ndarray,
                        steps: int) -> _Block:
        """Enqueue one block of `steps` decode steps over the active slots
        and its tokens' copy to the host; no host read. toks None: start
        from the tokens and positions the block before left on the device
        (the pipelined drain), `pos` being the host's projection of them."""
        if self._blocks is None:
            self._blocks = _DecodeBlocks(self)
        return self._blocks.dispatch(toks, pos, steps)

    def _run_decode_block(self, toks: np.ndarray, pos: np.ndarray,
                          steps: int) -> _Block:
        """Device half of step_block: `steps` chained decode steps from the
        host state."""
        self._grow_for_block(self.pos, steps)
        return self._dispatch_block(toks, pos, steps)

    @staticmethod
    def _read_block(blk: _Block) -> np.ndarray:
        """The (steps, B) tokens of a dispatched block, once they are on
        the host: the block's one host read."""
        if blk.done is not None:
            blk.done.synchronize()
        return blk.host.numpy().copy()

    def _drain_blocks_pipelined(self, max_steps: int) -> None:
        """Decode all active slots with one block always in flight: block
        N+1 is enqueued from the tokens and positions block N leaves on the
        device, with the active mask the host has then (one block stale,
        as in the JAX engine), before block N's tokens are read, so the
        read and the absorb overlap device work. Token streams equal the
        sequential path's: slots are independent, a slot that finished
        inside block N has its surplus from block N+1 discarded, and the
        projected budget keeps every write below max_seq_len. An unread
        last block (every slot finished inside the one before) is
        discarded. run() takes this path when no admission waits."""
        def budget(extra: int) -> int:
            k, longest = max_steps, 0
            for slot in np.flatnonzero(self.active):
                req = self.slot_req[slot]
                k = min(k, self.cfg.max_seq_len
                        - (int(self.pos[slot]) + extra) - 1)
                longest = max(longest, req.max_new_tokens
                              - len(self.generated[req.uid]) - extra)
            return max(0, min(k, longest))

        s1 = budget(0)
        if s1 <= 0:
            return
        if s1 == 1:
            self.step()
            return
        self._grow_for_block(self.pos, s1)
        blk1 = self._dispatch_block(self.last_tok, self.pos, s1)
        while True:
            s2 = budget(s1)
            blk2 = None
            if s2 > 1:
                pos_proj = self.pos.copy()
                pos_proj[self.active] += s1
                self._grow_for_block(pos_proj, s2)
                blk2 = self._dispatch_block(None, pos_proj, s2)
            self._absorb_block(self._read_block(blk1), s1)
            if blk2 is None or not self.active.any():
                return
            blk1, s1 = blk2, s2

    def run(self, requests: list[Request],
            decode_block: int = 1) -> dict[int, list[int]]:
        """Serve requests to completion with continuous batching: new
        requests join as slots free up, decode proceeds every tick.
        decode_block > 1 decodes up to that many steps a host read (blocks):
        with no slot decoding, the prefill backlog is drained in one burst;
        with no prefill pending, the pipelined drain runs when no request
        waits (in an engine that pipelines blocks, _pipeline_blocks), else
        step_block(decode_block, waiters=True). Greedy streams equal
        decode_block=1's."""
        pending = list(requests)
        while pending or self.active.any() or self._pf:
            while pending and self.has_capacity():
                self.add_request(pending.pop(0))
            if decode_block > 1 and not self.active.any():
                # nothing decodes: the chunk-a-tick pacing bounds decode
                # latency, which is moot here, so admit the backlog at once
                while self._pf:
                    self._advance_prefill()
            if decode_block > 1 and not self._pf:
                if not pending and self._pipeline_blocks:
                    self._drain_blocks_pipelined(decode_block)
                else:
                    self.step_block(decode_block, waiters=True)
            else:
                self.step()
        return dict(self.finished)


class _SpecTicks:
    """The device half of a SpecEngine's ticks: static buffers last_tok
    (B,) int32, pos (B,) int32, active (B,) bool (the write mask) and f_acc
    (1,) f32 (force_accept) that the tick reads, and on the card one CUDA
    graph of the whole tick for each (g, window), whose output is one
    (B, g + 2) int32 tensor: the target's argmax tokens (B, g + 1), then
    n_acc.

    On the card the host state reaches the static buffers once a tick, from
    pinned memory with non_blocking copies in stream order, and the output
    comes back once, a non_blocking copy into pinned memory followed by an
    event the host waits on. A graph is captured at the first tick of its
    key on a side stream, into one memory pool shared by every key, after
    an eager warm-up of that key's tick with every row masked and no
    force_accept draw (each g runs its GEMMs at new m = B and B * (g + 1),
    so every key needs its own first use outside the graph; a masked row
    writes no cache row, and the generator does not move). The
    engine's generator is registered with each graph, so every replay
    draws fresh force_accept noise. A graph holds the params and caches of
    both models; replacing them needs a new engine. A failed capture
    raises: there is no eager tick on the card. On the CPU each tick runs
    eagerly over the same buffers."""

    def __init__(self, eng: "SpecEngine"):
        self.eng = eng
        dev = eng.device
        B = eng.B
        self.cuda = dev.type == "cuda"
        shapes = dict(last_tok=((B,), torch.int32), pos=((B,), torch.int32),
                      active=((B,), torch.bool), f_acc=((1,), torch.float32))
        with torch.inference_mode():
            for name, (shape, dtype) in shapes.items():
                setattr(self, name, torch.zeros(shape, dtype=dtype,
                                                device=dev))
        self.staging = {name: torch.zeros(shape, dtype=dtype,
                                          pin_memory=self.cuda)
                        for name, (shape, dtype) in shapes.items()}
        self.host: dict[int, torch.Tensor] = {}    # g -> pinned (B, g + 2)
        # (g, window) -> (graph, its (B, g + 2) output)
        self.graphs: dict[tuple, tuple] = {}
        self.capture_s = 0.0
        self.stream = torch.cuda.Stream(dev) if self.cuda else None
        self.pool = torch.cuda.graph_pool_handle() if self.cuda else None

    def _upload(self) -> None:
        """Copy the engine's last tokens, positions, active mask and
        force_accept into the static buffers, in stream order. The staging
        is free: the last tick's output was read after its upload ran."""
        eng, st = self.eng, self.staging
        st["last_tok"].numpy()[:] = eng.last_tok
        st["pos"].numpy()[:] = eng.pos
        st["active"].numpy()[:] = eng.active
        st["f_acc"].numpy()[:] = eng.force_accept
        for name, t in st.items():
            getattr(self, name).copy_(t, non_blocking=self.cuda)

    def _tick(self, g: int, window: int, mask: torch.Tensor,
              draw: bool = True) -> torch.Tensor:
        """One speculative tick over the static buffers: g draft forwards at
        T = 1 over the draft cache, each taking the argmax; the target's
        verify forward over [last_tok, drafts] (T = g + 1) at positions
        pos + arange(g + 1); then n_acc, the count of leading agreements
        over the first g - 1 drafts, each position also accepted where a
        uniform draw is below force_accept (draw False: no draw, none
        forced). Rows with mask False write no cache row. Returns (B, g + 2)
        int32: the target's tokens, then n_acc."""
        eng = self.eng
        cur, drafts = self.last_tok, []
        for t in range(g):
            lg, _ = eng._draft_forward(cur[:, None], eng.dcache,
                                       (self.pos + t)[:, None],
                                       kv_window=window, write_mask=mask)
            cur = lg[:, -1].argmax(dim=-1).to(torch.int32)
            drafts.append(cur)
        drafts = torch.stack(drafts, dim=1)                      # (B, g)
        seq = torch.cat([self.last_tok[:, None], drafts], dim=1)
        tpos = self.pos[:, None] + torch.arange(
            g + 1, dtype=torch.int32, device=self.pos.device)[None]
        logits, _ = eng._forward(seq, eng.cache, tpos, kv_window=window,
                                 write_mask=mask)
        tgt = logits.argmax(dim=-1).to(torch.int32)              # (B, g+1)
        agree = tgt[:, :g - 1] == drafts[:, :g - 1]
        force = (torch.rand(agree.shape, generator=eng.generator,
                            device=agree.device) < self.f_acc if draw
                 else torch.zeros_like(agree))
        n_acc = (agree | force).to(torch.int32).cumprod(dim=1).sum(dim=1)
        return torch.cat([tgt, n_acc[:, None].to(torch.int32)], dim=1)

    def _capture(self, g: int, window: int) -> tuple:
        """Capture _tick at (g, window) after its masked warm-up, keep
        it."""
        t0 = time.perf_counter()
        graph, out = _capture_graph(
            self.eng, self.stream, self.pool,
            lambda: self._tick(g, window, torch.zeros_like(self.active),
                               draw=False),
            lambda: self._tick(g, window, self.active))
        self.graphs[(g, window)] = (graph, out)
        self.capture_s += time.perf_counter() - t0
        return self.graphs[(g, window)]

    @torch.inference_mode()
    def run(self, g: int, window: int) -> np.ndarray:
        """One tick from the engine's host state: on the card a replay of
        the (g, window) graph (captured at its first use), on the CPU
        _tick. Returns the (B, g + 2) output on the host, after the tick's
        one read."""
        self._upload()
        if not self.cuda:
            return self._tick(g, window, self.active).numpy()
        graph, out = (self.graphs.get((g, window))
                      or self._capture(g, window))
        graph.replay()
        host = self.host.get(g)
        if host is None:
            host = self.host[g] = torch.zeros(out.shape, dtype=torch.int32,
                                              pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        return host.numpy().copy()


class SpecEngine(Engine):
    """Draft-verify speculative decoding over the contiguous-cache engine,
    greedy-exact: the emitted tokens are the target's greedy tokens; only
    the number of target forwards changes.

    A tick: the draft model proposes g tokens autoregressively (g forwards
    at T = 1 over its own cache, dcache), the target verifies them in one
    cached forward at T = g + 1 (flash prefill), and each slot accepts the
    longest agreeing prefix plus the target's own next token. Acceptance
    is capped at g - 1, so the draft cache holds KV for every accepted
    position (the g-th proposal is never written there); KV of a rejected
    tail in either cache is hidden by the causal mask and overwritten
    later, the chunked-prefill contract. On the card each tick is one
    replay of the captured CUDA graph of its (g, window) (_SpecTicks).

    Greedy only (sampling would need rejection sampling): a request with a
    temperature > 0 raises ValueError at its first tick. The draft shares
    the target's vocabulary and a max_seq_len at least the target's, and
    lies on the target's device. run(decode_block=K) runs ticks:
    step_block is step()."""

    # spec ticks have their own scheduling: no pipelined block drain
    _pipeline_blocks = False

    #: admissible draft depths when gamma_adaptive: each value is one
    #: verify shape (B, g + 1), so the set is small and fixed
    GAMMA_BUCKETS = (3, 5, 7, 11)

    def __init__(self, params, cfg: llama.LlamaConfig, draft_params,
                 draft_cfg: Optional[llama.LlamaConfig] = None, *,
                 gamma: int = 7, gamma_adaptive: bool = True,
                 max_batch: int = 8, fmt: str = "nvfp4",
                 draft_fmt: str = "bf16", cache_dtype=torch.bfloat16,
                 seed: int = 0):
        """gamma: the draft depth (with gamma_adaptive, the start of the
        bucket walk and, with 3, its ceiling). draft_fmt: the draft's GEMM
        format (dense draft layers ignore it, as the target's do fmt).
        cache_dtype: both caches', bf16 flat or fp8 headed. The draft's
        cache, dcache, has max_batch slots of the draft's max_seq_len."""
        super().__init__(params, cfg, max_batch=max_batch, fmt=fmt,
                         cache_dtype=cache_dtype, seed=seed)
        self.draft_cfg = draft_cfg or cfg
        if self.draft_cfg.vocab_size != cfg.vocab_size:
            raise ValueError(f"draft vocabulary {self.draft_cfg.vocab_size} "
                             f"!= target vocabulary {cfg.vocab_size}")
        if self.draft_cfg.max_seq_len < cfg.max_seq_len:
            raise ValueError(f"draft max_seq_len {self.draft_cfg.max_seq_len}"
                             f" < target max_seq_len {cfg.max_seq_len}")
        if draft_params["embed"].device != self.device:
            raise ValueError(f"draft params on {draft_params['embed'].device}"
                             f", target params on {self.device}")
        self.gamma0 = gamma
        self.gamma = gamma
        self.gamma_adaptive = gamma_adaptive
        self._gamma_max = max(gamma, 3)
        # acceptance EMA (the fraction of the g - 1 cap used): high walks
        # the buckets up, low walks them down
        self._acc_ema = 0.5
        self.draft_params = draft_params
        self._draft_fn = _llama_forward(self.draft_cfg, draft_fmt)
        self.dcache = llama.init_cache(self.draft_cfg, max_batch,
                                       cache_dtype, device=self.device)
        self.spec_stats = {"proposed": 0, "accepted": 0, "ticks": 0}
        #: synthetic acceptance floor in [0, 1]: each draft position is
        #: force-accepted with this probability whatever the agreement.
        #: 0.0 is the exact greedy path; above it the emitted tokens mean
        #: nothing (the target cache keeps draft-token KV inside a forced
        #: prefix) while the device work is the same: a knob to measure
        #: tokens/s against acceptance on random weights.
        self.force_accept = 0.0
        self._ticks: Optional[_SpecTicks] = None        # made at first use

    @torch.inference_mode()
    def _draft_forward(self, toks, cache, pos, kv_window=None,
                       write_mask=None):
        return self._draft_fn(self.draft_params, toks, cache, pos,
                              kv_window=kv_window, write_mask=write_mask)

    def reset(self) -> None:
        """Engine.reset, and the draft depth, acceptance EMA and spec_stats
        back to their start; both caches' storage stays."""
        super().reset()
        self.gamma = self.gamma0
        self._acc_ema = 0.5
        self.spec_stats = {"proposed": 0, "accepted": 0, "ticks": 0}

    def step_block(self, max_steps: int, waiters: bool = True) -> int:
        """A tick already emits several tokens a host read; a plain decode
        block would bypass the draft and leave its cache behind, so
        run(decode_block=K) runs ticks."""
        return self.step()

    def _prefill_chunk(self, slot, toks, pos, kv_window):
        # the draft's cache rows take the chunk first (its logits unused:
        # the first proposal is made at tick time), then the target's
        rows = [(k[slot:slot + 1], v[slot:slot + 1]) for (k, v) in
                self.dcache]
        self._draft_forward(self._dev(toks), rows, self._dev(pos),
                            kv_window=kv_window)
        return super()._prefill_chunk(slot, toks, pos, kv_window)

    def _pick_gamma(self) -> int:
        """Draft depth for this tick: the acceptance-adaptive walk over
        GAMMA_BUCKETS (up to the constructor's gamma), capped by the largest
        remaining budget among active slots plus one (n_acc <= g - 1, plus
        the bonus token); at least 2. gamma_adaptive=False keeps gamma."""
        remaining = max(
            (self.slot_req[s].max_new_tokens
             - len(self.generated[self.slot_req[s].uid])
             for s in np.flatnonzero(self.active)), default=1)
        cap = max(2, remaining + 1)
        if not self.gamma_adaptive:
            return max(2, min(self.gamma, cap))
        bs = [b for b in self.GAMMA_BUCKETS if b <= self._gamma_max]
        i = min(range(len(bs)), key=lambda j: abs(bs[j] - self.gamma))
        if self._acc_ema > 0.7 and i + 1 < len(bs):
            self.gamma = bs[i + 1]
        elif self._acc_ema < 0.35 and i > 0:
            self.gamma = bs[i - 1]
        return max(2, min(self.gamma, cap))

    def _tick_window(self, g: int) -> int:
        """The kv_window of a tick at depth g: the active slots' bucket,
        widened to cover the verify's writes at pos .. pos + g, capped at
        max_seq_len."""
        return min(self.cfg.max_seq_len,
                   max(self._kv_window(), _next_pow2_128(
                       int(self.pos[self.active].max()) + g + 1)))

    def step(self) -> int:
        """One tick: advance at most one prefill chunk, then one
        speculative tick over all active slots (one graph replay and one
        host read on the card). Each slot emits its accepted drafts and the
        target's next token, stopping at eos, max_new_tokens or pos + g + 1
        >= max_seq_len. Returns #active+queued."""
        if self._pf:
            self._advance_prefill()
        if not self.active.any():
            return len(self._pf)
        if np.any(self.temps[self.active] > 0):
            raise ValueError("SpecEngine is greedy-only: a request has "
                             "temperature > 0")
        g = self._pick_gamma()
        if self._ticks is None:
            self._ticks = _SpecTicks(self)
        out = self._ticks.run(g, self._tick_window(g))
        accs = []
        for slot in np.flatnonzero(self.active):
            req = self.slot_req[slot]
            n_acc = int(out[slot, g + 1])
            accs.append(n_acc)
            self.spec_stats["proposed"] += g
            self.spec_stats["accepted"] += n_acc
            done = False
            for tok in out[slot, :n_acc + 1].tolist():
                self.generated[req.uid].append(tok)
                self.pos[slot] += 1
                self.last_tok[slot] = tok
                done = (len(self.generated[req.uid]) >= req.max_new_tokens
                        or tok == req.eos_id
                        or self.pos[slot] + g + 1 >= self.cfg.max_seq_len)
                if done:
                    break
            if done:
                self._finish(slot)
        if accs:
            self._acc_ema = (0.8 * self._acc_ema
                             + 0.2 * (sum(accs) / len(accs)) / max(g - 1, 1))
        self.spec_stats["ticks"] += 1
        return int(self.active.sum()) + len(self._pf)


def _next_pow2_128(n: int) -> int:
    """The smallest power-of-two multiple of 128 >= n (uncapped)."""
    w = 128
    while w < n:
        w *= 2
    return w


class PagedEngine(Engine):
    """Engine over a paged KV cache (models/paged.py): pages are allocated
    as sequences grow and return to the shared pool when a request
    finishes, so the pool holds the sum of the actual lengths instead of
    max_batch * max_seq_len. Scheduling is Engine's; only the cache
    backend differs."""

    def __init__(self, params, cfg: llama.LlamaConfig, *, max_batch: int = 8,
                 fmt: str = "nvfp4", page_size: int = 256,
                 num_pages: Optional[int] = None, cache_dtype=torch.bfloat16,
                 top_k: int = 0, seed: int = 0,
                 prefill_fmt: Optional[str] = None,
                 prefill_chunk: Optional[int] = None):
        """page_size (clamped to max_seq_len) and num_pages (default: every
        slot at max_seq_len) shape the pool; cache_dtype bf16 or
        torch.float8_e4m3fn. The rest as Engine, prefill_fmt included:
        prefill chunks and batched admissions run forward_paged in
        prefill_fmt, decode steps in fmt."""
        self._page_size = page_size
        self._num_pages = num_pages
        super().__init__(params, cfg, max_batch=max_batch, fmt=fmt,
                         cache_dtype=cache_dtype, top_k=top_k, seed=seed,
                         prefill_fmt=prefill_fmt,
                         prefill_chunk=prefill_chunk)

    def _init_cache(self, cache_dtype) -> None:
        self.cache = None
        self.pc = paged.init_paged_cache(
            self.cfg, self.B, page_size=self._page_size,
            num_pages=self._num_pages, dtype=cache_dtype, device=self.device)

    def _paged_forward(self, toks, bt, pos, kv_window, write_mask=None, *,
                       fmt):
        logits, _ = paged.forward_paged(
            self.params, self._dev(toks), self.cfg, self.pc.pages, bt,
            self._dev(pos), page_size=self.pc.page_size, fmt=fmt,
            kv_window=kv_window,
            write_mask=None if write_mask is None else self._dev(write_mask))
        return logits

    def _prefill_chunk(self, slot, toks, pos, kv_window):
        # the whole padded chunk gets pages (its tail is the garbage the
        # causal mask hides, as in the contiguous cache)
        paged.ensure_capacity(self.pc, slot, int(pos[0, -1]) + 1)
        return self._paged_forward(toks, self.pc.block_tables[slot:slot + 1],
                                   pos, kv_window, fmt=self.prefill_fmt)

    def _admission_batchable(self) -> bool:
        return True

    def _run_batched_admission(self, group, toks_b, pos_b, mask_b,
                               kv_window):
        for j in group:
            paged.ensure_capacity(self.pc, j.slot, int(pos_b[j.slot, -1]) + 1)
        return self._paged_forward(toks_b, self.pc.block_tables, pos_b,
                                   kv_window, mask_b, fmt=self.prefill_fmt)

    def _decode_logits(self):
        # cover this tick's write position; inactive slots write to the
        # scratch page through write_mask
        for slot in np.flatnonzero(self.active):
            paged.ensure_capacity(self.pc, slot, int(self.pos[slot]) + 1)
        return self._paged_forward(self.last_tok[:, None],
                                   self.pc.block_tables, self.pos[:, None],
                                   self._kv_window(), self.active,
                                   fmt=self.fmt)

    def _block_inputs(self) -> dict:
        # a captured step keeps the address of the table it read, so the
        # steps read a static copy, uploaded once a block after
        # _grow_for_block; the eager step() keeps pc.block_tables
        return {"tables": self.pc.tables}

    def _block_forward(self, blocks, window, write_mask):
        return self._paged_forward(blocks.toks, blocks.tables, blocks.pos,
                                   window, write_mask, fmt=self.fmt)

    def _grow_for_block(self, pos, steps):
        # every active slot gets the pages of the whole block up front;
        # `pos` may be the drain's projection, and the budget keeps
        # pos + steps <= max_seq_len - 1, so ensure_capacity never passes
        # max_pages (it raises ValueError if asked to)
        for slot in np.flatnonzero(self.active):
            paged.ensure_capacity(self.pc, slot, int(pos[slot]) + steps)

    def _score_logits(self, toks, pos, kv_window):
        # a scratch pool of B * ceil(L / ps) pages in the engine's dtype,
        # each row's pages allocated up to L, the chunk in prefill_fmt
        B, L = toks.shape
        ps = self.pc.page_size
        pc = paged.init_paged_cache(
            self.cfg, B, page_size=ps, num_pages=B * -(-L // ps),
            dtype=self.pc.pages[0][0].dtype, device=self.device)
        for b in range(B):
            paged.ensure_capacity(pc, b, L)
        logits, _ = paged.forward_paged(
            self.params, toks, self.cfg, pc.pages, pc.block_tables, pos,
            page_size=ps, fmt=self.prefill_fmt, kv_window=kv_window)
        return logits

    def _release(self, slot: int) -> None:
        paged.release_slot(self.pc, slot)
        self.pos[slot] = 0
        self.last_tok[slot] = 0

    def pages_in_use(self) -> int:
        return sum(len(u) for u in self.pc.used)
