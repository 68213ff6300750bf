"""Continuous-batching serving engine for FP4 models (torch).

Counterpart of petit_kernel_tpu/models/serving.py (Request, the prefill
buckets, sample_next, Engine with run(decode_block=N), step_block and the
pipelined block drain over a bf16 or fp8 cache, and PagedEngine). The JAX
engine compiles its steps with jit and donates the cache; this one runs
eagerly and updates the cache tensors in place. Scheduling state lives on
the host, as numpy arrays: slots, per-slot positions, the chunked-prefill
queue. step() reads the sampled tokens back to the host once a step.

Decode blocks (step_block, run(decode_block > 1)) run K decode steps for
one host read of their tokens. On the card each step of a block is a
replay of one captured CUDA graph of the decode step (llama.forward at
T = 1, sample_next, then the step's own advance of the device-resident
tokens and positions), one graph a kv_window bucket; step t of a block
takes the bucket that step() would take there, so a block is bit for bit
K step() calls from the same state while no slot finishes inside it. On
the CPU the same steps run eagerly over the same buffers. Only the
contiguous Engine over llama.forward takes blocks so far: PagedEngine and
an Engine with forward_fn raise NotImplementedError.

Engine takes a custom forward_fn (models/moe.make_engine_forward serves
Mixtral through it) and a cache built by the caller. prefill_fmt="w4a8"
runs prefill chunks and batched admissions through the W4A8 GEMM over the
nvfp4 weights while decode keeps fmt (llama.linear routes chunks of fewer
than llama.W4A8_MIN_M rows to the exact kernel). fmt="hybrid" serves a
model quantized with llama.quantize_params(params, "hybrid"): its split
layers run the hybrid GEMM, layers too narrow to split nvfp4. Every
forward of an engine runs under torch.inference_mode(). Not ported yet:
SpecEngine and score_forward.
"""

from __future__ import annotations

import dataclasses
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
    (B, 1) int32, active (B,) bool as the write mask, temps (B,) f32), two
    (max_seq_len, B) int32 output buffers a block's tokens go to, and on
    the card one CUDA graph of the decode step a kv_window bucket.

    On the card: host state reaches the static buffers once a block, from
    pinned memory with non_blocking copies in stream order; a block's
    tokens come back once, a non_blocking copy into pinned memory followed
    by an event. The output and staging buffers alternate between blocks,
    so the pipelined drain can enqueue one block while the last is read.
    Graphs are captured lazily at the first use of their bucket on a side
    stream of their own, after one eager warm-up of the forward on that
    stream (so the split counters, kept per stream, and the tables the
    kernels cache at first use are made outside any graph), into one
    memory pool: they replay one at a
    time on the caller's stream, and each keeps its outputs alive. A graph
    holds the engine's params and cache tensors; replacing them needs a
    new engine. A failed capture raises: there is no eager path on the
    card. On the CPU each step runs eagerly over the same buffers."""

    def __init__(self, eng: "Engine"):
        self.eng = eng
        dev = eng.device
        B, S = eng.B, eng.cfg.max_seq_len
        self.cuda = dev.type == "cuda"
        shapes = dict(toks=((B, 1), torch.int32), pos=((B, 1), torch.int32),
                      active=((B,), torch.bool), temps=((B,), torch.float32))
        with torch.inference_mode():
            for name, (shape, dtype) in shapes.items():
                setattr(self, name, torch.zeros(shape, dtype=dtype,
                                                device=dev))
            self.outs = [torch.zeros((S, B), dtype=torch.int32, device=dev)
                         for _ in range(2)]
        pin = self.cuda
        self.host_outs = [torch.zeros((S, B), dtype=torch.int32,
                                      pin_memory=pin) for _ in range(2)]
        # per parity: host (pinned) copies of the four static buffers, and
        # the event after their last upload
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
        """Copy the engine's active mask and temperatures, and with toks
        (host (B,) arrays toks and pos) the tokens and positions, into the
        static buffers, in stream order."""
        eng, p = self.eng, self.parity
        st, ev = self.staging[p], self.uploaded[p]
        if ev is not None and not ev.query():
            ev.synchronize()           # the staging's last upload is read
        names = ["active", "temps"]
        st["active"].numpy()[:] = eng.active
        st["temps"].numpy()[:] = eng.temps
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
        logits, _ = eng._forward(self.toks, eng.cache, self.pos,
                                 kv_window=window, write_mask=self.active)
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
        s = self.stream
        s.wait_stream(torch.cuda.current_stream(eng.device))
        if not self.graphs:
            # the forward alone, every row masked: it writes no cache row
            # and draws no noise
            with torch.cuda.stream(s):
                eng._forward(self.toks, eng.cache, self.pos,
                             kv_window=window,
                             write_mask=torch.zeros_like(self.active))
            torch.cuda.current_stream(eng.device).wait_stream(s)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(eng.generator)
        with torch.inference_mode(), torch.cuda.graph(graph, pool=self.pool,
                                                      stream=s):
            logits, nxt = self._step(window)
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
        (moe.make_engine_forward); one without kv_window and write_mask
        raises NotImplementedError (the JAX engine's fallback for them
        serves tensor-parallel steps, which are not ported). Sampling:
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
        # decode blocks capture llama.forward's step; blocks over a custom
        # forward_fn are not ported yet (ROADMAP.md, queue 1 item 1)
        self._blocks_unported = (None if forward_fn is None
                                 else "an Engine with forward_fn")
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
            params_ = inspect.signature(forward_fn).parameters
            if not {"kv_window", "write_mask"} <= set(params_):
                raise NotImplementedError(
                    "forward_fn must take kv_window= and write_mask=: the "
                    "fallback without them serves tensor-parallel steps, "
                    "which are not ported")
            prefill_fn = forward_fn
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

    # every forward of the engine (forward_fn or llama.forward) runs under
    # inference mode: no step builds an autograd graph, whatever the params
    # require
    @torch.inference_mode()
    def _forward(self, toks, cache, pos, kv_window=None, write_mask=None):
        return self._forward_fn(self.params, toks, cache, pos,
                                kv_window=kv_window, write_mask=write_mask)

    @torch.inference_mode()
    def _prefill_forward(self, toks, cache, pos, kv_window=None,
                         write_mask=None):
        """_forward in prefill_fmt: prefill chunks and batched admission."""
        return self._prefill_fn(self.params, toks, cache, pos,
                                kv_window=kv_window, write_mask=write_mask)

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
        group = [j for j in self._pf if self._chunk_key(j) == (lb, kv_window)]
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

    def score_forward(self, toks):
        raise NotImplementedError("score_forward is not ported yet")

    # ------------------------------------------------------------------------

    def _kv_window(self, pos: Optional[np.ndarray] = None) -> Optional[int]:
        """Bucketed max attended length over active slots: a power-of-two
        multiple of 128 (llama.decode_window), so attention traffic tracks
        the actual context. `pos` overrides self.pos with projected
        positions (the steps of a decode block, where host state lags the
        device)."""
        if not self.active.any():
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

    def _require_blocks(self) -> None:
        if self._blocks_unported:
            raise NotImplementedError(
                f"decode blocks for {self._blocks_unported} are not ported "
                "yet: they come with the paged and forward_fn engines "
                "(ROADMAP.md, queue 1 item 1); use decode_block=1")

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
        self._require_blocks()
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
        """Pre-dispatch capacity hook: the contiguous cache needs nothing
        (the budget already keeps every write below max_seq_len)."""

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
        waits, else step_block(decode_block, waiters=True). Greedy streams
        equal decode_block=1's. Only the contiguous Engine over
        llama.forward takes blocks (NotImplementedError otherwise)."""
        if decode_block > 1:
            self._require_blocks()
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
                if not pending:
                    self._drain_blocks_pipelined(decode_block)
                else:
                    self.step_block(decode_block, waiters=True)
            else:
                self.step()
        return dict(self.finished)


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
        self._blocks_unported = "PagedEngine"

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

    def _release(self, slot: int) -> None:
        paged.release_slot(self.pc, slot)
        self.pos[slot] = 0
        self.last_tok[slot] = 0

    def pages_in_use(self) -> int:
        return sum(len(u) for u in self.pc.used)
