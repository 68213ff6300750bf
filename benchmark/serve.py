"""Driving an engine: spans around the calls it makes into its layers, the
warm-up, and the closed and open loops of a mix, timed from the client's
side.

Spans are recorded from here, around the engine's own methods, wrapped on
the instance (the package is not edited): `_advance_prefill` (one
admission tick: a prompt's chunk, or one batched forward over the
same-key chunks), `_run_decode_block` and `_read_block` (a decode block's
dispatch and its one host read), `_decode` (an eager decode step) and
`add_request`. Each prefill and decode span carries the work it did
(work.Model). A method the engine no longer has is left unwrapped and
listed in Recorder.missing; metrics that read its spans are then absent.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from petit_kernel_tpu_torch.models import llama, serving

from . import work

clock = time.perf_counter


@dataclasses.dataclass
class Span:
    name: str
    t0: float
    t1: float
    attrs: dict


class Recorder:
    """Spans in memory, each also a record_function range (which a
    profiler, when one runs, puts on its timeline)."""

    def __init__(self):
        self.spans: list[Span] = []
        self.missing: list[str] = []

    def wrap(self, obj, attr: str, name: str, before=None, after=None):
        inner = getattr(obj, attr, None)
        if inner is None:
            self.missing.append(attr)
            return

        def wrapped(*a, **kw):
            ctx = before(*a, **kw) if before else None
            t0 = clock()
            with torch.profiler.record_function("bench." + name):
                out = inner(*a, **kw)
            t1 = clock()
            attrs = after(ctx, out) if after else {}
            self.spans.append(Span(name, t0, t1, attrs))
            return out

        setattr(obj, attr, wrapped)


def instrument(eng, model: work.Model, rec: Recorder) -> None:
    B = eng.B

    def before_prefill():
        jobs = list(eng._pf)
        lb, _ = eng._chunk_key(jobs[0])
        return [(j, j.offset, len(j.req.tokens)) for j in jobs], lb

    def after_prefill(ctx, _):
        snap, lb = ctx
        chunks = [(off, j.offset - off) for j, off, _ in snap
                  if j.offset > off]
        heads = sum(j.offset == total for j, off, total in snap
                    if j.offset > off)
        launched = B * lb if len(chunks) > 1 else lb
        return {"ops": model.chunks(chunks, launched, heads),
                "tokens": sum(n for _, n in chunks), "jobs": len(chunks),
                "rows": launched, "done": heads}

    def before_block(toks, pos, steps):
        return eng.pos[eng.active].astype(np.int64), steps

    def after_block(ctx, _):
        pos, steps = ctx
        ops = [op for t in range(steps)
               for op in model.decode_step(pos + t, B)]
        return {"ops": ops, "steps": steps, "rows": len(pos)}

    def before_decode():
        return eng.pos[eng.active].astype(np.int64), 1

    rec.wrap(eng, "_advance_prefill", "engine.prefill", before_prefill,
             after_prefill)
    rec.wrap(eng, "_run_decode_block", "blocks.run", before_block,
             after_block)
    rec.wrap(eng, "_read_block", "blocks.read")
    rec.wrap(eng, "_decode", "engine.decode", before_decode, after_block)
    rec.wrap(eng, "add_request", "engine.add_request")


@dataclasses.dataclass
class Record:
    uid: int
    prompt: np.ndarray
    max_new: int
    due: Optional[float] = None     # seconds from the window's opening
    noticed: Optional[float] = None
    sent: Optional[float] = None
    first: Optional[float] = None
    last: Optional[float] = None
    n: int = 0
    tokens: Optional[list] = None   # the served tokens, once finished


class Tracker:
    """The client's side: sends requests and reads what reached the host
    after each engine call. Times are seconds from the window's opening
    (`t0`, set when it opens; negative before)."""

    def __init__(self, eng):
        self.eng = eng
        self.t0 = clock()
        self.records: dict[int, Record] = {}
        self.inflight: dict[int, Record] = {}
        self.arrivals: list[tuple[float, int]] = []

    def now(self) -> float:
        return clock() - self.t0

    def send(self, req, noticed: Optional[float] = None) -> None:
        rec = Record(req.uid, req.prompt, req.max_new, req.due, noticed)
        self.records[req.uid] = self.inflight[req.uid] = rec
        rec.sent = self.now()
        self.eng.add_request(serving.Request(
            uid=req.uid, tokens=req.prompt, max_new_tokens=req.max_new,
            eos_id=-1, temperature=0.0))

    def poll(self) -> None:
        t = self.now()
        eng = self.eng
        for uid, rec in list(self.inflight.items()):
            toks = eng.generated.get(uid)
            done = toks is None and uid in eng.finished
            if done:
                toks = eng.finished.pop(uid)
            n = len(toks) if toks is not None else 0
            if n > rec.n:
                self.arrivals.append((t, n - rec.n))
                if rec.first is None:
                    rec.first = t
                rec.n = n
            if done:
                rec.last, rec.tokens = t, list(toks)
                del self.inflight[uid]


def decode_windows(mix: dict, max_seq_len: int) -> list[int]:
    """Every kv_window bucket a decode step of the mix can take."""
    lo = mix["prompt"]["min"] + 1
    hi = mix["prompt"]["max"] + mix["output"]["max"]
    return sorted({llama.decode_window(n, max_seq_len)
                   for n in range(lo, hi + 1)})


def prefill_buckets(mix: dict) -> list[int]:
    """Every bucket a prefill chunk of the mix can take."""
    chunk = serving.PREFILL_CHUNK
    out = set()
    for p in range(mix["prompt"]["min"], mix["prompt"]["max"] + 1):
        last = p - (p - 1) // chunk * chunk
        out.add(next(b for b in serving.PREFILL_BUCKETS if b >= last))
        if p > chunk:
            out.add(chunk)
    return sorted(out)


def warm_up(eng, mix: dict, vocab: int) -> None:
    """Capture the decode graph of every kv_window the mix reaches, then
    run each prefill bucket the mix reaches once alone and once batched
    (two prompts of one key), and the longest prompt alone and batched,
    each with a block of decode steps and an eager step after it; then
    release everything. On the card nothing is captured after this."""
    K = mix["block_steps"]
    if eng.device.type == "cuda":
        if eng._blocks is None:
            eng._blocks = serving._DecodeBlocks(eng)
        for w in decode_windows(mix, eng.cfg.max_seq_len):
            if w not in eng._blocks.graphs:
                eng._blocks._capture(w)
    rng = np.random.default_rng(0)
    uid = iter(range(-1, -10**6, -1))

    def req(n):
        return serving.Request(
            uid=next(uid), tokens=rng.integers(0, vocab, n, dtype=np.int32),
            max_new_tokens=K + 2)

    lens = prefill_buckets(mix)
    groups = [[req(n)] for n in lens] + [[req(n), req(n)] for n in lens]
    longest = mix["prompt"]["max"]
    groups += [[req(longest)], [req(longest), req(longest)]]
    for group in groups:
        for r in group:
            eng.add_request(r)
        while eng.step_block(K, waiters=True):
            pass
    eng.reset()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()


def captures(eng) -> int:
    blocks = eng._blocks
    return 0 if blocks is None else len(blocks.graphs)


class Slicer:
    """Starts the tracer at the first loop boundary `start` seconds into the
    window and stops it at the first boundary `length` seconds after it
    started (the profiler's own start-up excluded)."""

    def __init__(self, tracer, start: float, length: float, now=None):
        self.tracer, self.start, self.length = tracer, start, length
        self.now = now
        self.end = None
        self.state = 0 if tracer is not None else 2

    def tick(self, t: float) -> None:
        if self.state == 0 and t >= self.start:
            self.tracer.start()
            self.end = self.now() + self.length
            self.state = 1
        elif self.state == 1 and t >= self.end:
            self.tracer.stop()
            self.state = 2

    def close(self) -> None:
        if self.state == 1:
            self.tracer.stop()
            self.state = 2


def closed_loop(eng, tracker: Tracker, reqs, mix: dict, seconds: float,
                slicer: Slicer) -> None:
    """`clients` clients on the engine's slots: fill every slot, open the
    window, then send each client's next request (from the iterable
    `reqs`) as its last finishes."""
    K = mix["block_steps"]
    it = iter(reqs)
    clients = mix["clients"]

    def refill():
        while len(tracker.inflight) < clients and eng.has_capacity():
            tracker.send(next(it))

    refill()
    for _ in range(100000):
        if eng.active.sum() >= min(clients, eng.B):
            break
        eng.step_block(K, waiters=True)
        tracker.poll()
        refill()
    else:
        raise RuntimeError("the engine never filled its slots")
    tracker.t0 = clock()
    tracker.poll()
    while tracker.now() < seconds:
        refill()
        slicer.tick(tracker.now())
        eng.step_block(K, waiters=True)
        tracker.poll()
    slicer.close()


def open_loop(eng, tracker: Tracker, reqs, mix: dict, seconds: float,
              slicer: Slicer) -> dict:
    """Arrivals at their due times (the iterable `reqs`, in order), queued
    by the client while no slot is free, until the window closes. Returns
    how late the client noticed arrivals."""
    K = mix["block_steps"]
    queue = collections.deque()
    it = iter(reqs)
    nxt, busy = next(it), 0
    tracker.t0 = clock()
    while (now := tracker.now()) < seconds:
        while nxt.due <= now:
            queue.append((nxt, now))
            nxt = next(it)
        while queue and eng.has_capacity():
            r, noticed = queue.popleft()
            tracker.send(r, noticed)
            busy += 1
        slicer.tick(now)
        if busy:
            busy = eng.step_block(K, waiters=True)
            tracker.poll()
        else:
            time.sleep(max(0.0, min(nxt.due, seconds) - now))
    slicer.close()
    late = [r.noticed - r.due for r in tracker.records.values()
            if r.due < seconds]
    return {"late_p50_ms": 1e3 * float(np.median(late)) if late else 0.0,
            "late_max_ms": 1e3 * max(late, default=0.0)}
