"""The device trace of a traced run: torch.profiler (CUPTI kernel records,
graph replays included) over a steady slice of the window, read into
plain lists so the profiler's memory goes with it.

A slice is opened and closed between two engine calls, after a device
synchronize, so every kernel of the calls inside it runs inside it. Host
spans come from the record_function ranges the recorder opens
("bench.<span>"); the slice itself is the range "bench.slice".
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import torch

from . import serve

SLICE = "bench.slice"


@dataclasses.dataclass
class Slice:
    t0_ns: int
    t1_ns: int
    host_t0: float              # the recorder's clock at the slice's ends
    host_t1: float
    kernels: list               # (name, start_ns, dur_ns), clipped
    host: list                  # (span name, start_ns, end_ns)

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9


class Tracer:
    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.prof = None
        self.mark = None
        self.host_t0 = None
        self.result: Optional[Slice] = None

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._sync()
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.mark = torch.profiler.record_function(SLICE)
        self.mark.__enter__()
        self.host_t0 = serve.clock()

    def stop(self) -> None:
        self._sync()
        host_t1 = serve.clock()
        self.mark.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.result = _read(self.prof, self.host_t0, host_t1)
        self.prof = None


def _read(prof, host_t0: float, host_t1: float) -> Slice:
    events = prof.profiler.kineto_results.events()
    t0 = t1 = None
    kernels, host = [], []
    for e in events:
        name = e.name()
        cpu = e.device_type() == torch.autograd.DeviceType.CPU
        if name == SLICE and cpu:
            t0, t1 = e.start_ns(), e.end_ns()
        elif name.startswith("bench."):
            if cpu:
                host.append((name[len("bench."):], e.start_ns(), e.end_ns()))
        elif not cpu and not e.is_user_annotation():
            kernels.append((name, e.start_ns(), e.duration_ns()))
    if t0 is None:
        raise RuntimeError("the trace lost its slice range")
    clipped = []
    for name, s, d in kernels:
        a, b = max(s, t0), min(s + d, t1)
        if b > a:
            clipped.append((name, a, b - a))
    return Slice(t0, t1, host_t0, host_t1, clipped, host)


def busy_ns(sl: Slice) -> int:
    """The union of the device operations' intervals."""
    total, end = 0, None
    for _, s, d in sorted(sl.kernels, key=lambda k: k[1]):
        e = s + d
        if end is None or s > end:
            total += d
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def matches(name: str, patterns) -> bool:
    return any(p in name for p in patterns)


def base_name(name: str) -> str:
    """A kernel's name without 'void ', its template arguments and its
    parameters."""
    name = re.sub(r"^void\s+", "", name)
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


def breakdown(sl: Slice, families: dict) -> dict:
    """Up to 10 device operations by time (kernels of a family under the
    family's name), and up to 10 idle stretches by what the host was
    doing then (the innermost span open at the gap's middle), summed."""
    ops: dict[str, float] = {}
    for name, _, d in sl.kernels:
        key = next((f for f, spec in families.items()
                    if matches(name, spec["patterns"])), base_name(name))
        ops[key] = ops.get(key, 0.0) + d / 1e9
    gaps: dict[str, float] = {}
    spans = sorted(sl.host, key=lambda h: h[1])
    nxt, open_ = 0, []
    cursor = sl.t0_ns
    ivals = sorted((s, s + d) for _, s, d in sl.kernels)
    ivals.append((sl.t1_ns, sl.t1_ns))
    for s, e in ivals:
        if s > cursor:
            mid = (cursor + s) // 2      # increasing: a sweep over spans
            while nxt < len(spans) and spans[nxt][1] <= mid:
                open_.append(spans[nxt])
                nxt += 1
            open_ = [h for h in open_ if h[2] > mid]
            # nested spans: the innermost opened last
            key = max(open_, key=lambda h: h[1])[0] if open_ else "harness"
            gaps[key] = gaps.get(key, 0.0) + (s - cursor) / 1e9
        cursor = max(cursor, e)
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in idle]}
