"""Timing on the CUDA card: the median of single calls, L2 flushed.

Counterpart of petit_kernel_tpu/utils/benchlib.py without its relay
protocol. The TPU was timed over a remote relay whose round trips hid the
device time, so that module chains calls in a loop and takes a marginal
cost; here CUDA events bracket each call on the device itself.

Before each call a 256 MiB device buffer, more than twice the 50 MB L2 of
an H100, is overwritten outside the events, so every call reads its
weights from device memory, as a layer of a serving step does after the
layers before it have pushed it out of L2. The flush also gives the host
time to queue the call behind the start event. Back-to-back launches
without it (chip_smoke.cuda_ms) keep weights under 50 MB in L2 and read
faster.
"""

from __future__ import annotations

import statistics

import torch

FLUSH_BYTES = 256 * 2 ** 20
_FLUSH: dict = {}


def _flush_buffer(device: torch.device) -> torch.Tensor:
    buf = _FLUSH.get(device)
    if buf is None:
        buf = _FLUSH[device] = torch.empty(FLUSH_BYTES // 4,
                                           dtype=torch.int32, device=device)
    return buf


def cuda_time(call, *args, iters: int = 20, warmup: int = 3,
              flush_l2: bool = True) -> float:
    """Median seconds of `iters` single calls of call(*args) on the current
    CUDA device, each timed by its own pair of CUDA events, after `warmup`
    untimed calls; with flush_l2, L2 is flushed before each call, outside
    its events. Raises without a CUDA card: a time comes only from one."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time needs a CUDA card: no time is taken "
                           "on the CPU")
    buf = None
    if flush_l2:
        buf = _flush_buffer(torch.device("cuda", torch.cuda.current_device()))
    for _ in range(warmup):
        call(*args)
    events = []
    for _ in range(iters):
        if buf is not None:
            buf.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call(*args)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events) / 1e3
