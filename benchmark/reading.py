"""What a metric's reader (metrics/<name>.py, `read(run)`) reads: the run's
requests, token arrivals, spans with their work, and, in a traced run, the
device trace of the slice. Times are seconds from the window's opening. A
reader returns None where it finds nothing to read, and the harness then
leaves the metric out."""

from __future__ import annotations

import math
from typing import Optional

from . import trace as trace_mod
from . import work


def p90(values) -> Optional[float]:
    """The 90th percentile by nearest rank: the value at ceil(0.9 n), the
    highest percentile with ten samples beyond it in a window of some
    hundred requests."""
    v = sorted(values)
    if not v:
        return None
    return v[math.ceil(0.9 * len(v)) - 1]


class Run:
    def __init__(self, *, seconds: float, setup_s: float, records: dict,
                 arrivals: list, spans: list, t0: float, end: float,
                 missing: list, families: dict, peaks: Optional[dict],
                 slice_: Optional[trace_mod.Slice] = None):
        self.seconds = seconds
        self.setup_s = setup_s
        self.records = records          # uid -> serve.Record
        self.arrivals = arrivals        # (t, tokens)
        self.t0 = t0                    # the recorder's clock at opening
        self.end = end                  # when the run stopped serving
        self.spans = spans
        self.missing = missing
        self.families = families
        self.peaks = peaks
        self.slice = slice_

    # -- spans ----------------------------------------------------------

    def window(self, name: str) -> list:
        """Spans of `name` that start inside the window."""
        if self._gone(name):
            return []
        return [s for s in self.spans if s.name == name
                and 0 <= s.t0 - self.t0 < self.seconds]

    def _gone(self, name: str) -> bool:
        wrapped = {"engine.prefill": "_advance_prefill",
                   "blocks.run": "_run_decode_block",
                   "blocks.read": "_read_block", "engine.decode": "_decode",
                   "engine.add_request": "add_request"}
        return wrapped.get(name) in self.missing

    def decode_steps(self) -> list:
        """(wall seconds, steps, ops) of every decode block (dispatch to
        host read) and every eager decode step in the window."""
        if self._gone("blocks.run") or self._gone("blocks.read"):
            return []
        out, run = [], None
        for s in self.spans:
            if not 0 <= s.t0 - self.t0 < self.seconds:
                continue
            if s.name == "blocks.run":
                run = s
            elif s.name == "blocks.read" and run is not None:
                out.append((s.t1 - run.t0, run.attrs["steps"],
                            run.attrs["ops"]))
                run = None
            elif s.name == "engine.decode":
                out.append((s.t1 - s.t0, 1, s.attrs["ops"]))
        return out

    # -- the device trace --------------------------------------------------

    def slice_ops(self) -> list:
        """The work of the engine calls inside the traced slice."""
        sl = self.slice
        return [op for s in self.spans if "ops" in s.attrs
                and sl.host_t0 <= s.t0 and s.t1 <= sl.host_t1
                for op in s.attrs["ops"]]

    def device_s(self, family: str) -> float:
        pats = self.families[family]["patterns"]
        return sum(d for name, _, d in self.slice.kernels
                   if trace_mod.matches(name, pats)) / 1e9

    def roofline(self, family: str) -> Optional[float]:
        """The family's least time (work.bound_s of each op it runs in the
        slice) over its device time there, in %."""
        if self.slice is None or self.peaks is None:
            return None
        fam = self.families[family]
        lo, hi = fam.get("rows", [None, None])
        least = sum(work.bound_s(op.nbytes, op.flops, self.peaks)
                    for op in self.slice_ops() if op.kind == fam["op"]
                    and (lo is None or op.rows >= lo)
                    and (hi is None or op.rows <= hi))
        dev = self.device_s(family)
        if dev <= 0 or least <= 0:
            return None
        return 100.0 * least / dev

    def forwards_in_slice(self) -> int:
        """Forwards the engine ran inside the slice: every decode step of a
        block, every eager step, every admission tick's forward."""
        sl = self.slice
        return sum(s.attrs.get("steps", 1) for s in self.spans
                   if "ops" in s.attrs and sl.host_t0 <= s.t0
                   and s.t1 <= sl.host_t1)

    def idle_share(self) -> Optional[float]:
        if self.slice is None or not self.slice.kernels:
            return None
        return 100.0 * (1 - trace_mod.busy_ns(self.slice)
                        / (self.slice.t1_ns - self.slice.t0_ns))
