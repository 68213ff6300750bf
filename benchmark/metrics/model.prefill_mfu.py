"""The model's prefill forwards: the operations of the real prompt tokens
(work.py) at the bf16 peak over the wall of the admission ticks that ran
them, in %."""


def read(run):
    spans = run.window("engine.prefill")
    if not spans or run.peaks is None:
        return None
    flops = sum(op.flops for s in spans for op in s.attrs["ops"])
    wall = sum(s.t1 - s.t0 for s in spans)
    return 100.0 * flops / run.peaks["bf16_flop_per_s"] / wall
