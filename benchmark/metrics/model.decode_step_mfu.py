"""The model's decode steps (models/llama.py, paged.py, moe.py): their
least time on the card (the larger of their operations at the bf16 peak and
their bytes at the memory bandwidth, work.py) over their wall, in %."""

from benchmark import work


def read(run):
    steps = run.decode_steps()
    if not steps or run.peaks is None:
        return None
    nbytes = sum(op.nbytes for _, _, ops in steps for op in ops)
    flops = sum(op.flops for _, _, ops in steps for op in ops)
    wall = sum(w for w, _, _ in steps)
    return 100.0 * work.bound_s(nbytes, flops, run.peaks) / wall
