"""Decode blocks (_DecodeBlocks): the wall of each block, from its dispatch
to its host read, and of each eager decode step, over their steps."""


def read(run):
    steps = run.decode_steps()
    n = sum(k for _, k, _ in steps)
    return 1e3 * sum(w for w, _, _ in steps) / n if n else None
