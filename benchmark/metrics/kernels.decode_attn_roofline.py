"""Decode attention (kernels/decode_attn.json): its least time over its
device time in the traced slice, in %."""


def read(run):
    return run.roofline("decode_attn")
