"""The 16-row FP4 GEMM family (kernels/decode_gemm.json): its least time
over its device time in the traced slice, in %."""


def read(run):
    return run.roofline("decode_gemm")
