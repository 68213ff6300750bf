"""The 64-row FP4 GEMM family (kernels/prefill_gemm.json): its least time
over its device time in the traced slice, in %."""


def read(run):
    return run.roofline("prefill_gemm")
