"""Console entry points (pyproject [project.scripts]), on the CUDA card.

Counterpart of petit_kernel_tpu/_cli.py. `petit-tpu-torch-tune` is the
reference's `bench_matmul --algo tune` flow (ops/autotune.py): it times every
candidate of each shape and merges the fastest into the card's table
(petit_kernel_tpu_torch/tuned/<device>.json). `petit-tpu-torch-bench` times
the FP4 GEMM entry (table loaded, solution -1) against a dense bf16
torch.matmul on the same shapes, through bench.run. Both take their times
from utils/benchlib.cuda_time and raise without a card. Without the console
scripts:

    python -m petit_kernel_tpu_torch._cli tune [--format mxfp4] ...
    python -m petit_kernel_tpu_torch._cli bench [--ms 16,256] ...

petit_kernel_tpu_torch/bench.py runs the full suites of the repo's bench.py.
"""

from __future__ import annotations

import argparse
import sys


# Default shapes: the Llama-70B-derived (n, k) pairs the reference sweeps
# (its tools/benchmarks/matmul.py:92-117).
_NK_PAIRS = ((4096, 8192), (8192, 8192), (10240, 8192), (57344, 8192),
             (8192, 28672), (28672, 8192), (8192, 1024), (1024, 8192))


def _parse_shapes(spec: str | None, ms: str) -> list[tuple[int, int, int]]:
    m_list = [int(x) for x in ms.split(",")]
    if spec:
        nk = []
        for part in spec.split(";"):
            n, k = part.split(",")
            nk.append((int(n), int(k)))
    else:
        nk = list(_NK_PAIRS)
    return [(m, n, k) for m in m_list for (n, k) in nk]


def tune_main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="petit-tpu-torch-tune")
    p.add_argument("--shapes", help="n,k;n,k;... (default: Llama-70B suite)")
    p.add_argument("--ms", default="16,256,512")
    p.add_argument("--format", choices=("nvfp4", "mxfp4"), default="nvfp4")
    p.add_argument("--full", action="store_true",
                   help="print each shape's top solutions (the walk always "
                        "covers the whole feasible space)")
    p.add_argument("--time-budget", type=float, default=None,
                   help="per-shape wall-clock cap in seconds")
    p.add_argument("--no-save", action="store_true")
    args = p.parse_args(argv)

    from .ops import autotune
    from .ops.solution import ElementB

    eb = ElementB.NVFP4 if args.format == "nvfp4" else ElementB.MXFP4
    autotune.load_table()
    autotune.tune_suite(_parse_shapes(args.shapes, args.ms), eb,
                        verbose=True, save=not args.no_save,
                        full=args.full, time_budget_s=args.time_budget)
    if not args.no_save:
        print(f"# table: {autotune.table_path()}", flush=True)


def bench_main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="petit-tpu-torch-bench")
    p.add_argument("--shapes", help="n,k;n,k;... (default: Llama-70B suite)")
    p.add_argument("--ms", default="16")
    p.add_argument("--format", choices=("nvfp4", "mxfp4"), default="nvfp4")
    p.add_argument("--iters", type=int, default=20,
                   help="timed calls a shape (median)")
    args = p.parse_args(argv)

    import torch

    from . import bench

    if not torch.cuda.is_available():
        raise SystemExit("petit-tpu-torch-bench: no CUDA card; the bench "
                         "times only the card")
    for r in bench.run(_parse_shapes(args.shapes, args.ms), False,
                       args.iters, args.format):
        print(f"m={r['m']:5d} n={r['n']:6d} k={r['k']:6d}  fp4 "
              f"{r['t_fp4'] * 1e6:9.1f} us ({r['tflops']:6.2f} TFLOP/s)  "
              f"dense {r['t_dense'] * 1e6:9.1f} us  "
              f"speedup {r['speedup']:5.2f}x", flush=True)


if __name__ == "__main__":
    cmds = {"tune": tune_main, "bench": bench_main}
    if len(sys.argv) < 2 or sys.argv[1] not in cmds:
        sys.exit("usage: python -m petit_kernel_tpu_torch._cli "
                 "{tune,bench} [options]")
    cmds[sys.argv[1]](sys.argv[2:])
