"""GEMM benchmark on the CUDA card: the fused FP4 GEMM against dense bf16.

    python -m petit_kernel_tpu_torch.bench            # quick decode suite
    python -m petit_kernel_tpu_torch.bench --full --tune --format mxfp4

Counterpart of the repo's bench.py (the JAX package's bench) with its
suites, modes and one JSON line: for each (m, n, k) case it fabricates a
quantized weight from a seed on the card, runs the format's mul_* entry
(solution -1 through the card's tuned table, or with --tune the id
ops/autotune.tune_shape finds) and, as the baseline, torch.matmul of the
same bf16 activations by the weight dequantized on the card
(fused.dequant_tpu_layout). Times: utils/benchlib.cuda_time, the median of
--iters single calls, each after an L2 flush. Without a card it exits
non-zero.

Prints ONE JSON line, bench.py's:
  {"metric": ..., "value": N, "unit": "TFLOP/s", "vs_baseline": N, ...}
where value is the geomean TFLOP/s of the fused kernel over the m = 16
cases and vs_baseline the geomean of dense time / FP4 time (> 1: faster
than dense). The default run (quick nvfp4 suite) also runs nvfp4p2 and
nvfp4p2z and reports as bench.py does: nvfp4p2z as the headline, nvfp4p2
and exact nvfp4 beside it.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

# The reference's bench suite: m in {16, 256, 512} x 8 Llama-70B (n, k)
# pairs; the quick default takes three of them at m = 16.
SHAPES_NK = [
    (4096, 4096),
    (4096, 14336),
    (6144, 4096),
    (8192, 8192),
    (8192, 28672),
    (10240, 8192),
    (28672, 4096),
    (57344, 8192),
]
SHAPES_NK_QUICK = [(10240, 8192), (8192, 8192), (8192, 28672)]

# Production-trace suite (m, n, k): one shape per (m-band, projection) of
# the reference's 80-shape trace with ragged m up to 16375.
SHAPES_TRACE_MNK = [
    (15, 8192, 8192), (15, 57344, 8192), (44, 4096, 14336),
    (44, 8192, 1024), (566, 7168, 8192), (611, 28672, 4096),
    (932, 8192, 28672), (1340, 8192, 3584), (2084, 10240, 8192),
    (4314, 4096, 4096), (14437, 6144, 4096), (16375, 8192, 8192),
]

# Llama-70B 8-way tensor-parallel shard shapes (n, k): the fused qkv and
# gate|up column shards, the wo and w_down row shards.
SHAPES_70B_TP8 = [
    (1280, 8192),    # wqkv column shard: (8192 + 2*1024)/8
    (8192, 1024),    # wo row shard: k = 8192/8
    (7168, 8192),    # w_gate|w_up column shard: 2*28672/8
    (8192, 3584),    # w_down row shard: k = 28672/8
]

FORMATS = ("nvfp4", "mxfp4", "mxfp4z", "nvfp4p2", "nvfp4p2z", "w4a8",
           "hybrid")


def run(cases, tune: bool, iters: int, fmt: str = "nvfp4") -> list[dict]:
    """cases: iterable of (m, n, k); consecutive equal (n, k) reuse one
    weight. Returns one dict a case (times in seconds)."""
    from . import (mul_mxfp4_a16, mul_mxfp4z_a16, mul_nvfp4_a8,
                   mul_nvfp4_a16, mul_nvfp4p2_a16, mul_nvfp4p2z_a16)
    from .ops import autotune
    from .ops.kernels import fused
    from .ops.solution import ElementB, MatmulType
    from .utils import benchlib

    if fmt == "hybrid":
        return run_hybrid(cases, iters)
    autotune.load_table()    # the card's persisted table, if there is one
    mul = {"nvfp4": mul_nvfp4_a16, "nvfp4p2": mul_nvfp4p2_a16,
           "nvfp4p2z": mul_nvfp4p2z_a16, "mxfp4z": mul_mxfp4z_a16,
           "w4a8": mul_nvfp4_a8, "mxfp4": mul_mxfp4_a16}[fmt]
    results = []
    prev_nk = None
    for (m, n, k) in cases:
        if (n, k) != prev_nk:
            prev_nk = (n, k)
            gen = torch.Generator(device="cuda").manual_seed(n + k)
            b, s, eb = autotune.random_weight(fmt, n, k, gen)
            gs = torch.ones((1,), dtype=torch.float32, device="cuda")
            group = 16 if eb == ElementB.NVFP4 else 32
            # the dense (k, n) baseline operand, dequantized on the card
            b_dense = fused.dequant_tpu_layout(b, s, element_b=eb)[:k]
        a = torch.randn((m, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        sid = -1
        if tune:
            mt = MatmulType.INT8 if fmt == "w4a8" else MatmulType.BF16
            sid = autotune.tune_shape(m, n, k, eb, mt).repr()
        t_fp4 = benchlib.cuda_time(
            lambda: mul(a, b, s, gs, m, n, k, sid), iters=iters)
        t_dense = benchlib.cuda_time(lambda: torch.matmul(a, b_dense),
                                     iters=iters)
        results.append(dict(m=m, n=n, k=k, t_fp4=t_fp4, t_dense=t_dense,
                            group=group,
                            tflops=2 * m * n * k / t_fp4 / 1e12,
                            speedup=t_dense / t_fp4))
    return results


def run_hybrid(cases, iters: int) -> list[dict]:
    """Hybrid FP4 + BF16 salient columns (ops/hybrid.py) against dense;
    (n, k) pairs that no column split divides are skipped, as in
    bench.py."""
    from .ops import hybrid as hybrid_mod
    from .utils import benchlib

    results = []
    prev_nk, hq = None, None
    for (m, n, k) in cases:
        if (n, k) != prev_nk:
            gen = torch.Generator(device="cuda").manual_seed(n + k)
            w = torch.randn((k, n), generator=gen, device="cuda") / 8
            for (bnf, bnd) in ((1536, 512), (768, 256), (384, 128)):
                if n % (bnf + bnd) == 0:
                    break
            else:
                prev_nk = None   # no stale hq for this (n, k)
                continue
            hq = hybrid_mod.quantize_hybrid(w, block_nf=bnf, block_nd=bnd)
            b_dense = w.to(torch.bfloat16)
            del w
            prev_nk = (n, k)
        a = torch.randn((m, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        t_h = benchlib.cuda_time(lambda: hybrid_mod.mul_hybrid(a, hq),
                                 iters=iters)
        t_dense = benchlib.cuda_time(lambda: torch.matmul(a, b_dense),
                                     iters=iters)
        results.append(dict(m=m, n=n, k=k, t_fp4=t_h, t_dense=t_dense,
                            group=16, tflops=2 * m * n * k / t_h / 1e12,
                            speedup=t_dense / t_h))
    return results


def _geo(rs, key):
    return math.exp(sum(math.log(r[key]) for r in rs) / len(rs))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m petit_kernel_tpu_torch.bench")
    p.add_argument("--full", action="store_true", help="full shape sweep")
    p.add_argument("--tune", action="store_true", help="autotune each shape")
    p.add_argument("--trace", action="store_true",
                   help="production-trace suite (ragged m) instead")
    p.add_argument("--shard70b", action="store_true",
                   help="Llama-70B 8-way TP shard shapes instead")
    p.add_argument("--format", choices=FORMATS, default="nvfp4")
    p.add_argument("--iters", type=int, default=20,
                   help="timed calls a case (median)")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("petit_kernel_tpu_torch.bench: no CUDA card; the "
                         "bench times only the card")

    if args.trace:
        cases = SHAPES_TRACE_MNK
    elif args.shard70b:
        cases = [(m, n, k) for (n, k) in SHAPES_70B_TP8
                 for m in (16, 256, 512)]
    else:
        shapes = SHAPES_NK if args.full else SHAPES_NK_QUICK
        ms = (16, 256, 512) if args.full else (16,)
        # w4a8 targets the compute-bound prefill regime
        if args.format == "w4a8" and not args.full:
            ms = (256, 512)
        cases = [(m, n, k) for (n, k) in shapes for m in ms]
    results = run(cases, args.tune, args.iters, fmt=args.format)
    # the default run also measures the pow2 (nvfp4p2) and zero-free pow2
    # (nvfp4p2z) formats and reports as bench.py does
    extra = extra_z = None
    if (args.format == "nvfp4" and not args.trace and not args.shard70b
            and not args.full):
        extra = run(cases, args.tune, args.iters, fmt="nvfp4p2")
        extra_z = run(cases, args.tune, args.iters, fmt="nvfp4p2z")

    if args.verbose:
        for r in results + (extra or []) + (extra_z or []):
            wgb = (r["n"] * r["k"] / 2
                   + r["n"] * r["k"] / r["group"] * 2) / 1e9
            print(f"# m={r['m']:4d} n={r['n']:6d} k={r['k']:6d} "
                  f"fp4={r['t_fp4'] * 1e6:9.1f}us "
                  f"dense={r['t_dense'] * 1e6:9.1f}us "
                  f"{r['tflops']:7.2f} TFLOP/s "
                  f"{wgb / r['t_fp4']:6.1f} GB/s speedup={r['speedup']:.3f}")

    decode = [r for r in results if r["m"] == 16]
    label = "decode_m16"
    if not decode:
        decode = results
        label = "prefill" if args.format == "w4a8" else "all"
    line = {
        "metric": f"{args.format}_gemm_{label}_geomean_tflops",
        "value": round(_geo(decode, "tflops"), 3),
        "unit": "TFLOP/s",
        "vs_baseline": round(_geo(decode, "speedup"), 3),
    }
    if extra:
        d2 = [r for r in extra if r["m"] == 16]
        dz = [r for r in extra_z if r["m"] == 16]
        line = {
            "metric": "nvfp4p2z_gemm_decode_m16_geomean_tflops",
            "value": round(_geo(dz, "tflops"), 3),
            "unit": "TFLOP/s",
            "vs_baseline": round(_geo(dz, "speedup"), 3),
            "nvfp4p2_tflops": round(_geo(d2, "tflops"), 3),
            "nvfp4p2_vs_baseline": round(_geo(d2, "speedup"), 3),
            "nvfp4_exact_tflops": round(_geo(decode, "tflops"), 3),
            "nvfp4_exact_vs_baseline": round(_geo(decode, "speedup"), 3),
        }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
