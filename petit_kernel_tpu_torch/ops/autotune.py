"""Offline autotuner: enumerate -> time -> persist the best solution per
shape (torch).

Counterpart of petit_kernel_tpu/ops/autotune.py, itself the reference's
`bench_matmul --algo tune` flow: for each problem shape, time the candidate
solutions on the card and keep the fastest in the dispatch table
(ops/gemm.py _TUNED_TABLE), which resolve_solution consults for
solution_id -1. Every Hopper kernel instance is compiled ahead of time
(csrc/), so unlike a Pallas block shape a candidate costs no compile and
needs no pruning: the candidates are every feasible non-high-precision id,
the heuristic's first, which is the reference's full walk. `full` and
`time_budget_s` keep their meaning: a full walk prints its top solutions,
and a budget stops the walk once it has run out, after the first
candidate.

Times: utils/benchlib.cuda_time, the median of single calls with L2
flushed, on operands fabricated from a seed. Without a CUDA card the timing
raises. Tables persist as JSON, one per card, keyed by the 7 fields of
gemm._table_key joined with commas, in petit_kernel_tpu_torch/tuned/
<device>.json, where <device> is torch.cuda.get_device_name() with spaces
replaced by underscores. (The repo's tuned/ holds the JAX package's
tables, whose ids have another bit layout.)
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Sequence

import torch

from ..utils import benchlib
from . import gemm as gemm_mod
from . import layout
from . import solution as solution_mod
from .kernels import fused
from .kernels import grouped as grouped_mod
from .solution import ElementB, MatmulType, SolutionId


def _table_dir() -> str:
    """The package's tuned/ when present or creatable, else a per-user
    cache directory (the package may be installed read-only)."""
    pkg = os.path.normpath(os.path.join(os.path.dirname(__file__), "..",
                                        "tuned"))
    if os.path.isdir(pkg) or os.access(os.path.dirname(pkg), os.W_OK):
        return pkg
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "petit_kernel_tpu_torch", "tuned")


_TABLE_DIR = _table_dir()


def _device_kind() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: a tuned table belongs to one")
    return torch.cuda.get_device_name().replace(" ", "_")


def table_path(kind: str | None = None) -> str:
    return os.path.join(_TABLE_DIR, f"{kind or _device_kind()}.json")


def candidate_solutions(m: int, n: int, k: int,
                        element_b: ElementB = ElementB.NVFP4,
                        mfma_type: MatmulType = MatmulType.BF16
                        ) -> list[SolutionId]:
    """The heuristic default, then every other feasible non-high-precision
    id (at most 8 a shape: 4 tiles, with and without the weight cache)."""
    base = solution_mod.choose_default_solution(m, n, k, element_b,
                                                mfma_type)
    return [base] + [sid for sid in solution_mod.get_solutions(
        m, n, k, element_b, mfma_type) if sid != base]


def time_solution(sid: SolutionId, a, b, s, gs, *, iters: int = 10,
                  warmup: int = 2) -> float:
    """Median seconds of one call of sid's kernel on these operands (a bf16;
    a high-precision id runs on f32(a), an INT8 id through the W4A8 path, as
    in the JAX package). Raises without a CUDA card."""
    if sid.mfma_type == MatmulType.INT8:
        return benchlib.cuda_time(
            lambda: fused.fused_mul_w4a8(a, b, s, gs, sid=sid),
            iters=iters, warmup=warmup)
    a = a.float() if sid.high_precision else a
    return benchlib.cuda_time(lambda: fused.fused_mul(a, b, s, gs, sid=sid),
                              iters=iters, warmup=warmup)


def random_weight(fmt: str, n: int, k: int, gen, device="cuda"):
    """A random quantized (n, k) weight of `fmt` (a bench.py format name) on
    `device`, bench.py's draws: any FP4 byte (no zero codes for the
    zero-free formats), E4M3 scale bytes with exponent field 4..10
    (mantissa zero for the pow2 formats) or E8M0 bytes 118..131. Returns
    (words (kp/8, n) int32, scales (kp/16, n) bf16, element_b)."""
    def draw(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.uint8,
                             device=device)
    group = 32 if fmt in ("mxfp4", "mxfp4z") else 16
    qw = draw(0, 256, (n, k // 2))
    if fmt in ("nvfp4p2z", "mxfp4z"):
        # zero-free contract: no stored zero codes (0 = +0, 8 = -0)
        lo, hi = qw & 0xF, qw >> 4
        lo = torch.where(lo == 0, 1, torch.where(lo == 8, 9, lo))
        hi = torch.where(hi == 0, 1, torch.where(hi == 8, 9, hi))
        qw = (lo | (hi << 4)).to(torch.uint8)
    if group == 32:
        raw = draw(118, 132, (n, k // group))
    else:
        raw = draw(4, 11, (n, k // group)) << 3
        if fmt in ("nvfp4", "w4a8"):
            raw = raw | draw(0, 8, (n, k // group))
    words = layout.repack_fp4_weights(qw, n, k,
                                      pad_to=layout.pad_multiple(group))
    scales = layout.process_fp4_scales(raw, n, k, group_size=group)
    return (words, scales,
            ElementB.MXFP4 if group == 32 else ElementB.NVFP4)


def tune_shape(m: int, n: int, k: int,
               element_b: ElementB = ElementB.NVFP4,
               mfma_type: MatmulType = MatmulType.BF16,
               *, verbose: bool = False, update_table: bool = True,
               full: bool = False, time_budget_s: float | None = None,
               top: int = 5, device="cuda") -> SolutionId:
    """Time the candidates of one shape on the card and return the fastest
    SolutionId; by default also record it in the dispatch table under
    _table_key(m, n, k, element_b, mfma_type, False). Operands come from a
    seeded generator on `device` (another device only for tests, which
    replace time_solution)."""
    gen = torch.Generator(device=device).manual_seed(1234)
    fmt = "nvfp4" if element_b == ElementB.NVFP4 else "mxfp4"
    b, s, _ = random_weight(fmt, n, k, gen, device)
    a = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
    gs = torch.ones((1,), dtype=torch.float32, device=device)

    cands = candidate_solutions(m, n, k, element_b, mfma_type)
    t0 = time.perf_counter()
    timed: list[tuple[float, SolutionId]] = []
    for idx, sid in enumerate(cands):
        if (time_budget_s is not None and idx > 0
                and time.perf_counter() - t0 > time_budget_s):
            if verbose:
                print(f"# tune budget hit after {idx}/{len(cands)} "
                      "candidates")
            break
        t = time_solution(sid, a, b, s, gs)
        timed.append((t, sid))
        if verbose:
            print(f"#   {sid.block_m:4d}x{sid.block_n:4d}"
                  f"{' wc' if sid.weight_cache else '   '}  {t * 1e6:10.1f} us"
                  f"  {2 * m * n * k / t / 1e12:7.2f} TFLOP/s", flush=True)
    timed.sort(key=lambda ts: ts[0])
    if full and verbose:
        print(f"# top-{top} for m={m} n={n} k={k}:")
        for t, sid in timed[:top]:
            print(f"#   {2 * m * n * k / t / 1e12:7.2f} TFLOP/s  "
                  f"{t * 1e6:9.1f} us  {sid}")
    best = timed[0][1]
    if update_table:
        key = gemm_mod._table_key(m, n, k, element_b, mfma_type, False)
        gemm_mod._TUNED_TABLE[key] = best.repr()
    return best


def tune_grouped_shape(E: int, cap: int, n: int, k: int,
                       element_b: ElementB = ElementB.MXFP4,
                       *, verbose: bool = False,
                       update_table: bool = True) -> SolutionId:
    """Tune the grouped (MoE expert) kernel for the per-expert shape (cap,
    n, k) with E experts and record the fastest under the grouped table
    key. The candidates are the dense ones without the weight cache, which
    the grouped kernel lacks."""
    gen = torch.Generator(device="cuda").manual_seed(99)
    fmt = "nvfp4" if element_b == ElementB.NVFP4 else "mxfp4"
    # one expert's weight for all E: the time does not depend on the values
    w, s, _ = random_weight(fmt, n, k, gen)
    words = w.expand(E, *w.shape).contiguous()
    st = s.expand(E, *s.shape).contiguous()
    xs = torch.randn((E, cap, k), generator=gen, device="cuda").to(
        torch.bfloat16)
    gs = torch.ones((E,), dtype=torch.float32, device="cuda")

    best, best_t = None, math.inf
    for sid in candidate_solutions(cap, n, k, element_b):
        if sid.weight_cache:
            continue
        t = benchlib.cuda_time(
            lambda: grouped_mod.grouped_mul(xs, words, st, gs, sid=sid),
            iters=10, warmup=2)
        if verbose:
            print(f"# grouped {sid.block_m:4d}x{sid.block_n:4d}  "
                  f"{t * 1e6:10.1f} us  "
                  f"{2 * E * cap * n * k / t / 1e12:7.2f} TFLOP/s",
                  flush=True)
        if t < best_t:
            best, best_t = sid, t
    if update_table:
        key = gemm_mod._table_key(cap, n, k, element_b, MatmulType.BF16,
                                  False, grouped=True)
        gemm_mod._TUNED_TABLE[key] = best.repr()
    return best


def tune_suite(shapes: Sequence[tuple[int, int, int]],
               element_b: ElementB = ElementB.NVFP4,
               *, verbose: bool = False, save: bool = True,
               full: bool = False,
               time_budget_s: float | None = None) -> dict:
    """Tune a suite of (m, n, k) shapes, persist the table unless save is
    False, and return a copy of it."""
    for (m, n, k) in shapes:
        sid = tune_shape(m, n, k, element_b, verbose=verbose, full=full,
                         time_budget_s=time_budget_s)
        if verbose:
            print(f"# best for m={m} n={n} k={k}: {sid}", flush=True)
    if save:
        save_table()
    return dict(gemm_mod._TUNED_TABLE)


def save_table(kind: str | None = None) -> str:
    """Merge the dispatch table into the card's JSON file; returns its
    path."""
    os.makedirs(_TABLE_DIR, exist_ok=True)
    path = table_path(kind)
    existing = {}
    if os.path.exists(path):
        with open(path) as f:
            existing = json.load(f)
    existing.update({",".join(map(str, key)): v
                     for key, v in gemm_mod._TUNED_TABLE.items()})
    with open(path, "w") as f:
        json.dump(existing, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def load_table(kind: str | None = None) -> bool:
    """Load the card's persisted table into the dispatcher; False if there
    is none. Every key has the 7 fields of gemm._table_key."""
    path = table_path(kind)
    if not os.path.exists(path):
        return False
    with open(path) as f:
        raw = json.load(f)
    table = {}
    for ks, v in raw.items():
        parts = ks.split(",")
        if len(parts) != 7:
            raise ValueError(f"{path}: table key {ks!r} has {len(parts)} "
                             "fields, not 7")
        table[(*map(int, parts[:5]), parts[5] == "True",
               parts[6] == "True")] = int(v)
    gemm_mod.set_tuned_table(table)
    return True
