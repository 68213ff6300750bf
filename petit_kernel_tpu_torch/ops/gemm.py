"""Public GEMM entry points and dispatch (torch).

Counterpart of petit_kernel_tpu/ops/gemm.py: validates the problem,
resolves solution_id (-1 -> the tuned table, then the heuristic; else an
explicit feasible id) and runs the fused dequant+GEMM
(ops/kernels/fused.py). The table is empty until autotune.load_table() or
set_tuned_table() fills it (only the tune and bench entry points load one,
as in the JAX package); the heuristic never picks the weight cache, which
a table entry or an explicit id selects. The five mul_*_a16 entries differ
only in ElementB: the kernel's exact decode and bf16 scale multiply serve
pow2 and zero-free tensors unchanged, so their table entries are the exact
format's. A high-precision id (hints.require_high_precision, or an explicit
hp id) runs the f32 kernel (fused.fused_mul_hp): A goes in as f32, and the
f32 result comes back in A's dtype. The W4A8 entries (mul_nvfp4_a8,
mul_mxfp4_a8) take the same operands and run the int8 kernel
(fused_mul_w4a8).

mul_fp4_diff is the differentiable FP4 GEMM (a torch.autograd.Function):
the forward is a mul_* entry, the backward dequantizes the weights with
the dequant kernel (fused.dequant_tpu_layout) and multiplies densely.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import layout
from . import solution as solution_mod
from .kernels import fused
from .solution import ElementB, MatmulType, SolutionHints, SolutionId

# Filled by autotune.load_table() or set_tuned_table(): maps
# _table_key(...) -> SolutionId repr.
_TUNED_TABLE: dict = {}


def set_tuned_table(table: dict) -> None:
    _TUNED_TABLE.clear()
    _TUNED_TABLE.update(table)


def _m_bucket(m: int) -> int:
    """Bucket m for table lookup: exact up to 32 (decode batches), then the
    next power of two from 64, so one entry serves ragged batch sizes."""
    if m <= 32:
        return m
    b = 64
    while b < m:
        b *= 2
    return b


def _table_key(m: int, n: int, k: int, element_b: ElementB,
               mfma_type: MatmulType, high_precision: bool,
               grouped: bool = False) -> tuple:
    """Tuned-table key (m_bucket, n, k, element_b, mfma, hp, grouped), the
    JAX package's 7-field key. `grouped` separates the grouped (MoE expert)
    kernel's optima from the dense kernel's at the same per-expert shape.
    The port's SolutionId has no pow2 or zero-free bits, so the JAX
    package's 8- and 9-field keys have no counterpart: those formats look
    up the exact format's entry."""
    return (_m_bucket(m), n, k, int(element_b), int(mfma_type),
            bool(high_precision), bool(grouped))


def resolve_solution(m: int, n: int, k: int, element_b: ElementB,
                     mfma_type: MatmulType = MatmulType.BF16,
                     high_precision: bool = False, solution_id: int = -1,
                     hints: Optional[SolutionHints] = None) -> SolutionId:
    """solution_id -1 -> the tuned table's entry for the shape if it is
    feasible, else the heuristic; otherwise an explicit SolutionId.repr()
    that must decode, match element_b, satisfy the hints and be feasible,
    or ValueError. hints.b_type must agree with element_b, and
    require_high_precision forces high precision and rejects explicit
    non-high-precision ids (the JAX package's rules, gemm.py:64-125)."""
    if hints is not None:
        if hints.b_type != element_b:
            raise ValueError(f"hints.b_type {hints.b_type} mismatches "
                             f"element_b {element_b}")
        high_precision = high_precision or hints.require_high_precision
    if solution_id is not None and solution_id >= 0:
        try:
            sid = SolutionId.from_repr(solution_id)
        except ValueError as e:
            raise ValueError(f"solution id {solution_id}: {e}") from None
        if sid.element_b != element_b:
            raise ValueError(f"solution {sid} element_b mismatch "
                             f"(want {element_b})")
        if high_precision and not sid.high_precision:
            raise ValueError(f"solution {sid} is not high-precision but "
                             "hints require it")
        if not solution_mod.is_feasible(sid, m, n, k):
            raise ValueError(f"solution {sid} infeasible for m={m} n={n} "
                             f"k={k} (kErrorKernelShape)")
        return sid
    key = _table_key(m, n, k, element_b, mfma_type, high_precision)
    if key in _TUNED_TABLE:
        sid = SolutionId.from_repr(_TUNED_TABLE[key])
        if solution_mod.is_feasible(sid, m, n, k):
            return sid
    return solution_mod.choose_default_solution(
        m, n, k, element_b, mfma_type, high_precision)


def resolve_grouped_solution(cap: int, n: int, k: int, element_b: ElementB,
                             solution_id: int = -1) -> SolutionId:
    """The tile of the grouped (MoE expert) kernel for the per-expert
    problem (cap, n, k): an explicit SolutionId.repr() must decode, match
    element_b and be feasible, or ValueError; -1 takes the grouped table
    entry, then the dense entry of the same shape, then the heuristic at
    m = cap. The grouped kernel has no weight-cache variant, so a
    weight_cache id is refused, and a weight_cache table entry skipped, as
    in the JAX package (gemm.py:128-162)."""
    if solution_id is not None and solution_id >= 0:
        try:
            sid = SolutionId.from_repr(solution_id)
        except ValueError as e:
            raise ValueError(f"solution id {solution_id}: {e}") from None
        if sid.element_b != element_b:
            raise ValueError(f"solution {sid} element_b mismatch "
                             f"(want {element_b})")
        if sid.weight_cache:
            raise ValueError(f"solution {sid}: the grouped kernel has no "
                             "weight_cache variant (kErrorKernelShape)")
        if not solution_mod.is_feasible(sid, cap, n, k):
            raise ValueError(f"solution {sid} infeasible for cap={cap} n={n} "
                             f"k={k} (kErrorKernelShape)")
        return sid
    for grouped in (True, False):
        key = _table_key(cap, n, k, element_b, MatmulType.BF16, False,
                         grouped)
        if key in _TUNED_TABLE:
            sid = SolutionId.from_repr(_TUNED_TABLE[key])
            if (not sid.weight_cache and not sid.high_precision
                    and solution_mod.is_feasible(sid, cap, n, k)):
                return sid
    return solution_mod.choose_default_solution(cap, n, k, element_b)


def _validate_and_prepare(a, b, s, m, n, k, group: int):
    """The JAX package's error contract (gemm.py:165-192): ValueError for a
    wrong shape or dtype. Returns (a, b as int32, s)."""
    if a.dim() != 2 or tuple(a.shape) != (m, k):
        raise ValueError(f"a must be (m, k) = {(m, k)}, got {tuple(a.shape)}")
    if a.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"a dtype must be bf16/f16/f32, got {a.dtype}")
    if b.dtype not in (torch.int32, torch.uint32):
        raise ValueError(f"b must be the int32 repacked weights, got {b.dtype}")
    kp = layout.padded_k(k, layout.pad_multiple(group))
    if tuple(b.shape) != (kp // 8, n):
        raise ValueError(f"b must be repack output (k_padded/8, n) = "
                         f"{(kp // 8, n)}, got {tuple(b.shape)}")
    if s.dtype != torch.bfloat16:
        raise ValueError(f"s must be bfloat16 processed scales "
                         f"(process_*_scales output), got {s.dtype}")
    if tuple(s.shape) != (kp // 16, n):
        raise ValueError(f"s must be processed scales (k_padded/16, n) = "
                         f"{(kp // 16, n)}, got {tuple(s.shape)}")
    if k % 128 != 0:
        raise ValueError(f"k = {k} must be a multiple of 128")
    if b.device != a.device or s.device != a.device:
        raise ValueError(f"a, b and s must share a device; got {a.device}, "
                         f"{b.device}, {s.device}")
    if b.dtype == torch.uint32:
        b = b.view(torch.int32)
    return a, b, s


def _mul(a, b, s, global_scale, size_m, size_n, size_k, solution_id,
         element_b: ElementB, hints: Optional[SolutionHints] = None):
    if size_m == 0 or size_n == 0 or size_k == 0:
        return torch.zeros((size_m, size_n), dtype=a.dtype, device=a.device)
    group = 16 if element_b == ElementB.NVFP4 else 32
    a, b, s = _validate_and_prepare(a, b, s, size_m, size_n, size_k, group)
    in_dtype = a.dtype
    mfma = MatmulType.FP16 if in_dtype == torch.float16 else MatmulType.BF16
    if hints is None and solution_id < 0:
        hints = solution_mod.default_hints(b_type=element_b)
    sid = resolve_solution(size_m, size_n, size_k, element_b, mfma,
                           solution_id=solution_id, hints=hints)
    gs = torch.as_tensor(global_scale, dtype=torch.float32, device=a.device)
    # a high-precision id takes A as f32 and returns f32; otherwise fp16 and
    # f32 activations compute in bf16; both cast back to A's dtype, as the
    # JAX package does (gemm.py:222-235)
    work = torch.float32 if sid.high_precision else torch.bfloat16
    out = fused.fused_mul(a.to(work), b, s, gs.reshape(1), sid=sid)
    return out if in_dtype == work else out.to(in_dtype)


def mul_nvfp4_a16(a, b, s, global_scale, size_m, size_n, size_k,
                  solution_id: int = -1, *,
                  hints: Optional[SolutionHints] = None):
    """c = (a @ dequant_nvfp4(b, s)) * global_scale -> (m, n) in a.dtype.
    b, s: repack_nvfp4 / process_nvfp4_scales outputs."""
    return _mul(a, b, s, global_scale, size_m, size_n, size_k, solution_id,
                ElementB.NVFP4, hints=hints)


def mul_mxfp4_a16(a, b, s, global_scale, size_m, size_n, size_k,
                  solution_id: int = -1, *,
                  hints: Optional[SolutionHints] = None):
    """MXFP4 variant (b, s from repack_mxfp4 / process_mxfp4_scales)."""
    return _mul(a, b, s, global_scale, size_m, size_n, size_k, solution_id,
                ElementB.MXFP4, hints=hints)


def mul_mxfp4z_a16(a, b, s, global_scale, size_m, size_n, size_k,
                   solution_id: int = -1, *,
                   hints: Optional[SolutionHints] = None):
    """Zero-free MXFP4 ("mxfp4z", quantize_mxfp4z tensors)."""
    return _mul(a, b, s, global_scale, size_m, size_n, size_k, solution_id,
                ElementB.MXFP4, hints=hints)


def mul_nvfp4p2_a16(a, b, s, global_scale, size_m, size_n, size_k,
                    solution_id: int = -1, *,
                    hints: Optional[SolutionHints] = None):
    """NVFP4 with power-of-two scales ("nvfp4p2", quantize_nvfp4_pow2)."""
    return _mul(a, b, s, global_scale, size_m, size_n, size_k, solution_id,
                ElementB.NVFP4, hints=hints)


def mul_nvfp4p2z_a16(a, b, s, global_scale, size_m, size_n, size_k,
                     solution_id: int = -1, *,
                     hints: Optional[SolutionHints] = None):
    """Zero-free nvfp4p2 ("nvfp4p2z", quantize_nvfp4_pow2z tensors)."""
    return _mul(a, b, s, global_scale, size_m, size_n, size_k, solution_id,
                ElementB.NVFP4, hints=hints)


def _mul_w4a8(a, b, s, global_scale, size_m, size_n, size_k, solution_id,
              element_b: ElementB, r_t=None, acol=None):
    """The JAX package's _mul_w4a8 (gemm.py:276-298): an explicit id must be
    an INT8 one; a tuned-table id of another type becomes an INT8 id of its
    tile without the weight cache (and, here, without the high-precision
    bit, which no W4A8 kernel has); the output comes back in a's dtype."""
    if size_m == 0 or size_n == 0 or size_k == 0:
        return torch.zeros((size_m, size_n), dtype=a.dtype, device=a.device)
    group = 16 if element_b == ElementB.NVFP4 else 32
    a, b, s = _validate_and_prepare(a, b, s, size_m, size_n, size_k, group)
    in_dtype = a.dtype
    if solution_id is not None and solution_id >= 0:
        try:
            sid = SolutionId.from_repr(solution_id)
        except ValueError as e:
            raise ValueError(f"solution id {solution_id}: {e}") from None
        if sid.mfma_type != MatmulType.INT8:
            raise ValueError(f"solution {sid} is not an INT8 (W4A8) "
                             "solution")
    sid = resolve_solution(size_m, size_n, size_k, element_b,
                           MatmulType.INT8, solution_id=solution_id)
    if sid.mfma_type != MatmulType.INT8:
        sid = dataclasses.replace(sid, mfma_type=MatmulType.INT8,
                                  high_precision=False, weight_cache=False)
    gs = torch.as_tensor(global_scale, dtype=torch.float32, device=a.device)
    out = fused.fused_mul_w4a8(a.to(torch.bfloat16), b, s, gs.reshape(1),
                               sid=sid, r_t=r_t, acol=acol)
    return out if in_dtype == torch.bfloat16 else out.to(in_dtype)


def mul_nvfp4_a8(a, b, s, global_scale, size_m, size_n, size_k,
                 solution_id: int = -1, *, r_t=None, acol=None):
    """W4A8 over mul_nvfp4_a16's operands: activations quantized per token
    to int8, the FP4 weights requantized to int8 per column in the kernel,
    int32 sums (fused.fused_mul_w4a8). Not exact: within int8 quantization
    noise of mul_nvfp4_a16. r_t, acol: fused.w4a8_requant_constants(s),
    computed per call unless given. Meant for large m (prefill), where the
    int8 tensor cores run at twice the bf16 rate."""
    return _mul_w4a8(a, b, s, global_scale, size_m, size_n, size_k,
                     solution_id, ElementB.NVFP4, r_t=r_t, acol=acol)


def mul_mxfp4_a8(a, b, s, global_scale, size_m, size_n, size_k,
                 solution_id: int = -1, *, r_t=None, acol=None):
    """MXFP4 W4A8 (see mul_nvfp4_a8)."""
    return _mul_w4a8(a, b, s, global_scale, size_m, size_n, size_k,
                     solution_id, ElementB.MXFP4, r_t=r_t, acol=acol)


_DIFF_MULS = {"nvfp4": mul_nvfp4_a16, "nvfp4p2": mul_nvfp4p2_a16,
              "nvfp4p2z": mul_nvfp4p2z_a16, "mxfp4z": mul_mxfp4z_a16,
              "w4a8": mul_nvfp4_a8, "mxfp4": mul_mxfp4_a16}


class _MulFp4Diff(torch.autograd.Function):
    """The JAX package's custom VJP (gemm.py:364-395), in its order of
    roundings."""

    @staticmethod
    def forward(ctx, fmt, size_k, a, b, s, gs):
        m, n = a.shape[0], b.shape[1]
        y = _DIFF_MULS[fmt](a, b, s, gs, m, n, size_k, -1)
        ctx.fmt, ctx.size_k = fmt, size_k
        ctx.save_for_backward(a, b, s, gs, y)
        return y

    @staticmethod
    def backward(ctx, g):
        a, b, s, gs, y = ctx.saved_tensors
        da = dgs = None
        if ctx.needs_input_grad[2]:
            eb = (ElementB.MXFP4 if ctx.fmt in ("mxfp4", "mxfp4z")
                  else ElementB.NVFP4)
            deq = fused.dequant_tpu_layout(b, s, element_b=eb)  # (kp, n)
            w = deq[:ctx.size_k] * gs.float().to(torch.bfloat16)
            del deq
            g16 = g.to(torch.bfloat16)
            if a.device.type == "cuda" and a.dtype == torch.bfloat16:
                da = torch.matmul(g16, w.T)   # f32 sums, one bf16 rounding
            else:          # f32 on the CPU: the same sums, deterministic
                da = (g16.float() @ w.float().T).to(a.dtype)
        if ctx.needs_input_grad[5]:
            gsf = gs.float()
            dot = (g.float() * y.float()).sum()
            dgs = torch.where(gsf != 0, dot / gsf, 0.0).reshape(gs.shape)
        return None, None, da, None, None, dgs


def mul_fp4_diff(fmt: str, size_k: int, a, b, s, gs):
    """Differentiable FP4 GEMM: y = the `fmt` entry's (a @ dequant(b, s)) *
    gs with solution -1 ("w4a8" runs mul_nvfp4_a8). Gradients flow to a
    and to the global scale gs (a tensor), never to the frozen b and s:
    da = f32(bf16(g) @ bf16(dequant(b, s)[:size_k] * bf16(gs))^T) cast to
    a's dtype, through the dequant kernel on the card; dgs = sum(g * y) /
    gs (0 where gs == 0). Without a gradient to take it runs the forward
    alone."""
    gs = torch.as_tensor(gs, dtype=torch.float32, device=a.device)
    if torch.is_grad_enabled() and (a.requires_grad or gs.requires_grad):
        return _MulFp4Diff.apply(fmt, size_k, a, b, s, gs)
    return _DIFF_MULS[fmt](a, b, s, gs, a.shape[0], b.shape[1], size_k, -1)


def get_fp4_solutions(size_m: int, size_n: int, size_k: int,
                      a_type=torch.bfloat16, c_type=torch.bfloat16,
                      element_b: ElementB = ElementB.NVFP4) -> list[int]:
    """Feasible solution reprs for a shape, weight-cache and high-precision
    ones included (the JAX package's list, gemm.py:398-407)."""
    del c_type
    mfma = MatmulType.FP16 if a_type == torch.float16 else MatmulType.BF16
    sols = solution_mod.get_solutions(size_m, size_n, size_k, element_b, mfma)
    sols += solution_mod.get_solutions(size_m, size_n, size_k, element_b,
                                       mfma, high_precision=True)
    return [s.repr() for s in sols]
