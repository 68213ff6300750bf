"""Grouped (per-expert) fused FP4 GEMM: the CUDA kernel's wrapper and its
plain twin.

Counterpart of petit_kernel_tpu/ops/kernels/grouped.py:grouped_mul, the
MoE expert GEMM: every expert's capacity bucket (cap, k) against its own
stacked FP4 weights, in one launch. The kernel is
csrc/grouped_fp4_gemm.cu (fused_mul's tile bodies with the expert as
blockIdx.z: mma.sync 16-row tiles for decode buckets, the wgmma 64-row
tiles of csrc/fp4_wgmma.cuh for cap > 32); grouped_mul_reference is the same function in plain
PyTorch, one fused_mul_reference per expert. grouped_mul takes the plain
version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from .. import gemm as gemm_mod
from ..solution import ElementB, SolutionId
from . import fused


def grouped_mul_reference(xs: torch.Tensor, words: torch.Tensor,
                          scales_t: torch.Tensor, gs: torch.Tensor, *,
                          sid: SolutionId) -> torch.Tensor:
    """Plain PyTorch grouped_mul: fused_mul_reference per expert, so only
    one expert's weights are dequantized at a time."""
    return torch.stack([
        fused.fused_mul_reference(xs[e], words[e], scales_t[e],
                                  gs[e].reshape(1), sid=sid)
        for e in range(xs.shape[0])])


def _infer_element_b(k: int, kp: int) -> ElementB:
    """The JAX package's guess when element_b is not given (grouped.py:93):
    MXFP4 pads k to 1024, NVFP4 to 512. It names the solution only; one
    kernel decodes both."""
    return ElementB.NVFP4 if kp - k < 512 else ElementB.MXFP4


def grouped_mul(xs: torch.Tensor, words: torch.Tensor,
                scales_t: torch.Tensor, gs: torch.Tensor, *,
                sid: Optional[SolutionId] = None, solution_id: int = -1,
                element_b: Optional[ElementB] = None) -> torch.Tensor:
    """out[e] = bf16((xs[e] @ dequant(words[e], scales_t[e])) * gs[e]).

    xs       : (E, cap, k) bf16, natural k order, k % 128 == 0; rows are
               the experts' capacity buckets (zero rows for empty slots)
    words    : (E, kp/8, n) int32, each expert a single-matrix repack
    scales_t : (E, kp/16, n) bf16 processed scales
    gs       : (E,) f32 per-expert global scales, on xs's device (read by
               the kernel from device memory: no host sync)
    sid      : the (block_m, block_n) tile; without it, solution_id and
               element_b resolve one (ops/gemm.py resolve_grouped_solution)

    Returns (E, cap, n) bf16. Launches csrc/grouped_fp4_gemm.cu for CUDA
    tensors (counted in grouped_mul.launches); runs grouped_mul_reference
    for CPU tensors.
    """
    if xs.dim() != 3 or words.dim() != 3 or scales_t.dim() != 3:
        raise ValueError(f"grouped_mul: xs (E, cap, k), words (E, kp/8, n) "
                         f"and scales (E, kp/16, n) expected, got "
                         f"{tuple(xs.shape)}, {tuple(words.shape)}, "
                         f"{tuple(scales_t.shape)}")
    E, cap, k = xs.shape
    _, kw, n = words.shape
    kp = kw * 8
    if sid is None:
        if element_b is None:
            element_b = _infer_element_b(k, kp)
        sid = gemm_mod.resolve_grouped_solution(cap, n, k, element_b,
                                                solution_id=solution_id)
    if words.shape[0] != E or tuple(scales_t.shape) != (E, kp // 16, n) \
            or tuple(gs.shape) != (E,) or kp < k or k % 128 or kp % 256 \
            or n % 16:
        raise ValueError(f"grouped_mul: bad shapes xs {tuple(xs.shape)}, "
                         f"words {tuple(words.shape)}, scales "
                         f"{tuple(scales_t.shape)}, gs {tuple(gs.shape)}")
    if xs.device.type == "cpu":
        return grouped_mul_reference(xs, words, scales_t, gs, sid=sid)
    if xs.device.type != "cuda":
        raise ValueError(f"grouped_mul: unsupported device {xs.device}")
    for name, t in (("words", words), ("scales_t", scales_t), ("gs", gs)):
        if t.device != xs.device:
            raise ValueError(f"grouped_mul: {name} is on {t.device}, xs on "
                             f"{xs.device}")
    if xs.dtype != torch.bfloat16 or words.dtype != torch.int32 \
            or scales_t.dtype != torch.bfloat16 or gs.dtype != torch.float32:
        raise ValueError("grouped_mul: xs bf16, words int32, scales bf16, "
                         "gs f32 expected")
    xs = xs.contiguous()
    if xs.data_ptr() % 16:
        xs = xs.clone()     # the kernel loads X in 16-byte words
    words = words.contiguous()
    scales_t = scales_t.contiguous()
    gs = gs.contiguous()
    out = torch.empty((E, cap, n), dtype=torch.bfloat16, device=xs.device)
    if E == 0 or cap == 0 or n == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    code = lib.pk_grouped_fp4_gemm(xs.data_ptr(), words.data_ptr(),
                                   scales_t.data_ptr(), gs.data_ptr(),
                                   out.data_ptr(), E, cap, n, k, kp,
                                   sid.block_m, sid.block_n, stream)
    _build.check("pk_grouped_fp4_gemm", code)
    grouped_mul.launches += 1
    return out


grouped_mul.launches = 0
