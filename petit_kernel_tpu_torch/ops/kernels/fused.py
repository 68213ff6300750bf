"""Fused FP4-dequant + GEMM: the CUDA kernel's wrapper and its plain twin.

Counterpart of petit_kernel_tpu/ops/kernels/fused.py:fused_mul. The kernel
is csrc/fp4_gemm.cu (mma.sync over a bf16 tile decoded in shared memory);
fused_mul_reference is the same function in plain PyTorch. fused_mul takes
the plain version only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from .. import _build
from .. import layout
from ..solution import SolutionId


def fused_mul_reference(a: torch.Tensor, words: torch.Tensor,
                        scales_t: torch.Tensor, global_scale: torch.Tensor,
                        *, sid: SolutionId) -> torch.Tensor:
    """Plain PyTorch fused_mul: bf16((a @ dequant(words, scales)) * gs).

    Value times scale is exact in bf16 (a 2-bit by a 4-bit significand), so
    the f32 dequant holds the numbers of the kernel's bf16 B tile; the
    products are exact in f32, and the f32 matmul sums them, as the
    kernel's f32 accumulators do (in another order)."""
    del sid  # one decode serves every scale path
    b = layout.dequant_from_tpu_layout(words, scales_t, words.shape[1],
                                       a.shape[1])
    acc = a.to(torch.bfloat16).float() @ b
    return (acc * global_scale.float()).to(torch.bfloat16)


def fused_mul(a: torch.Tensor, words: torch.Tensor, scales_t: torch.Tensor,
              global_scale: torch.Tensor, *, sid: SolutionId) -> torch.Tensor:
    """c[m, n] = bf16((a[m, k] @ dequant(words, scales)[k, n]) * gs).

    a        : (m, k) bf16, natural k order, k % 128 == 0
    words    : (kp/8, n) int32, the shared packed layout (ops/layout.py)
    scales_t : (kp/16, n) bf16 processed scales
    global_scale : f32 tensor of one element, on a's device (read by the
               kernel from device memory: no host sync)
    sid      : the (block_m, block_n) tile to launch

    Launches csrc/fp4_gemm.cu for CUDA tensors (counted in
    fused_mul.launches); runs fused_mul_reference for CPU tensors.
    """
    m, k = a.shape
    kw, n = words.shape
    kp = kw * 8
    if a.device.type == "cpu":
        return fused_mul_reference(a, words, scales_t, global_scale, sid=sid)
    if a.device.type != "cuda":
        raise ValueError(f"fused_mul: unsupported device {a.device}")
    for name, t in (("words", words), ("scales_t", scales_t),
                    ("global_scale", global_scale)):
        if t.device != a.device:
            raise ValueError(f"fused_mul: {name} is on {t.device}, a on "
                             f"{a.device}")
    if a.dtype != torch.bfloat16 or words.dtype != torch.int32 \
            or scales_t.dtype != torch.bfloat16 \
            or global_scale.dtype != torch.float32:
        raise ValueError("fused_mul: a bf16, words int32, scales bf16, "
                         "global_scale f32 expected")
    if tuple(scales_t.shape) != (kp // 16, n) or kp < k or k % 128 \
            or kp % 256 or n % 16 or global_scale.numel() != 1:
        raise ValueError(f"fused_mul: bad shapes a {tuple(a.shape)}, words "
                         f"{tuple(words.shape)}, scales "
                         f"{tuple(scales_t.shape)}")
    a = a.contiguous()
    if a.data_ptr() % 16:
        a = a.clone()     # the kernel loads A in 16-byte words
    words = words.contiguous()
    scales_t = scales_t.contiguous()
    out = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    if m == 0 or n == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = lib.pk_fp4_gemm(a.data_ptr(), words.data_ptr(),
                           scales_t.data_ptr(), global_scale.data_ptr(),
                           out.data_ptr(), m, n, k, kp, sid.block_m,
                           sid.block_n, stream)
    _build.check("pk_fp4_gemm", code)
    fused_mul.launches += 1
    return out


fused_mul.launches = 0
