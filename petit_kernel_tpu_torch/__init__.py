"""petit_kernel_tpu_torch — the FP4 (NVFP4/MXFP4) weight-only GEMM framework
in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The PyTorch port of petit_kernel_tpu, whose module tree and names it
mirrors; the JAX package stays the reference it is tested against. Both
share the packed-weight contract (ops/layout.py), so the same bytes run
through either. Public surface, the reference library's 7-function API:

    repack_nvfp4 / repack_mxfp4        checkpoint weights -> packed words
    process_nvfp4_scales / process_mxfp4_scales
    mul_nvfp4_a16 / mul_mxfp4_a16      fused dequant+GEMM (CUDA kernel)
    get_fp4_solutions                  kernel-config enumeration
    DataType, PetitSolutionHints       enums / hints

plus the pow2 and zero-free entries, the W4A8 entries mul_nvfp4_a8 /
mul_mxfp4_a8 (int8 activations over the same weights, int8 tensor-core
kernel), the whole solution space of the reference: weight-cache ids for
every mul_* entry and high-precision ids (f32 activations, an f32-accurate
product, through `PetitSolutionHints(require_high_precision=True)` or an
explicit id), `ops.autotune` (the offline tuner and the per-card tables in
`tuned/`, which solution -1 consults once loaded), the console entries
`petit-tpu-torch-tune` / `petit-tpu-torch-bench` (`_cli.py`) and the GEMM
bench `python -m petit_kernel_tpu_torch.bench`, the
differentiable ops.gemm.mul_fp4_diff (a torch.autograd.Function whose
backward runs the dequant kernel; llama.forward over quantized params is
differentiable through it), and `models` (Llama with flat bf16 or headed
fp8 KV caches, paged KV, serving Engine and PagedEngine, W4A8 prefill
through `prefill_fmt="w4a8"`, hybrid FP4 + BF16 serving, where the most
salient quarter of each projection's columns stays dense, through
`Engine(llama.quantize_params(params, "hybrid"), cfg, fmt="hybrid")`, and
Mixtral-8x7B MoE, whose experts run one grouped FP4 GEMM launch per
projection: `Engine(params, cfg, forward_fn=moe.make_engine_forward(cfg))`).
Every function returns torch tensors on the device of its input; the
entry points that build state (init_params, init_cache, the converters)
build on the CUDA card unless asked for the CPU. CUDA
kernels build on first use (ops/_build.py); on CPU tensors each kernel's
plain PyTorch twin runs instead. This package never imports JAX.
"""

from __future__ import annotations

import enum

import torch

from .numerics import formats as _formats
from .ops import layout as _layout
from .ops.gemm import (get_fp4_solutions, mul_mxfp4_a8, mul_mxfp4_a16,
                       mul_mxfp4z_a16, mul_nvfp4_a8, mul_nvfp4_a16,
                       mul_nvfp4p2_a16, mul_nvfp4p2z_a16)
from .ops.solution import (ElementB, MatmulType, SolutionId, default_hints)
from .ops.solution import SolutionHints as PetitSolutionHints


class DataType(enum.Enum):
    """Parity with petit_kernel.DataType."""
    int4 = 0
    float8_e4m3fn = 1
    float4_e2m1 = 2
    float16 = 3
    bfloat16 = 4
    float8_e5m2fn = 5
    mxfloat4_e2m1 = 6


def repack_nvfp4(qweights, size_n: int, size_k: int) -> torch.Tensor:
    """Checkpoint NVFP4 weights (uint8 (n, k/2) or int32 (n, k/8)) -> packed
    int32 words (k_padded/8, n), on the input's device."""
    return _layout.repack_fp4_weights(torch.as_tensor(qweights), size_n,
                                      size_k)


def repack_mxfp4(qweights, size_n: int, size_k: int) -> torch.Tensor:
    """Same shuffle as repack_nvfp4, with k zero-padded to 1024."""
    return _layout.repack_fp4_weights(torch.as_tensor(qweights), size_n,
                                      size_k, pad_to=_layout.K_PAD_MX)


def process_nvfp4_scales(scales, size_n: int, size_k: int) -> torch.Tensor:
    """E4M3 scale bytes (n, k/16) -> bf16 (k_padded/16, n), decoded exactly;
    validates the positive-scale invariant."""
    return _layout.process_fp4_scales(torch.as_tensor(scales), size_n, size_k,
                                      group_size=_formats.NVFP4_GROUP_SIZE)


def process_mxfp4_scales(scales, size_n: int, size_k: int) -> torch.Tensor:
    """E8M0 scale bytes (n, k/32) -> bf16 (k_padded/16, n), each row
    duplicated to stride 16 (byte 0, 2^-127, becomes exact 0)."""
    return _layout.process_fp4_scales(torch.as_tensor(scales), size_n, size_k,
                                      group_size=_formats.MXFP4_GROUP_SIZE)


__all__ = [
    "repack_nvfp4",
    "repack_mxfp4",
    "process_nvfp4_scales",
    "process_mxfp4_scales",
    "mul_nvfp4_a16",
    "mul_mxfp4_a16",
    "mul_nvfp4p2_a16",
    "mul_nvfp4p2z_a16",
    "mul_mxfp4z_a16",
    "mul_nvfp4_a8",
    "mul_mxfp4_a8",
    "get_fp4_solutions",
    "DataType",
    "PetitSolutionHints",
    "SolutionId",
    "ElementB",
    "MatmulType",
    "default_hints",
]
