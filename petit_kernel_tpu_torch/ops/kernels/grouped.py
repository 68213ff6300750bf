"""Grouped (per-expert) fused FP4 GEMM: the CUDA kernel's wrapper and its
plain twin.

Counterpart of petit_kernel_tpu/ops/kernels/grouped.py:grouped_mul, the
MoE expert GEMM: every expert's capacity bucket (cap, k) against its own
stacked FP4 weights, in one launch. The kernel is
csrc/grouped_fp4_gemm.cu, fused_mul's tile bodies with the expert as
blockIdx.z: for decode buckets (block_m = 16) the split-k stream tiles of
csrc/fp4_stream.cuh, which also skip the tiles of empty bucket rows when
given `rows`; for cap > 32 the wgmma 64-row tiles of csrc/fp4_wgmma.cuh.
grouped_mul_reference is the same function in plain PyTorch, one
fused_mul_reference per expert. grouped_mul takes the plain version only
for tensors on the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

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


def grouped_splits(experts: int, cap: int, n: int, kp: int, block_m: int,
                   block_n: int, num_sms: int) -> int:
    """grouped_mul's default k-splits: fused_mul's rule (fused.stream_splits)
    over the output tiles of every expert, m = experts * ceil(cap /
    block_m) * block_m, whether or not `rows` skips them (the host cannot
    know which without a sync); 1 at block_m = 64."""
    return fused.stream_splits(experts * -(-cap // block_m) * block_m, n, 0,
                               kp, block_m, block_n, num_sms)[0]


def grouped_mul(xs: torch.Tensor, words: torch.Tensor,
                scales_t: torch.Tensor, gs: torch.Tensor, *,
                sid: Optional[SolutionId] = None, solution_id: int = -1,
                element_b: Optional[ElementB] = None,
                splits: Optional[int] = None,
                rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[e] = bf16((xs[e] @ dequant(words[e], scales_t[e])) * gs[e]).

    xs       : (E, cap, k) bf16, natural k order, k % 128 == 0; rows are
               the experts' capacity buckets (zero rows for empty slots)
    words    : (E, kp/8, n) int32, each expert a single-matrix repack
    scales_t : (E, kp/16, n) bf16 processed scales
    gs       : (E,) f32 per-expert global scales, on xs's device (read by
               the kernel from device memory: no host sync)
    sid      : the (block_m, block_n) tile; without it, solution_id and
               element_b resolve one (ops/gemm.py resolve_grouped_solution)
    splits   : k-splits of each 16-row output tile, an int in [1, kp /
               256]; the 64-row tiles take 1. Default grouped_splits,
               fused_mul's rule over every expert's tiles. Checked but
               unused on the CPU. Each expert's output equals
               fused_mul(xs[e], ..., splits=splits) at the same tile bit
               for bit.
    rows     : optional (E,) int32 on xs's device, the filled rows of each
               bucket: xs[e, rows[e]:] must be zero. The 16-row tiles at or
               past rows[e] then stream nothing and write the bits their
               zero rows give; the result is unchanged. Read only by the
               kernel (no host sync); checked but unused on the CPU.

    Returns (E, cap, n) bf16. Launches csrc/grouped_fp4_gemm.cu for CUDA
    tensors (counted in grouped_mul.launches); runs grouped_mul_reference
    for CPU tensors. Nothing syncs with the host, so a CUDA graph can
    capture it.
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
    if splits is not None:
        fused._check_splits("grouped_mul", splits, kp,
                            sid.block_m == fused.STREAM_BLOCK_M)
    if rows is not None and (
            not isinstance(rows, torch.Tensor) or rows.dtype != torch.int32
            or tuple(rows.shape) != (E,) or rows.device != xs.device):
        got = (f"{rows.dtype} {tuple(rows.shape)} on {rows.device}"
               if isinstance(rows, torch.Tensor) else type(rows).__name__)
        raise ValueError(f"grouped_mul: rows must be an int32 ({E},) tensor "
                         f"on {xs.device}, got {got}")
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
    # the kernel copies X, the words and the scales in 16-byte pieces
    xs = fused._aligned(xs)
    words = words.contiguous()
    scales_t = scales_t.contiguous()
    gs = gs.contiguous()
    if rows is not None:
        rows = rows.contiguous()
    out = torch.empty((E, cap, n), dtype=torch.bfloat16, device=xs.device)
    if E == 0 or cap == 0 or n == 0:
        return out
    if splits is None:
        splits = grouped_splits(E, cap, n, kp, sid.block_m, sid.block_n,
                                fused._num_sms(xs.device.index))
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    ws_ptr = cnt_ptr = None
    if splits > 1:
        tiles = E * -(-cap // sid.block_m) * -(-n // sid.block_n)
        ws = torch.empty(tiles * splits * sid.block_m * sid.block_n,
                         dtype=torch.float32, device=xs.device)
        ws_ptr = ws.data_ptr()
        cnt_ptr = fused._counters(xs.device, stream, tiles).data_ptr()
    fused._launch("pk_grouped_fp4_gemm", xs.data_ptr(), words.data_ptr(),
                  scales_t.data_ptr(), gs.data_ptr(), out.data_ptr(), ws_ptr,
                  cnt_ptr, None if rows is None else rows.data_ptr(), E, cap,
                  n, k, kp, sid.block_m, sid.block_n, splits, stream)
    grouped_mul.launches += 1
    return out


grouped_mul.launches = 0
