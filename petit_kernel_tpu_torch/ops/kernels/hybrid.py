"""Hybrid FP4 + BF16 GEMM: the CUDA kernel's wrapper and its plain twin.

Counterpart of petit_kernel_tpu/ops/kernels/hybrid.py:hybrid_mul. A weight
matrix is split by columns (ops/hybrid.py): FP4 columns in the packed
layout and the most salient columns kept dense in bf16. One launch of
csrc/hybrid_gemm.cu computes both products. Its decode tiles (block_m =
16) cut each output tile's k range over several CTAs (fused.stream_splits,
the rule fused_mul's 16-row tiles follow too, here as hybrid_splits) that
stream the weights through a cp.async ring (csrc/fp4_stream.cuh) and sum
their partials in a fixed order; its prefill tiles (block_m = 64) run one
CTA per tile: FP4 tiles with the wgmma body of csrc/fp4_wgmma.cuh (the
one fused_mul's 64-row tiles run), dense tiles with the bf16 wgmma body of
csrc/dense_wgmma.cuh, which reads wd's rows as they are stored (MN-major,
through the transpose bit of B). The dense columns are held in natural k order, (kp, nd): the JAX package
stores them pi-permuted to its kernel's A order, which the port's kernels
do not use (models/convert.py undoes the permutation).

hybrid_mul_reference is the same function in plain PyTorch; hybrid_mul
takes it only for tensors on the CPU, and for CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from .. import solution as solution_mod
from ..solution import SolutionId
from . import fused

# the split rule and its step, shared with fused_mul's 16-row tiles
KSTEP = fused.KSTEP
hybrid_splits = fused.stream_splits


# the GEMM heuristic, pure in (m, n, k): cached, as it runs for every
# projection of every decode step
_default_sid = functools.lru_cache(maxsize=4096)(
    solution_mod.choose_default_solution)


def hybrid_mul_reference(a: torch.Tensor, words: torch.Tensor,
                         scales_t: torch.Tensor, global_scale: torch.Tensor,
                         wd: torch.Tensor, *, sid: SolutionId):
    """Plain PyTorch hybrid_mul: outf = fused_mul_reference, outd =
    bf16(f32(a) @ f32(wd[:k]))."""
    outf = fused.fused_mul_reference(a, words, scales_t, global_scale,
                                     sid=sid)
    k = a.shape[1]
    outd = (a.to(torch.bfloat16).float() @ wd[:k].float()).to(torch.bfloat16)
    return outf, outd


def hybrid_mul(a: torch.Tensor, words: torch.Tensor, scales_t: torch.Tensor,
               global_scale: torch.Tensor, wd: torch.Tensor, *,
               sid: Optional[SolutionId] = None,
               splits: Optional[int] = None):
    """(outf (m, nf), outd (m, nd)) bf16: the FP4 columns'
    bf16((a @ dequant(words, scales)) * gs) and the dense columns'
    bf16(a @ wd), from one launch.

    a        : (m, k) bf16, natural k order, k % 128 == 0
    words    : (kp/8, nf) int32 and scales_t (kp/16, nf) bf16, the packed
               FP4 columns (ops/layout.py)
    global_scale : f32 tensor of one element, on a's device
    wd       : (kp, nd) bf16 dense columns, natural k order, rows past k
               zero; nd % 16 == 0
    sid      : the (block_m, block_n) tile of both halves; default the GEMM
               heuristic at (m, nf, k)
    splits   : k-splits of every output tile, in [1, kp / 256]; only
               block_m = 16 tiles split. Default stream_splits' pair on
               the card (unused on the CPU). With one split (and always at
               block_m = 64) outf equals fused_mul's at the same tile bit
               for bit; with more, the f32 partials are summed in split
               order, so a launch repeats its bits.

    Launches csrc/hybrid_gemm.cu for CUDA tensors (counted in
    hybrid_mul.launches); runs hybrid_mul_reference for CPU tensors."""
    m, k = a.shape
    kp, nf = words.shape[0] * 8, words.shape[1]
    nd = wd.shape[1]
    if sid is None:
        sid = _default_sid(m, nf, k)
    if wd.dim() != 2 or wd.shape[0] != kp or nd % 16:
        raise ValueError(f"hybrid_mul: wd must be (kp, nd) = ({kp}, nd) with "
                         f"nd % 16 == 0, got {tuple(wd.shape)}")
    if splits is not None:
        s = fused._check_splits("hybrid_mul", splits, kp,
                                sid.block_m == fused.STREAM_BLOCK_M)
        splits = s, s
    if a.device.type == "cpu":
        return hybrid_mul_reference(a, words, scales_t, global_scale, wd,
                                    sid=sid)
    if a.device.type != "cuda":
        raise ValueError(f"hybrid_mul: unsupported device {a.device}")
    if a.dtype != torch.bfloat16:
        raise ValueError(f"hybrid_mul: a must be bf16, got {a.dtype}")
    fused._check("pk_hybrid_gemm", a, words, scales_t, global_scale,
                 ("wd", wd, torch.bfloat16, (kp, nd)))
    # the kernel copies every operand in 16-byte pieces
    a, wd = fused._aligned(a), fused._aligned(wd)
    words, scales_t = fused._aligned(words), fused._aligned(scales_t)
    outf = torch.empty((m, nf), dtype=torch.bfloat16, device=a.device)
    outd = torch.empty((m, nd), dtype=torch.bfloat16, device=a.device)
    if m == 0 or nf + nd == 0:
        return outf, outd
    bm, bn = sid.block_m, sid.block_n
    if splits is None:
        splits = fused.stream_splits(m, nf, nd, kp, bm, bn,
                                     fused._num_sms(a.device.index))
    sf, sd = splits
    stream = torch.cuda.current_stream(a.device).cuda_stream
    ws_ptr = cnt_ptr = None
    if sf > 1 or sd > 1:
        m_tiles = -(-m // bm)
        f_tiles, d_tiles = -(-nf // bn), -(-nd // bn)
        ws = torch.empty(m_tiles * (f_tiles * sf + d_tiles * sd) * bm * bn,
                         dtype=torch.float32, device=a.device)
        ws_ptr = ws.data_ptr()
        cnt_ptr = fused._counters(a.device, stream,
                                  m_tiles * (f_tiles + d_tiles)).data_ptr()
    fused._launch("pk_hybrid_gemm", a.data_ptr(), words.data_ptr(),
                  scales_t.data_ptr(), global_scale.data_ptr(), wd.data_ptr(),
                  outf.data_ptr(), outd.data_ptr(), ws_ptr, cnt_ptr, m, nf,
                  nd, k, kp, bm, bn, sf, sd, stream)
    hybrid_mul.launches += 1
    return outf, outd


hybrid_mul.launches = 0
