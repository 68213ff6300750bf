"""Quantizers and dequant/GEMM oracles on torch tensors (any device).

Counterpart of petit_kernel_tpu/numerics/reference.py. The quantizers give
byte-identical output to the numpy ones on the same float32 input
(tests/test_torch_numerics.py), and run on the card, so random full-width
models are quantized there in seconds.

Checkpoint layout (the reference library's inputs):
  qweights : uint8 (n, k//2)   two E2M1 nibbles per byte, low nibble = even k
  scales   : uint8 (n, k//16)  raw E4M3 bytes (NVFP4) or (n, k//32) raw E8M0
             bytes (MXFP4)
  global_scale : float32 0-dim tensor, applied as the GEMM epilogue factor.
The global scale stays a tensor on the weight's device: reading it back
would stall the host on every layer.
"""

from __future__ import annotations

import torch

from . import formats


def _groups(w: torch.Tensor, g: int) -> torch.Tensor:
    n, k = w.shape
    if k % g:
        raise ValueError(f"k = {k} must be a multiple of the group size {g}")
    return w.float().reshape(n, k // g, g)


def dequant_nvfp4(qweights: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """NVFP4 (n, k//2) bytes + (n, k//16) E4M3 scales -> f32 (n, k), without
    the global scale."""
    n, kb = qweights.shape
    k = kb * 2
    if tuple(scales.shape) != (n, k // formats.NVFP4_GROUP_SIZE):
        raise ValueError(f"scales shape {tuple(scales.shape)} != {(n, k // 16)}")
    vals = formats.fp4_decode(formats.unpack_fp4_pairs(qweights))
    s = formats.e4m3_decode(scales)
    return (vals.reshape(n, -1, formats.NVFP4_GROUP_SIZE)
            * s[:, :, None]).reshape(n, k)


def dequant_mxfp4(qweights: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """MXFP4 (n, k//2) bytes + (n, k//32) E8M0 scales -> f32 (n, k)."""
    n, kb = qweights.shape
    k = kb * 2
    if tuple(scales.shape) != (n, k // formats.MXFP4_GROUP_SIZE):
        raise ValueError(f"scales shape {tuple(scales.shape)} != {(n, k // 32)}")
    vals = formats.fp4_decode(formats.unpack_fp4_pairs(qweights))
    s = formats.e8m0_decode(scales)
    return (vals.reshape(n, -1, formats.MXFP4_GROUP_SIZE)
            * s[:, :, None]).reshape(n, k)


def gemm_reference(a: torch.Tensor, qweights: torch.Tensor,
                   scales: torch.Tensor, global_scale, *,
                   fmt: str = "nvfp4") -> torch.Tensor:
    """Oracle for mul_*_a16: (a_f32 @ deq(B).T * gs) cast to a.dtype."""
    deq = dequant_nvfp4 if fmt == "nvfp4" else dequant_mxfp4
    b = deq(qweights, scales) * torch.as_tensor(
        global_scale, dtype=torch.float32, device=qweights.device)
    return (a.float() @ b.T).to(a.dtype)


def quantize_nvfp4(w: torch.Tensor, global_scale=None):
    """Dense (n, k) -> (qweights u8 (n, k/2), scales u8 (n, k/16), gs f32).

    Per-16 group amax maps the group into [-6, 6] through an E4M3 scale; the
    f32 global scale amax(w) / (6 * 448) folds the E4M3 range (ModelOpt's
    recipe). Scales round UP to the next E4M3 value so no FP4 saturates."""
    n, k = w.shape
    wg = _groups(w, formats.NVFP4_GROUP_SIZE)
    if global_scale is None:
        amax = wg.abs().amax()
        global_scale = torch.where(amax > 0, amax / (6.0 * 448.0), 1.0)
    gs = torch.as_tensor(global_scale, dtype=torch.float32, device=w.device)
    scale_f = wg.abs().amax(dim=-1) / 6.0 / gs
    scales = formats.e4m3_encode(scale_f.clamp_min(2.0 ** -9))
    s_dec = formats.e4m3_decode(scales)
    # E4M3 is monotonic in its byte for positives: +1 is the next magnitude
    bump = (s_dec < scale_f) & (scales < 0x7E)
    scales = torch.where(bump, scales + 1, scales).to(torch.uint8)
    denom = formats.e4m3_decode(scales) * gs
    denom = torch.where(denom == 0, 1.0, denom)
    q = formats.fp4_encode(wg / denom[:, :, None])
    return formats.pack_fp4_pairs(q.reshape(n, k)), scales, gs


def quantize_nvfp4_pow2(w: torch.Tensor, global_scale=None,
                        zero_free: bool = False):
    """NVFP4 with power-of-two E4M3 scales ("nvfp4p2"), same container as
    quantize_nvfp4. The global scale anchors the largest group at 2^8, so the
    E4M3 pow2 range 2^-9 .. 2^8 is available downward."""
    n, k = w.shape
    wg = _groups(w, formats.NVFP4_GROUP_SIZE)
    gmax = wg.abs().amax(dim=-1)
    if global_scale is None:
        amax = wg.abs().amax()
        e_max = torch.ceil(torch.log2(amax / 6.0)) - 8
        global_scale = torch.where(
            amax > 0, torch.ldexp(torch.ones_like(amax), e_max), 1.0)
    gs = torch.as_tensor(global_scale, dtype=torch.float32, device=w.device)
    # smallest 2^e with gmax <= 6 * 2^e * gs, clipped to the E4M3 pow2 range
    safe = torch.where(gmax > 0, gmax, 1.0)
    e = torch.ceil(torch.log2(safe / (6.0 * gs))).to(torch.int32).clamp(-9, 8)
    # E4M3 byte of 2^e: subnormals 2^-9..2^-7 are mantissa {1, 2, 4} at
    # exponent field 0; normals 2^-6..2^8 are exponent field e + 7
    sub = 1 << (e + 9).clamp(0, 2)
    scales = torch.where(e < -6, sub, (e + 7) << 3).to(torch.uint8)
    denom = formats.e4m3_decode(scales) * gs
    denom = torch.where(denom == 0, 1.0, denom)
    q = formats.fp4_encode(wg / denom[:, :, None], zero_free=zero_free)
    return formats.pack_fp4_pairs(q.reshape(n, k)), scales, gs


def quantize_nvfp4_pow2z(w: torch.Tensor, global_scale=None):
    """"nvfp4p2z": nvfp4p2 with zero-free value rounding (no stored zero)."""
    return quantize_nvfp4_pow2(w, global_scale, zero_free=True)


def quantize_mxfp4(w: torch.Tensor, zero_free: bool = False):
    """Dense (n, k) -> (qweights u8 (n, k/2), scales u8 (n, k/32), gs = 1).
    Scale = the power of two that maps the group amax into [-6, 6];
    zero_free=True is the "mxfp4z" value rounding."""
    n, k = w.shape
    wg = _groups(w, formats.MXFP4_GROUP_SIZE)
    gmax = wg.abs().amax(dim=-1)
    gmax = torch.where(gmax == 0, 1.0, gmax)
    e = torch.ceil(torch.log2(gmax / 6.0)).to(torch.int32)
    scales = (e + 127).clamp(1, 254).to(torch.uint8)
    s_dec = formats.e8m0_decode(scales)
    q = formats.fp4_encode(wg / s_dec[:, :, None], zero_free=zero_free)
    gs = torch.ones((), dtype=torch.float32, device=w.device)
    return formats.pack_fp4_pairs(q.reshape(n, k)), scales, gs


def quantize_mxfp4z(w: torch.Tensor):
    """"mxfp4z": MXFP4 with zero-free value rounding."""
    return quantize_mxfp4(w, zero_free=True)
