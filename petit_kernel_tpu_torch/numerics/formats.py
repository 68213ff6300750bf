"""Low-precision floating-point codecs on torch tensors (any device).

Counterpart of petit_kernel_tpu/numerics/formats.py: the same bit-level
contract for FP4 (E2M1) weights and the two block-scale formats, NVFP4's
FP8-E4M3 and MXFP4's E8M0. Every function takes and returns torch tensors
and runs on the device its input lies on, so a full-width checkpoint can be
quantized on the card.

E4M3 goes through torch's float8_e4m3fn cast (round to nearest even). On the
range the quantizers feed it, [2^-9, 448], it gives the same bytes as the
ml_dtypes cast the JAX package uses; tests/test_torch_numerics.py pins that.
"""

from __future__ import annotations

import torch

# Nibble n = [s e1 e0 m]; value = (-1)^s * (e==0 ? m/2 : 2^(e-1) * (1 + m/2)).
FP4_VALUES = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0,
              -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0)

NVFP4_GROUP_SIZE = 16
MXFP4_GROUP_SIZE = 32

# Midpoints between consecutive E2M1 magnitudes [0, .5, 1, 1.5, 2, 3, 4, 6].
_MIDS = (0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0)


def fp4_table(device=None) -> torch.Tensor:
    """The 16-entry E2M1 value table as float32 on `device`."""
    return torch.tensor(FP4_VALUES, dtype=torch.float32, device=device)


def fp4_decode(nibbles: torch.Tensor) -> torch.Tensor:
    """Decode E2M1 nibble codes (values 0..15) to float32."""
    return fp4_table(nibbles.device)[nibbles.long() & 0xF]


def fp4_encode(values: torch.Tensor, zero_free: bool = False) -> torch.Tensor:
    """Encode floats to the nearest E2M1 nibble, round to nearest even.

    Out-of-range magnitudes saturate to +-6. zero_free rounds to the
    nearest NONZERO magnitude (the nvfp4p2z / mxfp4z value rounding).
    Negative zero is never emitted. Returns uint8 codes.
    """
    v = values.float()
    sign = torch.signbit(v).to(torch.uint8)
    mag = v.abs()
    mids = torch.tensor(_MIDS, dtype=torch.float32, device=v.device)
    idx = torch.searchsorted(mids, mag.contiguous(), right=False)
    if zero_free:
        idx = idx.clamp_min(1)
    # searchsorted keeps an exact midpoint at the lower index i; RNE wants
    # the even code, so a tie moves up when the upper index is even
    for i, m in enumerate(_MIDS):
        if (i + 1) % 2 == 0:
            idx = torch.where(mag == m, i + 1, idx)
    code = idx.to(torch.uint8) | (sign << 3)
    return torch.where(code == 8, 0, code).to(torch.uint8)


def pack_fp4_pairs(nibbles: torch.Tensor) -> torch.Tensor:
    """Pack nibble codes along the last axis, low nibble first: byte i holds
    elements (2i | 2i+1 << 4)."""
    n = nibbles.to(torch.uint8)
    if n.shape[-1] % 2:
        raise ValueError("pack_fp4_pairs needs an even last axis")
    return n[..., 0::2] | (n[..., 1::2] << 4)


def unpack_fp4_pairs(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_fp4_pairs: byte -> (lo, hi) nibble codes interleaved."""
    p = packed.to(torch.uint8)
    return torch.stack([p & 0xF, p >> 4], dim=-1).reshape(
        *p.shape[:-1], p.shape[-1] * 2)


def e4m3_decode(raw: torch.Tensor) -> torch.Tensor:
    """Decode raw E4M3 bytes to float32 (exact)."""
    return raw.to(torch.uint8).view(torch.float8_e4m3fn).float()


def e4m3_encode(values: torch.Tensor) -> torch.Tensor:
    """Encode floats to raw E4M3 bytes (round to nearest even)."""
    return values.float().to(torch.float8_e4m3fn).view(torch.uint8)


def e8m0_decode(raw: torch.Tensor) -> torch.Tensor:
    """Decode raw E8M0 bytes to float32: 2^(u8 - 127); 255 -> NaN."""
    r = raw.to(torch.uint8)
    out = (r.to(torch.int32) << 23).view(torch.float32)
    # u8 == 0 encodes 2^-127 (the bit pattern 0 << 23 is +0.0)
    out = torch.where(r == 0, 2.0 ** -127, out)
    return torch.where(r == 255, float("nan"), out)


def e8m0_encode(values: torch.Tensor) -> torch.Tensor:
    """Encode positive floats to the nearest-below power-of-two E8M0 byte."""
    v = values.float()
    if bool((v <= 0).any()):
        raise ValueError("E8M0 encodes positive powers of two only")
    e = torch.floor(torch.log2(v)).to(torch.int32)
    return (e + 127).clamp(0, 254).to(torch.uint8)
