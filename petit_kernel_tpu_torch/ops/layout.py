"""Offline weight and scale repack into the shared packed layout (torch).

Counterpart of petit_kernel_tpu/ops/layout.py, which documents the layout in
full. Both packages produce and consume the same bytes:

  Packed weights W: (K/8, N) 32-bit words, held here as torch.int32 with the
    same bits (torch's uint32 has almost no CPU ops). Slot s (bits 4s..4s+3)
    of word W[r, c], with j = s & 3 and h = s >> 2, holds the q-coded nibble
    of column c at natural

        k = j*(K/4) + (r // 64)*128 + pi(2*(r % 64) + h),
        pi(i) = (i % 8)*16 + i // 8,

    with the v6 bit placement inside each 16-bit half (sign and 3-bit
    magnitude t pre-positioned per quarter j). The q-code swaps E2M1
    magnitude codes 0 and 1, so t = 1 is the stored zero.

  Scales S: bfloat16 (K/16, N), one row per 16 natural k for both formats
    (MXFP4's 32-wide groups are duplicated); padded rows hold 2^-126.

K is zero-padded to 512 (NVFP4) or 1024 (MXFP4). Everything here is torch
on the input's device, so a full-width layer repacks on the card in well
under a second. `>>` on int32 is an arithmetic shift, so the code works in
int64 and masks after every shift.
"""

from __future__ import annotations

import torch

from ..numerics import formats

K_ALIGN = 128
N_ALIGN = 16
K_PAD = 512
K_PAD_MX = 1024
SCALE_STRIDE = 16

# q-code magnitude remap (self-inverse: swaps E2M1 codes 0 and 1)
Q_OF_M = (1, 0, 2, 3, 4, 5, 6, 7)
# v6 bit placement per quarter j: magnitude shift (j < 3) and sign position
V6_SHIFT = (0, 3, 6)
V6_SGN_POS = (15, 12, 9, 14)


def pad_multiple(group_size: int) -> int:
    return K_PAD if group_size == formats.NVFP4_GROUP_SIZE else K_PAD_MX


def padded_k(size_k: int, multiple: int = K_PAD) -> int:
    return -(-size_k // multiple) * multiple


def _q_remap(nib: torch.Tensor) -> torch.Tensor:
    """E2M1 codes <-> stored q-codes (self-inverse; sign bit untouched)."""
    q = torch.tensor(Q_OF_M, dtype=torch.uint8, device=nib.device)
    return (nib & 8) | q[(nib & 7).long()]


def _v6_place(nib: torch.Tensor, j: int) -> torch.Tensor:
    """q-coded nibble (sign<<3 | t) -> its v6 in-half bit pattern (int64)."""
    t = (nib & 7).long()
    sg = ((nib >> 3) & 1).long()
    if j < 3:
        return (t << (6 - V6_SHIFT[j])) | (sg << V6_SGN_POS[j])
    return ((t & 3) << 10) | ((t >> 2) << 13) | (sg << 14)


def _v6_extract(half: torch.Tensor, j: int) -> torch.Tensor:
    """Inverse of _v6_place on a 16-bit half (int64) -> q-coded nibble."""
    if j < 3:
        t = (half >> (6 - V6_SHIFT[j])) & 7
        sg = (half >> V6_SGN_POS[j]) & 1
    else:
        t = ((half >> 10) & 3) | (((half >> 13) & 1) << 2)
        sg = (half >> 14) & 1
    return ((sg << 3) | t).to(torch.uint8)


def _slot_k(r: torch.Tensor, j: int, h: int, k: int) -> torch.Tensor:
    """Natural k held by slot (j + 4h) of word row r."""
    i = 2 * (r % 64) + h
    return j * (k // 4) + (r // 64) * 128 + (i % 8) * 16 + i // 8


def _validate_nk(size_n: int, size_k: int) -> None:
    if size_k % K_ALIGN != 0:
        raise ValueError(f"k = {size_k} must be a multiple of {K_ALIGN}")
    if size_n % N_ALIGN != 0:
        raise ValueError(f"n = {size_n} must be a multiple of {N_ALIGN}")


def _as_u8_qweights(qweights: torch.Tensor, size_n: int,
                    size_k: int) -> torch.Tensor:
    """uint8 (n, k/2), or an int32 (n, k/8) little-endian view of it."""
    q = qweights
    if q.dtype == torch.int32:
        q = q.contiguous().view(torch.uint8)
    if q.dtype != torch.uint8:
        raise TypeError(f"qweights must be uint8 or int32, got {q.dtype}")
    if tuple(q.shape) != (size_n, size_k // 2):
        raise ValueError(f"qweights shape {tuple(q.shape)} != (n, k/2) = "
                         f"{(size_n, size_k // 2)}")
    return q


def repack_fp4_weights(qweights: torch.Tensor, size_n: int, size_k: int, *,
                       pad_to: int = K_PAD) -> torch.Tensor:
    """Checkpoint qweights (n, k/2) uint8 -> packed words int32 (kp/8, n)."""
    _validate_nk(size_n, size_k)
    q = _as_u8_qweights(qweights, size_n, size_k)
    kp = padded_k(size_k, pad_to)
    nib = formats.unpack_fp4_pairs(q)                    # (n, k) codes
    nib = torch.where(nib == 8, 0, nib).to(torch.uint8)  # no negative zero
    # zero-pad k first, then q-code: padded nibbles are stored zeros (t = 1)
    nib_t = torch.zeros((kp, size_n), dtype=torch.uint8, device=q.device)
    nib_t[:size_k] = nib.T
    nib_t = _q_remap(nib_t)
    r = torch.arange(kp // 8, device=q.device)[:, None]
    words = torch.zeros((kp // 8, size_n), dtype=torch.int64, device=q.device)
    for s in range(8):
        j, h = s & 3, s >> 2
        ks = _slot_k(r, j, h, kp).expand(-1, size_n)
        words |= _v6_place(torch.gather(nib_t, 0, ks), j) << (16 * h)
    # reinterpret the unsigned 32-bit pattern as int32
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def unpack_fp4_weights(words: torch.Tensor, size_n: int,
                       size_k: int) -> torch.Tensor:
    """Inverse of repack_fp4_weights -> nibble codes (n, size_k) uint8."""
    kp = words.shape[0] * 8
    if tuple(words.shape) != (kp // 8, size_n) or kp < size_k:
        raise ValueError(f"words shape {tuple(words.shape)} does not hold "
                         f"(n, k) = {(size_n, size_k)}")
    w = words.long() & 0xFFFFFFFF
    nib_t = torch.empty((kp, size_n), dtype=torch.uint8, device=words.device)
    r = torch.arange(kp // 8, device=words.device)
    for s in range(8):
        j, h = s & 3, s >> 2
        nib_t[_slot_k(r, j, h, kp)] = _v6_extract((w >> (16 * h)) & 0xFFFF, j)
    return _q_remap(nib_t[:size_k].T)


def process_fp4_scales(scales: torch.Tensor, size_n: int, size_k: int, *,
                       group_size: int) -> torch.Tensor:
    """Checkpoint scales (n, k/group) raw bytes -> bfloat16 (kp/16, n).

    Validates the positive-scale invariant, decodes E4M3 / E8M0 exactly to
    bf16, duplicates MXFP4 rows to stride 16, and fills padded rows with
    2^-126 (the smallest bf16 normal) as the JAX package does."""
    _validate_nk(size_n, size_k)
    s = scales
    if s.dtype != torch.uint8:
        if s.element_size() != 1:
            raise TypeError(f"scales must be raw bytes, got {s.dtype}")
        s = s.view(torch.uint8)
    if tuple(s.shape) != (size_n, size_k // group_size):
        raise ValueError(
            f"scales shape {tuple(s.shape)} != (n, k/{group_size}) = "
            f"{(size_n, size_k // group_size)}")
    if group_size == formats.NVFP4_GROUP_SIZE:
        if bool((s & 0x80).any()):
            raise ValueError("NVFP4 E4M3 scales must be positive")
        if bool(((s & 0x7F) == 0x7F).any()):
            raise ValueError("NVFP4 E4M3 scales must not be NaN")
        dec = formats.e4m3_decode(s)
    else:
        if bool((s == 0xFF).any()):
            raise ValueError("MXFP4 E8M0 scales must not be NaN (0xFF)")
        if bool((s > 252).any()):
            raise ValueError(
                "MXFP4 E8M0 scale bytes 253/254 (2^126, 2^127) are outside "
                "the range the JAX kernels accept; rescale the checkpoint")
        # byte 0 (2^-127) is below the bf16 normal range: store exact 0
        dec = torch.where(s == 0, 0.0, formats.e8m0_decode(s))
    out = dec.T.to(torch.bfloat16)
    if group_size == formats.MXFP4_GROUP_SIZE:
        out = out.repeat_interleave(2, dim=0)
    kp = padded_k(size_k, pad_multiple(group_size))
    pad = torch.full(((kp - size_k) // SCALE_STRIDE, size_n), 2.0 ** -126,
                     dtype=torch.bfloat16, device=s.device)
    return torch.cat([out, pad], dim=0).contiguous()


def dequant_from_tpu_layout(words: torch.Tensor, scales_t: torch.Tensor,
                            size_n: int, size_k: int) -> torch.Tensor:
    """Dequantize packed words and processed scales -> f32 (size_k, n),
    natural k order, without the global scale. Stored zeros give exact 0."""
    vals = formats.fp4_decode(unpack_fp4_weights(words, size_n, size_k))
    sc = scales_t[:size_k // SCALE_STRIDE].float().T      # (n, size_k/16)
    deq = vals.reshape(size_n, -1, SCALE_STRIDE) * sc[:, :, None]
    return deq.reshape(size_n, size_k).T
