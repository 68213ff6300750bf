"""Decode attention, flash prefill and the in-place KV append: the CUDA
kernels' wrappers and their plain twins.

Counterpart of petit_kernel_tpu/ops/kernels/attention.py for the flat
(B, S, Hkv, d) bf16 cache:

  decode_attention_contiguous <- _decode_kernel      (csrc/decode_attention.cu)
  flash_prefill_attention     <- _prefill_kernel     (csrc/prefill_attention.cu)
  kv_append                   <- _kv_append_kernel   (csrc/kv_append.cu)

Each wrapper takes its `*_reference` twin only for tensors on the CPU; for
CUDA tensors it launches its kernel or raises. JAX's immutable cache with
buffer donation becomes an in-place update of the cache tensor here.
"""

from __future__ import annotations

import math

import torch

from .. import _build

_NEG_INF = -1e30


def _on_one_cuda_device(where: str, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"{where}: unsupported device {dev}")
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"{where}: tensors on {dev} and {t.device}")


def _check_cuda_attention(where: str, q, ck, cv, pos) -> None:
    _on_one_cuda_device(where, q, ck, cv, pos)
    if q.dtype != torch.bfloat16 or ck.dtype != torch.bfloat16 \
            or cv.dtype != torch.bfloat16:
        raise ValueError(f"{where}: the kernel takes bf16 q and a bf16 "
                         "cache")
    if pos.dtype != torch.int32:
        raise ValueError(f"{where}: positions must be int32")
    if ck.shape != cv.shape or not (ck.is_contiguous() and cv.is_contiguous()):
        raise ValueError(f"{where}: K and V caches must be contiguous and "
                         "of one shape")
    if ck.shape[-1] not in (64, 128):
        raise ValueError(f"{where}: head_dim {ck.shape[-1]} not in (64, 128)")


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

def decode_attention_reference(q: torch.Tensor, ck: torch.Tensor,
                               cv: torch.Tensor, pos: torch.Tensor, *,
                               nb: int, page_size: int = 128) -> torch.Tensor:
    """Plain one-token GQA attention over the positions p <= pos[b] and
    p < nb * page_size. q (B, H, d); ck/cv (B, S, Hkv, d) -> (B, H, d)
    bf16. Logits are bf16 q.k products summed in f32, times 1/sqrt(d)."""
    B, H, d = q.shape
    S, Hkv = ck.shape[1], ck.shape[2]
    G = H // Hkv
    qf = q.float().reshape(B, Hkv, G, d)
    logits = torch.einsum("bhgd,bshd->bhgs", qf, ck.float()) / math.sqrt(d)
    p_idx = torch.arange(S, device=q.device)
    ok = (p_idx[None, :] <= pos.long()[:, None]) & (p_idx[None, :]
                                                    < nb * page_size)
    logits = torch.where(ok[:, None, None, :], logits, _NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, cv.float())
    return o.reshape(B, H, d).to(torch.bfloat16)


def decode_attention_contiguous(q: torch.Tensor, ck: torch.Tensor,
                                cv: torch.Tensor, pos: torch.Tensor, *,
                                nb: int, page_size: int = 128
                                ) -> torch.Tensor:
    """One-token attention per sequence over a contiguous flat cache.

    q      : (B, H, d) bf16 post-RoPE queries
    ck, cv : (B, S, Hkv, d) bf16 cache
    pos    : (B,) int32 absolute position of each query
    nb, page_size : attend only p < nb * page_size (callers pass the
             batch's bucketed window, so traffic tracks the context)
    returns (B, H, d) bf16.

    Launches csrc/decode_attention.cu for CUDA tensors (counted in
    decode_attention_contiguous.launches)."""
    B, H, d = q.shape
    if ck.dim() != 4 or ck.shape[0] != B or ck.shape[3] != d \
            or H % ck.shape[2] or tuple(pos.shape) != (B,):
        raise ValueError(f"decode attention: q {tuple(q.shape)}, cache "
                         f"{tuple(ck.shape)}, pos {tuple(pos.shape)}")
    if q.device.type == "cpu":
        return decode_attention_reference(q, ck, cv, pos, nb=nb,
                                          page_size=page_size)
    _check_cuda_attention("decode attention", q, ck, cv, pos)
    S, Hkv = ck.shape[1], ck.shape[2]
    if H // Hkv > 8:
        raise ValueError(f"decode attention: {H // Hkv} query heads per kv "
                         "head, the kernel takes at most 8")
    q, pos = q.contiguous(), pos.contiguous()
    out = torch.empty_like(q)
    lib = _build.library()
    code = lib.pk_decode_attention(
        q.data_ptr(), ck.data_ptr(), cv.data_ptr(), pos.data_ptr(),
        out.data_ptr(), B, H, Hkv, S, d, nb * page_size,
        1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("pk_decode_attention", code)
    decode_attention_contiguous.launches += 1
    return out


decode_attention_contiguous.launches = 0


# ---------------------------------------------------------------------------
# causal flash prefill
# ---------------------------------------------------------------------------

def flash_prefill_reference(q: torch.Tensor, ck: torch.Tensor,
                            cv: torch.Tensor, pos0: torch.Tensor, *,
                            ns: int, block_s: int = 128) -> torch.Tensor:
    """Plain causal attention of a T-token chunk at pos0[b] + t against the
    cache positions p <= pos0[b] + t, p < ns * block_s. q (B, T, H, d) ->
    (B, T, H, d) bf16."""
    B, T, H, d = q.shape
    S, Hkv = ck.shape[1], ck.shape[2]
    G = H // Hkv
    qf = q.float().reshape(B, T, Hkv, G, d)
    logits = torch.einsum("bthgd,bshd->bhgts", qf, ck.float()) / math.sqrt(d)
    q_pos = pos0.long()[:, None] + torch.arange(T, device=q.device)[None]
    p_idx = torch.arange(S, device=q.device)
    ok = (p_idx[None, None, :] <= q_pos[:, :, None]) \
        & (p_idx < ns * block_s)[None, None, :]                  # (B, T, S)
    logits = torch.where(ok[:, None, None], logits, _NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgts,bshd->bthgd", p, cv.float())
    return o.reshape(B, T, H, d).to(torch.bfloat16)


def flash_prefill_attention(q: torch.Tensor, ck: torch.Tensor,
                            cv: torch.Tensor, pos0: torch.Tensor, *,
                            ns: int, block_s: int = 128) -> torch.Tensor:
    """Causal multi-token attention of a contiguous chunk against the cache.

    q      : (B, T, H, d) bf16 post-RoPE queries; query t of row b sits at
             pos0[b] + t (the chunked-prefill contract)
    ck, cv : (B, S, Hkv, d) bf16 cache, the chunk's K/V already written
    pos0   : (B,) int32 chunk start positions
    ns, block_s : attend only p < ns * block_s
    returns (B, T, H, d) bf16.

    Launches csrc/prefill_attention.cu for CUDA tensors (counted in
    flash_prefill_attention.launches)."""
    B, T, H, d = q.shape
    if ck.dim() != 4 or ck.shape[0] != B or ck.shape[3] != d \
            or H % ck.shape[2] or tuple(pos0.shape) != (B,):
        raise ValueError(f"flash prefill: q {tuple(q.shape)}, cache "
                         f"{tuple(ck.shape)}, pos0 {tuple(pos0.shape)}")
    if q.device.type == "cpu":
        return flash_prefill_reference(q, ck, cv, pos0, ns=ns,
                                       block_s=block_s)
    _check_cuda_attention("flash prefill", q, ck, cv, pos0)
    S, Hkv = ck.shape[1], ck.shape[2]
    q, pos0 = q.contiguous(), pos0.contiguous()
    out = torch.empty_like(q)
    lib = _build.library()
    code = lib.pk_prefill_attention(
        q.data_ptr(), ck.data_ptr(), cv.data_ptr(), pos0.data_ptr(),
        out.data_ptr(), B, T, H, Hkv, S, d, ns * block_s,
        1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("pk_prefill_attention", code)
    flash_prefill_attention.launches += 1
    return out


flash_prefill_attention.launches = 0


# ---------------------------------------------------------------------------
# in-place KV append
# ---------------------------------------------------------------------------

def quantize_kv(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Cast new K/V values to the cache dtype: one rounding from x's own
    dtype. (The JAX package needs an optimization barrier to pin this;
    eager torch rounds exactly where it is told to.)"""
    return x if x.dtype == dtype else x.to(dtype)


def kv_append_reference(ck: torch.Tensor, cv: torch.Tensor,
                        k_new: torch.Tensor, v_new: torch.Tensor,
                        pos: torch.Tensor, mask: torch.Tensor):
    """Plain twin of kv_append: index writes, in place."""
    B = ck.shape[0]
    rows = torch.arange(B, device=ck.device)
    p = pos.long()
    keep = mask.bool()[:, None, None]
    for c, new in ((ck, k_new), (cv, v_new)):
        c[rows, p] = torch.where(keep, quantize_kv(new, c.dtype), c[rows, p])
    return ck, cv


def kv_append(ck: torch.Tensor, cv: torch.Tensor, k_new: torch.Tensor,
              v_new: torch.Tensor, pos: torch.Tensor,
              mask: torch.Tensor | None = None):
    """Write one token's K/V per sequence into the cache, in place.

    ck, cv : (B, S, Hkv, d) flat cache, updated in place
    k_new, v_new : (B, Hkv, d), cast to the cache dtype (quantize_kv)
    pos    : (B,) int32 write position per sequence (< S)
    mask   : optional (B,) bool/int; rows with mask[b] = 0 keep their cache
             content bit for bit (the engine's write_mask contract)
    returns (ck, cv), the same tensors.

    Launches csrc/kv_append.cu for CUDA tensors (counted in
    kv_append.launches)."""
    B, S, Hkv, d = ck.shape
    if tuple(k_new.shape) != (B, Hkv, d) or k_new.shape != v_new.shape \
            or ck.shape != cv.shape or tuple(pos.shape) != (B,):
        raise ValueError(f"kv_append: cache {tuple(ck.shape)}, new "
                         f"{tuple(k_new.shape)}, pos {tuple(pos.shape)}")
    if mask is None:
        mask = torch.ones((B,), dtype=torch.int32, device=ck.device)
    if ck.device.type == "cpu":
        return kv_append_reference(ck, cv, k_new, v_new, pos, mask)
    _on_one_cuda_device("kv_append", ck, cv, k_new, v_new, pos, mask)
    if pos.dtype != torch.int32 or ck.dtype != cv.dtype \
            or not (ck.is_contiguous() and cv.is_contiguous()):
        raise ValueError("kv_append: int32 positions and contiguous caches "
                         "of one dtype expected")
    row_bytes = Hkv * d * ck.element_size()
    if row_bytes % 16 or ck.data_ptr() % 16 or cv.data_ptr() % 16:
        raise ValueError("kv_append: cache rows must be 16-byte aligned")
    # the kernel copies 16-byte words: a view at an odd offset is cloned
    kn, vn = (quantize_kv(x, ck.dtype).contiguous() for x in (k_new, v_new))
    kn, vn = (x.clone() if x.data_ptr() % 16 else x for x in (kn, vn))
    m = mask.to(torch.int32).contiguous()
    pos = pos.contiguous()
    lib = _build.library()
    code = lib.pk_kv_append(ck.data_ptr(), cv.data_ptr(), kn.data_ptr(),
                            vn.data_ptr(), pos.data_ptr(), m.data_ptr(), B, S,
                            row_bytes,
                            torch.cuda.current_stream(ck.device).cuda_stream)
    _build.check("pk_kv_append", code)
    kv_append.launches += 1
    return ck, cv


kv_append.launches = 0
