"""Decode attention, flash prefill and the in-place KV write: the CUDA
kernels' wrappers and their plain twins.

Counterpart of petit_kernel_tpu/ops/kernels/attention.py. The flat
(B, S, Hkv, d) bf16 cache:

  decode_attention_contiguous <- _decode_kernel      (csrc/decode_attention.cu)
  flash_prefill_attention     <- _prefill_kernel     (csrc/prefill_attention.cu)
  kv_append                   <- _kv_append_kernel   (csrc/kv_append.cu)

The headed layouts, bf16 or fp8 e4m3: a paged pool (P + 1, Hkv, ps, d)
walked through a (B, max_pages) block table, or a contiguous (B, Hkv, S, d)
cache:

  paged_decode_attention,
  decode_attention_contiguous_headed  <- _decode_kernel_headed
                                         (csrc/paged_decode_attention.cu)
  flash_prefill_paged                 <- _prefill_kernel_paged
  flash_prefill_attention(headed=True) <- _prefill_kernel, headed
                                         (csrc/paged_prefill_attention.cu)
  kv_append(headed=True)              <- _kv_append_kernel_headed
                                         (csrc/kv_append.cu)
  kv_append_paged                     <- the XLA scatter of
                                         petit_kernel_tpu/models/paged.py
                                         _write_kv (csrc/kv_append.cu)

The three decode entries launch one split-KV body, csrc/decode_attention.cuh,
split over positions by decode_split_plan. The three KV writes launch one
append body, a (B, T) chunk of K and V a launch with the fp8 rounding in
it. Each wrapper takes its
`*_reference` twin only for tensors on the CPU; for CUDA tensors it
launches its kernel or raises. JAX's immutable cache with
buffer donation becomes an in-place update of the cache tensor here. fp8
K/V converts exactly to f32 in every kernel and twin (the JAX decode
kernel's SWAR upcast flushes fp8 subnormals to zero; the port does not).
"""

from __future__ import annotations

import functools
import math

import torch

from .. import _build
from .fused import _aligned, _counters

_NEG_INF = -1e30
# the decode body's split plan: positions a CTA tile, and the CTAs it aims
# for, four for each of the H100's 132 SMs, where two fit at once
# (csrc/decode_attention.cuh's shared memory and registers): shorter
# splits even out ragged lengths (264 and 1056 measured slower, PERF.md)
DECODE_TILE = 64
DECODE_CTAS = 4 * 132
DECODE_MAX_SPLITS = 512     # DA_MAX_SPLITS: the merge's rows fit shared memory


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

def decode_split_plan(batch: int, hkv: int, window: int,
                      splits: int | None = None) -> tuple[int, int]:
    """(splits, chunk) of a decode launch: CTA s of a (sequence, kv head)
    takes the positions [s * chunk, (s + 1) * chunk) below the window,
    chunk a multiple of DECODE_TILE. A function of (batch, hkv, window)
    alone, never of the positions, so a launch needs no host sync and
    replays in a CUDA graph. By default about DECODE_CTAS CTAs in all, at
    most one split a tile of the window and DECODE_MAX_SPLITS; a given
    `splits` is cut to those. Every position below the window lies in
    exactly one split, and none is empty."""
    tiles = max(1, -(-window // DECODE_TILE))
    if splits is None:
        splits = -(-DECODE_CTAS // max(1, batch * hkv))
    if splits < 1:
        raise ValueError(f"decode attention: splits {splits} < 1")
    per = -(-tiles // min(splits, tiles, DECODE_MAX_SPLITS))   # tiles a split
    return -(-tiles // per), per * DECODE_TILE


def _decode_workspace(q: torch.Tensor, hkv: int, window: int,
                      splits: int | None):
    """The plan, the f32 workspace of its partials (B*H*splits*(d + 2),
    one element when it does not split) and the split counters of q's
    device and stream (zero between launches, shared with fused_mul)."""
    B, H, d = q.shape
    n, chunk = decode_split_plan(B, hkv, window, splits)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws = torch.empty(B * H * n * (d + 2) if n > 1 else 1,
                     dtype=torch.float32, device=q.device)
    return n, chunk, ws, _counters(q.device, stream, B * hkv), stream


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
                                nb: int, page_size: int = 128,
                                splits: int | None = None) -> torch.Tensor:
    """One-token attention per sequence over a contiguous flat cache.

    q      : (B, H, d) bf16 post-RoPE queries
    ck, cv : (B, S, Hkv, d) bf16 cache
    pos    : (B,) int32 absolute position of each query
    nb, page_size : attend only p < nb * page_size (callers pass the
             batch's bucketed window, so traffic tracks the context)
    splits : CTAs a (sequence, kv head), default decode_split_plan's
    returns (B, H, d) bf16.

    Launches csrc/decode_attention.cu for CUDA tensors (counted in
    decode_attention_contiguous.launches)."""
    B, H, d = q.shape
    if ck.dim() != 4 or ck.shape[0] != B or ck.shape[3] != d \
            or H % ck.shape[2] or tuple(pos.shape) != (B,):
        raise ValueError(f"decode attention: q {tuple(q.shape)}, cache "
                         f"{tuple(ck.shape)}, pos {tuple(pos.shape)}")
    if splits is not None:
        decode_split_plan(B, ck.shape[2], nb * page_size, splits)
    if q.device.type == "cpu":
        return decode_attention_reference(q, ck, cv, pos, nb=nb,
                                          page_size=page_size)
    _check_cuda_attention("decode attention", q, ck, cv, pos)
    S, Hkv = ck.shape[1], ck.shape[2]
    if H // Hkv > 8:
        raise ValueError(f"decode attention: {H // Hkv} query heads per kv "
                         "head, the kernel takes at most 8")
    q, ck, cv = _aligned(q), _aligned(ck), _aligned(cv)
    pos = pos.contiguous()
    window = min(nb * page_size, S)
    n, chunk, ws, counters, stream = _decode_workspace(q, Hkv, window, splits)
    out = torch.empty_like(q)
    code = _build.library().pk_decode_attention(
        q.data_ptr(), ck.data_ptr(), cv.data_ptr(), pos.data_ptr(),
        out.data_ptr(), ws.data_ptr(), counters.data_ptr(), B, H, Hkv, S, d,
        window, n, chunk, 1.0 / math.sqrt(d), stream)
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
                            ns: int, block_s: int = 128,
                            headed: bool = False) -> torch.Tensor:
    """Causal multi-token attention of a contiguous chunk against the cache.

    q      : (B, T, H, d) bf16 post-RoPE queries; query t of row b sits at
             pos0[b] + t (the chunked-prefill contract)
    ck, cv : (B, S, Hkv, d) bf16 cache, the chunk's K/V already written;
             with headed=True a (B, Hkv, S, d) bf16 or fp8 cache
             (flash_prefill_headed)
    pos0   : (B,) int32 chunk start positions
    ns, block_s : attend only p < ns * block_s
    returns (B, T, H, d) bf16.

    Launches csrc/prefill_attention.cu for flat CUDA tensors (counted in
    flash_prefill_attention.launches)."""
    if headed:
        return flash_prefill_headed(q, ck, cv, pos0, ns=ns, block_s=block_s)
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
    q, ck, cv = _aligned(q), _aligned(ck), _aligned(cv)
    pos0 = pos0.contiguous()
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
# headed layouts, bf16 or fp8: a paged pool (P + 1, Hkv, ps, d) read through
# a block table, or a contiguous (B, Hkv, S, d) cache
# ---------------------------------------------------------------------------

_KV_DTYPES = (torch.bfloat16, torch.float8_e4m3fn)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The same storage as integers of the element's width: index reads and
    writes move fp8 and bf16 bytes exactly, on any device."""
    return t.view({1: torch.uint8, 2: torch.int16}[t.element_size()])


def _gather_pages(pages: torch.Tensor, block_tables: torch.Tensor,
                  n: int) -> torch.Tensor:
    """The first n pages of each block-table row of a (P, Hkv, ps, d) pool,
    as a flat (B, n * ps, Hkv, d) copy in the pool's dtype."""
    B = block_tables.shape[0]
    _, Hkv, ps, d = pages.shape
    rows = _bits(pages)[block_tables[:, :n].long()]      # (B, n, Hkv, ps, d)
    return rows.permute(0, 1, 3, 2, 4).reshape(B, n * ps, Hkv, d).view(
        pages.dtype)


@functools.cache
def _sequence_table(batch: int, hkv: int, device: torch.device
                    ) -> torch.Tensor:
    """Block table that views a contiguous (B, Hkv, S, d) cache as one page
    of S positions per sequence: entry b * Hkv."""
    return (torch.arange(batch, dtype=torch.int32, device=device)
            * hkv)[:, None].contiguous()


def _launch_headed(where: str, q, k, v, table, pos, *, ps: int,
                   page_stride: int, head_stride: int, window: int,
                   splits: int | None = None) -> torch.Tensor:
    """Run pk_paged_decode_attention (q (B, H, d), split by
    decode_split_plan or `splits`) or pk_paged_prefill_attention (q (B, T,
    H, d)) over a headed layout whose position p of sequence b, kv head h
    lies at element
    table[b, p // ps] * page_stride + h * head_stride + (p % ps) * d."""
    _on_one_cuda_device(where, q, k, v, table, pos)
    if q.dtype != torch.bfloat16 or k.dtype not in _KV_DTYPES \
            or v.dtype != k.dtype:
        raise ValueError(f"{where}: the kernel takes bf16 q and bf16 or fp8 "
                         f"e4m3 K/V, got {q.dtype}, {k.dtype}, {v.dtype}")
    if pos.dtype != torch.int32 or table.dtype != torch.int32:
        raise ValueError(f"{where}: positions and block tables must be int32")
    if k.shape != v.shape or not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{where}: K and V must be contiguous and of one "
                         "shape")
    H, d = q.shape[-2], q.shape[-1]
    hkv = k.shape[1]
    if d not in (64, 128):
        raise ValueError(f"{where}: head_dim {d} not in (64, 128)")
    if H // hkv > 8 and q.dim() == 3:
        raise ValueError(f"{where}: {H // hkv} query heads per kv head, the "
                         "kernel takes at most 8")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    pos, table = pos.contiguous(), table.contiguous()
    out = torch.empty_like(q)
    lib = _build.library()
    kv_fp8 = int(k.dtype == torch.float8_e4m3fn)
    if q.dim() == 3:
        n, chunk, ws, counters, stream = _decode_workspace(q, hkv, window,
                                                           splits)
        code = lib.pk_paged_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(),
            pos.data_ptr(), out.data_ptr(), ws.data_ptr(),
            counters.data_ptr(), q.shape[0], H, hkv, d, table.shape[1], ps,
            page_stride, head_stride, window, kv_fp8, n, chunk,
            1.0 / math.sqrt(d), stream)
        _build.check("pk_paged_decode_attention", code)
        return out
    code = lib.pk_paged_prefill_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(),
        pos.data_ptr(), out.data_ptr(), q.shape[0], q.shape[1], H, hkv, d,
        table.shape[1], ps, page_stride, head_stride, window, kv_fp8,
        1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("pk_paged_prefill_attention", code)
    return out


def _check_pool(where: str, d: int, k_pages, v_pages, block_tables, batch,
                n) -> None:
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape \
            or k_pages.shape[3] != d or block_tables.dim() != 2 \
            or block_tables.shape[0] != batch or block_tables.shape[1] < n:
        raise ValueError(f"{where}: pool {tuple(k_pages.shape)}, block "
                         f"tables {tuple(block_tables.shape)}, {n} pages")


def paged_decode_reference(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           pos: torch.Tensor, *, nb: int,
                           page_size: int) -> torch.Tensor:
    """Plain twin of paged_decode_attention: gather the first nb pages of
    each sequence, then decode_attention_reference (exact fp8 upcast)."""
    k = _gather_pages(k_pages, block_tables, nb)
    v = _gather_pages(v_pages, block_tables, nb)
    return decode_attention_reference(q, k, v, pos, nb=nb,
                                      page_size=page_size)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           pos: torch.Tensor, *, nb: int, page_size: int,
                           headed: bool = True,
                           splits: int | None = None) -> torch.Tensor:
    """One-token attention per sequence over a paged KV pool.

    q            : (B, H, d) bf16 post-RoPE queries
    k_pages      : (P, Hkv, ps, d) bf16 or fp8 e4m3 pool (headed layout;
                   the port keeps no flat pools, so headed=False raises)
    v_pages      : same shape and dtype
    block_tables : (B, >= nb) int32 page ids
    pos          : (B,) int32 absolute position of each query
    nb           : pages to visit; attend only p <= pos[b], p < nb * ps
    splits       : CTAs a (sequence, kv head), default decode_split_plan's
    returns (B, H, d) bf16.

    Launches csrc/paged_decode_attention.cu for CUDA tensors (counted in
    paged_decode_attention.launches)."""
    if not headed:
        raise NotImplementedError("paged pools are headed (P, Hkv, ps, d) "
                                  "in the port")
    B, H, d = q.shape
    _check_pool("paged decode attention", d, k_pages, v_pages, block_tables,
                B, nb)
    P, Hkv, ps, _ = k_pages.shape
    if ps != page_size or H % Hkv or tuple(pos.shape) != (B,):
        raise ValueError(f"paged decode attention: q {tuple(q.shape)}, pool "
                         f"{tuple(k_pages.shape)}, page_size {page_size}, "
                         f"pos {tuple(pos.shape)}")
    if splits is not None:
        decode_split_plan(B, Hkv, nb * ps, splits)
    if q.device.type == "cpu":
        return paged_decode_reference(q, k_pages, v_pages, block_tables, pos,
                                      nb=nb, page_size=ps)
    out = _launch_headed("paged decode attention", q, k_pages, v_pages,
                         block_tables, pos, ps=ps, page_stride=Hkv * ps * d,
                         head_stride=ps * d, window=nb * ps, splits=splits)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def decode_attention_headed_reference(q: torch.Tensor, ck: torch.Tensor,
                                      cv: torch.Tensor, pos: torch.Tensor, *,
                                      nb: int, page_size: int = 256
                                      ) -> torch.Tensor:
    """Plain twin of decode_attention_contiguous_headed."""
    return decode_attention_reference(q, ck.transpose(1, 2),
                                      cv.transpose(1, 2), pos, nb=nb,
                                      page_size=page_size)


def decode_attention_contiguous_headed(q: torch.Tensor, ck: torch.Tensor,
                                       cv: torch.Tensor, pos: torch.Tensor,
                                       *, nb: int, page_size: int = 256,
                                       splits: int | None = None
                                       ) -> torch.Tensor:
    """decode_attention_contiguous over a headed (B, Hkv, S, d) bf16 or fp8
    cache: attend p <= pos[b], p < nb * page_size. page_size only sets the
    window; the kernel reads each sequence as one page of S positions, and
    its splits (`splits`, default decode_split_plan's) need not end on a
    page.

    Launches csrc/paged_decode_attention.cu for CUDA tensors (counted in
    decode_attention_contiguous_headed.launches)."""
    B, H, d = q.shape
    if ck.dim() != 4 or ck.shape[0] != B or ck.shape[3] != d \
            or ck.shape != cv.shape or H % ck.shape[1] \
            or tuple(pos.shape) != (B,):
        raise ValueError(f"headed decode attention: q {tuple(q.shape)}, "
                         f"cache {tuple(ck.shape)}, pos {tuple(pos.shape)}")
    if splits is not None:
        decode_split_plan(B, ck.shape[1], nb * page_size, splits)
    if q.device.type == "cpu":
        return decode_attention_headed_reference(q, ck, cv, pos, nb=nb,
                                                 page_size=page_size)
    _, Hkv, S, _ = ck.shape
    out = _launch_headed("headed decode attention", q, ck, cv,
                         _sequence_table(B, Hkv, ck.device), pos, ps=S,
                         page_stride=S * d, head_stride=S * d,
                         window=min(nb * page_size, S), splits=splits)
    decode_attention_contiguous_headed.launches += 1
    return out


decode_attention_contiguous_headed.launches = 0


def flash_prefill_paged_reference(q: torch.Tensor, k_pages: torch.Tensor,
                                  v_pages: torch.Tensor,
                                  block_tables: torch.Tensor,
                                  pos0: torch.Tensor, *, ns: int
                                  ) -> torch.Tensor:
    """Plain twin of flash_prefill_paged: gather the first ns pages of each
    sequence, then flash_prefill_reference (exact fp8 upcast)."""
    k = _gather_pages(k_pages, block_tables, ns)
    v = _gather_pages(v_pages, block_tables, ns)
    return flash_prefill_reference(q, k, v, pos0, ns=ns,
                                   block_s=k_pages.shape[2])


def flash_prefill_paged(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_tables: torch.Tensor,
                        pos0: torch.Tensor, *, ns: int) -> torch.Tensor:
    """Causal flash prefill over a paged headed pool.

    q            : (B, T, H, d) bf16 post-RoPE; query t of row b sits at
                   pos0[b] + t, its chunk's K/V already written
    k_pages      : (P, Hkv, ps, d) bf16 or fp8 e4m3 pool; v_pages the same
    block_tables : (B, >= ns) int32 page ids
    ns           : pages to visit; attend p <= pos0[b] + t, p < ns * ps
    returns (B, T, H, d) bf16.

    Launches csrc/paged_prefill_attention.cu for CUDA tensors (counted in
    flash_prefill_paged.launches)."""
    B, T, H, d = q.shape
    _check_pool("paged flash prefill", d, k_pages, v_pages, block_tables, B,
                ns)
    P, Hkv, ps, _ = k_pages.shape
    if H % Hkv or tuple(pos0.shape) != (B,):
        raise ValueError(f"paged flash prefill: q {tuple(q.shape)}, pool "
                         f"{tuple(k_pages.shape)}, pos0 {tuple(pos0.shape)}")
    if q.device.type == "cpu":
        return flash_prefill_paged_reference(q, k_pages, v_pages,
                                             block_tables, pos0, ns=ns)
    out = _launch_headed("paged flash prefill", q, k_pages, v_pages,
                         block_tables, pos0, ps=ps, page_stride=Hkv * ps * d,
                         head_stride=ps * d, window=ns * ps)
    flash_prefill_paged.launches += 1
    return out


flash_prefill_paged.launches = 0


def flash_prefill_headed_reference(q: torch.Tensor, ck: torch.Tensor,
                                   cv: torch.Tensor, pos0: torch.Tensor, *,
                                   ns: int, block_s: int = 128
                                   ) -> torch.Tensor:
    """Plain twin of flash_prefill_headed."""
    return flash_prefill_reference(q, ck.transpose(1, 2), cv.transpose(1, 2),
                                   pos0, ns=ns, block_s=block_s)


def flash_prefill_headed(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                         pos0: torch.Tensor, *, ns: int, block_s: int = 128
                         ) -> torch.Tensor:
    """flash_prefill_attention(headed=True): a headed (B, Hkv, S, d) bf16 or
    fp8 cache, attend p <= pos0[b] + t, p < ns * block_s.

    Launches csrc/paged_prefill_attention.cu for CUDA tensors, each
    sequence one page of S positions (counted in
    flash_prefill_headed.launches)."""
    B, T, H, d = q.shape
    if ck.dim() != 4 or ck.shape[0] != B or ck.shape[3] != d \
            or ck.shape != cv.shape or H % ck.shape[1] \
            or tuple(pos0.shape) != (B,):
        raise ValueError(f"headed flash prefill: q {tuple(q.shape)}, cache "
                         f"{tuple(ck.shape)}, pos0 {tuple(pos0.shape)}")
    if q.device.type == "cpu":
        return flash_prefill_headed_reference(q, ck, cv, pos0, ns=ns,
                                              block_s=block_s)
    _, Hkv, S, _ = ck.shape
    out = _launch_headed("headed flash prefill", q, ck, cv,
                         _sequence_table(B, Hkv, ck.device), pos0, ps=S,
                         page_stride=S * d, head_stride=S * d,
                         window=min(ns * block_s, S))
    flash_prefill_headed.launches += 1
    return out


flash_prefill_headed.launches = 0


# ---------------------------------------------------------------------------
# in-place KV write: the flat and headed caches and the paged pool, one
# append body (csrc/kv_append.cu), a (B, T) chunk of K and V a launch
# ---------------------------------------------------------------------------

def quantize_kv(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Cast new K/V values to the cache dtype: one rounding from x's own
    dtype. (The JAX package needs an optimization barrier to pin this;
    eager torch rounds exactly where it is told to.)"""
    return x if x.dtype == dtype else x.to(dtype)


@functools.cache
def fp8_saturates() -> bool:
    """Whether this torch's cast to float8_e4m3fn saturates finite overflow
    (|x| past 464, and inf) to +-448, 0x7E with the sign, or makes it NaN,
    0x7F with the sign, as torch's older releases and the JAX package do.
    The append kernel rounds bf16 rows into an fp8 cache by the installed
    torch's rule, so its bytes are quantize_kv's."""
    big = torch.tensor([1000.0]).to(torch.float8_e4m3fn)
    return int(big.view(torch.uint8)) == 0x7E


def _chunk(where: str, k_new, v_new, pos, mask, B: int, Hkv: int, d: int):
    """k_new, v_new as a (B, T, Hkv, d) chunk and pos as (B, T): one
    token's (B, Hkv, d) rows at (B,) positions are a chunk of T = 1."""
    if k_new.dim() == 3 and pos.dim() == 1:
        k_new, v_new, pos = k_new[:, None], v_new[:, None], pos[:, None]
    T = pos.shape[1] if pos.dim() == 2 else -1
    if tuple(k_new.shape) != (B, T, Hkv, d) or v_new.shape != k_new.shape \
            or tuple(pos.shape) != (B, T) \
            or (mask is not None and tuple(mask.shape) != (B,)):
        raise ValueError(
            f"{where}: new rows {tuple(k_new.shape)} and "
            f"{tuple(v_new.shape)}, positions {tuple(pos.shape)}, mask "
            f"{None if mask is None else tuple(mask.shape)}, for {B} "
            f"sequences of {Hkv} heads of {d}")
    return k_new, v_new, pos


def _kept(pos: torch.Tensor, mask, S: int):
    """The (b, t) index pairs a flat or headed append writes: mask[b] set
    and 0 <= pos[b, t] < S."""
    keep = (pos >= 0) & (pos < S)
    if mask is not None:
        keep &= mask.bool()[:, None]
    return keep.nonzero(as_tuple=True)


def _rows16(x: torch.Tensor) -> torch.Tensor:
    """A (B, T, Hkv, d) chunk as the kernel reads it: the last dimension
    contiguous and every (b, t, h) row at a 16-byte boundary. A view that
    is so (the fused qkv projection's K and V) is read in place; any other
    is copied (fused._aligned)."""
    elt = x.element_size()
    if x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and all(
            s * elt % 16 == 0 for s, n in zip(x.stride()[:3], x.shape[:3])
            if n > 1):
        return x
    return _aligned(x)


def _strides(x: torch.Tensor, dims: int) -> list[int]:
    """The first `dims` element strides, 0 for a dimension of size 1."""
    return [s if n > 1 else 0 for s, n in zip(x.stride()[:dims],
                                              x.shape[:dims])]


def _launch_append(where: str, entry: str, ck, cv, lead: tuple, k, v, pos,
                   mask, layout: tuple) -> bool:
    """Launch a pk_kv_append* entry on the chunk k, v (B, T, Hkv, d) at pos
    (B, T): `lead` the pointers before the new rows', `layout` the sizes
    after the mask's. bf16 rows bound for an fp8 cache are rounded in the
    kernel (fp8_saturates' rule); rows of any other dtype are cast once here
    (quantize_kv) and copied. Returns whether it launched (an empty chunk
    launches nothing)."""
    if ck.dtype not in _KV_DTYPES or cv.dtype != ck.dtype \
            or not (ck.is_contiguous() and cv.is_contiguous()):
        raise ValueError(f"{where}: contiguous bf16 or fp8 e4m3 caches of "
                         f"one dtype expected, got {ck.dtype}, {cv.dtype}")
    elt, d = ck.element_size(), ck.shape[-1]
    if (d * elt) % 16 or ck.data_ptr() % 16 or cv.data_ptr() % 16:
        raise ValueError(f"{where}: cache rows must be 16-byte aligned")
    if pos.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{where}: positions must be int32 or int64, got "
                         f"{pos.dtype}")
    B, T = pos.shape
    if B * T == 0:
        return False
    cast = 0
    if ck.dtype == torch.float8_e4m3fn and k.dtype == torch.bfloat16 \
            and v.dtype == torch.bfloat16:
        cast = 2 if fp8_saturates() else 1
    else:
        k, v = quantize_kv(k, ck.dtype), quantize_kv(v, ck.dtype)
    k, v = _rows16(k), _rows16(v)
    if mask is not None and mask.dtype not in (torch.bool, torch.uint8,
                                               torch.int32):
        mask = mask.to(torch.int32)
    code = getattr(_build.library(), entry)(
        *lead, k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        None if mask is None else mask.data_ptr(), B, T, *layout, elt, cast,
        *_strides(k, 3), *_strides(v, 3), *_strides(pos, 2),
        pos.element_size(), 0 if mask is None else mask.element_size(),
        0 if mask is None else mask.stride(0),
        torch.cuda.current_stream(ck.device).cuda_stream)
    _build.check(entry, code)
    return True


def _launch_cache(where: str, entry: str, ck, cv, k, v, pos, mask,
                  S: int) -> bool:
    """pk_kv_append or pk_kv_append_headed into a flat or headed cache of S
    positions a sequence."""
    return _launch_append(where, entry, ck, cv, (ck.data_ptr(), cv.data_ptr()),
                          k, v, pos, mask, (S, k.shape[2], k.shape[3]))


def _launch_pool(k_pages, v_pages, bt_rows, k, v, pos, mask) -> bool:
    """pk_kv_append_paged into a (P, Hkv, ps, d) pool through int32
    block-table rows."""
    if bt_rows.dtype != torch.int32:
        raise ValueError("paged kv_append: block tables must be int32")
    if bt_rows.stride(1) != 1:
        bt_rows = bt_rows.contiguous()
    P, Hkv, ps, d = k_pages.shape
    return _launch_append(
        "paged kv_append", "pk_kv_append_paged", k_pages, v_pages,
        (k_pages.data_ptr(), v_pages.data_ptr(), bt_rows.data_ptr()), k, v,
        pos, mask, (P, ps, bt_rows.shape[1], bt_rows.stride(0), Hkv, d))


def kv_append_reference(ck: torch.Tensor, cv: torch.Tensor,
                        k_new: torch.Tensor, v_new: torch.Tensor,
                        pos: torch.Tensor, mask: torch.Tensor | None = None):
    """Plain twin of kv_append: index writes of the kept (b, t) rows
    through an integer view, in place."""
    B, S, Hkv, d = ck.shape
    k_new, v_new, pos = _chunk("kv_append", k_new, v_new, pos, mask, B, Hkv,
                               d)
    b, t = _kept(pos, mask, S)
    p = pos[b, t].long()
    for c, new in ((ck, k_new), (cv, v_new)):
        _bits(c)[b, p] = _bits(quantize_kv(new[b, t], c.dtype))
    return ck, cv


def kv_append(ck: torch.Tensor, cv: torch.Tensor, k_new: torch.Tensor,
              v_new: torch.Tensor, pos: torch.Tensor,
              mask: torch.Tensor | None = None, *, headed: bool = False):
    """Write new K/V into the cache, in place, cast once to the cache dtype.

    ck, cv : (B, S, Hkv, d) flat cache, bf16 or fp8 e4m3, updated in place;
             with headed=True a (B, Hkv, S, d) cache (kv_append_headed)
    k_new, v_new : (B, Hkv, d), one token a sequence at pos (B,), as the
             JAX package's signature has it; or a chunk (B, T, Hkv, d) at
             pos (B, T). Any strides with the last dimension contiguous
             (a view of the fused qkv projection is read in place).
    pos    : int32 or int64 write positions; positions outside [0, S)
             write nothing
    mask   : optional (B,) bool, uint8 or int32; rows with mask[b] = 0 keep
             their cache content bit for bit (the engine's write_mask)
    returns (ck, cv), the same tensors.

    Launches csrc/kv_append.cu (pk_kv_append), one launch a call, for CUDA
    tensors (counted in kv_append.launches)."""
    if headed:
        return kv_append_headed(ck, cv, k_new, v_new, pos, mask)
    B, S, Hkv, d = ck.shape
    if cv.shape != ck.shape:
        raise ValueError(f"kv_append: caches {tuple(ck.shape)} and "
                         f"{tuple(cv.shape)}")
    k_new, v_new, pos = _chunk("kv_append", k_new, v_new, pos, mask, B, Hkv,
                               d)
    if ck.device.type == "cpu":
        return kv_append_reference(ck, cv, k_new, v_new, pos, mask)
    _on_one_cuda_device("kv_append", ck, cv, k_new, v_new, pos,
                        *(() if mask is None else (mask,)))
    if _launch_cache("kv_append", "pk_kv_append", ck, cv, k_new, v_new, pos,
                     mask, S):
        kv_append.launches += 1
    return ck, cv


kv_append.launches = 0


def kv_append_headed_reference(ck: torch.Tensor, cv: torch.Tensor,
                               k_new: torch.Tensor, v_new: torch.Tensor,
                               pos: torch.Tensor,
                               mask: torch.Tensor | None = None):
    """Plain twin of kv_append_headed: index writes of the kept (b, t) rows
    through an integer view, in place (bit for bit for fp8 too)."""
    B, Hkv, S, d = ck.shape
    k_new, v_new, pos = _chunk("headed kv_append", k_new, v_new, pos, mask,
                               B, Hkv, d)
    b, t = _kept(pos, mask, S)
    p = pos[b, t].long()
    for c, new in ((ck, k_new), (cv, v_new)):
        _bits(c)[b, :, p] = _bits(quantize_kv(new[b, t], c.dtype))
    return ck, cv


def kv_append_headed(ck: torch.Tensor, cv: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, pos: torch.Tensor,
                     mask: torch.Tensor | None = None):
    """kv_append(headed=True): the same write into a (B, Hkv, S, d) bf16 or
    fp8 cache, at ck[b, :, pos[b, t]]. bf16 rows bound for an fp8 cache are
    rounded in the kernel, bit for bit quantize_kv.

    Launches csrc/kv_append.cu (pk_kv_append_headed), one launch a call, for
    CUDA tensors (counted in kv_append_headed.launches)."""
    B, Hkv, S, d = ck.shape
    if cv.shape != ck.shape:
        raise ValueError(f"headed kv_append: caches {tuple(ck.shape)} and "
                         f"{tuple(cv.shape)}")
    k_new, v_new, pos = _chunk("headed kv_append", k_new, v_new, pos, mask,
                               B, Hkv, d)
    if ck.device.type == "cpu":
        return kv_append_headed_reference(ck, cv, k_new, v_new, pos, mask)
    _on_one_cuda_device("headed kv_append", ck, cv, k_new, v_new, pos,
                        *(() if mask is None else (mask,)))
    if _launch_cache("headed kv_append", "pk_kv_append_headed", ck, cv, k_new,
                     v_new, pos, mask, S):
        kv_append_headed.launches += 1
    return ck, cv


kv_append_headed.launches = 0


def _check_paged_write(k_pages, v_pages, bt_rows, page_size: int) -> None:
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape \
            or k_pages.shape[2] != page_size or bt_rows.dim() != 2:
        raise ValueError(f"paged kv_append: pools {tuple(k_pages.shape)} "
                         f"and {tuple(v_pages.shape)}, page_size "
                         f"{page_size}, block tables {tuple(bt_rows.shape)}")


def kv_append_paged_reference(k_pages: torch.Tensor, v_pages: torch.Tensor,
                              bt_rows: torch.Tensor, k_new: torch.Tensor,
                              v_new: torch.Tensor, pos: torch.Tensor,
                              page_size: int,
                              mask: torch.Tensor | None = None):
    """Plain twin of kv_append_paged, the torch glue of the JAX package's
    scatter: each (token, head) pair is one row of the pool seen as
    (P * Hkv * ps, d), written by one index write a pool through an
    integer view. A masked row's last token goes to the scratch page at
    offset 0; a position below 0 or past the table's width, or a table
    entry outside the pool, writes nothing."""
    _check_paged_write(k_pages, v_pages, bt_rows, page_size)
    P, Hkv, ps, d = k_pages.shape
    B, n = bt_rows.shape
    k_new, v_new, pos = _chunk("paged kv_append", k_new, v_new, pos, mask, B,
                               Hkv, d)
    p = pos.long()
    idx = p // ps
    inside = (p >= 0) & (idx < n)
    page = torch.gather(bt_rows.long(), 1, idx.clamp(0, n - 1))
    if mask is not None:
        keep = mask.bool()[:, None].expand_as(p)
        last = torch.arange(p.shape[1], device=p.device) == p.shape[1] - 1
        page = torch.where(keep, page, P - 1)
        p = torch.where(keep, p, 0)
        inside = torch.where(keep, inside, last)
    inside &= (page >= 0) & (page < P)
    rows = ((page[inside][:, None] * Hkv
             + torch.arange(Hkv, device=p.device)) * ps
            + (p[inside] % ps)[:, None])                      # (n, Hkv)
    for pages, new in ((k_pages, k_new), (v_pages, v_new)):
        _bits(pages).view(P * Hkv * ps, d)[rows] = _bits(
            quantize_kv(new[inside], pages.dtype))
    return k_pages, v_pages


def kv_append_paged(k_pages: torch.Tensor, v_pages: torch.Tensor,
                    bt_rows: torch.Tensor, k_new: torch.Tensor,
                    v_new: torch.Tensor, pos: torch.Tensor, page_size: int,
                    mask: torch.Tensor | None = None):
    """Write new K/V into a paged pool through block-table rows, in place,
    cast once to the pool dtype.

    k_pages, v_pages : (P, Hkv, ps, d) bf16 or fp8 e4m3 pools, the last
             page the scratch page
    bt_rows : (B, max_pages) int32 page ids; position p of row b lies at
             page bt_rows[b, p // ps], offset p % ps, pool row
             (page * Hkv + h) * ps + p % ps of the (P * Hkv * ps, d) view
    k_new, v_new, pos, mask : as kv_append's. A row with mask[b] = 0
             writes its last token to the scratch page at offset 0 (a slot
             swept along in a batched step must not touch its own pages);
             a position below 0 or past the table's width writes nothing.
    returns (k_pages, v_pages), the same tensors.

    The JAX counterpart is no Pallas kernel: the XLA scatter of
    petit_kernel_tpu/models/paged.py:_write_kv. Launches csrc/kv_append.cu
    (pk_kv_append_paged), one launch a call, for CUDA tensors (counted in
    kv_append_paged.launches)."""
    _check_paged_write(k_pages, v_pages, bt_rows, page_size)
    _, Hkv, _, d = k_pages.shape
    k_new, v_new, pos = _chunk("paged kv_append", k_new, v_new, pos, mask,
                               bt_rows.shape[0], Hkv, d)
    if k_pages.device.type == "cpu":
        return kv_append_paged_reference(k_pages, v_pages, bt_rows, k_new,
                                         v_new, pos, page_size, mask)
    _on_one_cuda_device("paged kv_append", k_pages, v_pages, bt_rows, k_new,
                        v_new, pos, *(() if mask is None else (mask,)))
    if _launch_pool(k_pages, v_pages, bt_rows, k_new, v_new, pos, mask):
        kv_append_paged.launches += 1
    return k_pages, v_pages


kv_append_paged.launches = 0
