"""Paged KV cache: fixed-size pages in a shared pool, per-sequence block
tables (torch).

Counterpart of petit_kernel_tpu/models/paged.py. KV lives in one pool of
pages per layer, allocated on demand as sequences grow, so a ragged batch
holds the sum of its lengths instead of max_batch * max_seq_len. Pools are
headed (num_pages + 1, Hkv, page_size, d), bf16 or fp8 e4m3; the last page
is a scratch page that block tables of slots without an allocation point
at, and that masked writes are redirected to. The allocator (free list,
per-slot page lists, the block table) is host Python, as in the JAX
package; the block table goes to the device when it changed.

The attention of a paged forward runs the paged decode and paged
flash-prefill kernels (ops/kernels/attention.py). The JAX package's
fallback that gathers the whole pool when no kv_window is given is not
ported: attention_paged needs kv_window.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import llama
from ..ops.kernels import attention as attn_mod


class PagedKVCache:
    """Per-layer page pools, the (B, max_pages) block table and the host
    allocator state: `free` (page ids, popped from the end) and `used`
    (each slot's pages in position order)."""

    def __init__(self, pages, tables: np.ndarray, page_size: int,
                 num_pages: int):
        self.pages = pages      # per layer (k, v): (P + 1, Hkv, ps, d)
        self.tables = tables    # host (B, max_pages) int32
        self.page_size = page_size
        self.num_pages = num_pages          # allocatable, without scratch
        self.free = list(range(num_pages - 1, -1, -1))
        self.used = [[] for _ in range(tables.shape[0])]
        self._device_tables = None

    @property
    def max_pages(self) -> int:
        return int(self.tables.shape[1])

    @property
    def scratch_page(self) -> int:
        return self.num_pages

    @property
    def block_tables(self) -> torch.Tensor:
        """The block table as an int32 tensor on the pools' device, copied
        there again only after the allocator changed it."""
        if self._device_tables is None:
            self._device_tables = torch.from_numpy(self.tables.copy()).to(
                self.pages[0][0].device)
        return self._device_tables

    def _set(self, slot: int, i, page: int) -> None:
        self.tables[slot, i] = page
        self._device_tables = None

    def allocator_state(self):
        """A copy of the allocator (block table, free list, per-slot page
        lists), for restore_allocator; the pools are not part of it."""
        return self.tables.copy(), list(self.free), [list(u) for u in
                                                     self.used]

    def restore_allocator(self, state) -> None:
        """Put back an allocator_state(); the device table follows."""
        tables, free, used = state
        self.tables[:] = tables
        self.free, self.used = list(free), [list(u) for u in used]
        self._device_tables = None


def init_paged_cache(cfg: llama.LlamaConfig, batch: int, *,
                     page_size: int = 256, num_pages: Optional[int] = None,
                     dtype=torch.bfloat16, device=None) -> PagedKVCache:
    """Zeroed pools on `device` (default the CUDA card; raises without
    one, llama.resolve_device). page_size is clamped to max_seq_len, which
    it must divide; num_pages defaults to every slot at max_seq_len."""
    page_size = min(page_size, cfg.max_seq_len)
    if cfg.max_seq_len % page_size:
        raise ValueError(f"page_size {page_size} must divide max_seq_len "
                         f"{cfg.max_seq_len}")
    max_pages = cfg.max_seq_len // page_size
    if num_pages is None:
        num_pages = batch * max_pages
    shape = (num_pages + 1, cfg.num_kv_heads, page_size, cfg.head_dim)
    device = llama.resolve_device(device)
    pages = [(torch.zeros(shape, dtype=dtype, device=device),
              torch.zeros(shape, dtype=dtype, device=device))
             for _ in range(cfg.num_layers)]
    tables = np.full((batch, max_pages), num_pages, np.int32)
    return PagedKVCache(pages, tables, page_size, num_pages)


def ensure_capacity(cache: PagedKVCache, slot: int, upto_pos: int) -> None:
    """Grow slot's block table to cover positions < upto_pos. Raises
    ValueError past max_pages pages (the JAX package's table update drops
    such a write silently) and RuntimeError when the pool is exhausted."""
    need = -(-upto_pos // cache.page_size)
    if need > cache.max_pages:
        raise ValueError(f"slot {slot}: position {upto_pos - 1} needs {need} "
                         f"pages, the block table holds {cache.max_pages}")
    used = cache.used[slot]
    while len(used) < need:
        if not cache.free:
            raise RuntimeError("paged KV pool exhausted")
        page = cache.free.pop()
        cache._set(slot, len(used), page)
        used.append(page)


def release_slot(cache: PagedKVCache, slot: int) -> None:
    """Return a slot's pages to the pool and point its block table back at
    the scratch page, so stale writes never reach a reused page."""
    cache.free.extend(reversed(cache.used[slot]))
    cache.used[slot] = []
    cache._set(slot, slice(None), cache.scratch_page)


def gather_slot_kv(cache: PagedKVCache, slot: int, n: int) -> list:
    """Slot's K and V of every layer over positions < n, gathered through
    its block-table row: [k0, v0, k1, v1, ...], each (n, Hkv, d) in the
    pool's dtype. Two runs that wrote the same positions through other
    physical pages give the same tensors."""
    ids = torch.as_tensor(cache.tables[slot, :-(-n // cache.page_size)],
                          dtype=torch.long, device=cache.pages[0][0].device)

    def rows(t):
        # gathered as bytes: fp8 indexing is not implemented everywhere
        b = t.view(torch.uint8)[ids].transpose(1, 2)
        return b.reshape(-1, t.shape[1], b.shape[-1])[:n].view(t.dtype)

    return [rows(t) for kv in cache.pages for t in kv]


def _write_kv(pages_kv, bt_rows, new_k, new_v, pos, page_size: int,
              write_mask=None) -> None:
    """Write one chunk's k/v (B, T, Hkv, d) into the pools at positions pos
    (B, T), through block-table rows bt_rows (B, max_pages), in place, cast
    once to the pool dtype: one kv_append_paged launch on the card. Rows
    with write_mask[b] False write to the scratch page at offset 0 instead
    (a slot swept along in a batched step must not touch its own pages)."""
    k_pages, v_pages = pages_kv
    attn_mod.kv_append_paged(k_pages, v_pages, bt_rows, new_k, new_v, pos,
                             page_size, write_mask)


def attention_paged(x, lp, pages_kv, bt_rows, pos, cfg: llama.LlamaConfig,
                    *, fmt: str, page_size: int, kv_window: int,
                    write_mask=None, rope_cs=None):
    """llama.attention with the KV in pages. A decode step (T == 1) runs
    paged decode attention, a chunk (T > 1, positions pos[b, 0] + t) paged
    flash prefill, each over the first ceil(kv_window / page_size) entries
    of each block-table row."""
    if kv_window is None:
        raise ValueError("paged attention needs kv_window: it runs only the "
                         "paged decode and prefill kernels")
    B, T, _ = x.shape
    nq, d = cfg.num_heads, cfg.head_dim
    q, k, v = llama._qkv(x, lp, pos, cfg, fmt=fmt, rope_cs=rope_cs)
    _write_kv(pages_kv, bt_rows, k, v, pos, page_size, write_mask)
    k_pages, v_pages = pages_kv
    n = min(-(-kv_window // page_size), bt_rows.shape[1])
    pos0 = pos[:, 0].to(torch.int32).contiguous()
    if T == 1:
        o = attn_mod.paged_decode_attention(
            q.reshape(B, nq, d), k_pages, v_pages, bt_rows, pos0, nb=n,
            page_size=page_size)
    else:
        o = attn_mod.flash_prefill_paged(q, k_pages, v_pages, bt_rows, pos0,
                                         ns=n)
    return llama.linear(o.reshape(B, T, nq * d).to(x.dtype), lp["wo"],
                        fmt=fmt)


@torch.inference_mode()
def forward_paged(params, tokens, cfg: llama.LlamaConfig, pages, bt, pos, *,
                  page_size: int, fmt: str = "nvfp4", kv_window=None,
                  write_mask=None):
    """llama.forward with paged KV: (logits, pages), the pools updated in
    place. bt: (B, max_pages) int32 block table, grown beforehand with
    ensure_capacity; pos (B, T) absolute positions; kv_window: required,
    the bucketed attended length; write_mask (B,) bool: rows with False
    write to the scratch page only."""
    x = params["embed"][tokens.long()]
    rope_cs = llama._rope_angles(pos, cfg.head_dim, cfg.rope_theta)
    for i, lp in enumerate(params["layers"]):
        h = llama.rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        x = x + attention_paged(h, lp, pages[i], bt, pos, cfg, fmt=fmt,
                                page_size=page_size, kv_window=kv_window,
                                write_mask=write_mask, rope_cs=rope_cs)
        h = llama.rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        x = x + llama.mlp(h, lp, fmt=fmt)
    x = llama.rms_norm(x, params["final_norm"], cfg.rms_eps)
    return llama.linear(x, params["lm_head"], fmt=fmt), pages
