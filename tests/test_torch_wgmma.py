"""The 64-row (prefill) FP4 tile body, csrc/fp4_wgmma.cuh, on the CPU.

A CUDA kernel has no CPU mode, so these tests hold what the body is built
from against the JAX package:

- its data movement, played in numpy: A copied quarter by quarter into
  128-byte-swizzled rows, the packed words decoded two values at a time
  (the body's decode_pair bit formulas) into swizzled B rows, and both
  read back as a wgmma descriptor 32 bytes per 16-deep chunk reads them.
  The sum over every unit must be the JAX package's fused_mul (Pallas,
  interpret mode) on the same bytes, at the GEMM tolerance (rtol 2^-7,
  atol 2^-8 * max|ref|: f32 sums of exact bf16 products in another
  order, one bf16 rounding);
- its ring: the order in which a unit decodes, waits, copies and issues
  its wgmmas, played as events, leaves no slot overwritten before its
  reader is done and no operand read before it landed, at every A
  lookahead the shared-memory plan picks;
- the tiles each launcher dispatches: solution.TILE_SHAPES.

The kernels themselves run on the card: tests/test_torch_cuda.py.
"""

import dataclasses
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import petit_kernel_tpu as pk
from petit_kernel_tpu.numerics import formats as jformats
from petit_kernel_tpu.ops import layout as jlayout
from petit_kernel_tpu.utils.testdata import make_gemm_data
from petit_kernel_tpu_torch.ops import solution as tsol
from petit_kernel_tpu_torch.ops.kernels import fused

torch.set_num_threads(1)

_CSRC = os.path.join(os.path.dirname(__file__), os.pardir,
                     "petit_kernel_tpu_torch", "csrc")
_ROW = 128          # bytes of a swizzled quarter row: 64 bf16
_KSTEP = 256        # natural k a step
_WROWS = 32         # packed word rows a step


@pytest.mark.parametrize("src", ["fp4_gemm.cu", "grouped_fp4_gemm.cu",
                                 "hybrid_gemm.cu", "fp4_gemm_w4a8.cu"])
def test_launchers_dispatch_the_solution_tiles(src):
    """The (block_m, block_n) tiles a launcher dispatches are the ones
    solution.py lists, so every id the heuristic or a table picks has a
    kernel."""
    with open(os.path.join(_CSRC, src)) as f:
        text = f.read()
    tiles = {(int(bm), int(bn)) for bm, bn in re.findall(
        r"block_m == (\d+) && block_n == (\d+)", text)}
    assert tiles == set(tsol.TILE_SHAPES)
    if src == "fp4_gemm_w4a8.cu":
        # both entries' 64-row tiles launch the int8 wgmma body, at G = 1
        # (pk_fp4_gemm_w4a8) or WC_GROUP m-tiles a CTA (the weight cache)
        for bn in (64, 128):
            assert re.search(
                rf"block_m == 64 && block_n == {bn}\)\s*err = "
                rf"launch_wgmma<{bn}, G>", text)
        for entry, g in (("pk_fp4_gemm_w4a8", "1"),
                         ("pk_fp4_gemm_w4a8_wc", "WC_GROUP")):
            assert re.search(rf"{entry}\([^{{]*\{{\s*return dispatch<{g}>",
                             text)


# ---- the data movement -----------------------------------------------------

def _decode_pair(x: np.ndarray, j: int):
    """fp4_stream.cuh decode_pair<j> on 32-bit words: the slots of quarter
    j in both 16-bit halves as bf16 bit patterns (low half, high half)."""
    x = x.astype(np.uint64)
    if j == 0:
        v = (x & 0x81C081C0) + 0x3F003F00
    elif j == 1:
        v = (x & 0x10381038) * 8 + 0x3F003F00
    elif j == 2:
        v = (x & 0x02070207) * 64 + 0x3F003F00
    else:
        v = ((((x >> 4) & 0x00C000C0) | ((x >> 5) & 0x01000100)
              | ((x << 1) & 0x80008000)) + 0x3F003F00)
    v &= 0xFFFFFFFF
    halves = []
    for h in (v & 0xFFFF, v >> 16):
        # the stored zero t = 1 gave magnitude 0x3F40: cleared, sign too
        halves.append(np.where((h & 0x7FFF) == 0x3F40, 0, h).astype(np.uint16))
    return halves


def _f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _swizzled(rows: int) -> np.ndarray:
    """A quarter slot: `rows` rows of 128 bytes as bf16 bit patterns."""
    return np.zeros((rows, _ROW // 2), np.uint16)


def _store_chunk(slot, r, chunk, vals):
    """16-byte chunk `chunk` of row r to chunk ^ (r & 7), as the body's
    stores and cp.async destinations place it."""
    p = (chunk ^ (r & 7)) * 8
    slot[r, p:p + 8] = vals


def _wgmma_read(slot):
    """The (rows, 64) operand a K-major 128-byte-swizzled descriptor
    gives, chunk q (16 deep) at start + 32q bytes: the hardware XORs
    address bits 4-6 with bits 7-9 (the row within the 1024-byte atom)."""
    rows = slot.shape[0]
    out = np.zeros((rows, 64), np.uint16)
    for r in range(rows):
        for q in range(4):
            for e in range(16):
                byte = 32 * q + 2 * e                      # unswizzled offset
                phys = byte ^ ((r & 7) << 4)
                out[r, 16 * q + e] = slot[r, phys // 2]
    return out


def _emulated_tile_body(a_bits, words, scales_t, gs):
    """C = bf16((A @ dequant(W, S)) * gs) built unit by unit as
    fp4_wgmma_tile builds it: wg_load_a, wg_load_ws, wg_words + wg_decode,
    the wgmma descriptor reads, f32 sums in unit order."""
    m, k = a_bits.shape
    kw, n = words.shape
    kp = kw * 8
    kq, srq = kp // 4, kp // 64
    w_all = words.view(np.uint32)
    acc = np.zeros((m, n), np.float32)
    for step in range(kp // _KSTEP):
        c, g = step >> 1, step & 1
        # wg_load_ws: stage row sr <- word row 64c + 2g + 4(sr >> 1) + sr & 1
        w = np.stack([w_all[64 * c + 2 * g + 4 * (sr >> 1) + (sr & 1)]
                      for sr in range(_WROWS)])
        for j in range(4):
            a_slot, b_slot = _swizzled(m), _swizzled(n)
            k0 = j * kq + c * 128 + g * 64                  # unit_k0
            for r in range(m):                              # wg_load_a
                for a in range(8):
                    kn = k0 + a * 8
                    run = (a_bits[r, kn:kn + 8] if kn < k
                           else np.zeros(8, np.uint16))
                    _store_chunk(a_slot, r, a, run)
            for p in range(4):                              # wg_decode
                b, d = p & 1, p >> 1
                for h in range(2):
                    chunk = b + 4 * d + 2 * h
                    sc = _f32(scales_t[j * srq + 8 * c + 4 * g + 2 * d + h])
                    vals = np.zeros((n, 8), np.uint16)
                    for y in range(4):
                        w0, w1 = w[16 * b + d + 4 * y], w[16 * b + d + 4 * y + 2]
                        pair = ((w0 & 0xFFFF) | ((w1 & 0xFFFF) << 16) if h == 0
                                else (w0 >> 16) | (w1 & 0xFFFF0000))
                        lo, hi = _decode_pair(pair, j)
                        vals[:, 2 * y] = _bf16_bits(_f32(lo) * sc)
                        vals[:, 2 * y + 1] = _bf16_bits(_f32(hi) * sc)
                    for col in range(n):
                        _store_chunk(b_slot, col, chunk, vals[col])
            a_q = _f32(_wgmma_read(a_slot)).astype(np.float64)
            b_q = _f32(_wgmma_read(b_slot)).astype(np.float64)
            acc += (a_q @ b_q.T).astype(np.float32)
    return (acc * np.float32(gs)).astype(np.float32)


def _zeroed_data(m, n, k, seed):
    """nvfp4 data with three quarters of the nibbles the code of +0, which
    the q-coded layout stores as t = 1."""
    d = make_gemm_data(m, n, k, "nvfp4", seed=seed)
    rng = np.random.default_rng(seed + 1)
    nib = rng.integers(0, 16, size=(n, k), dtype=np.uint8)
    nib[(nib == 8) | (rng.random((n, k)) < 0.75)] = 0
    q = jformats.pack_fp4_pairs(nib)
    words = jlayout.repack_fp4_weights(q, n, k,
                                       pad_to=jlayout.pad_multiple(16))
    return dataclasses.replace(d, qweights=q, words=words)


_JAX_MUL = {"nvfp4": pk.mul_nvfp4_a16, "mxfp4": pk.mul_mxfp4_a16,
            "nvfp4p2z": pk.mul_nvfp4p2z_a16, "zeros": pk.mul_nvfp4_a16}


@pytest.mark.parametrize("fmt", sorted(_JAX_MUL))
def test_tile_body_data_movement_matches_jax_fused_mul(fmt):
    """Ragged m (70) and n (336), k = 640 padded to 1024: four steps, 16
    units. The emulated body against the JAX package's fused_mul and the
    port's CPU twin on the same bytes."""
    m, n, k = 70, 336, 640
    d = (_zeroed_data(m, n, k, seed=3) if fmt == "zeros"
         else make_gemm_data(m, n, k, fmt, seed=3))
    a_bf = jnp.asarray(d.a, jnp.bfloat16)
    want = np.asarray(_JAX_MUL[fmt](
        a_bf, jnp.asarray(d.words), jnp.asarray(d.scales_t),
        jnp.float32(d.global_scale), m, n, k, -1, interpret=True),
        np.float32)
    a_bits = np.array(a_bf).view(np.uint16)
    got = _emulated_tile_body(a_bits, d.words.view(np.int32),
                              d.scales_t.view(np.uint16), d.global_scale)
    got = _f32(_bf16_bits(got))
    np.testing.assert_allclose(got, want, rtol=2 ** -7,
                               atol=2 ** -8 * np.abs(want).max())
    twin = fused.fused_mul_reference(
        torch.from_numpy(a_bits.view(np.int16)).view(torch.bfloat16),
        torch.from_numpy(d.words.view(np.int32)),
        torch.from_numpy(d.scales_t.view(np.int16)).view(torch.bfloat16),
        torch.tensor([d.global_scale]), sid=tsol.SolutionId(64, 128))
    np.testing.assert_allclose(got, twin.float().numpy(), rtol=2 ** -7,
                               atol=2 ** -8 * np.abs(want).max())


def test_decode_pair_matches_the_e2m1_table():
    """Every 16-bit half, every quarter: decode_pair gives the signed E2M1
    value of the slot's q-code (t = 1 the stored zero, an exact +0)."""
    mags = {0: 0.5, 1: 0.0, 2: 1.0, 3: 1.5, 4: 2.0, 5: 3.0, 6: 4.0, 7: 6.0}
    half = np.arange(1 << 16, dtype=np.uint32)
    for j in range(4):
        lo, hi = _decode_pair(half | (half << 16), j)
        assert (lo == hi).all()
        if j == 0:
            t, sg = (half >> 6) & 7, (half >> 15) & 1
        elif j == 1:
            t, sg = (half >> 3) & 7, (half >> 12) & 1
        elif j == 2:
            t, sg = half & 7, (half >> 9) & 1
        else:
            t = ((half >> 10) & 3) | (((half >> 13) & 1) << 2)
            sg = (half >> 14) & 1
        want = np.where(t == 1, 0.0, np.vectorize(mags.get)(t)
                        * np.where(sg == 1, -1.0, 1.0))
        got = _f32(lo)
        assert np.array_equal(got, want.astype(np.float32)), j
        assert (lo[t == 1] == 0).all()               # +0, sign cleared


# ---- the ring --------------------------------------------------------------

def _ring_faults(da, steps, a_slots=None, b_slots=3, mma_depth=1, units=4,
                 words=True):
    """Play fp4_wgmma_tile's order (`units` units a step; the W4A8 body,
    w4a8_wgmma_tile, runs 2) for every thread at once and return the
    hazards found. A unit u = units * step + j runs: decode into B slot
    u % b_slots (reading the step's words and scales);
    cp.async.wait_group(da - 1); barrier; copy A(u + da) into slot
    (u + da) % a_slots (and, at j = 0, the next step's words and scales
    into stage (step + 1) % 2); commit; wgmmas on A(u), B(u); commit;
    wgmma.wait_group(mma_depth). The prologue commits da groups,
    A(v) for v < da with step 0's words in the first, then waits for
    da - 1 and meets a barrier. A copy group counts as landed for every
    thread once a wait has retired it and a barrier followed; a wgmma as
    done once a wait has retired it and a barrier followed. A tuple
    mma_depth plays one warpgroup a depth, each waiting only for its own
    wgmmas, all reading one A slot (their own rows) and one B slot: a
    wgmma is done for all threads once every warpgroup's is. words=False
    plays a ring whose stages carry the words and scales with A
    (csrc/w4a8_stream.cuh, at units=1 and mma_depth=0: its MMAs are done
    when a thread leaves the step): no decode into shared memory, no
    separate stages of words."""
    depths = (mma_depth,) if isinstance(mma_depth, int) else mma_depth
    a_slots = da + 2 if a_slots is None else a_slots
    n_units = units * steps
    faults = []
    groups = []                      # contents of each committed group
    group_of = {}                    # operand -> its group
    landed = 0                       # groups landed for all threads
    retired_mma = [-1] * len(depths)   # last wgmma each warpgroup retired
    done_mma = -1                    # last wgmma done for all threads
    a_holder = {}                    # A slot -> unit whose A it holds
    ws_holder = {}                   # stage -> step whose words it holds
    b_reader = {}                    # B slot -> unit whose wgmma reads it

    def commit(ops):
        for op in ops:
            group_of[op] = len(groups)
        groups.append(ops)

    def wait_copies(depth):
        return max(0, len(groups) - depth)

    def load_a(u):
        s = u % a_slots
        prev = a_holder.get(s)
        if prev is not None and prev > done_mma:
            faults.append(f"A({u}) overwrites slot {s} under wgmma({prev})")
        a_holder[s] = u
        return ("A", u)

    def load_ws(step):
        ws_holder[step % 2] = step
        return ("WS", step)

    for v in range(da):
        ops = [load_ws(0)] if v == 0 and words else []
        if v < n_units:
            ops.append(load_a(v))
        commit(ops)
    landed = wait_copies(da - 1)          # prologue wait + barrier
    for u in range(n_units):
        step, j = divmod(u, units)
        b = u % b_slots
        if words:
            # decode(u): reads the step's words and scales, writes B slot
            if group_of[("WS", step)] >= landed:
                faults.append(f"decode({u}) reads words({step}) not landed")
            if ws_holder[step % 2] != step:
                faults.append(
                    f"decode({u}) finds words({ws_holder[step % 2]})")
            if b in b_reader and b_reader[b] > done_mma:
                faults.append(f"decode({u}) overwrites B slot {b} under "
                              f"wgmma({b_reader[b]})")
        # wait, barrier
        landed = wait_copies(da - 1)
        done_mma = min(retired_mma)
        ops = []
        if u + da < n_units:
            ops.append(load_a(u + da))
        if words and j == 0 and step + 1 < steps:
            ops.append(load_ws(step + 1))
        commit(ops)
        # wgmma(u)
        if group_of[("A", u)] >= landed:
            faults.append(f"wgmma({u}) reads A({u}) not landed")
        if a_holder[u % a_slots] != u:
            faults.append(f"wgmma({u}) finds A({a_holder[u % a_slots]})")
        b_reader[b] = u
        retired_mma = [u - d for d in depths]
    return faults


@pytest.mark.parametrize("steps", [1, 2, 5])
@pytest.mark.parametrize("da", [1, 2, 3])
def test_ring_order_has_no_hazard(da, steps):
    """Every lookahead the shared-memory plan may pick (1 for the plain
    tiles, whose blocks share an SM; 2 and 3 for the weight cache) with
    da + 2 A slots, three B slots and one wgmma group left in flight."""
    assert _ring_faults(da, steps) == []


@pytest.mark.parametrize("broken", [dict(a_slots=3, da=2),
                                    dict(b_slots=2, da=1),
                                    dict(mma_depth=2, da=1),
                                    dict(da=4)])
def test_ring_player_finds_a_short_ring(broken):
    """One A slot or B slot fewer, one more wgmma group in flight, or a
    lookahead the words' one-step lead cannot cover: the player finds the
    hazard, so the test above has teeth."""
    assert _ring_faults(steps=3, **broken) != []
