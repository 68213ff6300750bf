"""The plain W4A8 kernel's 64-row tile body, csrc/w4a8_wgmma.cuh, on the CPU.

A CUDA kernel has no CPU mode, so these tests hold what the body is built
from against the JAX package, bit for bit (its integer sums are exact):

- its requantization, the kernel's bit operations played in numpy
  (decode_pair, mul.rn.bf16x2 by the R pair, the f32 add of 1.5 * 2^23
  that rounds each value, the three prmt that gather the bytes), equals
  rne(bf16(decode * r)) for all 16 codes of every quarter and every bf16
  r in [0, 127/6], both zeros and the stored zero t = 1 included;
- its data movement, played in numpy: int8 A copied unit by unit (two
  quarters of 64 k a unit) into 128-byte-swizzled rows, the words
  requantized into swizzled K-major B rows, both read back as an s8
  descriptor reads them, 32 bytes per k32 chunk, integer sums over every
  unit, then the epilogue. The result must be the JAX package's
  fused_mul_w4a8 (Pallas, interpret mode) and the port's twin on the same
  bytes, bit for bit;
- its ring: the order in which a unit requantizes, waits, copies and
  issues its wgmmas, played as events by tests/test_torch_wgmma.py's
  player at two units a step, leaves no slot overwritten before its reader
  is done and no operand read before it landed, and the player finds a
  ring that is too short;
- the weight cache's tiles (G > 1 m-tiles a CTA, a warpgroup each): the
  cut of a unit's requantization over all 128G threads (W8Share) writes
  every (column, chunk) of the B slot exactly once; the data movement at
  G (G*64 A rows in one slot, each warpgroup's descriptor at its own 64
  rows, one requantized B slot read by all G, m-groups and n-tiles as the
  launcher lays them, rows past m zero-filled and never stored) equals
  the JAX package's fused_mul_w4a8 with a weight-cache sid (its
  _fused_kernel_w4a8_wc, interpret mode) and the twin bit for bit; the
  ring at G warpgroups, each waiting only for its own wgmmas.

Tolerance: 0 throughout, as the integer sums are exact. The dispatch of
every solution tile by fp4_gemm_w4a8.cu is checked with the other
launchers in tests/test_torch_wgmma.py; the kernel itself runs on the
card: tests/test_torch_cuda.py.
"""

import dataclasses
import os
import re
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petit_kernel_tpu.ops import solution as jsol
from petit_kernel_tpu.ops.kernels import fused as jfused
from petit_kernel_tpu.utils.testdata import make_gemm_data
from petit_kernel_tpu_torch.ops import solution as tsol
from petit_kernel_tpu_torch.ops.kernels import fused
from test_torch_wgmma import (_bf16_bits, _decode_pair, _f32, _ring_faults,
                              _zeroed_data)

torch.set_num_threads(1)

_CSRC = os.path.join(os.path.dirname(__file__), os.pardir,
                     "petit_kernel_tpu_torch", "csrc")

_ROW = 128          # bytes of a swizzled row: 128 int8 k
_KSTEP = 256        # natural k a step
_WROWS = 32         # packed word rows a step
_MAGS = (0.5, 0.0, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)   # E2M1 magnitude of t


# ---- the kernel's bit operations on 32-bit words ---------------------------

def _u32(x):
    return np.asarray(x, np.uint64) & 0xFFFFFFFF


def _halves(x):
    x = _u32(x)
    return x & 0xFFFF, x >> 16


def _word(lo, hi):
    return _u32(np.asarray(lo, np.uint64) | (np.asarray(hi, np.uint64) << 16))


def _prmt(a, b, sel):
    """prmt.b32 d, a, b, sel: byte i of d is byte (nibble i & 7) of {b, a},
    or, with bit 3 of the nibble set, that byte's sign replicated."""
    src = [(_u32(a) >> (8 * i)) & 0xFF for i in range(4)]
    src += [(_u32(b) >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros(np.broadcast(src[0], src[4]).shape, np.uint64)
    for i in range(4):
        nib = (sel >> (4 * i)) & 0xF
        v = src[nib & 7]
        if nib & 8:
            v = np.where(v & 0x80, 0xFF, 0).astype(np.uint64)
        out |= v << np.uint64(8 * i)
    return out


def _decode_word(x, j):
    """decode_pair<j>: both halves' slots of quarter j as bf16 bits."""
    lo, hi = _decode_pair(_u32(x), j)
    return _word(lo, hi)


def _per_half(f, *words):
    parts = [_halves(w) for w in words]
    lo = f(*(p[0] for p in parts))
    hi = f(*(p[1] for p in parts))
    return _word(lo, hi)


def _mul_bf16x2(x, y):
    """mul.rn.bf16x2: the exact product rounded once to bf16."""
    return _per_half(lambda a, b: _bf16_bits(_f32(a) * _f32(b)), x, y)


def _plus_magic(x):
    """__fadd_rn of the bf16 bits x, moved to f32, and 1.5 * 2^23."""
    f = _f32(x) + np.float32(12582912.0)
    return f.astype(np.float32).view(np.uint32).astype(np.uint64)


def _requant4(b01, b23):
    """w4a8_wgmma.cuh requant4: four bf16 values as four int8 bytes."""
    f = [_plus_magic(h) for b in (b01, b23) for h in _halves(b)]
    return _prmt(_prmt(f[0], f[1], 0x0040), _prmt(f[2], f[3], 0x0040),
                 0x5410)


def _chunk(pairs, rr, j):
    """w8_chunk<j>: eight half pairs (values 2y, 2y + 1) under the R pair
    rr -> four words of int8, value x in byte x % 4 of word x // 4."""
    return [_requant4(_mul_bf16x2(_decode_word(pairs[2 * q], j), rr),
                      _mul_bf16x2(_decode_word(pairs[2 * q + 1], j), rr))
            for q in range(4)]


def _place(sign, t, j):
    """A 16-bit half holding (sign, t) in quarter j's bits."""
    if j == 0:
        return (t << 6) | (sign << 15)
    if j == 1:
        return (t << 3) | (sign << 12)
    if j == 2:
        return t | (sign << 9)
    return ((t & 3) << 10) | ((t >> 2) << 13) | (sign << 14)


_QUARTER_BITS = [_place(1, 7, j) for j in range(4)]


def _bytes(words):
    """Four words (shape (..., ) each) -> int8 (..., 16), byte x = value x."""
    w = np.stack([_u32(o).astype(np.uint32) for o in words], axis=-1)
    return np.ascontiguousarray(w).view(np.int8)


@pytest.mark.parametrize("j", range(4))
def test_requantization_formula_every_code_and_r(j):
    """All 16 codes (sign, t), each at every byte position of its word
    (16 rotations of the chunk), the other quarters' bits random, against
    torch.round(bf16(decode * r)) for every bf16 r from -0 and +0 to
    bf16(127/6)."""
    top = int(torch.tensor(127 / 6).to(torch.bfloat16).view(torch.int16))
    r_bits = np.concatenate([[0x8000], np.arange(top + 1)]).astype(np.uint64)
    rr = _word(r_bits, r_bits)
    r = _f32(r_bits)
    assert r.max() <= 127 / 6 and (r_bits == 0x8000).any()
    rng = np.random.default_rng(j)
    codes = [(s, t) for s in (0, 1) for t in range(8)]
    for rot in range(16):
        order = codes[rot:] + codes[:rot]
        junk = rng.integers(0, 1 << 16, size=16) & ~_QUARTER_BITS[j]
        halves = [_place(s, t, j) | int(x) for (s, t), x in zip(order, junk)]
        pairs = [_word(halves[2 * y], halves[2 * y + 1]) for y in range(8)]
        got = _bytes(_chunk(pairs, rr, j))                     # (nr, 16)
        dec = np.array([(-1.0 if s else 1.0) * _MAGS[t] for s, t in order],
                       np.float32)
        b = torch.from_numpy(r[:, None] * dec[None, :]).to(torch.bfloat16)
        want = torch.round(b.float()).to(torch.int8).numpy()
        np.testing.assert_array_equal(got, want)


# ---- the data movement -----------------------------------------------------

def _store_chunks(slot, rows, chunk, vals):
    """16-byte chunk `chunk` of each row in `rows` to chunk ^ (row & 7), as
    the body's stores and cp.async destinations place it."""
    phys = (chunk ^ (rows & 7)) * 16
    slot[rows[:, None], phys[:, None] + np.arange(16)] = vals


def _wgmma_read(slot):
    """The (rows, 128) int8 operand a K-major 128-byte-swizzled s8
    descriptor gives, k32 chunk q at start + 32q bytes: the hardware XORs
    address bits 4-6 with bits 7-9 (the row within the 1024-byte atom)."""
    rows = np.arange(slot.shape[0])
    phys = np.arange(_ROW)[None, :] ^ ((rows[:, None] & 7) << 4)
    return slot[rows[:, None], phys]


def _load_a(rows, u, kq, k):
    """w8_load_a of unit u (step u >> 1, quarters 2v and 2v + 1) for the
    A rows given (zero past m are all-zero rows): chunk a (16 k) of row r
    holds k (2v + (a >> 2)) * kq + 128c + 64g + 16(a & 3), zero past k."""
    step, v = u >> 1, u & 1
    c, g = step >> 1, step & 1
    slot = np.zeros((rows.shape[0], _ROW), np.int8)
    for a in range(8):
        kn = (2 * v + (a >> 2)) * kq + 128 * c + 64 * g + 16 * (a & 3)
        run = (rows[:, kn:kn + 16] if kn < k
               else np.zeros((rows.shape[0], 16), np.int8))
        _store_chunks(slot, np.arange(rows.shape[0]), a, run)
    return slot


def _emulated_w4a8_tile(a_i8, arow, words, r_bits, acol, gs, k):
    """C = bf16(((f32(A8 @ B8) * arow) * acol) * gs) built unit by unit as
    w4a8_wgmma_tile builds it: wg_load_ws, w8_load_a, w8_words + w8_decode
    (per thread task: row parity p, the thread's columns), the s8
    descriptor reads, int sums in unit order, the epilogue."""
    m = a_i8.shape[0]
    kw, n = words.shape
    kp = kw * 8
    kq, srq = kp // 4, kp // 64
    cols = np.arange(n)
    acc = np.zeros((m, n), np.int64)
    for step in range(kp // _KSTEP):
        c, g = step >> 1, step & 1
        ws = np.stack([words[64 * c + 2 * g + 4 * (sr >> 1) + (sr & 1)]
                       for sr in range(_WROWS)]).astype(np.uint64)
        rs = np.stack([r_bits[j * srq + 8 * c + 4 * g + t]
                       for j in range(4) for t in range(4)]).astype(np.uint64)
        for v in range(2):
            a_slot = _load_a(a_i8, 2 * step + v, kq, k)
            b_slot = np.zeros((n, _ROW), np.int8)
            for p in range(2):                              # w8_words
                lo = [_prmt(ws[4 * y + p], ws[4 * y + 2 + p], 0x5410)
                      for y in range(8)]
                hi = [_prmt(ws[4 * y + p], ws[4 * y + 2 + p], 0x7632)
                      for y in range(8)]
                for j in (2 * v, 2 * v + 1):                # w8_quarter
                    base = 4 * (j - 2 * v)
                    for h, pairs in ((0, lo), (1, hi)):
                        s = rs[4 * j + 2 * p + h]
                        vals = _bytes(_chunk(pairs, _word(s, s), j))
                        _store_chunks(b_slot, cols, base + 2 * p + h, vals)
            a_q = _wgmma_read(a_slot).astype(np.int64)
            b_q = _wgmma_read(b_slot).astype(np.int64)
            acc += a_q @ b_q.T
    out = (((acc.astype(np.float32) * arow) * acol) * np.float32(gs))
    return _bf16_bits(out.astype(np.float32))


@pytest.mark.parametrize("fmt", ["nvfp4", "mxfp4", "zeros"])
def test_tile_body_data_movement_matches_jax_fused_mul_w4a8(fmt):
    """Ragged m (70) and n (336), k = 640 padded to 1024: four steps, eight
    units. The emulated body against the JAX package's fused_mul_w4a8 and
    the port's twin on the same bytes, bit for bit ("zeros": nvfp4 with
    three quarters of the weights the stored zero)."""
    m, n, k = 70, 336, 640
    d = (_zeroed_data(m, n, k, seed=5) if fmt == "zeros"
         else make_gemm_data(m, n, k, fmt, seed=5))
    eb = tsol.ElementB.MXFP4 if fmt == "mxfp4" else tsol.ElementB.NVFP4
    a = torch.from_numpy(d.a).to(torch.bfloat16)
    words = torch.from_numpy(d.words.view(np.int32))
    st = torch.from_numpy(d.scales_t.view(np.int16)).view(torch.bfloat16)
    gs = torch.tensor([d.global_scale], dtype=torch.float32)
    assert words.shape[0] * 8 // _KSTEP >= 2 and words.shape[0] * 8 > k
    r_t, acol = fused.w4a8_requant_constants(st)
    a_i8, arow = fused.quantize_activations(a)
    got = _emulated_w4a8_tile(
        a_i8.numpy(), arow.numpy(), d.words.view(np.uint32),
        r_t.view(torch.int16).numpy().view(np.uint16), acol.numpy(),
        d.global_scale, k)
    jsid = jsol.choose_default_solution(m, n, k, jsol.ElementB(int(eb)),
                                        jsol.MatmulType.INT8)
    want = jfused.fused_mul_w4a8(
        jnp.asarray(d.a, jnp.bfloat16), jnp.asarray(d.words),
        jnp.asarray(d.scales_t), jnp.float32(d.global_scale), sid=jsid,
        interpret=True)
    np.testing.assert_array_equal(got, np.array(want).view(np.uint16))
    twin = fused.fused_mul_w4a8_reference(
        a, words, st, gs, sid=tsol.SolutionId(64, 128, eb,
                                              tsol.MatmulType.INT8))
    np.testing.assert_array_equal(
        got, twin.view(torch.int16).numpy().view(np.uint16))


# ---- the ring --------------------------------------------------------------

@pytest.mark.parametrize("steps", [1, 2, 5, 16])
def test_ring_order_has_no_hazard(steps):
    """The plan's ring (tests/test_torch_wgmma.py's player): two units a
    step, one unit of A lookahead, three A and three B slots, one wgmma
    group left in flight."""
    assert _ring_faults(1, steps, a_slots=3, units=2) == []


@pytest.mark.parametrize("broken", [dict(a_slots=2), dict(b_slots=2),
                                    dict(mma_depth=2),
                                    dict(da=2, a_slots=4)])
def test_ring_player_finds_a_short_ring(broken):
    """One A slot or B slot fewer, one more wgmma group in flight, or a
    lookahead of two units, which the words' lead of one step (two units)
    cannot cover: the player finds the hazard, so the test above has
    teeth."""
    kw = {"da": 1, "a_slots": 3, **broken}
    assert _ring_faults(steps=3, units=2, **kw) != []


# ---- the weight cache: G m-tiles a CTA -------------------------------------

def _wc_group():
    """G of the weight cache's tiles: fp4_gemm.cuh's WC_GROUP, which
    pk_fp4_gemm_w4a8_wc dispatches (tests/test_torch_wgmma.py checks)."""
    with open(os.path.join(_CSRC, "fp4_gemm.cuh")) as f:
        return int(re.search(r"constexpr int WC_GROUP = (\d+);", f.read())[1])


def _share_cut(bn, g):
    """W8Share<bn, g>: the (thread, column, chunk A, quarter of the unit)
    writes of one unit. Thread t runs column t % bn, chunk A = (t / bn) %
    4 and, where one (column, chunk) has QS = 2 threads, quarter h = t /
    (4 bn) of the unit; else both quarters."""
    nth = 128 * g
    qs = nth // (bn * 4)
    assert qs in (1, 2) and qs * bn * 4 == nth
    out = []
    for t in range(nth):
        n, a, h = t % bn, (t // bn) % 4, t // (4 * bn)
        for jl in ((0, 1) if qs == 1 else (h,)):
            out.append((t, n, a, jl))
    return out


@pytest.mark.parametrize("bn", [64, 128])
def test_shared_requantization_writes_each_chunk_once(bn):
    """At the launcher's G (WC_GROUP): every (column, quarter of the unit,
    chunk) of a unit's B slot is written by exactly one thread, every one
    of the 128G threads writes, each the same number of chunks, and a
    warp's 32 threads share their chunk and quarters (no divergence)."""
    cut = _share_cut(bn, _wc_group())
    writes = Counter((n, jl, a) for _, n, a, jl in cut)
    assert set(writes) == {(n, jl, a) for n in range(bn) for jl in (0, 1)
                           for a in range(4)}
    assert set(writes.values()) == {1}
    per_thread = Counter(t for t, *_ in cut)
    assert sorted(per_thread) == list(range(128 * _wc_group()))
    assert len(set(per_thread.values())) == 1
    task = {}
    for t, _, a, jl in cut:
        task.setdefault(t, (a, set()))[1].add(jl)
    for w in range(4 * _wc_group()):
        assert len({(a, frozenset(q)) for t, (a, q) in task.items()
                    if t // 32 == w}) == 1


def _unit_b_slot(ws, rs, v, bn, g):
    """Unit v's B slot (bn rows of 128 int8 k) requantized as W8Share cuts
    it: thread task (column n, chunk A = 2p + e, quarter j = 2v + jl)
    takes half e of stage rows 4y + p and 4y + 2 + p (w8_words), R row 4j +
    A, and stores chunk 4jl + A of row n (w8_half)."""
    slot = np.zeros((bn, _ROW), np.int8)
    tasks = {}
    for _, n, a, jl in _share_cut(bn, g):
        tasks.setdefault((a, jl), []).append(n)
    for (a, jl), cols in tasks.items():
        cols = np.array(sorted(cols))
        p, e = a >> 1, a & 1
        pr = [_prmt(ws[4 * y + p, cols], ws[4 * y + 2 + p, cols],
                    0x7632 if e else 0x5410) for y in range(8)]
        j = 2 * v + jl
        s = rs[4 * j + a, cols]
        _store_chunks(slot, cols, 4 * jl + a,
                      _bytes(_chunk(pr, _word(s, s), j)))
    return slot


def _emulated_w4a8_wc(a_i8, arow, words, r_bits, acol, gs, k, bn, g):
    """pk_fp4_gemm_w4a8_wc's 64-row tiles: CTA (m-group, n-tile), m-groups
    first; each stages its n-tile's words and R (zero past n), copies the
    G*64 rows of its m-group into one A slot a unit (zero past m), and
    requantizes one B slot that the G warpgroups' descriptors read, each
    at its own 64 A rows; the epilogue stores rows < m and columns < n."""
    m = a_i8.shape[0]
    kw, n = words.shape
    kp = kw * 8
    kq, srq = kp // 4, kp // 64
    out = np.zeros((m, n), np.uint16)
    rows_g = g * 64
    for m0 in range(0, m, rows_g):
        rows = np.zeros((rows_g, a_i8.shape[1]), np.int8)
        rows[:min(rows_g, m - m0)] = a_i8[m0:m0 + rows_g]
        for n0 in range(0, n, bn):
            cols = np.arange(n0, n0 + bn)
            ok = cols < n
            wt = np.zeros((kw, bn), np.uint64)
            wt[:, ok] = words[:, cols[ok]]
            rt = np.zeros((r_bits.shape[0], bn), np.uint64)
            rt[:, ok] = r_bits[:, cols[ok]]
            acc = np.zeros((rows_g, bn), np.int64)
            for step in range(kp // _KSTEP):
                c, hf = step >> 1, step & 1
                ws = np.stack([wt[64 * c + 2 * hf + 4 * (sr >> 1) + (sr & 1)]
                               for sr in range(_WROWS)])
                rs = np.stack([rt[j * srq + 8 * c + 4 * hf + t]
                               for j in range(4) for t in range(4)])
                for v in range(2):
                    a_q = _wgmma_read(_load_a(rows, 2 * step + v, kq, k))
                    b_q = _wgmma_read(_unit_b_slot(ws, rs, v, bn, g))
                    for grp in range(g):     # warpgroup grp's descriptor
                        r = slice(64 * grp, 64 * grp + 64)
                        acc[r] += (a_q[r].astype(np.int64)
                                   @ b_q.astype(np.int64).T)
            keep = min(rows_g, m - m0)
            res = (((acc[:keep, ok].astype(np.float32)
                     * arow[m0:m0 + keep]) * acol[:, cols[ok]])
                   * np.float32(gs))
            out[m0:m0 + keep, cols[ok]] = _bf16_bits(res.astype(np.float32))
    return out


@pytest.mark.parametrize("m", [None, 200, 300])
@pytest.mark.parametrize("bn", [64, 128])
@pytest.mark.parametrize("fmt", ["nvfp4", "mxfp4", "zeros"])
def test_weight_cache_data_movement_matches_jax_weight_cache(fmt, bn, m):
    """The weight cache's tiles at the launcher's G (WC_GROUP):
    m one m-group (None: G*64), 200 (a partial last group at G = 4, rows
    past m zero) and 300 (a partial group after full ones); n = 336
    (a ragged last n-tile), k = 640 padded to 1024. The emulation against
    the JAX package's fused_mul_w4a8 with a weight-cache sid (64-row
    blocks, so its cache serves several m-blocks) and the port's twin,
    bit for bit."""
    g = _wc_group()
    m = m or 64 * g
    n, k = 336, 640
    d = (_zeroed_data(m, n, k, seed=9) if fmt == "zeros"
         else make_gemm_data(m, n, k, fmt, seed=9))
    eb = tsol.ElementB.MXFP4 if fmt == "mxfp4" else tsol.ElementB.NVFP4
    a = torch.from_numpy(d.a).to(torch.bfloat16)
    words = torch.from_numpy(d.words.view(np.int32))
    st = torch.from_numpy(d.scales_t.view(np.int16)).view(torch.bfloat16)
    gs = torch.tensor([d.global_scale], dtype=torch.float32)
    r_t, acol = fused.w4a8_requant_constants(st)
    a_i8, arow = fused.quantize_activations(a)
    got = _emulated_w4a8_wc(
        a_i8.numpy(), arow.numpy(), d.words.view(np.uint32),
        r_t.view(torch.int16).numpy().view(np.uint16), acol.numpy(),
        d.global_scale, k, bn, g)
    jsid = dataclasses.replace(
        jsol.choose_default_solution(m, n, k, jsol.ElementB(int(eb)),
                                     jsol.MatmulType.INT8),
        block_m=64, weight_cache=True)
    want = jfused.fused_mul_w4a8(
        jnp.asarray(d.a, jnp.bfloat16), jnp.asarray(d.words),
        jnp.asarray(d.scales_t), jnp.float32(d.global_scale), sid=jsid,
        interpret=True)
    np.testing.assert_array_equal(got, np.array(want).view(np.uint16))
    twin = fused.fused_mul_w4a8_reference(
        a, words, st, gs, sid=tsol.SolutionId(64, bn, eb, tsol.MatmulType.INT8,
                                              weight_cache=True))
    np.testing.assert_array_equal(
        got, twin.view(torch.int16).numpy().view(np.uint16))


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("steps", [1, 2, 5, 16])
def test_ring_order_has_no_hazard_at_g_warpgroups(g, steps):
    """The ring at G warpgroups: one A slot of G*64 rows and one B slot a
    unit for all G, each warpgroup retiring only its own wgmma groups; a
    slot is free once every warpgroup's reader is done."""
    assert _ring_faults(1, steps, a_slots=3, units=2,
                        mma_depth=(1,) * g) == []


@pytest.mark.parametrize("g", [2, 4])
def test_ring_player_finds_one_lagging_warpgroup(g):
    """One warpgroup of G that leaves two wgmma groups in flight while the
    others leave one: the shared B slot (and its rows of the A slot) is
    overwritten under its wgmma, and the player finds it."""
    assert _ring_faults(1, steps=3, a_slots=3, units=2,
                        mma_depth=(1,) * (g - 1) + (2,)) != []
