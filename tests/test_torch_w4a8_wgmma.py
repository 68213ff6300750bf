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
  ring that is too short.

The dispatch of every solution tile by fp4_gemm_w4a8.cu is checked with the
other launchers in tests/test_torch_wgmma.py; the kernel itself runs on the
card: tests/test_torch_cuda.py.
"""

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
            a_slot = np.zeros((m, _ROW), np.int8)
            for a in range(8):                              # w8_load_a
                kn = (2 * v + (a >> 2)) * kq + 128 * c + 64 * g + 16 * (a & 3)
                run = (a_i8[:, kn:kn + 16] if kn < k
                       else np.zeros((m, 16), np.int8))
                _store_chunks(a_slot, np.arange(m), a, run)
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
