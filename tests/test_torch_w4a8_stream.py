"""The W4A8 GEMM's 16-row tiles, plain and weight cache, on the CPU.

fused_mul_w4a8's 16-row tiles run the split-k int8 stream body of
csrc/w4a8_stream.cuh (w4a8_stream_kernel<BN, G> in csrc/fp4_gemm_w4a8.cu,
G = 1 m-tile a CTA for the plain kernel, 4 for the weight cache). A CUDA
kernel has no CPU mode, so these tests hold what it is built from against
the JAX package, bit for bit (its integer sums are exact):

- the fragment requantization, the kernel's bit operations played in
  numpy: a thread's four stage rows 8tg + p + 2i made into half pairs by
  prmt, decode_pair, mul.rn.bf16x2 by the broadcast R of the chunk,
  requant4, give the int8 B fragments b[0] and b[1] of the k32 chunk
  (j, p), for all 16 codes at every byte position of every quarter and
  every bf16 r in [0, 127/6];
- the body's data movement played in numpy thread by thread, for G = 1
  and 4, BN = 64 and 128, nvfp4 and mxfp4: the stage as w8s_stage_load
  fills it (A rows of 272 bytes, zero past m and k, the words' 16-byte
  chunks swizzled by word_chunk, 16 R rows), the fragment loads
  (ldmatrix.x4 of A, the vector loads of words and R), the mma.sync
  m16n8k32 s8 fragments rebuilt into the 16 x 32 and 32 x 8 operands the
  hardware multiplies, the int32 partials of 1, 2 and kp / 256 splits
  packed into the workspace and summed in split order, the epilogue; at
  ragged m (1, 16, 37, 70), n (336) and k padded past itself (640 ->
  1024). The result must be the JAX package's fused_mul_w4a8 (Pallas,
  interpret mode; its weight cache for G = 4) and the port's twin;
- the ring order, played as events by tests/test_torch_wgmma.py's player
  with the words carried in each stage, at each instance's depth (the
  shared-memory plan of the header's static_asserts);
- the split rule (fused.w4a8_splits: stream_splits over the launch's
  CTAs, ceil(m / 64) m-groups for the weight cache) and fused_mul_w4a8's
  `splits` on CPU tensors, checked as on the card, ignored by the twin,
  refused above 1 at the 64-row tiles;
- the launcher: every 16-row tile of both entries on the stream body, the
  old mma.sync body gone, the C entries' arguments as ops/_build.py
  declares them.

Tolerance: 0 throughout. The kernel itself runs on the card:
tests/test_torch_cuda.py.
"""

import dataclasses
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petit_kernel_tpu.ops import solution as jsol
from petit_kernel_tpu.ops.kernels import fused as jfused
from petit_kernel_tpu.utils.testdata import make_gemm_data
from petit_kernel_tpu_torch.ops import _build
from petit_kernel_tpu_torch.ops import layout as tlayout
from petit_kernel_tpu_torch.ops import solution as tsol
from petit_kernel_tpu_torch.ops.kernels import fused
from test_torch_stream import _split_ranges
from test_torch_w4a8_wgmma import (_MAGS, _QUARTER_BITS, _bytes, _decode_word,
                                   _mul_bf16x2, _place, _prmt, _requant4,
                                   _u32, _word)
from test_torch_wgmma import _bf16_bits, _f32, _ring_faults

torch.set_num_threads(1)

_CSRC = os.path.join(os.path.dirname(__file__), os.pardir,
                     "petit_kernel_tpu_torch", "csrc")
_H100_SMS = 132
_KSTEP = 256        # natural k a step
_WROWS = 32         # packed word rows a step
_LDA = 272          # bytes of an A stage row (W8S_LDA)
_LLAMA8B_KN = ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096))


def _source(name):
    with open(os.path.join(_CSRC, name)) as f:
        return f.read()


# ---- the fragment requantization --------------------------------------------

def _fragments(ws, rs, tg, p, j):
    """b[0], b[1] of chunk (j, p) for thread tg of one B column: ws (32,
    ...) the column's stage word rows, rs (16, ...) its stage R rows, as
    w8s_stage_mma and w8s_chunk build them."""
    lo, hi = [], []
    for y in range(2):
        w0, w1 = ws[8 * tg + p + 4 * y], ws[8 * tg + p + 4 * y + 2]
        lo.append(_prmt(w0, w1, 0x5410))
        hi.append(_prmt(w0, w1, 0x7632))
    out = []
    for pairs, a in ((lo, 2 * p), (hi, 2 * p + 1)):
        s = rs[4 * j + a]
        rr = _word(s, s)
        out.append(_requant4(_mul_bf16x2(_decode_word(pairs[0], j), rr),
                             _mul_bf16x2(_decode_word(pairs[1], j), rr)))
    return out


@pytest.mark.parametrize("j", range(4))
def test_fragment_requantization_every_code_and_r(j):
    """One B column's 32 stage word rows hold quarter j's 64 natural
    offsets: slot half e of row r is offset 16(2(r & 1) + e) + (r >> 1).
    Offset o holds code (o + rot) % 16, so over 16 rotations every code
    sits at every offset and every byte position of both fragments; the
    other quarters' bits random; stage R row 4j + A (chunk A) runs over
    every bf16 r from -0, +0 to bf16(127/6), shifted by A. The bytes of
    b[0] (MMA k 4tg + i) and b[1] (16 + 4tg + i) of chunk (j, p) must be
    rne(bf16(decode * r)) of offsets 32p + 4tg + i and 32p + 16 + 4tg + i."""
    top = int(torch.tensor(127 / 6).to(torch.bfloat16).view(torch.int16))
    r_bits = np.concatenate([[0x8000], np.arange(top + 1)]).astype(np.uint64)
    rs = np.zeros((16, r_bits.size), np.uint64)
    for a in range(4):
        rs[4 * j + a] = np.roll(r_bits, 97 * a)
    rng = np.random.default_rng(j)
    codes = [(s, t) for s in (0, 1) for t in range(8)]
    for rot in range(16):
        code_of = [codes[(o + rot) % 16] for o in range(64)]
        half = np.zeros((32, 2), np.uint64)
        for r in range(32):
            for e in range(2):
                sg, t = code_of[16 * (2 * (r & 1) + e) + (r >> 1)]
                junk = int(rng.integers(0, 1 << 16)) & ~_QUARTER_BITS[j]
                half[r, e] = _place(sg, t, j) | junk
        ws = [np.full(r_bits.size, _word(half[r, 0], half[r, 1]), np.uint64)
              for r in range(32)]
        got = np.zeros((r_bits.size, 64), np.int8)
        for tg in range(4):
            for p in range(2):
                b0, b1 = _fragments(ws, rs, tg, p, j)
                got[:, 32 * p + 4 * tg:32 * p + 4 * tg + 4] = _bytes([b0])
                got[:, 32 * p + 16 + 4 * tg:32 * p + 20 + 4 * tg] = _bytes([b1])
        dec = np.array([(-1.0 if sg else 1.0) * _MAGS[t]
                        for sg, t in code_of], np.float32)
        r_of = np.stack([_f32(rs[4 * j + o // 16]) for o in range(64)], 1)
        b = torch.from_numpy(r_of * dec[None, :]).to(torch.bfloat16)
        want = torch.round(b.float()).to(torch.int8).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"rot {rot}")


# ---- the data movement -------------------------------------------------------

def _word_chunk(r, c):
    """fp4_stream.cuh word_chunk: the physical 16-byte chunk of word chunk
    c in stage row r."""
    return c ^ (((r >> 3) & 3) << 1)


def _stage(a_i8, words, r_bits, k, m0, step, bn, g):
    """w8s_stage_load for the CTAs of every n-tile at once: A (16g, 272)
    int8, words (tiles, 32, bn), R (tiles, 16, bn)."""
    m = a_i8.shape[0]
    kw, n = words.shape
    kp = kw * 8
    kq, srq = kp // 4, kp // 64
    c, h = divmod(step, 2)
    a_st = np.zeros((16 * g, _LDA), np.int8)
    rows = np.arange(16 * g)
    ok_rows = rows[m0 + rows < m]
    for a in range(16):
        kn = (a >> 2) * kq + 128 * c + 64 * h + 16 * (a & 3)
        if kn < k:
            a_st[ok_rows, 16 * a:16 * a + 16] = a_i8[m0 + ok_rows, kn:kn + 16]
    tiles = -(-n // bn)
    cols = np.arange(tiles * bn)
    ok = cols < n
    wrow = [64 * c + 2 * h + 4 * (r >> 1) + (r & 1) for r in range(_WROWS)]
    w_nat = np.zeros((_WROWS, tiles * bn), np.uint64)
    w_nat[:, ok] = words[wrow][:, cols[ok]]
    w_nat = w_nat.reshape(_WROWS, tiles, bn // 4, 4)
    w_st = np.zeros_like(w_nat)
    for r in range(_WROWS):
        w_st[r, :, _word_chunk(r, np.arange(bn // 4))] = w_nat[r].transpose(
            1, 0, 2)
    rrow = [(r >> 2) * srq + 8 * c + 4 * h + (r & 3)
            for r in range(_WROWS // 2)]
    r_st = np.zeros((_WROWS // 2, tiles * bn), np.uint64)
    r_st[:, ok] = r_bits[rrow][:, cols[ok]]
    return (a_st, w_st.reshape(_WROWS, tiles, bn).transpose(1, 0, 2),
            r_st.reshape(_WROWS // 2, tiles, bn).transpose(1, 0, 2))


_LANES = np.arange(32)


def _ldmatrix_x4(a_st, byte0):
    """ldmatrix.sync.aligned.m8n8.x4.b16 with lane l's address at row
    (l & 15), byte byte0 + 16(l >> 4): matrix i's rows are lanes 8i ..
    8i + 7's addresses, and lane t receives bytes 4(t % 4) .. + 3 of its
    row t / 4 -> (32, 4) uint32."""
    rows, cols = _LANES & 15, byte0 + 16 * (_LANES >> 4)
    regs = np.zeros((32, 4), np.uint64)
    for i in range(4):
        src = 8 * i + (_LANES >> 2)
        b = np.stack([a_st[rows[src], cols[src] + 4 * (_LANES & 3) + x]
                      for x in range(4)], 1).astype(np.uint8)
        regs[:, i] = np.ascontiguousarray(b).view(np.uint32).ravel()
    return regs


def _as_bytes(regs):
    """uint32 (..., ) -> int8 (..., 4), byte x at position x."""
    return np.ascontiguousarray(_u32(regs).astype(np.uint32)).view(
        np.int8).reshape(*np.shape(regs), 4)


def _mma_s8(a, b0, b1):
    """mma.sync m16n8k32 s8 on fragments, warp by warp: a (32, 4) uint32
    A fragments of the lanes, b0 and b1 (..., 32) B fragments of each warp
    -> (..., 32, 4) int64 products. A[g][4tg + x] is byte x of lane (g,
    tg)'s a[0], rows g + 8 a[1], k + 16 a[2] and a[3]; B[4tg + x][g] byte
    x of b[0], k + 16 of b[1]; lane (g, tg) receives D[g][2tg], D[g][2tg +
    1], D[g + 8][2tg], D[g + 8][2tg + 1]."""
    g, tg = _LANES >> 2, _LANES & 3
    ab = _as_bytes(a).astype(np.int64)                     # (32, 4 regs, 4)
    amat = np.zeros((16, 32), np.int64)
    for reg, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 16), (8, 16))):
        for x in range(4):
            amat[g + dr, dk + 4 * tg + x] = ab[:, reg, x]
    bmat = np.zeros((*b0.shape[:-1], 32, 8), np.int64)
    for regs, dk in ((b0, 0), (b1, 16)):
        bb = _as_bytes(regs).astype(np.int64)               # (..., 32, 4)
        for x in range(4):
            bmat[..., dk + 4 * tg + x, g] = bb[..., x]
    d = np.einsum("mk,...kn->...mn", amat, bmat)
    return np.stack([d[..., g, 2 * tg], d[..., g, 2 * tg + 1],
                     d[..., g + 8, 2 * tg], d[..., g + 8, 2 * tg + 1]], -1)


def _stage_mma(a_st, w_st, r_st, bn, g):
    """w8s_stage_mma for the 4 warps of every n-tile's CTA at once: the
    threads' accumulators (tiles, 4 warps, 32 lanes, g m-tiles, NT slices,
    4) of one step."""
    nt = bn // 32
    wn = np.arange(4)[:, None]
    tg = _LANES & 3
    wcol = wn * (bn // 4) + (_LANES >> 2) * nt                # (4, 32)
    tiles = w_st.shape[0]
    acc = np.zeros((tiles, 4, 32, g, nt, 4), np.int64)
    for p in range(2):
        lo = np.zeros((2, nt, tiles, 4, 32), np.uint64)
        hi = np.zeros((2, nt, tiles, 4, 32), np.uint64)
        for y in range(2):
            r0 = 8 * tg + p + 4 * y
            r1 = r0 + 2
            for jn in range(nt):
                w = [w_st[:, r, _word_chunk(r, wcol >> 2) * 4 + (wcol & 3) + jn]
                     for r in (r0, r1)]
                lo[y, jn] = _prmt(w[0], w[1], 0x5410)
                hi[y, jn] = _prmt(w[0], w[1], 0x7632)
        for j in range(4):
            frags = [_ldmatrix_x4(a_st[16 * mt:16 * mt + 16], 64 * j + 32 * p)
                     for mt in range(g)]
            for jn in range(nt):
                s0 = r_st[:, 4 * j + 2 * p, wcol + jn]
                s1 = r_st[:, 4 * j + 2 * p + 1, wcol + jn]
                b = []
                for pairs, s in ((lo, s0), (hi, s1)):
                    rr = _word(s, s)
                    b.append(_requant4(
                        _mul_bf16x2(_decode_word(pairs[0, jn], j), rr),
                        _mul_bf16x2(_decode_word(pairs[1, jn], j), rr)))
                for mt in range(g):
                    acc[..., mt, jn, :] += _mma_s8(frags[mt], b[0], b[1])
    return acc


def _reduce(parts, g, nt):
    """reduce_splits_i32: each split's accumulators packed into its
    [g][2][NT/2][128] int4 workspace block (x, y, z, w = acc[mt][2p][2h],
    acc[mt][2p][2h + 1], acc[mt][2p + 1][2h], acc[mt][2p + 1][2h + 1]),
    summed in split order in int32 and unpacked."""
    npart = nt // 2
    ws = np.zeros((len(parts), g, 2, npart, 128, 4), np.int64)
    for s, acc in enumerate(parts):
        thr = acc.reshape(128, g, nt, 4)          # thread = 32 * warp + lane
        for h in range(2):
            for p in range(npart):
                ws[s, :, h, p] = np.stack(
                    [thr[:, :, 2 * p, 2 * h], thr[:, :, 2 * p, 2 * h + 1],
                     thr[:, :, 2 * p + 1, 2 * h],
                     thr[:, :, 2 * p + 1, 2 * h + 1]], -1).transpose(1, 0, 2)
    assert ws[0].size == 16 * g * 32 * nt       # 16G x BN int32 a split
    total = ws[0].copy()
    for s in range(1, len(parts)):
        total = total + ws[s]
        assert np.abs(total).max() < 2 ** 31     # no int32 overflow
    out = np.zeros((128, g, nt, 4), np.int64)
    for h in range(2):
        for p in range(npart):
            t = total[:, h, p].transpose(1, 0, 2)      # (128, g, 4)
            out[:, :, 2 * p, 2 * h] = t[..., 0]
            out[:, :, 2 * p, 2 * h + 1] = t[..., 1]
            out[:, :, 2 * p + 1, 2 * h] = t[..., 2]
            out[:, :, 2 * p + 1, 2 * h + 1] = t[..., 3]
    return out.reshape(4, 32, g, nt, 4)


def _tile_of(acc, bn, g):
    """The threads' accumulators as the (16g, bn) tile: lane (gg, tg) of
    warp wn holds, in acc[mt][jn][e + 2h], row 16mt + gg + 8h and column
    wn*bn/4 + (2tg + e)*NT + jn (w8s_store); every element exactly once."""
    nt = bn // 32
    tile = np.zeros((16 * g, bn), np.int64)
    seen = np.zeros((16 * g, bn), np.int64)
    gg, tg = _LANES >> 2, _LANES & 3
    for wn in range(4):
        for mt in range(g):
            for jn in range(nt):
                for e4 in range(4):
                    h, e = e4 >> 1, e4 & 1
                    row = 16 * mt + gg + 8 * h
                    col = wn * (bn // 4) + (2 * tg + e) * nt + jn
                    tile[row, col] = acc[wn, :, mt, jn, e4]
                    seen[row, col] += 1
    assert (seen == 1).all()
    return tile


def _emulated_stream(a_i8, arow, words, r_bits, acol, gs, k, bn, g,
                     split_counts):
    """w4a8_stream_kernel<bn, g> at each split count: CTA (n-tile, split,
    m-group); each runs its split's steps through the stage and the MMAs,
    the partials meet in reduce_splits_i32, the epilogue stores rows < m
    and columns < n. -> {splits: bf16 bits (m, n)}."""
    m = a_i8.shape[0]
    kw, n = words.shape
    steps = kw * 8 // _KSTEP
    nt = bn // 32
    outs = {s: np.zeros((m, n), np.uint16) for s in split_counts}
    for m0 in range(0, m, 16 * g):
        per_step = [_stage_mma(*_stage(a_i8, words, r_bits, k, m0, s, bn, g),
                               bn, g) for s in range(steps)]
        for splits, out in outs.items():
            parts = [sum(per_step[s0:s1]) for s0, s1 in
                     _split_ranges(steps, splits)]
            for t, n0 in enumerate(range(0, n, bn)):
                acc = (parts[0][t] if splits == 1
                       else _reduce([pt[t] for pt in parts], g, nt))
                tile = _tile_of(acc, bn, g)
                rows = min(16 * g, m - m0)
                cols = min(bn, n - n0)
                res = (((tile[:rows, :cols].astype(np.float32)
                         * arow[m0:m0 + rows]) * acol[:, n0:n0 + cols])
                       * np.float32(gs))
                out[m0:m0 + rows, n0:n0 + cols] = _bf16_bits(
                    res.astype(np.float32))
    return outs


@pytest.mark.parametrize("g", [1, fused.WC_GROUP])
@pytest.mark.parametrize("bn", [64, 128])
@pytest.mark.parametrize("fmt", ["nvfp4", "mxfp4"])
def test_stream_body_data_movement_matches_jax(fmt, bn, g):
    """m = 1, 16, 37 and 70, n = 336 (a ragged last n-tile), k = 640
    padded to 1024 (four steps): the emulated body at 1, 2 and 4 splits
    against the JAX package's fused_mul_w4a8 (its weight cache at 16-row
    blocks for g = 4, where m > 16) and the port's twin, the wrapper with
    the same splits on CPU tensors too, bit for bit."""
    n, k = 336, 640
    eb = tsol.ElementB.MXFP4 if fmt == "mxfp4" else tsol.ElementB.NVFP4
    for m in (1, 16, 37, 70):
        d = make_gemm_data(m, n, k, fmt, seed=m + bn + g)
        a = torch.from_numpy(d.a).to(torch.bfloat16)
        words = torch.from_numpy(d.words.view(np.int32))
        st = torch.from_numpy(d.scales_t.view(np.int16)).view(torch.bfloat16)
        gs = torch.tensor([d.global_scale], dtype=torch.float32)
        kp = words.shape[0] * 8
        assert kp > k and kp // _KSTEP == 4
        r_t, acol = fused.w4a8_requant_constants(st)
        a_i8, arow = fused.quantize_activations(a)
        jsid = jsol.choose_default_solution(m, n, k, jsol.ElementB(int(eb)),
                                            jsol.MatmulType.INT8)
        if g > 1 and m > 16:
            jsid = dataclasses.replace(jsid, block_m=16, weight_cache=True)
        want = np.array(jfused.fused_mul_w4a8(
            jnp.asarray(d.a, jnp.bfloat16), jnp.asarray(d.words),
            jnp.asarray(d.scales_t), jnp.float32(d.global_scale), sid=jsid,
            interpret=True)).view(np.uint16)
        tsid = tsol.SolutionId(16, bn, eb, tsol.MatmulType.INT8,
                               weight_cache=g > 1)
        twin = fused.fused_mul_w4a8_reference(a, words, st, gs, sid=tsid)
        np.testing.assert_array_equal(
            twin.view(torch.int16).numpy().view(np.uint16), want)
        got = _emulated_stream(
            a_i8.numpy(), arow.numpy(), d.words.view(np.uint32),
            r_t.view(torch.int16).numpy().view(np.uint16), acol.numpy(),
            d.global_scale, k, bn, g, (1, 2, 4))
        for splits in (1, 2, 4):
            what = f"{fmt} m={m} bn={bn} g={g} splits={splits}"
            np.testing.assert_array_equal(got[splits], want, err_msg=what)
            cpu = fused.fused_mul_w4a8(a, words, st, gs, sid=tsid,
                                       splits=splits)
            np.testing.assert_array_equal(
                cpu.view(torch.int16).numpy().view(np.uint16), want,
                err_msg=what)


def test_a_fragments_read_natural_k_and_hit_every_bank():
    """The ldmatrix.x4 of chunk (j, p) gives lane (g, tg) a[0] = row g,
    stage bytes 64j + 32p + 4tg .. + 3 (natural offsets 32p + 4tg .. of
    quarter j), a[1] row g + 8, a[2] and a[3] 16 bytes on; and each of its
    8-row phases (rows 272 bytes apart) covers all 32 banks once."""
    addr = np.arange(16 * _LDA).reshape(16, _LDA)
    a_st = (addr & 0xFF).astype(np.uint8).view(np.int8)
    g, tg = _LANES >> 2, _LANES & 3
    for j in range(4):
        for p in range(2):
            regs = _ldmatrix_x4(a_st, 64 * j + 32 * p)
            for reg, (dr, db) in enumerate(((0, 0), (8, 0), (0, 16),
                                            (8, 16))):
                first = (g + dr) * _LDA + 64 * j + 32 * p + db + 4 * tg
                want = ((first[:, None] + np.arange(4)) & 0xFF).astype(
                    np.uint8)
                got = _as_bytes(regs[:, reg]).view(np.uint8)
                np.testing.assert_array_equal(got, want)
    for i in range(4):
        rows = 8 * (i & 1) + np.arange(8)
        banks = {((r * _LDA + 16 * (i >> 1)) // 4 + x) % 32
                 for r in rows for x in range(4)}
        assert len(banks) == 32


@pytest.mark.parametrize("bn", [64, 128])
def test_word_loads_of_a_warp_spread_over_the_banks(bn):
    """A warp's vector load of its lanes' NT words of stage row 8tg + p +
    2i (w8s_stage_mma; NT = 2 or 4): with word_chunk's swizzle the 32NT
    words fall NT to a bank, the fewest a load of that size can put on
    one (without it the four tg, rows 8 apart, share banks)."""
    nt = bn // 32
    for wn in range(4):
        for p in range(2):
            for i in range(4):
                tg = _LANES & 3
                r = 8 * tg + p + 2 * i
                wcol = wn * (bn // 4) + (_LANES >> 2) * nt
                addr = (r * bn + _word_chunk(r, wcol >> 2) * 4
                        + (wcol & 3))[:, None] + np.arange(nt)[None]
                counts = np.bincount((addr % 32).ravel(), minlength=32)
                assert (counts == nt).all(), (wn, p, i, counts)


# ---- the ring ----------------------------------------------------------------

def _plan():
    """The (BN, G) -> (stage bytes, stages) pairs the header pins with its
    static_assert."""
    text = _source("w4a8_stream.cuh")
    got = {}
    for bn, g, what, v in re.findall(
            r"W8sPlan<(\d+), (\d+)>::(stage|stages) == (\d+)", text):
        got.setdefault((int(bn), int(g)), {})[what] = int(v)
    return got


def test_shared_memory_plan_fits_two_ctas_an_sm():
    """Stage bytes (16G rows of 272, 32 word rows and 16 R rows of BN) and
    the deepest ring within 113 KB, as the header computes and pins them."""
    plan = _plan()
    assert set(plan) == {(64, 1), (128, 1), (64, 4), (128, 4)}
    for (bn, g), p in plan.items():
        stage = 16 * g * _LDA + _WROWS * bn * 4 + _WROWS // 2 * bn * 2
        assert p["stage"] == stage and stage % 128 == 0
        assert p["stages"] == 113 * 1024 // stage >= 3


@pytest.mark.parametrize("bn,g", [(64, 1), (128, 1), (64, 4), (128, 4)])
@pytest.mark.parametrize("steps", [1, 2, 4, 14, 56])
def test_ring_order_has_no_hazard(bn, g, steps):
    """w8s_stream: STAGES - 1 stages loaded ahead, a wait for all but
    STAGES - 2 groups and one barrier a step, the MMAs done within the
    step; the player with the words in each stage."""
    stages = _plan()[bn, g]["stages"]
    assert _ring_faults(stages - 1, steps, a_slots=stages, mma_depth=0,
                        units=1, words=False) == []


@pytest.mark.parametrize("broken", [dict(a_slots=3), dict(da=4)])
def test_ring_player_finds_a_short_ring(broken):
    """A ring one stage short, or a wait that leaves one group too many in
    flight: the player finds the hazard, so the test above has teeth."""
    kw = {"da": 3, "a_slots": 4, **broken}
    assert _ring_faults(steps=6, mma_depth=0, units=1, words=False,
                        **kw) != []


# ---- the split rule and the wrapper ------------------------------------------

@pytest.mark.parametrize("wc", [False, True])
@pytest.mark.parametrize("bn", [64, 128])
@pytest.mark.parametrize("m", [1, 16, 17, 32, 64, 65, 128])
@pytest.mark.parametrize("k,n", _LLAMA8B_KN)
def test_w4a8_splits_fill_one_wave_of_the_launch(k, n, m, bn, wc):
    """The most splits whose CTAs (m-tiles of 16 rows, or of 64 for the
    weight cache, times n-tiles) fit one wave of two per SM, or one; 1 at
    block_m = 64."""
    kp = tlayout.padded_k(k)
    steps = kp // _KSTEP
    sid = tsol.SolutionId(16, bn, tsol.ElementB.NVFP4, tsol.MatmulType.INT8,
                          weight_cache=wc)
    splits = fused.w4a8_splits(m, n, kp, sid, _H100_SMS)
    assert 1 <= splits <= steps
    ctas = -(-m // (64 if wc else 16)) * -(-n // bn)
    assert ctas * splits <= 2 * _H100_SMS or splits == 1
    assert splits == steps or ctas * (splits + 1) > 2 * _H100_SMS
    assert fused.w4a8_splits(m, n, kp, dataclasses.replace(sid, block_m=64),
                             _H100_SMS) == 1


def test_w4a8_splits_at_the_llama_shapes():
    """16x64 on 132 SMs: the plain tile at m = 16 and the weight cache at m
    = 64 (one m-group) both get fp4_gemm's m = 8 counts (wqkv 2, wo 4,
    w_gate_up 1, w_down 4); the weight cache at m = 128 two m-groups."""
    def counts(m, wc):
        sid = tsol.SolutionId(16, 64, tsol.ElementB.NVFP4,
                              tsol.MatmulType.INT8, weight_cache=wc)
        return [fused.w4a8_splits(m, n, k, sid, _H100_SMS)
                for k, n in _LLAMA8B_KN]
    assert counts(16, False) == counts(64, True) == [2, 4, 1, 4]
    assert counts(128, True) == counts(32, False) == [1, 2, 1, 2]


def _operands(m=5, n=128, k=640, fmt="nvfp4", seed=3):
    d = make_gemm_data(m, n, k, fmt, seed=seed)
    words = torch.from_numpy(d.words.view(np.int32))
    st = torch.from_numpy(d.scales_t.view(np.int16)).view(torch.bfloat16)
    a = torch.from_numpy(d.a).to(torch.bfloat16)
    gs = torch.tensor([d.global_scale], dtype=torch.float32)
    return a, words, st, gs


@pytest.mark.parametrize("wc", [False, True])
@pytest.mark.parametrize("splits", [None, 1, 3, 4])
def test_fused_mul_w4a8_cpu_splits_return_the_twin(splits, wc):
    a, words, st, gs = _operands(m=70)
    sid = tsol.SolutionId(16, 64, tsol.ElementB.NVFP4, tsol.MatmulType.INT8,
                          weight_cache=wc)
    want = fused.fused_mul_w4a8_reference(a, words, st, gs, sid=sid)
    got = fused.fused_mul_w4a8(a, words, st, gs, sid=sid, splits=splits)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("wc", [False, True])
@pytest.mark.parametrize("bad", [0, 5, 1.0, "2", (1, 2)])
def test_fused_mul_w4a8_cpu_rejects_bad_splits(bad, wc):
    """kp 1024: four steps, so 5 is one split too many."""
    a, words, st, gs = _operands(m=70)
    sid = tsol.SolutionId(16, 64, tsol.ElementB.NVFP4, tsol.MatmulType.INT8,
                          weight_cache=wc)
    with pytest.raises(ValueError, match="splits"):
        fused.fused_mul_w4a8(a, words, st, gs, sid=sid, splits=bad)


@pytest.mark.parametrize("wc", [False, True])
@pytest.mark.parametrize("bn", [64, 128])
def test_fused_mul_w4a8_cpu_64_row_tiles_take_one_split(bn, wc):
    a, words, st, gs = _operands(m=300)
    sid = tsol.SolutionId(64, bn, tsol.ElementB.NVFP4, tsol.MatmulType.INT8,
                          weight_cache=wc)
    assert fused.fused_mul_w4a8(a, words, st, gs, sid=sid,
                                splits=1).shape == (300, 128)
    for call in (fused.fused_mul_w4a8, fused.fused_mul_w4a8_wc):
        with pytest.raises(ValueError, match="do not split"):
            call(a, words, st, gs, sid=sid, splits=2)


# ---- the launcher ------------------------------------------------------------

def test_launcher_runs_every_16_row_tile_on_the_stream_body():
    """Both entries' 16-row tiles launch w4a8_stream_kernel<BN, G>, the
    weight cache at WC_GROUP, which fused.WC_GROUP names for the wrapper's
    split rule and workspace; the old mma.sync s8 body is gone."""
    text = _source("fp4_gemm_w4a8.cu")
    for bn in (64, 128):
        assert re.search(rf"block_m == 16 && block_n == {bn}\)\s*err = "
                         rf"launch_stream<{bn}, G>", text)
    assert "w4a8_stream_kernel<BN, G><<<" in text
    group = int(re.search(r"constexpr int WC_GROUP = (\d+);",
                          _source("fp4_gemm.cuh"))[1])
    assert group == fused.WC_GROUP
    for name in os.listdir(_CSRC):
        src = _source(name)
        for gone in ("fp4_gemm_w4a8_kernel", "LDB8", "requant<",
                     "w4a8_smem_bytes"):
            assert gone not in src, (name, gone)


@pytest.mark.parametrize("entry", ["pk_fp4_gemm_w4a8", "pk_fp4_gemm_w4a8_wc"])
def test_c_entries_take_the_declared_arguments(entry):
    """The extern "C" entry's parameters, pointers and ints in order, are
    the ctypes signature ops/_build.py gives it."""
    text = _source("fp4_gemm_w4a8.cu")
    params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', text)[1]
    kinds = ["p" if "*" in p else "i" for p in params.split(",")]
    want = ["p" if t is _build._P else "i" for t in _build.SIGNATURES[entry]]
    assert kinds == want
