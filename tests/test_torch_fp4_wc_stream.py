"""The FP4 GEMM's 16-row tiles on the stream body, plain and weight cache.

fused_mul's and fused_mul_wc's 16-row tiles run the split-k stream body of
csrc/fp4_stream.cuh (fp4_stream_kernel<BN, G> in csrc/fp4_gemm.cu: G = 1
m-tile a CTA for the plain GEMM, G = WC_GROUP = 4 for the weight cache,
whose CTA shares each decoded B fragment among the MMAs of several
m-tiles). A CUDA kernel has no CPU mode, so these tests hold what it is
built from against the JAX package:

- the body's data movement played in numpy thread by thread, at G = 1 and
  4: the stage as fp4_stage_load fills it (A rows in the
  step's local k order, zero past m and k, the words' 16-byte chunks
  swizzled by word_chunk, the 32 scale rows), ldmatrix.x4's A fragments,
  the prmt word pairs and decode_pair<J> of each quarter, the scale
  broadcast and mul.rn.bf16x2 into the mma.sync m16n8k16 B fragments, the
  fragments rebuilt into the 16 x 16 and 16 x 8 operands the hardware
  multiplies, f32 split partials packed into the workspace and summed in
  split order, the epilogue; at BN = 64 and 128, nvfp4 and mxfp4, m = 1,
  16, 17, 63, 64, 65 and 130, n = 336 (a ragged last n-tile), k = 640
  padded to 1024 (four steps), 1, 2 and 4 splits. The result is held
  against the JAX package's fused_mul (Pallas, interpret mode; its weight
  cache at 16-row blocks where m > 16) and the port's twin at the GEMM
  tolerance: rtol 2^-7, atol 2^-8 * max|ref|, since both sum the same exact
  products in f32, in other orders, and round once to bf16 (the play sums
  each MMA's 16 products exactly and rounds once into its f32
  accumulator, a model of the tensor core's sum);
- the operands each m-tile's MMAs receive, exactly: at G = 4 the same A
  and B fragments, chunk for chunk and slice for slice, as the G = 1 play
  gives that m-tile, so on the card the weight cache's output is the plain
  tile's bit for bit at the same split count;
- the shared-memory plan (FsPlan's static_asserts, read from the source)
  and the ring order, played as events by tests/test_torch_wgmma.py's
  player at each instance's depth;
- the split rule (fused.fp4_wc_splits: stream_splits over ceil(m / 64)
  m-groups and the CTAs an SM the plan holds) at the Llama-3-8B shapes,
  and fused_mul's
  and fused_mul_wc's `splits` on CPU tensors: checked as on the card,
  ignored by the twin, refused above 1 at the 64-row tiles;
- the launcher: every 16-row tile of both entries on fp4_stream_kernel,
  the old tile body gone, the C entries' arguments as ops/_build.py
  declares them.

The kernel itself runs on the card: tests/test_torch_cuda.py.
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
from test_torch_w4a8_stream import _LANES, _word_chunk
from test_torch_w4a8_wgmma import _decode_word, _mul_bf16x2, _prmt, _u32
from test_torch_wgmma import _bf16_bits, _f32, _ring_faults

torch.set_num_threads(1)

_CSRC = os.path.join(os.path.dirname(__file__), os.pardir,
                     "petit_kernel_tpu_torch", "csrc")
_H100_SMS = 132
_KSTEP = 256        # natural k a step
_WROWS = 32         # packed word rows a step
_LDS = 264          # bf16 of an A stage row (LDS)
_LLAMA8B_KN = ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096))
_MS = (1, 16, 17, 63, 64, 65, 130)


def _source(name):
    with open(os.path.join(_CSRC, name)) as f:
        return f.read()


def _plan():
    """{(BN, G): {stage, stages, per_sm}} as the header's static_assert
    pins FsPlan."""
    got = {}
    for bn, g, what, v in re.findall(
            r"FsPlan<(\d+), (\d+)>::(stage|stages|per_sm) == (\d+)",
            _source("fp4_stream.cuh")):
        got.setdefault((int(bn), int(g)), {})[what] = int(v)
    return got


# ---- the data movement -------------------------------------------------------

def _stage(a_bits, words, s_bits, k, m0, step, bn, rows):
    """fp4_stage_load (and zero_rows) for the CTAs of every n-tile at once:
    A (rows, LDS) bf16 bits, words (tiles, 32, bn), scales (tiles, 32,
    bn)."""
    m = a_bits.shape[0]
    kw, n = words.shape
    kp = kw * 8
    kq, srq = kp // 4, kp // 64
    c, hf = divmod(step, 2)
    a_st = np.zeros((rows, _LDS), np.uint16)
    r = np.arange(rows)
    ok_rows = r[m0 + r < m]
    for run in range(32):
        kn = (run >> 3) * kq + c * 128 + (run & 7) * 16 + hf * 8
        if kn < k:
            a_st[ok_rows, 8 * run:8 * run + 8] = a_bits[m0 + ok_rows, kn:kn + 8]
    tiles = -(-n // bn)
    cols = np.arange(tiles * bn)
    ok = cols < n
    w_nat = np.zeros((_WROWS, tiles * bn), np.uint64)
    w_nat[:, ok] = words[step * _WROWS:(step + 1) * _WROWS][:, cols[ok]]
    w_nat = w_nat.reshape(_WROWS, tiles, bn // 4, 4)
    w_st = np.zeros_like(w_nat)
    for rr in range(_WROWS):
        w_st[rr, :, _word_chunk(rr, np.arange(bn // 4))] = w_nat[rr].transpose(
            1, 0, 2)
    srow = [(rr >> 3) * srq + c * 8 + (rr & 7) for rr in range(_WROWS)]
    s_st = np.zeros((_WROWS, tiles * bn), np.uint64)
    s_st[:, ok] = s_bits[srow][:, cols[ok]]
    return (a_st, w_st.reshape(_WROWS, tiles, bn).transpose(1, 0, 2),
            s_st.reshape(_WROWS, tiles, bn).transpose(1, 0, 2))


def _ldmatrix_x4(a_st, row0, col0):
    """ldmatrix.sync.aligned.m8n8.x4.b16 with lane l's address at row row0
    + (l & 15), bf16 column col0 + 8(l >> 4): matrix i's rows are lanes 8i
    .. 8i + 7's addresses, and lane t receives bf16 2(t % 4), 2(t % 4) + 1
    of its row t / 4 -> (32, 4) uint32."""
    rows, cols = row0 + (_LANES & 15), col0 + 8 * (_LANES >> 4)
    regs = np.zeros((32, 4), np.uint64)
    for i in range(4):
        src = 8 * i + (_LANES >> 2)
        lo = a_st[rows[src], cols[src] + 2 * (_LANES & 3)]
        hi = a_st[rows[src], cols[src] + 2 * (_LANES & 3) + 1]
        regs[:, i] = lo.astype(np.uint64) | (hi.astype(np.uint64) << 16)
    return regs


def _halves_f32(regs):
    """uint32 registers -> (..., 2) f32 of their bf16 halves, low first."""
    r = _u32(regs)
    return np.stack([_f32((r & 0xFFFF).astype(np.uint16)),
                     _f32((r >> 16).astype(np.uint16))], -1)


def _mma_bf16(a, b0, b1):
    """mma.sync m16n8k16 bf16 on fragments, for each warp: a (W, 32, 4)
    uint32 A fragments of the lanes, b0 and b1 (T, W, 32) B fragments ->
    the exact (T, W, 32, 4) f64 sums of 16 products. A[g][2tg + x] is half
    x of lane (g, tg)'s a[0], rows g + 8 a[1], k + 8 a[2] and a[3];
    B[2tg + x][g] half x of b[0], k + 8 of b[1]; lane (g, tg) receives
    D[g][2tg], D[g][2tg + 1], D[g + 8][2tg], D[g + 8][2tg + 1]."""
    g, tg = _LANES >> 2, _LANES & 3
    ah = _halves_f32(a).astype(np.float64)            # (W, 32, 4 regs, 2)
    amat = np.zeros((a.shape[0], 16, 16))
    for reg, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        for x in range(2):
            amat[:, g + dr, dk + 2 * tg + x] = ah[:, :, reg, x]
    bmat = np.zeros((*b0.shape[:-1], 16, 8))
    for regs, dk in ((b0, 0), (b1, 8)):
        bh = _halves_f32(regs).astype(np.float64)      # (T, W, 32, 2)
        for x in range(2):
            bmat[..., dk + 2 * tg + x, g] = bh[..., x]
    d = np.einsum("wmk,twkn->twmn", amat, bmat)
    return np.stack([d[..., g, 2 * tg], d[..., g, 2 * tg + 1],
                     d[..., g + 8, 2 * tg], d[..., g + 8, 2 * tg + 1]], -1)


def _word(lo, hi):
    return _u32(np.asarray(lo, np.uint64) | (np.asarray(hi, np.uint64) << 16))


def _stage_mma(a_st, w_st, s_st, bn, g, seq):
    """fp4_stage_mma for the four warps of every n-tile's CTA at once: the
    step's sums (tiles, 4 warps, 32 lanes, G, NT, 4) f32, each MMA's exact
    sum rounded once into its f32 accumulator; each MMA's operands (A and
    B registers, (tiles, 32, 6)) appended to seq[(m-tile, jn, wn)], the
    m-tile counted within the CTA. Warp wn takes column quarter wn of all
    G m-tiles."""
    nt = bn // 32
    wn = np.arange(4)[:, None]
    tg = _LANES & 3
    wcol = wn * (bn // 4) + (_LANES >> 2) * nt                # (4, 32)
    tiles = w_st.shape[0]
    acc = np.zeros((tiles, 4, 32, g, nt, 4), np.float32)
    lo, hi = [], []     # per q, jn: the prmt word pairs, (tiles, 4, 32)
    for q in range(4):
        r0 = 8 * tg + q
        w0, w1 = [[w_st[:, r, _word_chunk(r, wcol >> 2) * 4 + (wcol & 3) + jn]
                   for jn in range(nt)] for r in (r0, r0 + 4)]
        lo.append([_prmt(w0[jn], w1[jn], 0x5410) for jn in range(nt)])
        hi.append([_prmt(w0[jn], w1[jn], 0x7632) for jn in range(nt)])
    for j in range(4):
        for q in range(4):
            kk = 4 * j + q
            # A: one ldmatrix.x4 for each m-tile, rows 16mt apart, bf16
            # 16kk .., the same for every warp
            frags = [np.broadcast_to(_ldmatrix_x4(a_st, 16 * mt, 16 * kk),
                                     (4, 32, 4)) for mt in range(g)]
            for jn in range(nt):
                b = []
                for half, row in ((lo, 8 * j + 2 * q), (hi, 8 * j + 2 * q + 1)):
                    # the thread's scale word of columns jn & ~1, jn | 1,
                    # its column jn's half broadcast by prmt
                    sw = _word(s_st[:, row, wcol + (jn & ~1)],
                               s_st[:, row, wcol + (jn | 1)])
                    bc = _prmt(sw, 0, 0x3232 if jn & 1 else 0x1010)
                    b.append(_mul_bf16x2(_decode_word(half[q][jn], j), bc))
                for mt in range(g):
                    d = _mma_bf16(frags[mt], b[0], b[1])
                    acc[..., mt, jn, :] = (acc[..., mt, jn, :].astype(
                        np.float64) + d).astype(np.float32)
                    ops = np.concatenate(
                        [np.broadcast_to(frags[mt], (tiles, 4, 32, 4)),
                         b[0][..., None], b[1][..., None]], -1)
                    for w in range(4):
                        seq.setdefault((mt, jn, w), []).append(
                            ops[:, w].astype(np.uint32))
    return acc


def _reduce(parts, g, bn):
    """reduce_splits: each split's accumulators (128 threads, G, NT, 4)
    packed into its [G][2][NT/2][128] float4 workspace block, every slot
    written once, 16G x BN floats a split, summed in split order in f32
    and unpacked."""
    nt, nth = bn // 32, 128
    npart = nt // 2
    block = g * 2 * npart * nth
    ws = np.full((len(parts) * block, 4), np.nan, np.float32)
    written = np.zeros(len(parts) * block, np.int64)
    tid = np.arange(nth)
    for s, acc in enumerate(parts):
        for mt in range(g):
            for h in range(2):
                for p in range(npart):
                    idx = (((s * g + mt) * 2 + h) * npart + p) * nth + tid
                    ws[idx] = np.stack(
                        [acc[:, mt, 2 * p, 2 * h], acc[:, mt, 2 * p, 2 * h + 1],
                         acc[:, mt, 2 * p + 1, 2 * h],
                         acc[:, mt, 2 * p + 1, 2 * h + 1]], -1)
                    written[idx] += 1
    assert (written == 1).all()
    assert block * 4 == 16 * g * bn
    out = np.zeros((nth, g, nt, 4), np.float32)
    for mt in range(g):
        for h in range(2):
            for p in range(npart):
                src = ((mt * 2 + h) * npart + p) * nth + tid
                total = ws[src].copy()
                for s in range(1, len(parts)):
                    total = (total + ws[src + s * block]).astype(np.float32)
                out[:, mt, 2 * p, 2 * h] = total[:, 0]
                out[:, mt, 2 * p, 2 * h + 1] = total[:, 1]
                out[:, mt, 2 * p + 1, 2 * h] = total[:, 2]
                out[:, mt, 2 * p + 1, 2 * h + 1] = total[:, 3]
    return out


def _tile_of(acc, bn, g):
    """The threads' accumulators (4 warps, 32, G, NT, 4) as the (16G, bn)
    tile: lane (gg, tg) of warp w holds, in acc[mt][jn][e + 2h], row 16mt
    + gg + 8h and column w bn/4 + (2tg + e) NT + jn (fp4_stream_store);
    every element exactly once."""
    nt = bn // 32
    tile = np.zeros((16 * g, bn), np.float32)
    seen = np.zeros((16 * g, bn), np.int64)
    gg, tg = _LANES >> 2, _LANES & 3
    for w in range(4):
        for mt in range(g):
            for jn in range(nt):
                for e4 in range(4):
                    h, e = e4 >> 1, e4 & 1
                    row = 16 * mt + gg + 8 * h
                    col = w * (bn // 4) + (2 * tg + e) * nt + jn
                    tile[row, col] = acc[w, :, mt, jn, e4]
                    seen[row, col] += 1
    assert (seen == 1).all()
    return tile


def _emulated_stream(a_bits, words, s_bits, gs, k, bn, g, split_counts):
    """fp4_stream_kernel<bn, g> at each split count:
    CTA (n-tile, split, m-group); each runs its split's steps through the
    stage and the MMAs, the partials meet in reduce_splits, the epilogue
    stores bf16(acc * gs) at rows < m and columns < n. -> ({splits: bf16
    bits (m, n)}, {(m-tile, jn, wn): operands of its MMAs over all steps,
    in order})."""
    m = a_bits.shape[0]
    kw, n = words.shape
    steps = kw * 8 // _KSTEP
    nt = bn // 32
    outs = {s: np.zeros((m, n), np.uint16) for s in split_counts}
    sequences = {}
    for m0 in range(0, m, 16 * g):
        seq = {}
        per_step = [_stage_mma(*_stage(a_bits, words, s_bits, k, m0, s, bn,
                                       16 * g), bn, g, seq)
                    for s in range(steps)]
        for (mt, jn, wn), ops in seq.items():
            sequences[(m0 // 16 + mt, jn, wn)] = np.stack(ops)
        for splits, out in outs.items():
            # a split's accumulators run on across its steps (the play adds
            # each step's sums in f32: a model of the same f32 sum)
            parts = [sum(per_step[s0:s1], np.zeros_like(per_step[0]))
                     .astype(np.float32)
                     for s0, s1 in _split_ranges(steps, splits)]
            for t, n0 in enumerate(range(0, n, bn)):
                if splits == 1:
                    acc = parts[0][t]
                else:
                    acc = _reduce([p[t].reshape(128, g, nt, 4)
                                   for p in parts], g, bn).reshape(
                                       4, 32, g, nt, 4)
                tile = _tile_of(acc, bn, g)
                rows, cols = min(16 * g, m - m0), min(bn, n - n0)
                out[m0:m0 + rows, n0:n0 + cols] = _bf16_bits(
                    tile[:rows, :cols] * np.float32(gs))
    return outs, sequences


_JAX_OUT = {}


def _jax_fused_mul(fmt, m, n, k, seed):
    """The JAX package's fused_mul on make_gemm_data(m, n, k, fmt, seed)
    (Pallas, interpret mode), its weight cache at 16-row blocks where m >
    16 (the weight cache needs two m-blocks), the plain kernel else."""
    key = (fmt, m, n, k, seed)
    if key not in _JAX_OUT:
        d = make_gemm_data(m, n, k, fmt, seed=seed)
        eb = jsol.ElementB.MXFP4 if fmt == "mxfp4" else jsol.ElementB.NVFP4
        jsid = jsol.choose_default_solution(m, n, k, eb)
        if m > 16:
            jsid = dataclasses.replace(jsid, block_m=16, weight_cache=True)
        _JAX_OUT[key] = (d, np.asarray(jfused.fused_mul(
            jnp.asarray(d.a, jnp.bfloat16), jnp.asarray(d.words),
            jnp.asarray(d.scales_t), jnp.float32(d.global_scale), sid=jsid,
            interpret=True), np.float32))
    return _JAX_OUT[key]


def _assert_gemm_close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               rtol=2 ** -7,
                               atol=2 ** -8 * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("bn", [64, 128])
@pytest.mark.parametrize("fmt", ["nvfp4", "mxfp4"])
def test_stream_body_data_movement_matches_jax(fmt, bn):
    """The emulated body at G = 1 and 4, at 1, 2 and 4 splits, against the
    JAX package's fused_mul and the port's twin; fused_mul and
    fused_mul_wc with the same splits on CPU tensors too. At G = 4 every
    m-tile's MMAs receive the G = 1 play's operands for that m-tile,
    exactly."""
    n, k = 336, 640
    for m in _MS:
        d, want = _jax_fused_mul(fmt, m, n, k, seed=m + 7)
        a = torch.from_numpy(d.a).to(torch.bfloat16)
        a_bits = a.view(torch.int16).numpy().view(np.uint16)
        words = torch.from_numpy(d.words.view(np.int32))
        st = torch.from_numpy(d.scales_t.view(np.int16)).view(torch.bfloat16)
        gs = torch.tensor([d.global_scale], dtype=torch.float32)
        kp = words.shape[0] * 8
        assert kp > k and kp // _KSTEP == 4
        eb = tsol.ElementB.MXFP4 if fmt == "mxfp4" else tsol.ElementB.NVFP4
        twin = fused.fused_mul_reference(a, words, st, gs, sid=None)
        _assert_gemm_close(twin.float().numpy(), want, f"twin m={m}")
        plays = {}
        for g in (1, 4):
            got, plays[g] = _emulated_stream(
                a_bits, d.words.view(np.uint32), d.scales_t.view(np.uint16),
                d.global_scale, k, bn, g, (1, 2, 4))
            for splits, bits in got.items():
                what = f"{fmt} m={m} bn={bn} g={g} splits={splits}"
                _assert_gemm_close(_f32(bits), want, what)
        assert set(plays[4]) >= set(plays[1])
        for key in plays[1]:
            np.testing.assert_array_equal(
                plays[4][key], plays[1][key],
                err_msg=f"m-tile, slice, warp {key}")
        for splits in (1, 2, 4):
            for wc in (False, True):
                sid = tsol.SolutionId(16, bn, eb, weight_cache=wc)
                cpu = fused.fused_mul(a, words, st, gs, sid=sid,
                                      splits=splits)
                assert torch.equal(cpu.view(torch.int16),
                                   twin.view(torch.int16))


def test_a_fragments_read_the_stage_rows_of_each_m_tile():
    """ldmatrix.x4 at m-tile mt, chunk kk gives lane (g, tg) a[0] = stage
    row 16mt + g, bf16 16kk + 2tg and + 1; a[1] row + 8; a[2] and a[3] 8
    bf16 on: the m16n8k16 A fragment of rows 16mt .. 16mt + 15."""
    addr = np.arange(64 * _LDS).reshape(64, _LDS)
    a_st = (addr & 0xFFFF).astype(np.uint16)
    g, tg = _LANES >> 2, _LANES & 3
    for mt in range(4):
        for kk in range(16):
            regs = _ldmatrix_x4(a_st, 16 * mt, 16 * kk)
            for reg, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
                first = (16 * mt + g + dr) * _LDS + 16 * kk + dc + 2 * tg
                np.testing.assert_array_equal(
                    _u32(regs[:, reg]), (first & 0xFFFF) | (((first + 1)
                                                            & 0xFFFF) << 16))


def test_fragments_hold_the_natural_k_of_the_chunk():
    """Word rows 8tg + q and + 4 of a step, halves 0 and 1, hold the
    natural k of MMA k 2tg, 2tg + 1, 8 + 2tg and 9 + 2tg of chunk 4j + q
    (the layout of ops/layout.py), which the A stage row holds at the same
    MMA k: B and A meet at the same natural k, in every step."""
    kp = 2048
    kq = kp // 4
    for step in range(kp // _KSTEP):
        c, hf = divmod(step, 2)
        for j in range(4):
            for q in range(4):
                for tg in range(4):
                    for hword, rr in ((0, 8 * tg + q), (1, 8 * tg + q + 4)):
                        for h in range(2):
                            r = step * _WROWS + rr
                            ii = 2 * (r % 64) + h
                            k_w = (j * kq + (r // 64) * 128 + (ii % 8) * 16
                                   + ii // 8)
                            i = 8 * h + 2 * tg + hword       # MMA k
                            L = 16 * (4 * j + q) + i          # local k
                            a_, x = (L % 64) // 8, L % 8
                            k_a = (L // 64) * kq + c * 128 + a_ * 16 \
                                + 8 * hf + x
                            assert k_w == k_a, (step, j, q, tg, rr, h)


# ---- the plan and the ring ---------------------------------------------------

def test_shared_memory_plan_is_the_headers():
    """FsPlan as the header pins it: stage bytes 16G A rows of 528 bytes,
    32 word rows and 32 scale rows of BN; the one-m-tile ring 4 and 3
    stages, two CTAs an SM; the weight cache's ring within the 232,448
    bytes one block may use, as many CTAs an SM as fit in 228 KB (1 KB
    reserved each), what fused.FP4_WC_PER_SM tells the split rule."""
    plan = _plan()
    assert set(plan) == {(64, 4), (128, 4)}
    text = _source("fp4_stream.cuh")
    assert "BN == 64 ? 4 : 3" in text        # stream_stages, G = 1
    for (bn, g), p in plan.items():
        stage = 16 * g * _LDS * 2 + _WROWS * bn * 4 + _WROWS * bn * 2
        assert p["stage"] == stage and stage % 128 == 0
        assert p["stage"] == {64: 46080, 128: 58368}[bn]
        assert 2 <= p["stages"] and p["stages"] * stage <= 232448
        assert p["per_sm"] == fused.FP4_WC_PER_SM[bn]
        assert p["per_sm"] == 228 * 1024 // (p["stages"] * stage + 1024)
    group = int(re.search(r"constexpr int WC_GROUP = (\d+);",
                          _source("fp4_gemm.cuh"))[1])
    assert group == fused.WC_GROUP == 4


@pytest.mark.parametrize("bn,g", [(64, 1), (128, 1), (64, 4), (128, 4)])
@pytest.mark.parametrize("steps", [1, 2, 4, 14, 56])
def test_ring_order_has_no_hazard(bn, g, steps):
    """fp4_stream: STAGES - 1 stages loaded ahead, a wait for all but
    STAGES - 2 groups and one barrier a step, the MMAs done within the
    step; the player with the words in each stage, at each instance's
    depth."""
    stages = {64: 4, 128: 3}[bn] if g == 1 else _plan()[bn, g]["stages"]
    assert _ring_faults(stages - 1, steps, a_slots=stages, mma_depth=0,
                        units=1, words=False) == []


# ---- the split rule and the wrappers -----------------------------------------

@pytest.mark.parametrize("bn", [64, 128])
@pytest.mark.parametrize("m", [1, 16, 17, 32, 64, 65, 128])
@pytest.mark.parametrize("k,n", _LLAMA8B_KN)
def test_fp4_wc_splits_fill_one_wave_of_the_launch(k, n, m, bn):
    """The most splits whose CTAs (ceil(m / 64) m-groups times n-tiles)
    fit one wave of the plan's CTAs an SM (two at 16x64, one at 16x128),
    or one; 1 at block_m = 64."""
    kp = tlayout.padded_k(k)
    steps = kp // _KSTEP
    sid = tsol.SolutionId(16, bn, weight_cache=True)
    splits = fused.fp4_wc_splits(m, n, kp, sid, _H100_SMS)
    assert 1 <= splits <= steps
    ctas, slots = -(-m // 64) * -(-n // bn), {64: 2, 128: 1}[bn] * _H100_SMS
    assert ctas * splits <= slots or splits == 1
    assert splits == steps or ctas * (splits + 1) > slots
    assert fused.fp4_wc_splits(m, n, kp, dataclasses.replace(sid, block_m=64),
                               _H100_SMS) == 1


def test_fp4_wc_splits_at_the_llama_shapes():
    """m = 64, one m-group, on 132 SMs: 16x64 (264 slots) gives wqkv 2
    (192 CTAs), wo 4 (256), w_gate_up 1 (448), w_down 4 (256); 16x128 (132
    slots) wqkv 2 (96), wo 4 (128), w_gate_up 1 (224), w_down 4; m = 128
    (two m-groups) halves them."""
    def counts(m, bn):
        sid = tsol.SolutionId(16, bn, weight_cache=True)
        return [fused.fp4_wc_splits(m, n, k, sid, _H100_SMS)
                for k, n in _LLAMA8B_KN]
    assert counts(64, 64) == counts(64, 128) == [2, 4, 1, 4]
    assert counts(128, 64) == counts(128, 128) == [1, 2, 1, 2]


def test_one_split_body_for_the_stream_rules():
    """fp4_wc_splits and w4a8_splits are stream_splits over their launch's
    CTAs: one m-group of 64 rows counts as one m-tile, at the CTAs an SM
    of each plan."""
    for k, n in _LLAMA8B_KN:
        kp = tlayout.padded_k(k)
        for bn in (64, 128):
            sid = tsol.SolutionId(16, bn, tsol.ElementB.NVFP4,
                                  tsol.MatmulType.INT8, weight_cache=True)
            assert fused.w4a8_splits(64, n, kp, sid, _H100_SMS) == \
                fused.stream_splits(16, n, 0, kp, 16, bn, _H100_SMS)[0]
            assert fused.fp4_wc_splits(64, n, kp, sid, _H100_SMS) == \
                fused.stream_splits(16, n, 0, kp, 16, bn, _H100_SMS,
                                    fused.FP4_WC_PER_SM[bn])[0]


def _operands(m=70, n=128, k=640, fmt="nvfp4", seed=3):
    d = make_gemm_data(m, n, k, fmt, seed=seed)
    words = torch.from_numpy(d.words.view(np.int32))
    st = torch.from_numpy(d.scales_t.view(np.int16)).view(torch.bfloat16)
    a = torch.from_numpy(d.a).to(torch.bfloat16)
    gs = torch.tensor([d.global_scale], dtype=torch.float32)
    return a, words, st, gs


_ENTRIES = {"fused_mul": fused.fused_mul, "fused_mul_wc": fused.fused_mul_wc}


@pytest.mark.parametrize("entry", sorted(_ENTRIES))
@pytest.mark.parametrize("splits", [None, 1, 3, 4])
def test_weight_cache_cpu_splits_return_the_twin(splits, entry):
    a, words, st, gs = _operands()
    sid = tsol.SolutionId(16, 64, weight_cache=True)
    want = fused.fused_mul_reference(a, words, st, gs, sid=sid)
    got = _ENTRIES[entry](a, words, st, gs, sid=sid, splits=splits)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("entry", sorted(_ENTRIES))
@pytest.mark.parametrize("bad", [0, 5, 1.0, "2", (1, 2)])
def test_weight_cache_cpu_rejects_bad_splits(bad, entry):
    """kp 1024: four steps, so 5 is one split too many."""
    a, words, st, gs = _operands()
    with pytest.raises(ValueError, match="splits"):
        _ENTRIES[entry](a, words, st, gs,
                        sid=tsol.SolutionId(16, 64, weight_cache=True),
                        splits=bad)


@pytest.mark.parametrize("entry", sorted(_ENTRIES))
@pytest.mark.parametrize("bn", [64, 128])
def test_weight_cache_cpu_64_row_tiles_take_one_split(bn, entry):
    a, words, st, gs = _operands(m=300)
    sid = tsol.SolutionId(64, bn, weight_cache=True)
    assert _ENTRIES[entry](a, words, st, gs, sid=sid,
                           splits=1).shape == (300, 128)
    with pytest.raises(ValueError, match="do not split"):
        _ENTRIES[entry](a, words, st, gs, sid=sid, splits=2)


# ---- the launcher ------------------------------------------------------------

def test_launcher_runs_every_16_row_tile_on_the_stream_body():
    """Both entries' 16-row tiles launch fp4_stream_kernel<BN, G>, the
    weight cache at WC_GROUP; the first tile body (fp4_gemm_tile and its
    kernel and launchers) is gone from every source."""
    text = _source("fp4_gemm.cu")
    for bn in (64, 128):
        assert re.search(rf"block_m == 16 && block_n == {bn}\)\s*err = "
                         rf"launch_stream<{bn}, G>", text)
    assert "fp4_stream_kernel<BN, G><<<" in text
    for entry, g in (("pk_fp4_gemm", "1"), ("pk_fp4_gemm_wc", "WC_GROUP")):
        assert re.search(rf"{entry}\([^{{]*\{{\s*return dispatch<{g}>", text)
    assert "splits != 1 && block_m != 16" in text
    for name in os.listdir(_CSRC):
        src = _source(name)
        for gone in ("fp4_gemm_tile", "fp4_gemm_kernel", "launch_decode",
                     "launch<16, BN, G>"):
            assert gone not in src, (name, gone)
        assert not re.search(r"(?<![\w])smem_bytes<", src), name


@pytest.mark.parametrize("entry", ["pk_fp4_gemm", "pk_fp4_gemm_wc"])
def test_c_entries_take_the_declared_arguments(entry):
    """The extern "C" entry's parameters, pointers and ints in order, are
    the ctypes signature ops/_build.py gives it."""
    text = _source("fp4_gemm.cu")
    params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', text)[1]
    kinds = ["p" if "*" in p else "i" for p in params.split(",")]
    want = ["p" if t is _build._P else "i" for t in _build.SIGNATURES[entry]]
    assert kinds == want
