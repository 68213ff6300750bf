"""The high-precision FP4 GEMM's 16-row tiles on the stream body's f32 form.

fused_mul_hp's and fused_mul_hp_wc's 16-row tiles run
fp4_hp_stream_kernel<BN, G> (csrc/fp4_gemm_hp.cu) on the f32-A form of the
split-k stream body, csrc/fp4_stream.cuh: G = 1 m-tile a CTA for the plain
GEMM, G = HP_WC_GROUP = 2 for the weight cache, whose CTA feeds each
decoded B fragment to the MMAs of both m-tiles. A CUDA kernel has no CPU
mode, so these tests hold what it is built from against the JAX package:

- the body played in numpy thread by thread, at G = 1 and 2: the f32 stage
  as hp_stage_load fills it (A rows in the step's local k order, two
  16-byte pieces a run, zero past m and k; the words and scales as the bf16
  stream loads them), each lane's four float2 of a chunk split by split3
  (bit for bit fused.split_bf16x3), the B fragments from the prmt word
  pairs, decode_pair and mul.rn.bf16x2, the fragments rebuilt into the
  16 x 16 and 16 x 8 operands the hardware multiplies, each MMA modelled as
  the exact sum of its 16 products plus its accumulator rounded once to
  f32, the three MMAs of a chunk (lo, mid, hi) into a fresh part and one
  __fadd_rn into acc, chunk by chunk, the f32 split partials through the
  workspace summed in split order, the epilogue f32(acc * gs); at BN = 64
  and 128, nvfp4 and mxfp4, m = 1, 8, 16, 17, 33, 64 and 65, n = 336 (a
  ragged last n-tile), k = 640 padded to 1024 (four steps), 1, 2 and 4
  splits. The result is held against the f64 product under the
  high-precision rule (4 max|f32 library - f64| + 2^-24 max(|A| @ |B|)
  |gs|, the f32 library being the port's twin fused_mul_hp_reference) and
  against the JAX package's fused_mul with a high_precision sid (Pallas,
  interpret mode; its weight cache at 16-row blocks where m > 16) within
  2^-20 max(|A| @ |B|) |gs|, the rule tests/test_torch_solutions.py holds
  the two packages' hp entries to;
- the operands each m-tile's MMAs receive, exactly: at G = 2 the A and B
  fragments of the G = 1 play, chunk for chunk, so on the card the weight
  cache's output is the plain tile's bit for bit at the same split count;
- the plan (HpPlan's static_asserts, read from the source), the banks of
  the float2 fragment loads and the ring order, played as events by
  tests/test_torch_wgmma.py's player at each instance's depth;
- the split rule (fused.hp_splits: stream_splits over the launch's CTAs at
  the CTAs an SM the plan holds) at the Llama-3-8B shapes, and the hp
  wrappers' `splits` on CPU tensors: checked as on the card, ignored by the
  twin, refused above 1 at the 64-row tiles;
- the launcher: the 16-row ids of both entries on fp4_hp_stream_kernel, the
  64-row ones on fp4_hp_wgmma_kernel (csrc/fp4_hp_wgmma.cuh, held by
  tests/test_torch_hp_wgmma.py), the C entries' arguments as ops/_build.py
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
from test_torch_fp4_wc_stream import (_halves_f32, _reduce, _stage,
                                      _tile_of)
from test_torch_stream import _split_ranges
from test_torch_w4a8_stream import _LANES, _word_chunk
from test_torch_w4a8_wgmma import _decode_word, _mul_bf16x2, _prmt, _u32
from test_torch_wgmma import _bf16_bits, _ring_faults

torch.set_num_threads(1)

_CSRC = os.path.join(os.path.dirname(__file__), os.pardir,
                     "petit_kernel_tpu_torch", "csrc")
_H100_SMS = 132
_KSTEP = 256        # natural k a step
_WROWS = 32         # packed word rows a step
_LDS = 264          # f32 of an hp A stage row (LDS)
_LLAMA8B_KN = ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096))
_MS = (1, 8, 16, 17, 33, 64, 65)
_G, _TG = _LANES >> 2, _LANES & 3


def _source(name):
    with open(os.path.join(_CSRC, name)) as f:
        return f.read()


def _plan():
    """{(BN, G): {stage, stages, per_sm}} as the header's static_assert
    pins HpPlan."""
    got = {}
    for bn, g, what, v in re.findall(
            r"HpPlan<(\d+), (\d+)>::(stage|stages|per_sm) == (\d+)",
            _source("fp4_stream.cuh")):
        got.setdefault((int(bn), int(g)), {})[what] = int(v)
    return got


# ---- the data movement -------------------------------------------------------

def _split3(pair):
    """split3 on (..., 2) f32 values -> the (hi, mid, lo) registers, uint32
    with the first value in the low half: hi and mid truncated, lo rounded
    to nearest even (both differences exact in f32)."""
    pair = np.ascontiguousarray(pair, np.float32)
    h = pair.view(np.uint32) & np.uint32(0xFFFF0000)
    r = pair - h.view(np.float32)
    mbits = r.view(np.uint32) & np.uint32(0xFFFF0000)
    lo = _bf16_bits(r - mbits.view(np.float32)).astype(np.uint64)

    def pack(b0, b1):
        return _u32(np.asarray(b0, np.uint64) | (np.asarray(b1, np.uint64)
                                                 << 16))
    return (pack(h[..., 0] >> 16, h[..., 1] >> 16),
            pack(mbits[..., 0] >> 16, mbits[..., 1] >> 16),
            pack(lo[..., 0], lo[..., 1]))


def _hp_stage(a, words, s_bits, k, m0, step, bn, rows):
    """hp_stage_load (and zero_rows) for the CTAs of every n-tile at once:
    A (rows, LDS) f32, each run of 8 natural k as two 16-byte pieces of 4
    (zero past m and k); the words (tiles, 32, bn) and scales (tiles, 32,
    bn) as hp_stage_load_b fills them."""
    m = a.shape[0]
    kp = words.shape[0] * 8
    kq = kp // 4
    c, hf = divmod(step, 2)
    a_st = np.zeros((rows, _LDS), np.float32)
    r = np.arange(rows)
    ok_rows = r[m0 + r < m]
    for run in range(32):
        for p in range(2):
            kn = (run >> 3) * kq + c * 128 + (run & 7) * 16 + hf * 8 + 4 * p
            if kn < k:
                a_st[ok_rows, 8 * run + 4 * p:8 * run + 4 * p + 4] = \
                    a[m0 + ok_rows, kn:kn + 4]
    _, w_st, s_st = _stage(np.zeros((m, k), np.uint16), words, s_bits, k,
                           m0, step, bn, rows)
    return a_st, w_st, s_st


def _a_fragments(a_st, g):
    """hp_a_frag for every m-tile mt and chunk kk: lane (g, tg) loads the
    float2 at row 16mt + g (+ 8), local k 16kk + 2tg (+ 8) and splits it ->
    registers (3 parts hi, mid, lo; G, 16 chunks, 32 lanes, 4) uint32. The
    split is held bit for bit against fused.split_bf16x3."""
    rows = 16 * np.arange(g)[:, None, None] + _G[None, None]
    cols = 16 * np.arange(16)[None, :, None] + 2 * _TG[None, None]
    regs = np.zeros((3, g, 16, 32, 4), np.uint64)
    for reg, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        pair = np.stack([a_st[rows + dr, cols + dc],
                         a_st[rows + dr, cols + dc + 1]], -1)
        for part, got in enumerate(_split3(pair)):
            regs[part, ..., reg] = got
        want = fused.split_bf16x3(torch.from_numpy(pair))
        for part in range(3):
            bits = want[part].view(torch.int16).numpy().view(np.uint16)
            np.testing.assert_array_equal(
                regs[part, ..., reg],
                bits[..., 0].astype(np.uint64)
                | (bits[..., 1].astype(np.uint64) << 16))
    return regs


def _a_matrix(regs):
    """A fragment registers (..., 32 lanes, 4) -> the (..., 16, 16) f64
    operand: A[g][2tg + x] is half x of lane (g, tg)'s a[0], rows g + 8
    a[1], k + 8 a[2] and a[3]."""
    ah = _halves_f32(regs).astype(np.float64)
    mat = np.zeros((*regs.shape[:-2], 16, 16))
    for reg, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        for x in range(2):
            mat[..., _G + dr, dk + 2 * _TG + x] = ah[..., reg, x]
    return mat


def _b_fragments(w_st, s_st, bn):
    """hp_word_pairs and hp_b_frag for the four warps of every n-tile's
    CTA: registers (tiles, 4 warps, NT slices, 16 chunks, 32 lanes, 2)."""
    nt = bn // 32
    wcol = np.arange(4)[:, None] * (bn // 4) + _G * nt        # (4, 32)
    regs = np.zeros((w_st.shape[0], 4, nt, 16, 32, 2), np.uint64)
    pairs = []     # per q, jn: (lo, hi) word pairs, (tiles, 4, 32)
    for q in range(4):
        r0 = 8 * _TG + q
        w0, w1 = [[w_st[:, r, _word_chunk(r, wcol >> 2) * 4 + (wcol & 3) + jn]
                   for jn in range(nt)] for r in (r0, r0 + 4)]
        pairs.append([(_prmt(w0[jn], w1[jn], 0x5410),
                       _prmt(w0[jn], w1[jn], 0x7632)) for jn in range(nt)])
    for j in range(4):
        for q in range(4):
            for jn in range(nt):
                for h, row in enumerate((8 * j + 2 * q, 8 * j + 2 * q + 1)):
                    sw = _u32(s_st[:, row, wcol + (jn & ~1)]
                              | (s_st[:, row, wcol + (jn | 1)] << 16))
                    bc = _prmt(sw, 0, 0x3232 if jn & 1 else 0x1010)
                    regs[:, :, jn, 4 * j + q, :, h] = _mul_bf16x2(
                        _decode_word(pairs[q][jn][h], j), bc)
    return regs


def _b_matrix(regs):
    """B fragment registers (..., 32 lanes, 2) -> the (..., 16, 8) f64
    operand: B[2tg + x][g] is half x of b[0], B[8 + 2tg + x][g] of b[1]."""
    mat = np.zeros((*regs.shape[:-2], 16, 8))
    for h in range(2):
        bh = _halves_f32(regs[..., h]).astype(np.float64)
        for x in range(2):
            mat[..., 8 * h + 2 * _TG + x, _G] = bh[..., x]
    return mat


def _thread_acc(acc):
    """(tiles, 4 warps, NT, G, 16, 8) accumulator matrices -> the threads'
    registers (tiles, 4, 32, G, NT, 4): lane (g, tg) holds D[g][2tg],
    D[g][2tg + 1], D[g + 8][2tg], D[g + 8][2tg + 1]."""
    regs = [acc[..., _G + 8 * (e >> 1), 2 * _TG + (e & 1)] for e in range(4)]
    # each (tiles, 4, NT, G, 32) -> (tiles, 4, 32, G, NT)
    return np.stack([r.transpose(0, 1, 4, 3, 2) for r in regs], -1)


def _emulated_hp(a, words, s_bits, gs, k, bn, g, split_counts):
    """fp4_hp_stream_kernel<bn, g> at each split count: CTA (n-tile, split,
    m-group) runs its split's steps, chunk by chunk, through the stage, the
    fragments and the MMAs; the partials meet in reduce_splits, the
    epilogue stores f32(acc * gs) at rows < m and columns < n. Every CTA of
    a step decodes the same B fragments (the step's words and scales), so
    the play builds them once a step. -> ({splits: f32 (m, n)}, {m-tile:
    (A registers, B registers) over all steps})."""
    m = a.shape[0]
    kw, n = words.shape
    steps = kw * 8 // _KSTEP
    nt = bn // 32
    outs = {s: np.zeros((m, n), np.float32) for s in split_counts}
    operands, b_regs, b_mats = {}, [], []
    for s in range(steps):
        _, w_st, s_st = _hp_stage(a, words, s_bits, k, 0, s, bn, 16)
        b_regs.append(_b_fragments(w_st, s_st, bn))
        # (16 chunks, 16 k, tiles * 4 warps * NT * 8 columns)
        b_mats.append(_b_matrix(b_regs[-1]).transpose(3, 4, 0, 1, 2, 5)
                      .reshape(16, 16, -1))
    tiles = b_regs[0].shape[0]
    for m0 in range(0, m, 16 * g):
        sums, a_ops = [], []
        for s in range(steps):
            a_st = _hp_stage(a, words, s_bits, k, m0, s, bn, 16 * g)[0]
            a_ops.append(_a_fragments(a_st, g))
            # (3 parts, 16 chunks, 16G rows, 16 k) @ (16 chunks, 16 k, T):
            # the exact 16-product sums of every MMA, (3, 16, 16G, T)
            amat = _a_matrix(a_ops[-1]).transpose(0, 2, 1, 3, 4).reshape(
                3, 16, 16 * g, 16)
            sums.append(amat @ b_mats[s])
        for mt in range(g):
            operands[m0 // 16 + mt] = (np.stack(a_ops)[:, :, mt],
                                       np.stack(b_regs))
        for splits, out in outs.items():
            parts = []
            for s0, s1 in _split_ranges(steps, splits):
                acc = np.zeros(sums[0].shape[2:], np.float32)
                for s in range(s0, s1):
                    for kk in range(16):
                        part = np.zeros_like(acc)
                        for p in (2, 1, 0):          # lo, mid, hi
                            part = (part + sums[s][p, kk]).astype(np.float32)
                        acc = acc + part
                # (16G rows, T) -> (tiles, 4, NT, G, 16, 8)
                acc = acc.reshape(g, 16, tiles, 4, nt, 8).transpose(
                    2, 3, 4, 0, 1, 5)
                parts.append(_thread_acc(acc))
            for t, n0 in enumerate(range(0, n, bn)):
                if splits == 1:
                    acc = parts[0][t]
                else:
                    acc = _reduce([p[t].reshape(128, g, nt, 4)
                                   for p in parts], g, bn).reshape(
                                       4, 32, g, nt, 4)
                tile = _tile_of(acc, bn, g) * np.float32(gs)
                rows, cols = min(16 * g, m - m0), min(bn, n - n0)
                out[m0:m0 + rows, n0:n0 + cols] = tile[:rows, :cols]
    return outs, operands


_JAX_OUT = {}


def _hp_data(fmt, m, n, k, seed):
    """make_gemm_data's operands, A scaled row by row by 2^-20 .. 2^19 (f32
    values over a wide range of magnitudes), and the JAX package's
    high-precision fused_mul on them (interpret mode), its weight cache at
    16-row blocks where m > 16."""
    key = (fmt, m, n, k, seed)
    if key not in _JAX_OUT:
        d = make_gemm_data(m, n, k, fmt, seed=seed)
        rng = np.random.default_rng(seed)
        a = (d.a * np.exp2(rng.integers(-20, 20, (m, 1)))).astype(np.float32)
        eb = jsol.ElementB.MXFP4 if fmt == "mxfp4" else jsol.ElementB.NVFP4
        jsid = dataclasses.replace(jsol.choose_default_solution(m, n, k, eb),
                                   high_precision=True)
        if m > 16:
            jsid = dataclasses.replace(jsid, block_m=16, weight_cache=True)
        _JAX_OUT[key] = (d, a, np.asarray(jfused.fused_mul(
            jnp.asarray(a), jnp.asarray(d.words), jnp.asarray(d.scales_t),
            jnp.float32(d.global_scale), sid=jsid, out_dtype=jnp.float32,
            interpret=True), np.float32))
    return _JAX_OUT[key]


def _torch_operands(d, a):
    words = torch.from_numpy(d.words.view(np.int32))
    st = torch.from_numpy(d.scales_t.view(np.int16)).view(torch.bfloat16)
    gs = torch.tensor([d.global_scale], dtype=torch.float32)
    return torch.from_numpy(a), words, st, gs


def _hp_rule(a, words, st, gs):
    """(the f64 product, the high-precision bound of its distance, the
    scale max(|A| @ |B|) |gs|): 4 max|twin - f64| + 2^-24 scale."""
    n, k = words.shape[1], a.shape[1]
    deq = tlayout.dequant_from_tpu_layout(words, st, n, k).double()
    g = gs.double()
    exact = (a.double() @ deq) * g
    twin = fused.fused_mul_hp_reference(a, words, st, gs, sid=None)
    scale = ((a.double().abs() @ deq.abs()) * g.abs()).max().item()
    lib = (twin.double() - exact).abs().max().item()
    return exact.numpy(), 4 * lib + 2 ** -24 * scale, scale


@pytest.mark.parametrize("bn", [64, 128])
@pytest.mark.parametrize("fmt", ["nvfp4", "mxfp4"])
def test_hp_stream_body_matches_f64_and_jax(fmt, bn):
    """The emulated body at G = 1 and 2, at 1, 2 and 4 splits: within the
    high-precision rule of the f64 product, and within 2^-20 max(|A| @
    |B|) |gs| of the JAX package's hp fused_mul; fused_mul with hp ids and
    the same splits on CPU tensors gives the twin. At G = 2 every m-tile's
    MMAs receive the G = 1 play's operands for that m-tile, exactly."""
    n, k = 336, 640
    for m in _MS:
        d, a, want = _hp_data(fmt, m, n, k, seed=m + 11)
        ta, words, st, gs = _torch_operands(d, a)
        kp = words.shape[0] * 8
        assert kp > k and kp // _KSTEP == 4
        exact, bound, scale = _hp_rule(ta, words, st, gs)
        assert np.abs(want - exact).max() <= 2 ** -20 * scale
        plays = {}
        for g in (1, fused.HP_WC_GROUP):
            got, plays[g] = _emulated_hp(
                a, d.words.view(np.uint32), d.scales_t.view(np.uint16),
                d.global_scale, k, bn, g, (1, 2, 4))
            for splits, out in got.items():
                what = f"{fmt} m={m} bn={bn} g={g} splits={splits}"
                assert np.isfinite(out).all(), what
                err = np.abs(out.astype(np.float64) - exact).max()
                assert err <= bound, (what, err, bound)
                assert np.abs(out - want).max() <= 2 ** -20 * scale, what
        for mt, (a_ops, b_ops) in plays[1].items():
            got_a, got_b = plays[fused.HP_WC_GROUP][mt]
            np.testing.assert_array_equal(got_a, a_ops, err_msg=f"A {mt}")
            np.testing.assert_array_equal(got_b, b_ops, err_msg=f"B {mt}")
        eb = tsol.ElementB.MXFP4 if fmt == "mxfp4" else tsol.ElementB.NVFP4
        twin = fused.fused_mul_hp_reference(ta, words, st, gs, sid=None)
        for splits in (1, 2, 4):
            for wc in (False, True):
                sid = tsol.SolutionId(16, bn, eb, high_precision=True,
                                      weight_cache=wc)
                cpu = fused.fused_mul(ta, words, st, gs, sid=sid,
                                      splits=splits)
                assert torch.equal(cpu.view(torch.int32),
                                   twin.view(torch.int32))


def test_a_fragments_split_every_f32_exactly():
    """split3 on values from 2^-110 to the largest f32, both signs, zeros
    and values with all 24 significand bits: hi + mid + lo equals the value
    exactly, hi and mid truncated, lo bf16_rn of the rest; the fragment
    registers hold those bits."""
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2 ** 32, (64, 264), dtype=np.uint64).astype(
        np.uint32)
    exp = rng.integers(17, 255, (64, 264)).astype(np.uint32)    # 2^-110 ..
    bits = (bits & np.uint32(0x807FFFFF)) | (exp << np.uint32(23))
    a_st = bits.view(np.float32).copy()
    a_st[0, :16] = 0.0
    a_st[1, :16] = np.float32(np.finfo(np.float32).max)
    regs = _a_fragments(a_st, 4)
    parts = [_a_matrix(regs[p]) for p in range(3)]
    total = parts[0] + parts[1] + parts[2]
    for mt in range(4):
        for kk in range(16):
            np.testing.assert_array_equal(
                total[mt, kk], a_st[16 * mt:16 * mt + 16,
                                    16 * kk:16 * kk + 16].astype(np.float64))


# ---- the plan and the ring ---------------------------------------------------

def test_shared_memory_plan_is_the_headers():
    """HpPlan as the header pins it: a stage is 16G A rows of LDS f32, 32
    word rows and 32 scale rows of BN; three stages at (64, 1), two
    elsewhere; as many CTAs an SM as fit in 228 KB (1 KB reserved each),
    what fused.HP_PER_SM tells the split rule; HP_WC_GROUP the same in the
    header and the wrapper."""
    plan = _plan()
    assert set(plan) == {(64, 1), (128, 1), (64, 2), (128, 2)}
    for (bn, g), p in plan.items():
        stage = 16 * g * _LDS * 4 + _WROWS * bn * 4 + _WROWS * bn * 2
        assert p["stage"] == stage and stage % 128 == 0
        assert p["stages"] == (3 if (bn, g) == (64, 1) else 2)
        assert p["stages"] * stage <= 232448
        assert p["per_sm"] == fused.HP_PER_SM[bn, g]
        assert p["per_sm"] == 228 * 1024 // (p["stages"] * stage + 1024)
    group = int(re.search(r"constexpr int HP_WC_GROUP = (\d+);",
                          _source("fp4_gemm.cuh"))[1])
    assert group == fused.HP_WC_GROUP == 2


def test_fragment_loads_are_free_of_bank_conflicts():
    """hp_a_frag's float2 loads (rows g and g + 8, words 16kk + 2tg and
    + 8): each half-warp's 16 loads cover the 32 banks once, in every
    m-tile and chunk."""
    for mt in range(2):
        for kk in range(16):
            for dr, dc in ((0, 0), (8, 0), (0, 8), (8, 8)):
                word = ((16 * mt + _G + dr) * _LDS + 16 * kk + dc
                        + 2 * _TG)
                for half in (slice(0, 16), slice(16, 32)):
                    banks = np.concatenate([word[half], word[half] + 1]) % 32
                    assert sorted(banks) == list(range(32))


@pytest.mark.parametrize("bn,g", [(64, 1), (128, 1), (64, 2), (128, 2)])
@pytest.mark.parametrize("steps", [1, 2, 4, 16, 56])
def test_ring_order_has_no_hazard(bn, g, steps):
    """hp_stream: STAGES - 1 stages loaded ahead, a wait for all but
    STAGES - 2 groups and one barrier a step, the MMAs done within the
    step; the player with the words in each stage, at each instance's
    depth."""
    stages = _plan()[bn, g]["stages"]
    assert _ring_faults(stages - 1, steps, a_slots=stages, mma_depth=0,
                        units=1, words=False) == []


# ---- the split rule and the wrappers -----------------------------------------

@pytest.mark.parametrize("wc", [False, True])
@pytest.mark.parametrize("bn", [64, 128])
@pytest.mark.parametrize("m", [1, 8, 16, 17, 32, 64, 65])
@pytest.mark.parametrize("k,n", _LLAMA8B_KN)
def test_hp_splits_fill_one_wave_of_the_launch(k, n, m, bn, wc):
    """The most splits whose CTAs (ceil(m / 16G) m-groups times n-tiles)
    fit one wave of the plan's CTAs an SM, or one; 1 at block_m = 64."""
    kp = tlayout.padded_k(k)
    steps = kp // _KSTEP
    sid = tsol.SolutionId(16, bn, high_precision=True, weight_cache=wc)
    g = fused.HP_WC_GROUP if wc else 1
    splits = fused.hp_splits(m, n, kp, sid, _H100_SMS)
    assert 1 <= splits <= steps
    ctas = -(-m // (16 * g)) * -(-n // bn)
    slots = fused.HP_PER_SM[bn, g] * _H100_SMS
    assert ctas * splits <= slots or splits == 1
    assert splits == steps or ctas * (splits + 1) > slots
    assert fused.hp_splits(m, n, kp, dataclasses.replace(sid, block_m=64),
                           _H100_SMS) == 1


def test_hp_splits_at_the_llama_shapes():
    """132 SMs. m = 8, two CTAs an SM: 16x64 gives wqkv 2 (192 CTAs), wo 4
    (256), w_gate_up 1 (448), w_down 4 (256), as the bf16 tile; 16x128
    wqkv 5, wo 8, w_gate_up 1, w_down 8. The weight cache at m = 64 (two
    m-groups of 32 rows): 1, 2, 1, 2 at both widths (264 and 132 slots)."""
    def counts(m, bn, wc):
        sid = tsol.SolutionId(16, bn, high_precision=True, weight_cache=wc)
        return [fused.hp_splits(m, n, tlayout.padded_k(k), sid, _H100_SMS)
                for k, n in _LLAMA8B_KN]
    assert counts(8, 64, False) == [2, 4, 1, 4] == [
        fused.stream_splits(8, n, 0, k, 16, 64, _H100_SMS)[0]
        for k, n in _LLAMA8B_KN]
    assert counts(8, 128, False) == [5, 8, 1, 8]
    assert counts(64, 64, True) == counts(64, 128, True) == [1, 2, 1, 2]


def _operands(m=70, n=128, k=640, fmt="nvfp4", seed=3):
    d = make_gemm_data(m, n, k, fmt, seed=seed)
    return _torch_operands(d, d.a.astype(np.float32))


_ENTRIES = {"fused_mul_hp": fused.fused_mul_hp,
            "fused_mul_hp_wc": fused.fused_mul_hp_wc}


@pytest.mark.parametrize("entry", sorted(_ENTRIES))
@pytest.mark.parametrize("splits", [None, 1, 3, 4])
def test_hp_cpu_splits_return_the_twin(splits, entry):
    a, words, st, gs = _operands()
    sid = tsol.SolutionId(16, 64, high_precision=True)
    want = fused.fused_mul_hp_reference(a, words, st, gs, sid=sid)
    got = _ENTRIES[entry](a, words, st, gs, sid=sid, splits=splits)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("entry", sorted(_ENTRIES))
@pytest.mark.parametrize("bad", [0, 5, 1.0, "2", (1, 2)])
def test_hp_cpu_rejects_bad_splits(bad, entry):
    """kp 1024: four steps, so 5 is one split too many."""
    a, words, st, gs = _operands()
    with pytest.raises(ValueError, match="splits"):
        _ENTRIES[entry](a, words, st, gs,
                        sid=tsol.SolutionId(16, 64, high_precision=True),
                        splits=bad)


@pytest.mark.parametrize("entry", sorted(_ENTRIES))
@pytest.mark.parametrize("bn", [64, 128])
def test_hp_cpu_64_row_tiles_take_one_split(bn, entry):
    a, words, st, gs = _operands(m=300)
    sid = tsol.SolutionId(64, bn, high_precision=True)
    assert _ENTRIES[entry](a, words, st, gs, sid=sid,
                           splits=1).shape == (300, 128)
    with pytest.raises(ValueError, match="do not split"):
        _ENTRIES[entry](a, words, st, gs, sid=sid, splits=2)


# ---- the launcher ------------------------------------------------------------

def test_launcher_runs_the_16_row_tiles_on_the_stream_body():
    """Both entries' 16-row tiles launch fp4_hp_stream_kernel<BN, G>, the
    weight cache at HP_WC_GROUP; the 64-row tiles fp4_hp_wgmma_kernel<BN,
    G> (one warpgroup an m-tile) on fp4_hp_wgmma_tile; the first tile loop
    (fp4_gemm_hp_tile, fp4_gemm_hp_kernel) is gone; only the 16-row tiles
    split."""
    text = _source("fp4_gemm_hp.cu")
    for bn in (64, 128):
        assert re.search(rf"block_m == 16 && block_n == {bn}\)\s*err = "
                         rf"launch_stream<{bn}, G>", text)
        assert re.search(rf"block_m == 64 && block_n == {bn}\)\s*err = "
                         rf"launch_wgmma<{bn}, G>", text)
    assert "fp4_hp_stream_kernel<BN, G><<<" in text
    assert "fp4_hp_wgmma_kernel<BN, G><<<grid, P::threads, P::bytes" in text
    assert "__launch_bounds__(THREADS * G, 1)" in text
    assert "fp4_hp_wgmma_tile<BN, G>(" in text
    for gone in ("fp4_gemm_hp_tile", "fp4_gemm_hp_kernel", "hp_smem_bytes",
                 "launch<"):
        assert gone not in text, gone
    assert "hp_stream<BN, G>(" in text
    for entry, g in (("pk_fp4_gemm_hp", "1"),
                     ("pk_fp4_gemm_hp_wc", "HP_WC_GROUP")):
        assert re.search(rf"{entry}\([^{{]*\{{\s*return dispatch<{g}>", text)
    assert "splits != 1 && block_m != 16" in text


@pytest.mark.parametrize("entry", ["pk_fp4_gemm_hp", "pk_fp4_gemm_hp_wc"])
def test_c_entries_take_the_declared_arguments(entry):
    """The extern "C" entry's parameters, pointers and ints in order, are
    the ctypes signature ops/_build.py gives it, pk_fp4_gemm's."""
    text = _source("fp4_gemm_hp.cu")
    params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', text)[1]
    kinds = ["p" if "*" in p else "i" for p in params.split(",")]
    want = ["p" if t is _build._P else "i" for t in _build.SIGNATURES[entry]]
    assert kinds == want
    assert _build.SIGNATURES[entry] == _build.SIGNATURES["pk_fp4_gemm"]
