"""The high-precision FP4 GEMM's 64-row tiles on the register-A wgmma body.

fused_mul_hp's and fused_mul_hp_wc's 64-row tiles run
fp4_hp_wgmma_kernel<BN, G> (csrc/fp4_gemm_hp.cu) on csrc/fp4_hp_wgmma.cuh:
one warpgroup an m-tile, G = 1 for the plain GEMM and G = HP_WC_GROUP = 2
for the weight cache, whose CTA feeds each decoded B unit to both
warpgroups. A CUDA kernel has no CPU mode, so these tests hold what it is
built from against the JAX package:

- the body played in numpy, unit by unit: the f32 A slot as hw_load_a fills
  it (rows of HW_LDA = 72 floats, 16-byte pieces, zero past m and k), each
  warp's register fragment gathered lane by lane (four float2 a chunk) and
  split by split3 (bit for bit fused.split_bf16x3), the words and scales as
  wg_load_ws stages them, B decoded by wg_words and wg_decode (prmt word
  pairs, decode_pair, mul.rn.bf16x2) into the 128-byte-swizzled B slot and
  read back through the descriptor (half h of a 128-wide tile 64 rows on),
  each wgmma modelled as the exact sum of its 16 products plus its
  accumulator rounded once to f32, the three of a chunk (lo with scale_d =
  0, mid, hi) into a fresh part and one __fadd_rn into acc, in unit order,
  the epilogue f32(acc * gs); at BN = 64 and 128, G = 1 and 2, nvfp4 and
  mxfp4, m = 70 and 130 (ragged), n = 336 (a ragged last n-tile), k = 640
  padded to 1024 (16 units). The result is held against the f64 product
  under the high-precision rule (4 max|f32 library - f64| + 2^-24
  max(|A| @ |B|) |gs|, the f32 library being the port's twin
  fused_mul_hp_reference) and against the JAX package's fused_mul with a
  high_precision sid at block_m 64 (Pallas, interpret mode; its weight
  cache where G = 2) within 2^-20 max(|A| @ |B|) |gs|, the rule
  tests/test_torch_solutions.py holds the two packages' hp entries to;
- the operands each m-tile's wgmmas receive, exactly: at G = 2 the A
  registers and the B slots of the G = 1 play, so on the card the weight
  cache's output is the plain tile's bit for bit;
- the decode's cut over 128G threads (every chunk of the B slot written
  once) and the B slot read through the descriptor equal to the
  dequantized weights in natural k order;
- the plan (HpWgPlan's static_asserts, read from the source), the banks of
  the float2 fragment loads, the register-A wgmma helpers' operand lists,
  and the ring order, played as events by tests/test_torch_wgmma.py's
  player at each instance's A lookahead.

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
from petit_kernel_tpu_torch.ops import layout as tlayout
from petit_kernel_tpu_torch.ops import solution as tsol
from petit_kernel_tpu_torch.ops.kernels import fused
from test_torch_hp_stream import _a_matrix, _hp_rule, _split3, _torch_operands
from test_torch_w4a8_stream import _LANES
from test_torch_w4a8_wgmma import _decode_word, _mul_bf16x2, _prmt, _u32
from test_torch_wgmma import _f32, _ring_faults

torch.set_num_threads(1)

_CSRC = os.path.join(os.path.dirname(__file__), os.pardir,
                     "petit_kernel_tpu_torch", "csrc")
_KSTEP = 256        # natural k a step
_WROWS = 32         # packed word rows a step
_LDA = 72           # floats of an f32 A slot row (HW_LDA)
_ROW = 128          # bytes of a swizzled B row (64 bf16)
_SMEM_LIMIT = 232448
_SMEM_SM = 233472
_G, _TG = _LANES >> 2, _LANES & 3


def _source(name):
    with open(os.path.join(_CSRC, name)) as f:
        return f.read()


def _plan():
    """{(BN, G): {bytes, da, blocks}} as the header's static_assert pins
    HpWgPlan."""
    got = {}
    for bn, g, what, v in re.findall(
            r"HpWgPlan<(\d+), (\d+)>::(bytes|da|blocks) == (\d+)",
            _source("fp4_hp_wgmma.cuh")):
        got.setdefault((int(bn), int(g)), {})[what] = int(v)
    return got


def _unit_k0(kp, u):
    """fp4_wgmma.cuh unit_k0: quarter u & 3, block and half of step u >> 2."""
    step = u >> 2
    return (u & 3) * (kp // 4) + (step >> 1) * 128 + (step & 1) * 64


# ---- A: the slot and the register fragments ---------------------------------

def _a_slot(a, m0, rows, k, k0):
    """hw_load_a: rows m0 .. m0 + rows - 1 of f32 A, natural k k0 .. + 63,
    as 16 pieces of 4 floats a row at floats r * HW_LDA + 4p (zero past m
    and k)."""
    slot = np.zeros((rows, _LDA), np.float32)
    ok = np.arange(rows)[m0 + np.arange(rows) < a.shape[0]]
    for p in range(16):
        kn = k0 + 4 * p
        if kn < k:
            slot[ok, 4 * p:4 * p + 4] = a[m0 + ok, kn:kn + 4]
    return slot


def _rs_fragments(slot, warps):
    """hw_a_frag for every warp, chunk and lane: lane (g, tg) of warp w loads
    the float2 at row 16w + g (+ 8), floats 16q + 2tg (+ 8) and splits it ->
    registers (3 parts hi, mid, lo; warps, 4 chunks, 32 lanes, 4) uint64.
    The split is held bit for bit against fused.split_bf16x3."""
    rows = 16 * np.arange(warps)[:, None, None] + _G[None, None]
    cols = 16 * np.arange(4)[None, :, None] + 2 * _TG[None, None]
    regs = np.zeros((3, warps, 4, 32, 4), np.uint64)
    for reg, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        pair = np.stack([slot[rows + dr, cols + dc],
                         slot[rows + dr, cols + dc + 1]], -1)
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


# ---- B: the staged words, the decode, the descriptor --------------------------

def _ws_stage(words, s_bits, n0, bn, step):
    """wg_load_ws for the CTA of n-tile n0: stage word row sr <- word row
    64c + 2g + 4(sr >> 1) + (sr & 1), stage scale row 4j + t <- scale row
    j * (kp / 64) + 8c + 4g + t, columns past n zero."""
    kp, n = words.shape[0] * 8, words.shape[1]
    c, g = step >> 1, step & 1
    cols = n0 + np.arange(bn)
    ok = cols < n
    cols = np.where(ok, cols, 0)
    w_rows = [64 * c + 2 * g + 4 * (sr >> 1) + (sr & 1) for sr in range(_WROWS)]
    s_rows = [(r >> 2) * (kp // 64) + 8 * c + 4 * g + (r & 3) for r in range(16)]
    w_st = np.where(ok, words[w_rows][:, cols], 0).astype(np.uint64)
    s_st = np.where(ok, s_bits[s_rows][:, cols], 0).astype(np.uint64)
    return w_st, s_st


def _decode_tasks(bn, g):
    """WgDecode's cut: thread t runs set p = t / STRIDE of the columns
    t % STRIDE + i * STRIDE, i < CW (threads past TASKS idle) -> (column,
    set) of every task run."""
    nth = 128 * g
    cw = bn * 4 // nth if bn * 4 >= nth else 1
    stride, tasks = bn // cw, bn * 4 // cw
    return [(t % stride + i * stride, t // stride)
            for t in range(min(nth, tasks)) for i in range(cw)]


def _b_slot(w_st, s_st, j, bn, g):
    """wg_words and wg_decode<j> by every thread of the CTA: set p = b + 2d
    of column n, from the half pairs of stage rows 16b + d + 4y and + 2,
    decoded, times the scales of stage rows 4j + 2d (half 0) and + 1 (half
    1), stored as chunks b + 4d and b + 4d + 2 of row n at chunk ^ (n & 7)
    -> the slot (bn, 64) bf16 bits as laid out in shared memory, and how
    many times each chunk was written."""
    slot = np.zeros((bn, 64), np.uint16)
    writes = np.zeros((bn, 8), int)
    tasks = np.array(_decode_tasks(bn, g))
    for p in range(4):
        cols = np.sort(tasks[tasks[:, 1] == p, 0])
        b, d = p & 1, p >> 1
        w0 = w_st[[16 * b + d + 4 * y for y in range(4)]][:, cols]
        w1 = w_st[[16 * b + d + 4 * y + 2 for y in range(4)]][:, cols]
        for h, sel in enumerate((0x5410, 0x7632)):
            s = s_st[4 * j + 2 * d + h, cols]
            v = _mul_bf16x2(_decode_word(_prmt(w0, w1, sel), j), _u32(s | (s << 16)))
            # 8 bf16: element 2y the low half of v[y], 2y + 1 its high half
            vals = np.stack([v & 0xFFFF, v >> 16], -1).transpose(1, 0, 2)
            chunk = b + 4 * d + 2 * h
            phys = chunk ^ (cols & 7)
            slot[cols[:, None], 8 * phys[:, None] + np.arange(8)] = \
                vals.reshape(len(cols), 8)
            writes[cols, chunk] += 1
    return slot, writes


def _desc_read(slot, row0, q):
    """A K-major 128-byte-swizzle descriptor (1024-byte atoms of 8 rows)
    started at row0 (64 rows on for half 1) and 32q bytes along: the 64
    rows x 16 k operand of one wgmma, the hardware XORing address bits 4-6
    with bits 7-9."""
    flat = slot.reshape(-1)
    addr = ((row0 + np.arange(64))[:, None] * _ROW + 32 * q
            + 2 * np.arange(16)[None])
    phys = addr ^ (((addr >> 7) & 7) << 4)
    return flat[phys // 2]


# ---- the body -------------------------------------------------------------------

def _b_operands(words, s_bits, bn, g):
    """Every (n-tile, unit)'s B slot and its four chunks as read for the
    wgmmas: {(t, u): (slot, (4, bn, 16) bf16 bits)}."""
    kp, n = words.shape[0] * 8, words.shape[1]
    out = {}
    for t, n0 in enumerate(range(0, n, bn)):
        for step in range(kp // _KSTEP):
            w_st, s_st = _ws_stage(words, s_bits, n0, bn, step)
            for j in range(4):
                slot, writes = _b_slot(w_st, s_st, j, bn, g)
                assert (writes == 1).all()
                ops = np.stack([np.concatenate(
                    [_desc_read(slot, 64 * h, q) for h in range(bn // 64)])
                    for q in range(4)])
                out[t, 4 * step + j] = (slot, ops)
    return out


def _emulated_hp_wgmma(a, words, s_bits, gs, k, bn, g, b_ops):
    """fp4_hp_wgmma_kernel<bn, g>: CTA (n-tile, m-group) runs the units in
    order; in each, every warp's chunk q: lo, mid, hi wgmmas into a fresh
    part, one rounded add. -> (f32 (m, n), {m-tile: A registers over the
    units})."""
    m, (kw, n) = a.shape[0], words.shape
    kp, rows = kw * 8, 64 * g
    tiles = -(-n // bn)
    out = np.zeros((m, n), np.float32)
    a_ops = {}
    # (units, 4 chunks, 16 k, tiles * bn columns) f64 B operands
    bmat = np.stack([np.concatenate(
        [_f32(b_ops[t, u][1]).astype(np.float64).transpose(0, 2, 1)
         for t in range(tiles)], -1) for u in range(kp // 64)])
    for m0 in range(0, m, rows):
        acc = np.zeros((rows, tiles * bn), np.float32)
        regs_u = []
        for u in range(kp // 64):
            regs = _rs_fragments(_a_slot(a, m0, rows, k, _unit_k0(kp, u)),
                                 4 * g)
            regs_u.append(regs)
            # (3 parts, 4g warps, 4 chunks, 16, 16) -> (3, 4, rows, 16)
            amat = _a_matrix(regs).transpose(0, 2, 1, 3, 4).reshape(
                3, 4, rows, 16)
            sums = np.einsum("pqrk,qkc->pqrc", amat, bmat[u])
            for q in range(4):
                part = sums[2, q].astype(np.float32)               # lo
                part = (part + sums[1, q]).astype(np.float32)      # mid
                part = (part + sums[0, q]).astype(np.float32)      # hi
                acc = acc + part
        for i in range(g):
            a_ops[m0 // 64 + i] = np.stack(regs_u)[:, :, 4 * i:4 * i + 4]
        tile = acc * np.float32(gs)
        valid = min(rows, m - m0)
        out[m0:m0 + valid] = tile[:valid, :n]
    return out, a_ops


_JAX_OUT = {}


def _hp_data(fmt, m, n, k, wc, seed):
    """make_gemm_data's operands, A scaled row by row by 2^-20 .. 2^19, and
    the JAX package's high-precision fused_mul at block_m 64 on them
    (interpret mode), its weight cache if wc."""
    key = (fmt, m, n, k, wc, seed)
    if key not in _JAX_OUT:
        d = make_gemm_data(m, n, k, fmt, seed=seed)
        rng = np.random.default_rng(seed)
        a = (d.a * np.exp2(rng.integers(-20, 20, (m, 1)))).astype(np.float32)
        eb = jsol.ElementB.MXFP4 if fmt == "mxfp4" else jsol.ElementB.NVFP4
        jsid = dataclasses.replace(jsol.choose_default_solution(m, n, k, eb),
                                   high_precision=True, block_m=64,
                                   weight_cache=wc)
        _JAX_OUT[key] = (d, a, np.asarray(jfused.fused_mul(
            jnp.asarray(a), jnp.asarray(d.words), jnp.asarray(d.scales_t),
            jnp.float32(d.global_scale), sid=jsid, out_dtype=jnp.float32,
            interpret=True), np.float32))
    return _JAX_OUT[key]


@pytest.mark.parametrize("bn", [64, 128])
@pytest.mark.parametrize("fmt", ["nvfp4", "mxfp4"])
def test_hp_wgmma_body_matches_f64_and_jax(fmt, bn):
    """The emulated body at G = 1 and 2, m = 70 and 130: within the
    high-precision rule of the f64 product and within 2^-20 max(|A| @ |B|)
    |gs| of the JAX package's hp fused_mul (its weight cache at G = 2). At
    G = 2 the output is the G = 1 play's bit for bit, and every m-tile's
    wgmmas receive the G = 1 play's A registers and B slots exactly.
    fused_mul with the 64-row hp ids on CPU tensors gives the twin."""
    n, k = 336, 640
    eb = tsol.ElementB.MXFP4 if fmt == "mxfp4" else tsol.ElementB.NVFP4
    for m in (70, 130):
        plays, ops, b_ops = {}, {}, {}
        for g in (1, fused.HP_WC_GROUP):
            d, a, want = _hp_data(fmt, m, n, k, g > 1, seed=m + 5)
            words, s_bits = d.words.view(np.uint32), d.scales_t.view(np.uint16)
            assert words.shape[0] * 8 == 1024
            b_ops[g] = _b_operands(words, s_bits, bn, g)
            ta, tw, ts, tg = _torch_operands(d, a)
            exact, bound, scale = _hp_rule(ta, tw, ts, tg)
            assert np.abs(want - exact).max() <= 2 ** -20 * scale
            got, ops[g] = _emulated_hp_wgmma(a, words, s_bits, d.global_scale,
                                             k, bn, g, b_ops[g])
            what = f"{fmt} m={m} bn={bn} g={g}"
            assert np.isfinite(got).all(), what
            err = np.abs(got.astype(np.float64) - exact).max()
            assert err <= bound, (what, err, bound)
            assert np.abs(got - want).max() <= 2 ** -20 * scale, what
            plays[g] = got
            twin = fused.fused_mul_hp_reference(ta, tw, ts, tg, sid=None)
            sid = tsol.SolutionId(64, bn, eb, high_precision=True,
                                  weight_cache=g > 1)
            cpu = fused.fused_mul(ta, tw, ts, tg, sid=sid)
            assert torch.equal(cpu.view(torch.int32), twin.view(torch.int32))
        wc = fused.HP_WC_GROUP
        assert np.array_equal(plays[wc].view(np.int32), plays[1].view(np.int32))
        for mt, regs in ops[1].items():
            np.testing.assert_array_equal(ops[wc][mt], regs, err_msg=str(mt))
        for key, (slot, b) in b_ops[1].items():
            np.testing.assert_array_equal(b_ops[wc][key][0], slot)
            np.testing.assert_array_equal(b_ops[wc][key][1], b)


@pytest.mark.parametrize("fmt", ["nvfp4", "mxfp4"])
def test_b_slots_read_back_the_dequantized_weights(fmt):
    """Every unit's B slot, read through the descriptor as the wgmmas read
    it, is the dequantized weight (exact in bf16) at natural k unit_k0 +
    16q + e of each column, zero past n; at both widths and both G."""
    m, n, k = 16, 336, 640
    d = make_gemm_data(m, n, k, fmt, seed=9)
    words, s_bits = d.words.view(np.uint32), d.scales_t.view(np.uint16)
    kp = words.shape[0] * 8
    _, tw, ts, _ = _torch_operands(d, d.a.astype(np.float32))
    deq = tlayout.dequant_from_tpu_layout(tw, ts, n, kp).numpy()
    for bn in (64, 128):
        for g in (1, fused.HP_WC_GROUP):
            for (t, u), (_, ops) in _b_operands(words, s_bits, bn, g).items():
                k0 = _unit_k0(kp, u)
                cols = t * bn + np.arange(bn)
                want = np.zeros((bn, 64), np.float32)
                want[cols < n] = deq[k0:k0 + 64, cols[cols < n]].T
                got = _f32(ops).transpose(1, 0, 2).reshape(bn, 64)
                np.testing.assert_array_equal(got, want, err_msg=f"{t} {u}")


def test_a_slot_rows_fall_on_distinct_banks():
    """hw_a_frag's float2 loads (rows 16w + g and + 8, floats 16q + 2tg and
    + 8, rows HW_LDA = 72 floats apart): each half-warp's 16 loads cover the
    32 banks once, for every warp of both warpgroups and every chunk; the
    header's HW_LDA is 72."""
    assert re.search(r"constexpr int HW_LDA = 72;", _source("fp4_hp_wgmma.cuh"))
    for w in range(8):
        for q in range(4):
            for dr, dc in ((0, 0), (8, 0), (0, 8), (8, 8)):
                word = (16 * w + _G + dr) * _LDA + 16 * q + dc + 2 * _TG
                for half in (slice(0, 16), slice(16, 32)):
                    banks = np.concatenate([word[half], word[half] + 1]) % 32
                    assert sorted(banks) == list(range(32))


# ---- the plan, the helpers and the ring -----------------------------------------

def test_shared_memory_plan_is_the_headers():
    """HpWgPlan as the header pins it: da + 2 A slots of 64G rows of 72
    f32, three B slots of BN rows of 128 bytes, two stages of 32 word rows
    and 16 scale rows, 1 KB of alignment; da the deepest of 3, 2, 1 that
    keeps the most CTAs an SM: (64, 1) 101,376 bytes, two CTAs, da 1;
    (128, 1) 183,296, da 3; (64, 2) 230,400, da 3; (128, 2) 201,728, da 1;
    one CTA each."""
    def blocks(nbytes):
        return _SMEM_SM // (nbytes + 1024) if nbytes <= _SMEM_LIMIT else 0
    plan = _plan()
    assert set(plan) == {(64, 1), (128, 1), (64, 2), (128, 2)}
    for (bn, g), p in plan.items():
        a_slot = 64 * g * _LDA * 4
        fixed = 3 * bn * _ROW + 2 * (_WROWS * bn * 4 + 16 * bn * 2) + 1024
        most = blocks(3 * a_slot + fixed)
        da = next(x for x in (3, 2, 1)
                  if x == 1 or blocks((x + 2) * a_slot + fixed) >= most)
        assert a_slot % 1024 == 0
        assert p == dict(bytes=(da + 2) * a_slot + fixed, da=da, blocks=most)
        assert p["bytes"] <= _SMEM_LIMIT
    assert {k: p["blocks"] for k, p in plan.items()} == {
        (64, 1): 2, (128, 1): 1, (64, 2): 1, (128, 2): 1}


@pytest.mark.parametrize("bn,g", [(64, 1), (128, 1), (64, 2), (128, 2)])
def test_decode_cut_writes_every_chunk_once(bn, g):
    """WgDecode over 128G threads: every (column, set) task runs once, so
    each of the slot's 8 chunks of every row is written once."""
    tasks = _decode_tasks(bn, g)
    assert sorted(tasks) == [(c, p) for c in range(bn) for p in range(4)]


def test_register_a_wgmma_helpers_number_their_operands():
    """wgmma_bf16_rs at N = 32 (m64n64k16) and 64 (m64n128k16): N "+f"
    accumulators %0 .. %N-1, the four A registers %N .. %N+3, the B
    descriptor %N+4, scale_d %N+5 in the predicate; B K-major (transpose
    immediate 0), unit scales."""
    text = _source("wgmma.cuh")
    bodies = re.findall(r"void wgmma_bf16_rs\(float \(&d\)\[(\d+)\](.*?)\n}",
                        text, re.S)
    assert [int(n) for n, _ in bodies] == [32, 64]
    for n, body in bodies:
        n = int(n)
        shape = {32: "m64n64k16", 64: "m64n128k16"}[n]
        assert f"wgmma.mma_async.sync.aligned.{shape}.f32.bf16.bf16" in body
        assert f"setp.ne.b32 p, %{n + 5}, 0;" in body
        regs = re.search(r'"\{(%0,.*?)\}, "\s*"\{(.*?)\}, %(\d+), p, 1, 1, 0;',
                         body, re.S)
        accs = re.findall(r"%(\d+)", regs[1])
        assert [int(x) for x in accs] == list(range(n))
        assert regs[2] == ", ".join(f"%{i}" for i in range(n, n + 4))
        assert int(regs[3]) == n + 4
        assert body.count('"+f"(d[') == n
        assert '"r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)' \
            in body


@pytest.mark.parametrize("bn,g", [(64, 1), (128, 1), (64, 2), (128, 2)])
@pytest.mark.parametrize("steps", [1, 2, 4, 16, 56])
def test_ring_order_has_no_hazard(bn, g, steps):
    """fp4_wgmma_tile's ring at each instance's lookahead: da + 2 A slots,
    three B slots, the last group of a unit in flight past its end (each
    warpgroup waits only for its own)."""
    da = _plan()[bn, g]["da"]
    depth = 1 if g == 1 else (1,) * g
    assert _ring_faults(da, steps, mma_depth=depth) == []


def test_each_step_drains_its_wgmma_groups():
    """The step loop of fp4_hp_wgmma_tile ends with wgmma.wait_group 0 and
    the add of the step's last part, so no group is in flight across the
    loop's back-edge (carried there, ptxas serializes every wgmma of the
    body); a step's first group adds no part; the other waits leave one
    group in flight."""
    text = _source("fp4_hp_wgmma.cuh")
    loop = text[text.index("for (int step = 0; step < steps; ++step)"):]
    loop = loop[:loop.index("\n  }\n")]
    assert loop.rstrip().endswith(
        "wgmma_wait<0>();\n    hw_add(r, 4 * (BN / 64) - 1);   // the step's last group")
    assert "if (J > 0 || t > 0) hw_add(r, t + 4 * H - 1);" in text
    assert text.count("wgmma_wait<1>();") == 1
    assert text.count("wgmma_wait<0>();") == 1


def test_cpu_64_row_hp_ids_run_the_twin_and_count_no_launch():
    """On CPU tensors both hp wrappers run the twin for the 64-row ids and
    leave every launch count as it was."""
    d = make_gemm_data(70, 128, 640, "nvfp4", seed=3)
    a, words, st, gs = _torch_operands(d, d.a.astype(np.float32))
    want = fused.fused_mul_hp_reference(a, words, st, gs, sid=None)
    wrappers = (fused.fused_mul_hp, fused.fused_mul_hp_wc)
    before = [(w.launches, w.wgmma_launches, w.stream_launches)
              for w in wrappers]
    for bn in (64, 128):
        for wc in (False, True):
            sid = tsol.SolutionId(64, bn, high_precision=True, weight_cache=wc)
            got = fused.fused_mul(a, words, st, gs, sid=sid)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert before == [(w.launches, w.wgmma_launches, w.stream_launches)
                      for w in wrappers]
