"""The hybrid GEMM's dense prefill tile body, csrc/dense_wgmma.cuh, on the
CPU.

A CUDA kernel has no CPU mode, so these tests hold what the body is built
from against the JAX package:

- its data movement, played in numpy: each stage's boxes as the tensor
  memory accelerator copies them with the 128-byte swizzle (A's 64 x 64
  box K-major, WD's 64-column boxes of k rows as they are stored:
  MN-major), read back at the addresses the descriptors give, the
  descriptors computed by the source's own expressions (wgmma.cuh:
  sw128_desc, sw128_mn_desc) and decoded by the fields of the wgmma
  matrix descriptor, 16 k a wgmma. The sum over the ring's stages must be
  the dense output of the JAX package's hybrid_mul (Pallas, interpret
  mode) on the same bytes, at the twin's tolerance (rtol 2^-7, atol
  2^-8 * max|ref|: f32 sums of exact bf16 products in another order, one
  bf16 rounding);
- its ring: the order in which a stage waits for its mbarrier, issues its
  wgmmas, waits for them and asks for a later stage, played as events,
  leaves no slot overwritten before its reader is done and no stage read
  before it was asked for, at the stage count and lookahead the source
  sets;
- the descriptor's bit fields, the transpose bit and the boxes, read from
  the source.

The kernel itself runs on the card: tests/test_torch_cuda.py.
"""

import os
import re

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from petit_kernel_tpu.ops import hybrid as jhybrid
from petit_kernel_tpu.ops.kernels import hybrid as jhybrid_kernel
from petit_kernel_tpu.utils.testdata import make_gemm_data
from petit_kernel_tpu_torch.ops import solution as tsol
from petit_kernel_tpu_torch.ops.kernels import hybrid as khybrid

torch.set_num_threads(1)

_CSRC = os.path.join(os.path.dirname(__file__), os.pardir,
                     "petit_kernel_tpu_torch", "csrc")
_ROW = 128          # bytes of a swizzled row: 64 bf16
_BM = 64            # rows of a wgmma m-tile


def _source(name):
    with open(os.path.join(_CSRC, name)) as f:
        return f.read()


def _function(text, name):
    """The body of the first function `name` in `text`, to its closing
    brace at column 0."""
    start = re.search(rf"\b(void|uint64_t) {name}\(", text).start()
    return text[start:text.index("\n}\n", start)]


def _desc_fn(name):
    """wgmma.cuh's descriptor function `name` as a Python function of the
    shared-memory address (and LBO, for the template), evaluating the
    source's own return expression."""
    body = _function(_source("wgmma.cuh"), name)
    ret = body.index("return")
    expr = " ".join(body[ret + len("return"):body.index(";", ret)].split())
    expr = re.sub(r"static_cast<uint(64|32)_t>", "", expr)
    expr = re.sub(r"(0x[0-9A-Fa-f]+)u", r"\1", expr)
    return lambda addr, lbo=None: eval(expr, {"a": addr, "LBO": lbo})


def _fields(desc):
    """The wgmma matrix descriptor's fields: start address, leading and
    stride byte offsets (bytes), base offset, layout (1 = 128-byte
    swizzle)."""
    return dict(start=(desc & 0x3FFF) << 4, lbo=((desc >> 16) & 0x3FFF) << 4,
                sbo=((desc >> 32) & 0x3FFF) << 4, base=(desc >> 49) & 7,
                layout=desc >> 62)


def _constants():
    """dense_wgmma.cuh's ring constants and per-wgmma descriptor steps."""
    text = _source("dense_wgmma.cuh")
    c = {name: int(re.search(rf"constexpr int {name} = (\d+);", text)[1])
         for name in ("DW_DK", "DW_BOX", "DW_STAGES")}
    ahead = re.search(r"constexpr int DW_AHEAD = DW_STAGES - (\d+);", text)
    c["DW_AHEAD"] = c["DW_STAGES"] - int(ahead[1])
    step = re.search(r"wgmma_bf16_tb\(acc, desc_a \+ \((\d+) >> 4\) \* q, "
                     r"desc_b \+ \((\d+) >> 4\) \* q\)", text)
    c["a_step"], c["b_step"] = int(step[1]), int(step[2])
    return c


def _swizzle(addr):
    """The 128-byte swizzle on shared-memory byte addresses: bits 4-6
    XOR bits 7-9 (the row within a 1024-byte atom)."""
    return addr ^ (((addr >> 7) & 7) << 4)


# ---- the descriptor --------------------------------------------------------

def test_descriptor_fields_and_transpose_bit_from_source():
    """sw128_mn_desc<LBO> as the source computes it: the address >> 4 in
    bits 0-13, LBO (the next 64 columns) in 16-29, SBO 1024 (the next 8 k)
    in 32-45, base offset 0, the 128-byte swizzle; the dense tile passes
    its 64-column block (64 k rows of 128 bytes) as LBO, which is where
    dw_load puts the next block; wgmma_bf16_tb sets B's transpose bit and
    only it, and wgmma_bf16 stays K-major."""
    c = _constants()
    mn = _desc_fn("sw128_mn_desc")
    for addr in (0, 1024, 9216, 0x3FC00):
        for lbo in (1024, 8192, 65536):
            assert _fields(mn(addr, lbo)) == dict(
                start=addr, lbo=lbo, sbo=1024, base=0, layout=1)
    assert _fields(_desc_fn("sw128_desc")(9216)) == dict(
        start=9216, lbo=16, sbo=1024, base=0, layout=1)
    text = _source("dense_wgmma.cuh")
    assert re.search(r"b_block = DW_DK \* WG_ROW;", text)
    assert "sw128_mn_desc<P::b_block>(st + P::a_bytes)" in text
    # the boxes: A's at (k0, m0), WD's 64-column blocks at (n0 + 64 j, k0),
    # block j at a_bytes + j * b_block: where the descriptor's LBO steps
    assert "tma_box(st, map_a, k0, m0, bar);" in text
    assert ("tma_box(st + P::a_bytes + j * P::b_block, map_wd, "
            "n0 + DW_BOX * j, k0, bar);") in text
    launcher = _source("hybrid_gemm.cu")
    assert "box[2] = {DW_BOX, DW_BOX}" in launcher
    assert "CU_TENSOR_MAP_SWIZZLE_128B" in launcher
    assert c["DW_BOX"] * 2 == _ROW == c["DW_DK"] * 2
    # 16 k a wgmma: 32 bytes along A's rows, two 8-k atoms (2048 bytes) of B
    assert (c["a_step"], c["b_step"]) == (32, 2 * 1024)
    wg = _source("wgmma.cuh")
    tb = _function(wg, "wgmma_bf16_tb")
    assert "p, 1, 1, 0, 1;" in tb and "p, 1, 1, 0, 0;" not in tb
    assert wg.count("p, 1, 1, 0, 1;") == 2          # both widths
    assert wg.count("p, 1, 1, 0, 0;") == 2          # wgmma_bf16 untouched


# ---- the data movement -----------------------------------------------------

def _bf16_bits(x):
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _f32(bits):
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _tma_box(smem, dst, matrix, x, y):
    """cp.async.bulk.tensor.2d of the 64 x 64 box at (x, y) (x the
    contiguous coordinate) of `matrix` (uint16) into byte `dst` of `smem`
    with the 128-byte swizzle: box row r at dst + 128 r, its 16-byte chunk
    c at chunk c ^ (r & 7); zeros past the matrix's edges."""
    rows, cols = matrix.shape
    for r in range(64):
        for c in range(8):
            x0 = x + 8 * c
            vals = np.zeros(8, np.uint16)
            if y + r < rows:
                part = matrix[y + r, x0:min(x0 + 8, cols)]
                vals[:len(part)] = part
            p = (dst + r * _ROW + ((c ^ (r & 7)) << 4)) // 2
            smem[p:p + 8] = vals


def _dw_stage(smem, st, a_bits, wd_bits, m0, n0, k0, bn, a_bytes, b_block):
    """dw_stage<BN>: A's box at (k0, m0), then WD's box at (n0 + 64 j, k0)
    for each 64-column block j, into the slot at byte `st`."""
    _tma_box(smem, st, a_bits, k0, m0)
    for j in range(bn // 64):
        _tma_box(smem, st + a_bytes + j * b_block, wd_bits, n0 + 64 * j, k0)


def _read_k_major(smem, desc, rows):
    """The (rows, 16) A operand of a K-major 128-byte-swizzle descriptor:
    element (r, kk) at start + (r // 8) SBO + (r % 8) 128 + 2 kk."""
    f = _fields(desc)
    r = np.arange(rows)[:, None]
    kk = np.arange(16)[None, :]
    addr = f["start"] + (r // 8) * f["sbo"] + (r % 8) * _ROW + 2 * kk
    return smem[_swizzle(addr) // 2]


def _read_mn_major(smem, desc, cols):
    """The (16, cols) B operand of an MN-major 128-byte-swizzle descriptor
    (CUTLASS's canonical ((T,8,m),(8,k)):((1,T,LBO),(8T,SBO))): element
    (k, n) at start + (n // 64) LBO + (k // 8) SBO + (k % 8) 128 +
    2 (n % 64)."""
    f = _fields(desc)
    assert f["layout"] == 1 and f["base"] == 0
    k = np.arange(16)[:, None]
    n = np.arange(cols)[None, :]
    addr = (f["start"] + (n // 64) * f["lbo"] + (k // 8) * f["sbo"]
            + (k % 8) * _ROW + 2 * (n % 64))
    return smem[_swizzle(addr) // 2]


def _emulated_dense_tile_body(a_bits, wd_bits, bn):
    """C = bf16(A @ WD[:K]) built tile by tile as dense_wgmma_tile builds
    it: the prologue's DW_AHEAD stages, then per stage i the wgmmas of slot
    i % DW_STAGES, each 16 k read through the source's descriptors, and
    the boxes of stage i + DW_AHEAD into slot (i + DW_AHEAD) % DW_STAGES;
    f32 sums in stage order."""
    c = _constants()
    dk, stages, ahead = c["DW_DK"], c["DW_STAGES"], c["DW_AHEAD"]
    a_bytes, b_block = _BM * _ROW, dk * _ROW
    stage = a_bytes + bn // 64 * b_block
    base = 1024 * 3                                   # a 1024-aligned ring
    smem = np.zeros((base + stages * stage) // 2, np.uint16)
    sw_a, sw_b = _desc_fn("sw128_desc"), _desc_fn("sw128_mn_desc")
    M, K = a_bits.shape
    N = wd_bits.shape[1]
    n = K // dk
    out = np.zeros((M, N), np.float32)
    for m0 in range(0, M, _BM):
        for n0 in range(0, N, bn):
            acc = np.zeros((_BM, bn), np.float32)
            issue = (lambda s: _dw_stage(
                smem, base + (s % stages) * stage, a_bits, wd_bits, m0, n0,
                s * dk, bn, a_bytes, b_block))
            for s in range(min(ahead, n)):
                issue(s)
            for i in range(n):
                st = base + (i % stages) * stage
                desc_a, desc_b = sw_a(st), sw_b(st + a_bytes, b_block)
                for q in range(dk // 16):
                    a_q = _f32(_read_k_major(
                        smem, desc_a + (c["a_step"] >> 4) * q, _BM))
                    b_q = _f32(_read_mn_major(
                        smem, desc_b + (c["b_step"] >> 4) * q, bn))
                    acc += (a_q.astype(np.float64)
                            @ b_q.astype(np.float64)).astype(np.float32)
                if i + ahead < n:
                    issue(i + ahead)
            rows, cols = min(_BM, M - m0), min(bn, N - n0)
            out[m0:m0 + rows, n0:n0 + cols] = acc[:rows, :cols]
    return _f32(_bf16_bits(out))


# (m, nd, k): ragged m, nd not a multiple of either tile width, k padded
# past itself (640 -> 1024, 384 -> 512)
_SHAPES = [(70, 80, 640), (33, 208, 384), (130, 144, 256)]


@pytest.mark.parametrize("bn", [64, 128])
@pytest.mark.parametrize("m,nd,k", _SHAPES)
def test_dense_tile_data_movement_matches_jax_hybrid_mul(m, nd, k, bn):
    """The emulated body's dense columns against the JAX package's
    hybrid_mul (its dense operand permuted to the kernel's k order, as
    quantize_hybrid stores it) and the port's twin, on the same bytes."""
    nf = 64
    d = make_gemm_data(m, nf, k, "nvfp4", seed=5)
    kp = d.words.shape[0] * 8
    rng = np.random.default_rng(m + nd + k)
    wd_nat = np.zeros((kp, nd), np.float32)
    wd_nat[:k] = rng.standard_normal((k, nd)) / 8
    wd_bits = _bf16_bits(wd_nat)                     # rows past k zero
    a_bits = _bf16_bits(d.a)
    wd_jax = jhybrid.permute_k_for_a(
        _f32(wd_bits[:k]).astype(ml_dtypes.bfloat16), kp)
    _, want = jhybrid_kernel.hybrid_mul(
        jnp.asarray(_f32(a_bits), jnp.bfloat16), jnp.asarray(d.words),
        jnp.asarray(d.scales_t), jnp.float32(d.global_scale),
        jnp.asarray(wd_jax), block_nf=nf, block_nd=nd, interpret=True)
    want = np.asarray(want, np.float32)
    got = _emulated_dense_tile_body(a_bits, wd_bits, bn)
    tol = dict(rtol=2 ** -7, atol=2 ** -8 * np.abs(want).max())
    np.testing.assert_allclose(got, want, **tol)
    as_t = (lambda b: torch.from_numpy(b.view(np.int16)).view(torch.bfloat16))
    _, twin = khybrid.hybrid_mul_reference(
        as_t(a_bits), torch.from_numpy(d.words.view(np.int32)),
        as_t(d.scales_t.view(np.uint16)), torch.tensor([d.global_scale]),
        as_t(wd_bits), sid=tsol.SolutionId(64, bn))
    np.testing.assert_allclose(got, twin.float().numpy(), **tol)


# ---- the ring --------------------------------------------------------------

def _dense_ring_faults(stages, ahead, n, mma_depth=1):
    """Play dense_wgmma_tile's order for every thread at once and return
    the hazards found. The prologue asks for stages s < min(ahead, n),
    stage s into slot s % stages. Stage i runs: wait on slot i % stages's
    mbarrier; wgmmas on the slot; commit; wgmma.wait_group(mma_depth);
    barrier; ask for stage i + ahead (if any) into its slot. A wait on an
    mbarrier for a stage never asked for could return on the slot's
    earlier phase of the same parity, and a stage asked for into a slot
    whose last reader is not done for every thread overwrites it; a wgmma
    counts as done for every thread once each has retired it and a
    barrier followed."""
    faults, holder = [], {}          # slot -> the last stage asked for
    done_mma = -1

    def ask(s):
        slot = s % stages
        prev = holder.get(slot)
        if prev is not None and prev > done_mma:
            faults.append(f"stage {s} overwrites slot {slot} under "
                          f"wgmma({prev})")
        holder[slot] = s

    for s in range(min(ahead, n)):
        ask(s)
    for i in range(n):
        if holder.get(i % stages) != i:
            faults.append(f"wgmma({i}) waits on slot {i % stages} holding "
                          f"stage {holder.get(i % stages)}")
        done_mma = i - mma_depth                       # wait, barrier
        if i + ahead < n:
            ask(i + ahead)
    return faults


@pytest.mark.parametrize("k", [128, 256, 4096, 14336])
def test_dense_ring_order_has_no_hazard(k):
    """The source's DW_STAGES slots and DW_AHEAD lookahead with one wgmma
    group in flight, over the stage counts of k = 128 (the least the
    kernel takes) to Llama-3-8B's w_down."""
    c = _constants()
    assert _dense_ring_faults(c["DW_STAGES"], c["DW_AHEAD"],
                              k // c["DW_DK"]) == []


@pytest.mark.parametrize("broken", [dict(ahead=4), dict(stages=3),
                                    dict(mma_depth=2), dict(ahead=0)])
def test_dense_ring_player_finds_a_short_ring(broken):
    """One stage more in flight, one slot fewer, one more wgmma group in
    flight, or no stage asked for ahead: the player finds the hazard, so
    the test above has teeth."""
    args = dict(stages=4, ahead=3, n=8) | broken
    assert _dense_ring_faults(**args) != []
