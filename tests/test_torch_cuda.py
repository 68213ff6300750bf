"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked `cuda`; each test skips without a CUDA card (a CUDA kernel has no
CPU mode). This file imports neither JAX nor the JAX package, so on a CUDA
host it runs on its own, without tests/conftest.py's JAX set-up:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the GEMM (its 64-row wgmma tiles also at full Llama-3-8B
widths, and on a weight of mostly stored zeros) and the grouped expert
GEMM at rtol 2^-7 with atol
2^-8 * max|ref| (both sum exact bf16 products in f32, in other orders,
then round once to bf16), the grouped GEMM also bit for bit against
fused_mul on each expert at the same tile and k-splits, with `rows` bit
for bit against the launch without them, and its layer's three calls
replayed in a CUDA graph bit for bit the eager run; the weight-cache GEMM bit
for bit against fused_mul at the same tile and split count (its 16-row
tiles at m = 1 to 130, every split count from 1 to 4 and the default of
each, counted as stream launches, and replayed in a CUDA graph bit for
bit); the W4A8 GEMM and its
weight-cache variant bit for bit against their twin (exact int32 sums),
the plain kernel's 64-row int8 wgmma tiles also at k = 4096 over 5 and 32
m-tiles, and the weight cache bit for bit against them; their 16-row
tiles (the split-k int8 stream body) at every split count, two launches
the same bits, the weight cache bit for bit the plain tile, and the split
counters they share with fused_mul zero after a W4A8 launch and an FP4
one;
attention at rtol = atol = 2^-7, flat or headed, bf16 or fp8 K/V (both
convert fp8 exactly), the decode entries (one split-KV body) at every
split count from 1 to one a 64-position tile and at the serving shapes, a
second launch bit for bit the first, and a CUDA-graph replay after pos
and the cache change in place bit for bit an eager launch, the prefill
wrappers also on views off a 16-byte boundary; the KV appends and the dequant kernel bit-exact (the
append body in every layout, bf16 and fp8, at T = 1 and a chunk, against its
twin, its fp8 rounding on every bf16 pattern against torch's cast, its CUDA
graph replays against eager launches, and one device kernel a _write_kv); the
hybrid GEMM's FP4 columns bit for bit against fused_mul at the same tile
with one k-split (and at block_m = 64), at the GEMM tolerance with more
(fused_mul at one split wherever another kernel is held to its bits);
fused_mul's split-k 16-row tiles at every split count against the twin at
the GEMM tolerance, a second launch and CUDA-graph replays bit for bit the
first launch, the split counters zero after each;
its dense columns at the GEMM tolerance, and a second launch bit for bit
the first at every split count; its 64-row dense CTAs also alone (a launch
with no FP4 columns, bit for bit the full launch's dense columns) and at
w_down's full width (k = 14336, m = 512); mul_fp4_diff's backward on
the card (dequant kernel, cuBLAS dA) against the same on the CPU at the
GEMM tolerance; the high-precision GEMMs against the f64 product of the
same operands, within 4 times the f32 library product's distance from it
plus 2^-24 * max(|A| @ |B|) * |gs| (the MMAs' f32 accumulation does not
round like a serial f32 sum, so no fixed ulp count holds), the
weight-cache one bit for bit the plain one at the same tile and split
count, their 16-row tiles (the stream body's f32 form) at 1 to 4 splits
and the defaults, two launches the same bits, counted as stream launches,
the four Llama-3-8B projections replayed in a CUDA graph bit for bit, the
split counters zero after; their 64-row tiles (the register-A wgmma
body) at full Llama-3-8B widths, m = 130 and, on w_down, 2048, two
launches the same bits, the weight cache bit for bit the plain tile, each
launch counted in wgmma_launches, a CUDA-graph replay bit for bit the
eager calls; every listed solution id through the public entry; the
L2-flushing timer; the Engine's decode blocks on a narrow 3-layer Llama
(flat bf16 and headed fp8 caches): a block's steps, each a replay of the
captured step graph of its window bucket, bit for bit the same number of
eager step() decodes from a snapshot of the same state (tokens, logits at
every step, both caches' bytes; one slot sampling at temperature 0.7),
also across a bucket, the split counters zero after, the block's dispatch
under torch.cuda.set_sync_debug_mode("error"), the pipelined drain equal
to sequential step_block calls and to decode_block=1, and one graph a
bucket after a run through three; the same for an fp8 PagedEngine (its
KV compared per slot, gathered through each slot's own table, since a
block takes its pages up front; the snapshot holds the allocator) and a
narrow Mixtral Engine (flat bf16, headed fp8), their step forwards run
under the sync debug mode too; score_forward of Engine (bf16, fp8),
PagedEngine and the Mixtral Engine on the card against the same engine
on the CPU at L = 37 and 300, logits within 2^-5 * max|logits|;
SpecEngine's ticks on the narrow Llama (a 1-layer draft and the target
itself, flat bf16 and headed fp8): the (g, window) tick graph's replay bit
for bit the eager tick from the same state (tokens, n_acc at
force_accept 0.5 with the generator restored, both caches' bytes) at g =
4 and 11, the KV append counted at capture, streams against the plain
Engine under the near-tie rule on the target's own score_forward logits,
and force_accept = 1.0 accepting g - 1 every tick. On a one-rank NCCL
group: the TP and EP engines (bit for bit the plain ones), the pipelined
decode step and forward at pp = 1 (tokens under the tie rule of the
cacheless forward, the forward within the GEMM tolerance), the dense TP
and SP training steps at tp = 1 (loss and gradients bit for bit the
plain step's); the fallback Engine (a forward_fn without kv_window and
write_mask) against the CPU under the tie rule, its block of 6 bit for
bit 6 eager steps; and, on a host with four cards only, the pipelined
forward and decode and the training steps across four ranks.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from petit_kernel_tpu_torch.models import llama as tllama
from petit_kernel_tpu_torch.models import moe as tmoe
from petit_kernel_tpu_torch.models import paged as tpaged
from petit_kernel_tpu_torch.models import serving as tserving
from petit_kernel_tpu_torch.numerics import reference as qref
from petit_kernel_tpu_torch.ops import gemm as tgemm
from petit_kernel_tpu_torch.ops import hybrid as thybrid
from petit_kernel_tpu_torch.ops import layout
from petit_kernel_tpu_torch.ops import solution as sol
from petit_kernel_tpu_torch.ops.kernels import attention, fused, grouped
from petit_kernel_tpu_torch.ops.kernels import hybrid as khybrid

pytestmark = pytest.mark.cuda

_QUANT = {"nvfp4": (qref.quantize_nvfp4, 16),
          "mxfp4": (qref.quantize_mxfp4, 32),
          "nvfp4p2z": (qref.quantize_nvfp4_pow2z, 16)}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _bf16(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


@pytest.mark.parametrize("fmt", sorted(_QUANT))
@pytest.mark.parametrize("bm,bn", sol.TILE_SHAPES)
def test_fp4_gemm_kernel_matches_twin(gen, fmt, bm, bn):
    quant, group = _QUANT[fmt]
    eb = sol.ElementB.NVFP4 if group == 16 else sol.ElementB.MXFP4
    for m, n, k in ((1, 208, 640), (37, 128, 1024), (70, 336, 384)):
        w = torch.randn((n, k), generator=gen, device="cuda") / math.sqrt(k)
        qw, sc, gs = quant(w)
        words = layout.repack_fp4_weights(qw, n, k,
                                          pad_to=layout.pad_multiple(group))
        st = layout.process_fp4_scales(sc, n, k, group_size=group)
        a = _bf16(gen, m, k)
        sid = sol.SolutionId(bm, bn, eb)
        before = fused.fused_mul.launches
        got = fused.fused_mul(a, words, st, gs.reshape(1), sid=sid)
        assert fused.fused_mul.launches == before + 1
        want = fused.fused_mul_reference(a, words, st, gs.reshape(1),
                                         sid=sid)
        torch.testing.assert_close(
            got.float(), want.float(), rtol=2 ** -7,
            atol=2 ** -8 * want.float().abs().max().item())


_LLAMA_KN = ((4096, 6144), (14336, 4096))   # Llama-3-8B wqkv and w_down


@pytest.mark.parametrize("fmt", sorted(_QUANT))
@pytest.mark.parametrize("bn", [64, 128])
def test_prefill_tiles_match_twin_at_llama_widths(gen, fmt, bn):
    """The 64-row (wgmma) tiles at full Llama-3-8B widths, m = 130 (ragged)
    and 2048, against the twin at the GEMM tolerance."""
    quant, group = _QUANT[fmt]
    eb = sol.ElementB.NVFP4 if group == 16 else sol.ElementB.MXFP4
    sid = sol.SolutionId(64, bn, eb)
    for k, n in _LLAMA_KN:
        w = torch.randn((n, k), generator=gen, device="cuda") / math.sqrt(k)
        qw, sc, gs = quant(w)
        words = layout.repack_fp4_weights(qw, n, k,
                                          pad_to=layout.pad_multiple(group))
        st = layout.process_fp4_scales(sc, n, k, group_size=group)
        for m in (130, 2048):
            a = _bf16(gen, m, k)
            got = fused.fused_mul(a, words, st, gs.reshape(1), sid=sid)
            want = fused.fused_mul_reference(a, words, st, gs.reshape(1),
                                             sid=sid)
            torch.testing.assert_close(
                got.float(), want.float(), rtol=2 ** -7,
                atol=2 ** -8 * want.float().abs().max().item())


@pytest.mark.parametrize("bn", [64, 128])
def test_prefill_tiles_decode_stored_zeros(gen, bn):
    """A weight three quarters zero (nvfp4: the zeros are stored zeros,
    q-code t = 1), k = 4096 padded to nothing and 640 padded to 1024: the
    64-row tiles, plain and weight cache, against the twin; stored zeros
    must add nothing."""
    for m, n, k in ((130, 4096, 4096), (200, 336, 640)):
        w = torch.randn((n, k), generator=gen, device="cuda") / math.sqrt(k)
        w[torch.rand((n, k), generator=gen, device="cuda") < 0.75] = 0
        qw, sc, gs = qref.quantize_nvfp4(w)
        words = layout.repack_fp4_weights(qw, n, k,
                                          pad_to=layout.pad_multiple(16))
        st = layout.process_fp4_scales(sc, n, k, group_size=16)
        a = _bf16(gen, m, k)
        want = fused.fused_mul_reference(a, words, st, gs.reshape(1),
                                         sid=sol.SolutionId(64, bn))
        for wc in (False, True):
            sid = sol.SolutionId(64, bn, weight_cache=wc)
            got = fused.fused_mul(a, words, st, gs.reshape(1), sid=sid)
            torch.testing.assert_close(
                got.float(), want.float(), rtol=2 ** -7,
                atol=2 ** -8 * want.float().abs().max().item())


_QUANT_ALL = {**_QUANT, "nvfp4p2": (qref.quantize_nvfp4_pow2, 16),
              "mxfp4z": (qref.quantize_mxfp4z, 32)}


@pytest.mark.parametrize("fmt", sorted(_QUANT_ALL))
@pytest.mark.parametrize("bn", [64, 128])
def test_split_k_tiles_match_twin_and_repeat(gen, fmt, bn):
    """fused_mul's 16-row tiles (the split-k stream) at ragged m, k padded
    past itself (640 -> 1024: 4 steps; 2176 -> 2560: 10 steps) and n not a
    multiple of the tile, in all five formats: at 1, 2, 3 and kp / 256
    splits and the default, against the twin at the GEMM tolerance; a
    second launch repeats the bits."""
    quant, group = _QUANT_ALL[fmt]
    eb = sol.ElementB.NVFP4 if group == 16 else sol.ElementB.MXFP4
    sid = sol.SolutionId(16, bn, eb)
    for n, k in ((336, 640), (208, 2176)):
        w = torch.randn((n, k), generator=gen, device="cuda") / math.sqrt(k)
        qw, sc, gs = quant(w)
        words = layout.repack_fp4_weights(qw, n, k,
                                          pad_to=layout.pad_multiple(group))
        st = layout.process_fp4_scales(sc, n, k, group_size=group)
        gs = gs.reshape(1)
        steps = words.shape[0] * 8 // fused.KSTEP
        for m in (1, 5, 16, 17, 32):
            a = _bf16(gen, m, k)
            want = fused.fused_mul_reference(a, words, st, gs, sid=sid)
            for splits in (*sorted({1, 2, 3, steps}), None):
                before = fused.fused_mul.launches
                got = fused.fused_mul(a, words, st, gs, sid=sid,
                                      splits=splits)
                assert fused.fused_mul.launches == before + 1
                torch.testing.assert_close(
                    got.float(), want.float(), rtol=2 ** -7,
                    atol=2 ** -8 * want.float().abs().max().item())
                again = fused.fused_mul(a, words, st, gs, sid=sid,
                                        splits=splits)
                assert torch.equal(again.view(torch.int16),
                                   got.view(torch.int16)), (m, n, splits)


_LLAMA8B_KN = ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096))


def test_split_k_tiles_replay_in_a_cuda_graph(gen):
    """The four Llama-3-8B projections at m = 8, default tile and splits:
    after one eager call, the four fused_mul calls captured in a CUDA graph
    and replayed three times give the eager bits each time (outputs zeroed
    before each replay), and every split counter reads zero afterwards:
    nothing on the path syncs with the host or leaves state behind."""
    calls = []
    for k, n in _LLAMA8B_KN:
        w = torch.randn((n, k), generator=gen, device="cuda") / math.sqrt(k)
        qw, sc, gs = qref.quantize_nvfp4(w)
        del w
        words = layout.repack_fp4_weights(qw, n, k)
        st = layout.process_fp4_scales(sc, n, k, group_size=16)
        sid = sol.choose_default_solution(8, n, k)
        assert sid.block_m == 16
        calls.append((_bf16(gen, 8, k), words, st, gs.reshape(1), sid))
    eager = [fused.fused_mul(a, w, s, g, sid=sid)
             for a, w, s, g, sid in calls]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fused.fused_mul(a, w, s, g, sid=sid)
                for a, w, s, g, sid in calls]
    for _ in range(3):
        for out in outs:
            out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for out, want in zip(outs, eager):
            assert torch.equal(out.view(torch.int16), want.view(torch.int16))
    for buf in fused._COUNTERS.values():
        assert not buf.any()


def test_decode_attention_kernel_matches_twin(gen):
    for B, S, hkv, h, d in ((3, 256, 2, 8, 128), (2, 384, 4, 28, 64)):
        q, k, v = _bf16(gen, B, h, d), _bf16(gen, B, S, hkv, d), \
            _bf16(gen, B, S, hkv, d)
        pos = torch.tensor([0, 100, 255][:B], dtype=torch.int32,
                           device="cuda")
        before = attention.decode_attention_contiguous.launches
        got = attention.decode_attention_contiguous(q, k, v, pos, nb=2)
        assert attention.decode_attention_contiguous.launches == before + 1
        want = attention.decode_attention_reference(q, k, v, pos, nb=2)
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=2 ** -7)


# Prefill shapes (B, T, S, hkv, h, d, pos0, window): G = h / hkv of 1, 4,
# 7 and 8, d 64 and 128, ragged last row tiles (T*G not a multiple of 64),
# a window below pos0 + T that cuts a 64-position KV tile, and a late
# chunk at 1536 in a 2048-position window
_PREFILL_CASES = (
    (2, 16, 256, 2, 8, 128, (0, 130), 256),
    (2, 40, 256, 4, 28, 64, (0, 130), 256),
    (2, 20, 256, 2, 2, 64, (3, 245), 240),
    (2, 20, 256, 2, 16, 128, (3, 245), 240),
    (2, 37, 256, 4, 16, 64, (0, 200), 256),
    (1, 128, 2048, 8, 32, 128, (1536,), 2048),
)


def test_flash_prefill_kernel_matches_twin(gen):
    for B, T, S, hkv, h, d, p0, window in _PREFILL_CASES:
        q, k, v = _bf16(gen, B, T, h, d), _bf16(gen, B, S, hkv, d), \
            _bf16(gen, B, S, hkv, d)
        pos0 = torch.tensor(p0, dtype=torch.int32, device="cuda")
        before = attention.flash_prefill_attention.launches
        got = attention.flash_prefill_attention(q, k, v, pos0,
                                                ns=window // 16, block_s=16)
        assert attention.flash_prefill_attention.launches == before + 1
        want = attention.flash_prefill_reference(q, k, v, pos0,
                                                 ns=window // 16, block_s=16)
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=2 ** -7)


def test_prefill_kernels_zero_rows_without_position(gen):
    """A window of 0 leaves every row without a valid position: each
    prefill kernel writes zeros, not NaN."""
    B, T, S, hkv, h, d = 2, 16, 256, 2, 8, 128
    q = _bf16(gen, B, T, h, d)
    pos0 = torch.tensor([0, 100], dtype=torch.int32, device="cuda")
    flat = _bf16(gen, B, S, hkv, d)
    headed = _kv(gen, torch.float8_e4m3fn, B, hkv, S, d)
    pool = _kv(gen, torch.float8_e4m3fn, 2 * B + 1, hkv, 16, d)
    bt = torch.arange(2 * B, dtype=torch.int32, device="cuda").reshape(B, 2)
    for got in (attention.flash_prefill_attention(q, flat, flat, pos0, ns=0),
                attention.flash_prefill_attention(q, headed, headed, pos0,
                                                  ns=0, headed=True),
                attention.flash_prefill_paged(q, pool, pool, bt, pos0,
                                              ns=0)):
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all()
        assert not got.float().any()


def test_kv_append_kernel_bit_exact(gen):
    B, S, hkv, d = 4, 64, 2, 128
    k, v = _bf16(gen, B, S, hkv, d), _bf16(gen, B, S, hkv, d)
    kn, vn = _bf16(gen, B, hkv, d), _bf16(gen, B, hkv, d)
    pos = torch.tensor([0, 9, 63, 31], dtype=torch.int32, device="cuda")
    mask = torch.tensor([True, False, True, True], device="cuda")
    k1, v1, k2, v2 = k.clone(), v.clone(), k.clone(), v.clone()
    before = attention.kv_append.launches
    attention.kv_append(k1, v1, kn, vn, pos, mask)
    assert attention.kv_append.launches == before + 1
    attention.kv_append_reference(k2, v2, kn, vn, pos, mask)
    assert torch.equal(k1.view(torch.int16), k2.view(torch.int16))
    assert torch.equal(v1.view(torch.int16), v2.view(torch.int16))
    assert torch.equal(k1[1].view(torch.int16), k[1].view(torch.int16))


def _kv(gen, dtype, *shape):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


_KV_DTYPES = (torch.bfloat16, torch.float8_e4m3fn)


@pytest.mark.parametrize("dtype", _KV_DTYPES)
@pytest.mark.parametrize("ps", [16, 256])
def test_paged_decode_kernel_matches_twin(gen, dtype, ps):
    """Permuted block tables, ragged positions, one sequence shorter than
    a page."""
    for B, hkv, h, d in ((3, 2, 8, 128), (2, 4, 28, 64)):
        nb = 512 // ps
        P = B * nb + 1
        q = _bf16(gen, B, h, d)
        k, v = _kv(gen, dtype, P, hkv, ps, d), _kv(gen, dtype, P, hkv, ps, d)
        bt = torch.randperm(P - 1, generator=gen, device="cuda")[:B * nb]
        bt = bt.reshape(B, nb).to(torch.int32)
        pos = torch.tensor([5, 300, 511][:B], dtype=torch.int32,
                           device="cuda")
        before = attention.paged_decode_attention.launches
        got = attention.paged_decode_attention(q, k, v, bt, pos, nb=nb,
                                               page_size=ps)
        assert attention.paged_decode_attention.launches == before + 1
        want = attention.paged_decode_reference(q, k, v, bt, pos, nb=nb,
                                                page_size=ps)
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=2 ** -7)


@pytest.mark.parametrize("dtype", _KV_DTYPES)
def test_decode_headed_kernel_matches_twin(gen, dtype):
    for B, S, hkv, h, d in ((3, 256, 2, 8, 128), (2, 384, 4, 28, 64)):
        q = _bf16(gen, B, h, d)
        k, v = _kv(gen, dtype, B, hkv, S, d), _kv(gen, dtype, B, hkv, S, d)
        pos = torch.tensor([0, 100, 255][:B], dtype=torch.int32,
                           device="cuda")
        before = attention.decode_attention_contiguous_headed.launches
        got = attention.decode_attention_contiguous_headed(q, k, v, pos,
                                                           nb=2,
                                                           page_size=128)
        assert (attention.decode_attention_contiguous_headed.launches
                == before + 1)
        want = attention.decode_attention_headed_reference(q, k, v, pos,
                                                           nb=2,
                                                           page_size=128)
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=2 ** -7)


# The split-KV decode body (csrc/decode_attention.cuh) through its three
# entries, as the CPU model plays it (tests/test_torch_decode_split.py):
# positions 0 (every split past the first wholly past pos), a 64-position
# tile's last and first, one past a 16-position page, one past the window;
# G = 1, 4, 8; d = 64, 128; bf16 and fp8; page sizes 16, 128, 256.
_DECODE_POS = (0, 63, 64, 16, 200)
_DECODE_GD = ((1, 64), (4, 128), (8, 64), (8, 128))
_DECODE_ENTRIES = ("flat", "headed bf16", "headed fp8", "paged bf16 16",
                   "paged fp8 16", "paged fp8 128", "paged bf16 256")


def _decode_case(gen, entry, B, hkv, G, d, pos, window, S=None):
    """(kernel(splits), twin(), wrapper, window, K, V) of one decode entry
    over random caches: flat (B, S, Hkv, d), headed (B, Hkv, S, d) or a
    permuted pool of pages; S defaults to the window."""
    kind, *rest = entry.split()
    dtype = torch.float8_e4m3fn if rest and rest[0] == "fp8" else \
        torch.bfloat16
    S = S or window
    q = _bf16(gen, B, G * hkv, d)
    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    if kind == "flat":
        k, v = _bf16(gen, B, S, hkv, d), _bf16(gen, B, S, hkv, d)
        return (lambda s: attention.decode_attention_contiguous(
                    q, k, v, pos, nb=window // 16, page_size=16, splits=s),
                lambda: attention.decode_attention_reference(
                    q, k, v, pos, nb=window // 16, page_size=16),
                attention.decode_attention_contiguous, pos, k, v)
    if kind == "headed":
        k, v = _kv(gen, dtype, B, hkv, S, d), _kv(gen, dtype, B, hkv, S, d)
        return (lambda s: attention.decode_attention_contiguous_headed(
                    q, k, v, pos, nb=window // 16, page_size=16, splits=s),
                lambda: attention.decode_attention_headed_reference(
                    q, k, v, pos, nb=window // 16, page_size=16),
                attention.decode_attention_contiguous_headed, pos, k, v)
    ps = int(rest[1])
    nb = -(-window // ps)
    P = B * nb + 1
    k, v = _kv(gen, dtype, P, hkv, ps, d), _kv(gen, dtype, P, hkv, ps, d)
    bt = torch.randperm(P - 1, generator=gen, device="cuda")[:B * nb]
    bt = bt.reshape(B, nb).to(torch.int32)
    return (lambda s: attention.paged_decode_attention(
                q, k, v, bt, pos, nb=nb, page_size=ps, splits=s),
            lambda: attention.paged_decode_reference(
                q, k, v, bt, pos, nb=nb, page_size=ps),
            attention.paged_decode_attention, pos, k, v)


def _split_counts_zero():
    for buf in fused._COUNTERS.values():
        assert not buf.any()


@pytest.mark.parametrize("entry", _DECODE_ENTRIES)
def test_decode_split_body_every_split_count(gen, entry):
    """Each entry against its twin at 2^-7 at the default split count and
    at every count from 1 to one split a 64-position tile (and one past
    it, cut to that), a second launch bit for bit the first, one launch
    counted a call, the split counters zero after each."""
    for G, d in _DECODE_GD:
        window = 192 if entry.split()[-1] not in ("128", "256") else 256
        kernel, twin, wrapper, *_ = _decode_case(gen, entry, 5, 2, G, d,
                                                 _DECODE_POS, window)
        want = twin()
        tiles = -(-window // 64)
        for splits in (None, *range(1, tiles + 2)):
            before = wrapper.launches
            got = kernel(splits)
            again = kernel(splits)
            torch.cuda.synchronize()
            assert wrapper.launches == before + 2
            assert torch.equal(got.view(torch.int16), again.view(torch.int16))
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=2 ** -7, atol=2 ** -7)
            _split_counts_zero()


# the Engine's decode shape (4 slots mid-decode, window 512) and the
# kernels phase's (8 ragged sequences over 2048 positions)
_DECODE_SERVING = ((4, (274, 316, 177, 108), 512),
                   (8, (0, 5, 127, 128, 700, 1023, 1500, 2047), 2048))


@pytest.mark.parametrize("entry", ("flat", "headed fp8", "paged fp8 16"))
def test_decode_split_body_at_serving_shapes(gen, entry):
    """H = 32, Hkv = 8, d = 128 at the serving shapes: the twin at 2^-7 at
    1 split, the plan's and one split a tile, each launch repeatable."""
    for B, pos, window in _DECODE_SERVING:
        kernel, twin, *_ = _decode_case(gen, entry, B, 8, 4, 128, pos, window)
        want = twin()
        for splits in (1, None, window // 64):
            got = kernel(splits)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int16),
                               kernel(splits).view(torch.int16))
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=2 ** -7, atol=2 ** -7)
        _split_counts_zero()


@pytest.mark.parametrize("entry", ("flat", "headed fp8", "paged fp8 16"))
def test_decode_attention_replays_in_a_cuda_graph(gen, entry):
    """Each entry captured in a CUDA graph at the Engine's decode shape and
    replayed after pos and the cache change in place (the next decode
    step's positions, fresh K/V values): each replay gives the bits of an
    eager launch on the changed inputs. The launch count moves at capture,
    not at replay; the split counters are zero after each replay."""
    B, pos, window = _DECODE_SERVING[0]
    kernel, _, wrapper, pos_t, k, v = _decode_case(gen, entry, B, 8, 4, 128,
                                                   pos, window)
    kernel(None)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = wrapper.launches
    with torch.cuda.graph(graph):
        out = kernel(None)
    assert wrapper.launches == before + 1
    for step in range(1, 4):
        pos_t.add_(step * 37).clamp_(max=window - 1)
        for c in (k, v):
            c.copy_(torch.randn(c.shape, generator=gen, device="cuda").to(
                c.dtype))
        out.zero_()
        graph.replay()
        want = kernel(None)
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int16), want.view(torch.int16))
        _split_counts_zero()
    assert wrapper.launches == before + 4


@pytest.mark.parametrize("dtype", _KV_DTYPES)
@pytest.mark.parametrize("ps", [16, 256])
def test_paged_prefill_kernel_matches_twin(gen, dtype, ps):
    """Permuted block tables over _PREFILL_CASES' shapes, the window
    rounded up to whole pages."""
    for B, T, _, hkv, h, d, p0, window in _PREFILL_CASES:
        ns = -(-window // ps)
        P = B * ns + 1
        q = _bf16(gen, B, T, h, d)
        k, v = _kv(gen, dtype, P, hkv, ps, d), _kv(gen, dtype, P, hkv, ps, d)
        bt = torch.randperm(P - 1, generator=gen, device="cuda")[:B * ns]
        bt = bt.reshape(B, ns).to(torch.int32)
        pos0 = torch.tensor(p0, dtype=torch.int32, device="cuda")
        before = attention.flash_prefill_paged.launches
        got = attention.flash_prefill_paged(q, k, v, bt, pos0, ns=ns)
        assert attention.flash_prefill_paged.launches == before + 1
        want = attention.flash_prefill_paged_reference(q, k, v, bt, pos0,
                                                       ns=ns)
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=2 ** -7)


@pytest.mark.parametrize("dtype", _KV_DTYPES)
def test_prefill_headed_kernel_matches_twin(gen, dtype):
    for B, T, S, hkv, h, d, p0, window in _PREFILL_CASES:
        q = _bf16(gen, B, T, h, d)
        k, v = _kv(gen, dtype, B, hkv, S, d), _kv(gen, dtype, B, hkv, S, d)
        pos0 = torch.tensor(p0, dtype=torch.int32, device="cuda")
        before = attention.flash_prefill_headed.launches
        got = attention.flash_prefill_attention(q, k, v, pos0,
                                                ns=window // 16, block_s=16,
                                                headed=True)
        assert attention.flash_prefill_headed.launches == before + 1
        want = attention.flash_prefill_headed_reference(
            q, k, v, pos0, ns=window // 16, block_s=16)
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=2 ** -7)


def _off_boundary(t):
    """t's values in a contiguous view one element past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16
    return view


def test_prefill_wrappers_realign_views_off_a_16_byte_boundary(gen):
    """q and the K/V caches as views off a 16-byte boundary (2 bytes for
    bf16, 1 for fp8): the flat, headed and paged prefill wrappers clone
    them and match their twins."""
    B, T, S, hkv, h, d, p0, window = _PREFILL_CASES[0]
    pos0 = torch.tensor(p0, dtype=torch.int32, device="cuda")
    q = _bf16(gen, B, T, h, d)
    k, v = _bf16(gen, B, S, hkv, d), _bf16(gen, B, S, hkv, d)
    ns = window // 16
    got = attention.flash_prefill_attention(
        _off_boundary(q), _off_boundary(k), _off_boundary(v), pos0, ns=ns,
        block_s=16)
    want = attention.flash_prefill_reference(q, k, v, pos0, ns=ns,
                                             block_s=16)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=2 ** -7)
    fp8 = torch.float8_e4m3fn
    kh, vh = _kv(gen, fp8, B, hkv, S, d), _kv(gen, fp8, B, hkv, S, d)
    got = attention.flash_prefill_attention(
        _off_boundary(q), _off_boundary(kh), _off_boundary(vh), pos0, ns=ns,
        block_s=16, headed=True)
    want = attention.flash_prefill_headed_reference(q, kh, vh, pos0, ns=ns,
                                                    block_s=16)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=2 ** -7)
    ps = 16
    pages = -(-window // ps)
    P = B * pages + 1
    kp, vp = _kv(gen, fp8, P, hkv, ps, d), _kv(gen, fp8, P, hkv, ps, d)
    bt = torch.randperm(P - 1, generator=gen, device="cuda")[:B * pages]
    bt = bt.reshape(B, pages).to(torch.int32)
    got = attention.flash_prefill_paged(
        _off_boundary(q), _off_boundary(kp), _off_boundary(vp), bt, pos0,
        ns=pages)
    want = attention.flash_prefill_paged_reference(q, kp, vp, bt, pos0,
                                                   ns=pages)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=2 ** -7)


@pytest.mark.parametrize("dtype", _KV_DTYPES)
def test_kv_append_headed_kernel_bit_exact(gen, dtype):
    B, S, hkv, d = 4, 64, 2, 128
    k, v = _kv(gen, dtype, B, hkv, S, d), _kv(gen, dtype, B, hkv, S, d)
    kn, vn = _bf16(gen, B, hkv, d), _bf16(gen, B, hkv, d)
    pos = torch.tensor([0, 9, 63, 31], dtype=torch.int32, device="cuda")
    mask = torch.tensor([True, False, True, True], device="cuda")
    k1, v1, k2, v2 = k.clone(), v.clone(), k.clone(), v.clone()
    before = attention.kv_append_headed.launches
    attention.kv_append(k1, v1, kn, vn, pos, mask, headed=True)
    assert attention.kv_append_headed.launches == before + 1
    attention.kv_append_headed_reference(k2, v2, kn, vn, pos, mask)
    for got, want in ((k1, k2), (v1, v2)):
        assert torch.equal(attention._bits(got), attention._bits(want))
    assert torch.equal(attention._bits(k1[1]), attention._bits(k[1]))


# the append body's layouts: cache kind and dtype
_APPEND_LAYOUTS = ("flat bf16", "flat fp8", "headed bf16", "headed fp8",
                   "paged bf16", "paged fp8")


def _append_setup(gen, layout, T, B=4, hkv=8, d=128, S=64, ps=16):
    """A cache pair (or pool pair) of `layout`, new K and V (B, T, hkv, d) as
    strided views of one fused qkv tensor (the Llama block's), and the
    wrapper, its twin and its counter as functions of (cache, k, v, pos,
    mask). A pool of B * S / ps pages and a scratch page, each row's pages
    permuted."""
    kind, tag = layout.split()
    dtype = torch.bfloat16 if tag == "bf16" else torch.float8_e4m3fn
    nq = 32
    qkv = _bf16(gen, B, T, (nq + 2 * hkv) * d)
    k = qkv[..., nq * d:(nq + hkv) * d].reshape(B, T, hkv, d)
    v = qkv[..., (nq + hkv) * d:].reshape(B, T, hkv, d)
    if kind == "paged":
        P = B * S // ps + 1
        shape = (P, hkv, ps, d)
        bt = torch.randperm(P - 1, generator=gen, device="cuda").reshape(
            B, S // ps).to(torch.int32)

        def kernel(c, k_, v_, pos, mask):
            attention.kv_append_paged(*c, bt, k_, v_, pos, ps, mask)

        def twin(c, k_, v_, pos, mask):
            attention.kv_append_paged_reference(*c, bt, k_, v_, pos, ps, mask)
        wrapper = attention.kv_append_paged
    else:
        headed = kind == "headed"
        shape = (B, hkv, S, d) if headed else (B, S, hkv, d)

        def kernel(c, k_, v_, pos, mask):
            attention.kv_append(*c, k_, v_, pos, mask, headed=headed)
        ref = (attention.kv_append_headed_reference if headed
               else attention.kv_append_reference)

        def twin(c, k_, v_, pos, mask):
            ref(*c, k_, v_, pos, mask)
        wrapper = attention.kv_append_headed if headed else attention.kv_append
    cache = tuple(_kv(gen, dtype, *shape) for _ in range(2))
    return cache, qkv, k, v, kernel, twin, wrapper


def _append_pos(T, S=64, B=4):
    """(B, T) positions, int32 at T = 1 and int64 past it; with T > 1 one
    position below 0 and one past S (and the block table): no write."""
    pos = torch.tensor([0, 17, 40, S - T], device="cuda")[:, None] \
        + torch.arange(T, device="cuda")
    if T > 1:
        pos[1, 1], pos[2, T - 2] = -1, S + 3
    return pos.to(torch.int64 if T > 1 else torch.int32)


_APPEND_MASKS = {"none": None, "bool": (True, False, True, True),
                 "int32": (0, 1, 1, 0)}


def _append_mask(kind):
    m = _APPEND_MASKS[kind]
    return None if m is None else torch.tensor(
        m, dtype=torch.bool if kind == "bool" else torch.int32,
        device="cuda")


def _same_bits(got, want, pool=False):
    """Cache bytes equal. With pool, the scratch page (the last) is left
    out: masked rows all write it at offset 0, in no set order."""
    cut = slice(0, -1) if pool else slice(None)
    return all(torch.equal(attention._bits(g[cut]), attention._bits(w[cut]))
               for g, w in zip(got, want))


def test_kv_append_fp8_rounding_of_every_bf16_pattern(gen):
    """All 65,536 bf16 bit patterns as the new K (and, reversed, V) of a
    headed fp8 append: the cache bytes are .to(torch.float8_e4m3fn)'s bit
    for bit, NaN signs, subnormals, -0 and the overflow rule included."""
    B, hkv, S, d = 4, 8, 16, 128
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32, device="cuda")
    x = bits.to(torch.int16).view(torch.bfloat16).reshape(B, S, hkv, d)
    y = x.flip(0)
    ck, cv = (torch.zeros((B, hkv, S, d), dtype=torch.float8_e4m3fn,
                          device="cuda") for _ in range(2))
    pos = torch.arange(S, device="cuda").expand(B, S)
    attention.kv_append(ck, cv, x, y, pos, headed=True)
    for c, new in ((ck, x), (cv, y)):
        want = new.to(torch.float8_e4m3fn).transpose(1, 2)
        assert torch.equal(attention._bits(c), attention._bits(want))


@pytest.mark.parametrize("mask", sorted(_APPEND_MASKS))
@pytest.mark.parametrize("T", [1, 7])
@pytest.mark.parametrize("layout", _APPEND_LAYOUTS)
def test_kv_append_body_bit_exact_twin(gen, layout, T, mask):
    """Every layout and cache dtype, one token and a 7-token chunk, with and
    without a mask (bool or int32), K and V strided views of the fused qkv
    tensor: one launch, the cache bytes of the twin. At T = 1 the JAX
    signature, (B, Hkv, d) rows at (B,) positions."""
    cache, _, k, v, kernel, twin, wrapper = _append_setup(gen, layout, T)
    pos, m = _append_pos(T), _append_mask(mask)
    args = (k[:, 0], v[:, 0], pos[:, 0]) if T == 1 else (k, v, pos)
    got, want = [c.clone() for c in cache], [c.clone() for c in cache]
    before = wrapper.launches
    kernel(got, *args, m)
    assert wrapper.launches == before + 1
    twin(want, *args, m)
    torch.cuda.synchronize()
    pool = layout.startswith("paged") and m is not None \
        and int((m == 0).sum()) > 1
    assert _same_bits(got, want, pool)
    assert not _same_bits(got, cache)


@pytest.mark.parametrize("T", [1, 7])
@pytest.mark.parametrize("layout", ["flat bf16", "headed fp8", "paged fp8"])
def test_kv_append_replays_in_a_cuda_graph(gen, layout, T):
    """Each entry captured in a CUDA graph, then replayed three times after
    new positions, new K/V values and a new mask are written into the same
    tensors: each replay leaves the cache bytes of an eager launch on the
    same inputs. The launch count moves at capture, not at replay."""
    cache, qkv, k, v, kernel, _, wrapper = _append_setup(gen, layout, T)
    pos, m = _append_pos(T), _append_mask("bool")
    graphed, eager = [c.clone() for c in cache], [c.clone() for c in cache]
    warm = [c.clone() for c in cache]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernel(warm, k, v, pos, m)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = wrapper.launches
    with torch.cuda.graph(graph):
        kernel(graphed, k, v, pos, m)
    assert wrapper.launches == before + 1
    for step in range(1, 4):
        pos.add_(step * 3).remainder_(64)
        qkv.copy_(_bf16(gen, *qkv.shape))
        m.copy_(torch.tensor([step % 2 == 0, True, step != 2, False],
                             device="cuda"))
        graph.replay()
        kernel(eager, k, v, pos, m)
        torch.cuda.synchronize()
        assert _same_bits(graphed, eager, layout.startswith("paged"))
    assert wrapper.launches == before + 4


@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("layout", ["flat bf16", "headed bf16", "headed fp8",
                                    "paged fp8"])
def test_write_kv_launches_one_kernel(gen, layout, T):
    """models/llama.py and models/paged.py _write_kv as the Llama block
    calls them (K and V views of the fused qkv tensor, int32 (B, T)
    positions, a bool write mask) launch exactly one device kernel, the
    append body, and nothing else: no cast, copy, gather or index write
    (three calls under the profiler, three launches of one kernel)."""
    from torch.profiler import ProfilerActivity, profile
    cache, _, k, v, _, _, _ = _append_setup(gen, layout, T)
    pos = _append_pos(T).clamp(0, 63).to(torch.int32)
    m = _append_mask("bool")
    if layout.startswith("paged"):
        P = cache[0].shape[0]
        bt = torch.randperm(P - 1, generator=gen, device="cuda").reshape(
            4, -1).to(torch.int32)

        def write():
            tpaged._write_kv(cache, bt, k, v, pos, 16, m)
    else:
        headed = layout.startswith("headed")

        def write():
            tllama._write_kv(*cache, k, v, pos, m, headed)
    write()
    torch.cuda.synchronize()
    # CUPTI now and then hands back no device event at all for so short a
    # window; a window with none is profiled again, up to three times
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                write()
            torch.cuda.synchronize()
        kernels = [(e.key, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    assert len(kernels) == 1 and kernels[0][1] == 3, kernels
    assert "kv_append_kernel" in kernels[0][0], kernels


@pytest.mark.parametrize("fmt", ["mxfp4", "nvfp4"])
@pytest.mark.parametrize("cap,splits", [(8, 1), (8, 2), (128, 1)])
def test_grouped_kernel_matches_twin_and_fused_mul(gen, fmt, cap, splits):
    """E=4 experts, a k padded past itself (640) and a ragged n (336); the
    16-row tiles (cap 8) at 1 and 2 k-splits, the 64-row ones (cap 128) at
    1: each expert bit for bit fused_mul at the same tile and splits."""
    E, k, n = 4, 640, 336
    eb = sol.ElementB.MXFP4 if fmt == "mxfp4" else sol.ElementB.NVFP4
    w = torch.randn((E, k, n), generator=gen, device="cuda") / math.sqrt(k)
    ex = tmoe.quantize_moe_linear(w, fmt)
    xs = _bf16(gen, E, cap, k)
    xs[1, cap // 2:] = 0                 # an expert's empty bucket slots
    sid = sol.choose_default_solution(cap, n, k, eb)
    before = grouped.grouped_mul.launches
    got = grouped.grouped_mul(xs, ex["words"], ex["scales"], ex["gs"],
                              sid=sid, splits=splits)
    assert grouped.grouped_mul.launches == before + 1
    want = grouped.grouped_mul_reference(xs, ex["words"], ex["scales"],
                                         ex["gs"], sid=sid)
    torch.testing.assert_close(
        got.float(), want.float(), rtol=2 ** -7,
        atol=2 ** -8 * want.float().abs().max().item())
    for e in range(E):
        one = fused.fused_mul(xs[e], ex["words"][e], ex["scales"][e],
                              ex["gs"][e:e + 1], sid=sid, splits=splits)
        assert torch.equal(one.view(torch.int16), got[e].view(torch.int16))
    for buf in fused._COUNTERS.values():
        assert not buf.any()


def _grouped_layer(gen, E=4, cap=8, H=512, F=768, fmt="mxfp4"):
    """A small MoE layer's stacked experts (w_gate, w_up, w_down) and
    buckets: expert 0 empty, expert 1 filled to cap / 2, the others full,
    with their rows tensor."""
    layer = {}
    for name, (k, n) in (("w_gate", (H, F)), ("w_up", (H, F)),
                         ("w_down", (F, H))):
        w = torch.randn((E, k, n), generator=gen, device="cuda") / math.sqrt(k)
        layer[name] = tmoe.quantize_moe_linear(w, fmt)
    filled = [0, cap // 2] + [cap] * (E - 2)
    xs = _bf16(gen, E, cap, H)
    for e, f in enumerate(filled):
        xs[e, f:] = 0
    return layer, xs, torch.tensor(filled, dtype=torch.int32, device="cuda")


def _layer_calls(layer, xs, **kw):
    def gmul(ys, ex):
        return grouped.grouped_mul(ys, ex["words"], ex["scales"], ex["gs"],
                                   **kw)
    g = gmul(xs, layer["w_gate"])
    u = gmul(xs, layer["w_up"])
    h = torch.nn.functional.silu(g.float()).to(torch.bfloat16) * u
    return gmul(h, layer["w_down"])


@pytest.mark.parametrize("cap", [8, 24])
@pytest.mark.parametrize("splits", [1, 2, None])
def test_grouped_rows_skip_empty_tiles_bit_for_bit(gen, cap, splits):
    """rows skips the 16-row tiles at or past each bucket's filled rows
    (cap 24: expert 1's second tile): the three calls of a layer give the
    bits of the launch without rows, +0 for the empty expert, and leave
    every split counter at zero."""
    layer, xs, rows = _grouped_layer(gen, cap=cap)
    for ex in layer.values():
        want = grouped.grouped_mul(xs, ex["words"], ex["scales"], ex["gs"],
                                   splits=splits)
        got = grouped.grouped_mul(xs, ex["words"], ex["scales"], ex["gs"],
                                  splits=splits, rows=rows)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
        assert not got[0].view(torch.int16).any()          # +0, sign clear
    want = _layer_calls(layer, xs, splits=splits)
    got = _layer_calls(layer, xs, splits=splits, rows=rows)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    for buf in fused._COUNTERS.values():
        assert not buf.any()


def test_grouped_layer_replays_in_a_cuda_graph(gen):
    """The three grouped calls of a layer with rows, default splits (more
    than one at these widths): captured after one eager run, replayed
    twice, each replay the eager bits; the counters zero after."""
    layer, xs, rows = _grouped_layer(gen)
    ex = layer["w_gate"]
    assert grouped.grouped_splits(
        4, 8, ex["words"].shape[2], ex["words"].shape[1] * 8, 16, 64,
        fused._num_sms(0)) > 1
    eager = _layer_calls(layer, xs, rows=rows)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _layer_calls(layer, xs, rows=rows)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int16), eager.view(torch.int16))
    for buf in fused._COUNTERS.values():
        assert not buf.any()


def test_init_cache_defaults_to_the_card(gen):
    del gen
    cache = tllama.init_cache(tllama.LlamaConfig.tiny(), 2)
    assert cache[0][0].device.type == "cuda"


_W4A8_CASES = ((1, 208, 640), (37, 128, 1024), (70, 336, 384),
               (300, 256, 512))


@pytest.mark.parametrize("fmt", ["nvfp4", "mxfp4"])
@pytest.mark.parametrize("bm,bn", sol.TILE_SHAPES)
def test_w4a8_kernels_bit_equal_to_twin(gen, fmt, bm, bn):
    """Ragged m and n, k padded past itself; the weight-cache kernel where
    the id is feasible (m > block_m), with precomputed constants."""
    quant, group = _QUANT[fmt]
    eb = sol.ElementB.NVFP4 if group == 16 else sol.ElementB.MXFP4
    for m, n, k in _W4A8_CASES:
        w = torch.randn((n, k), generator=gen, device="cuda") / math.sqrt(k)
        qw, sc, gs = quant(w)
        words = layout.repack_fp4_weights(qw, n, k,
                                          pad_to=layout.pad_multiple(group))
        st = layout.process_fp4_scales(sc, n, k, group_size=group)
        a = _bf16(gen, m, k)
        sid = sol.SolutionId(bm, bn, eb, sol.MatmulType.INT8)
        before = fused.fused_mul_w4a8.launches
        got = fused.fused_mul_w4a8(a, words, st, gs.reshape(1), sid=sid)
        assert fused.fused_mul_w4a8.launches == before + 1
        want = fused.fused_mul_w4a8_reference(a, words, st, gs.reshape(1),
                                              sid=sid)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
        wc = sol.SolutionId(bm, bn, eb, sol.MatmulType.INT8,
                            weight_cache=True)
        if sol.is_feasible(wc, m, n, k):
            r_t, acol = fused.w4a8_requant_constants(st)
            before = fused.fused_mul_w4a8_wc.launches
            got = fused.fused_mul_w4a8(a, words, st, gs.reshape(1), sid=wc,
                                       r_t=r_t, acol=acol)
            assert fused.fused_mul_w4a8_wc.launches == before + 1
            assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def _w4a8_operands(gen, fmt, n, k):
    quant, group = _QUANT[fmt]
    w = torch.randn((n, k), generator=gen, device="cuda") / math.sqrt(k)
    qw, sc, gs = quant(w)
    words = layout.repack_fp4_weights(qw, n, k,
                                      pad_to=layout.pad_multiple(group))
    st = layout.process_fp4_scales(sc, n, k, group_size=group)
    eb = sol.ElementB.NVFP4 if group == 16 else sol.ElementB.MXFP4
    return words, st, gs.reshape(1), eb


@pytest.mark.parametrize("fmt", ["nvfp4", "mxfp4"])
@pytest.mark.parametrize("bn", [64, 128])
def test_w4a8_wgmma_tiles_bit_equal_to_twin(gen, fmt, bn):
    """The plain kernel's 64-row tiles (the int8 wgmma body) at k = 4096,
    over 5 and 32 m-tiles (m = 300, ragged, and 2048), bit for bit the
    twin, each launch counted as a wgmma launch."""
    n, k = 512, 4096
    words, st, gs, eb = _w4a8_operands(gen, fmt, n, k)
    sid = sol.SolutionId(64, bn, eb, sol.MatmulType.INT8)
    for m in (300, 2048):
        a = _bf16(gen, m, k)
        before = fused.fused_mul_w4a8.wgmma_launches
        got = fused.fused_mul_w4a8(a, words, st, gs, sid=sid)
        assert fused.fused_mul_w4a8.wgmma_launches == before + 1
        want = fused.fused_mul_w4a8_reference(a, words, st, gs, sid=sid)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("fmt", ["nvfp4", "mxfp4"])
@pytest.mark.parametrize("bn", [64, 128])
def test_w4a8_weight_cache_bit_equal_to_wgmma_tiles(gen, fmt, bn):
    """The weight-cache kernel's 64-row tiles (the int8 wgmma body, G
    m-tiles a CTA sharing one requantization) against the plain kernel's
    at the same widths, bit for bit, at m = 200 (one partial m-group at G
    = 4), 300 (a partial group after full ones) and 2048, each launch
    counted as a wgmma launch of the weight cache."""
    n, k = 512, 4096
    words, st, gs, eb = _w4a8_operands(gen, fmt, n, k)
    r_t, acol = fused.w4a8_requant_constants(st)
    sid = sol.SolutionId(64, bn, eb, sol.MatmulType.INT8)
    wc = sol.SolutionId(64, bn, eb, sol.MatmulType.INT8, weight_cache=True)
    for m in (200, 300, 2048):
        a = _bf16(gen, m, k)
        plain = fused.fused_mul_w4a8(a, words, st, gs, sid=sid, r_t=r_t,
                                     acol=acol)
        before = fused.fused_mul_w4a8_wc.launches
        wgmma = fused.fused_mul_w4a8_wc.wgmma_launches
        got = fused.fused_mul_w4a8(a, words, st, gs, sid=wc, r_t=r_t,
                                   acol=acol)
        assert fused.fused_mul_w4a8_wc.launches == before + 1
        assert fused.fused_mul_w4a8_wc.wgmma_launches == wgmma + 1
        assert torch.equal(got.view(torch.int16), plain.view(torch.int16))


@pytest.mark.parametrize("fmt", ["nvfp4", "mxfp4"])
@pytest.mark.parametrize("bn", [64, 128])
def test_w4a8_stream_tiles_every_split_count(gen, fmt, bn):
    """The 16-row tiles of both W4A8 kernels (the split-k int8 stream body
    of csrc/w4a8_stream.cuh) on _W4A8_CASES at 1, 2, 3 (where kp / 256
    allows) and kp / 256 splits and the default: bit for bit the twin, a
    second launch the same bits, each launch counted as a stream launch;
    the weight cache (where its id is feasible, m > 16) bit for bit the
    plain 16-row tile."""
    for m, n, k in _W4A8_CASES:
        words, st, gs, eb = _w4a8_operands(gen, fmt, n, k)
        r_t, acol = fused.w4a8_requant_constants(st)
        a = _bf16(gen, m, k)
        sid = sol.SolutionId(16, bn, eb, sol.MatmulType.INT8)
        wc = sol.SolutionId(16, bn, eb, sol.MatmulType.INT8,
                            weight_cache=True)
        want = fused.fused_mul_w4a8_reference(a, words, st, gs, sid=sid,
                                              r_t=r_t, acol=acol)
        steps = words.shape[0] * 8 // fused.KSTEP
        counts = sorted({c for c in (1, 2, 3, steps) if c <= steps})
        for splits in (*counts, None):
            plain = None
            for s_, wrapper in ((sid, fused.fused_mul_w4a8),
                                (wc, fused.fused_mul_w4a8_wc)):
                if s_.weight_cache and not sol.is_feasible(s_, m, n, k):
                    continue
                before = wrapper.stream_launches
                got = fused.fused_mul_w4a8(a, words, st, gs, sid=s_, r_t=r_t,
                                           acol=acol, splits=splits)
                assert wrapper.stream_launches == before + 1
                what = (m, n, k, s_.weight_cache, splits)
                assert torch.equal(got.view(torch.int16),
                                   want.view(torch.int16)), what
                again = fused.fused_mul_w4a8(a, words, st, gs, sid=s_,
                                             r_t=r_t, acol=acol,
                                             splits=splits)
                assert torch.equal(again.view(torch.int16),
                                   got.view(torch.int16)), what
                if plain is None:
                    plain = got
                else:
                    assert torch.equal(got.view(torch.int16),
                                       plain.view(torch.int16)), what


def test_w4a8_and_fp4_stream_tiles_leave_the_split_counters_zero(gen):
    """Llama-3-8B's wo (k = n = 4096) at 4 splits: a W4A8 16-row launch
    (the plain tile at m = 16, then the weight cache at m = 64) followed
    by fused_mul's 16-row tiles on the same stream, which share the
    counter buffer: every result right (the W4A8 ones bit for bit, the FP4
    one at the GEMM tolerance) and every split counter zero afterwards."""
    n = k = 4096
    words, st, gs, eb = _w4a8_operands(gen, "nvfp4", n, k)
    r_t, acol = fused.w4a8_requant_constants(st)
    fp4 = sol.SolutionId(16, 64, eb)
    for m, wc in ((16, False), (64, True)):
        a = _bf16(gen, m, k)
        sid = sol.SolutionId(16, 64, eb, sol.MatmulType.INT8,
                             weight_cache=wc)
        got = fused.fused_mul_w4a8(a, words, st, gs, sid=sid, r_t=r_t,
                                   acol=acol, splits=4)
        a8 = a[:8].contiguous()
        out = fused.fused_mul(a8, words, st, gs, sid=fp4, splits=4)
        torch.cuda.synchronize()
        for buf in fused._COUNTERS.values():
            assert not buf.any(), (m, wc)
        want = fused.fused_mul_w4a8_reference(a, words, st, gs, sid=sid,
                                              r_t=r_t, acol=acol)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
        ref = fused.fused_mul_reference(a8, words, st, gs, sid=fp4)
        torch.testing.assert_close(
            out.float(), ref.float(), rtol=2 ** -7,
            atol=2 ** -8 * ref.float().abs().max().item())


def _fp4_operands(gen, fmt, n, k):
    quant, group = _QUANT[fmt]
    eb = sol.ElementB.NVFP4 if group == 16 else sol.ElementB.MXFP4
    w = torch.randn((n, k), generator=gen, device="cuda") / math.sqrt(k)
    qw, sc, gs = quant(w)
    words = layout.repack_fp4_weights(qw, n, k,
                                      pad_to=layout.pad_multiple(group))
    st = layout.process_fp4_scales(sc, n, k, group_size=group)
    return words, st, gs.reshape(1), eb


def _wc_split_counts(m, n, words, bm, bn, eb):
    """The split counts both sides take: 1 to 4 (as kp / 256 allows) and
    the default of each entry, passed to both; 1 at block_m = 64."""
    if bm == 64:
        return [1]
    kp = words.shape[0] * 8
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plain = fused.stream_splits(m, n, 0, kp, bm, bn, sms)[0]
    wc = fused.fp4_wc_splits(m, n, kp, sol.SolutionId(bm, bn, eb,
                                                      weight_cache=True), sms)
    return sorted({c for c in (1, 2, 3, 4) if c <= kp // fused.KSTEP}
                  | {plain, wc})


@pytest.mark.parametrize("fmt", ["nvfp4", "mxfp4"])
@pytest.mark.parametrize("bm,bn", sol.TILE_SHAPES)
def test_weight_cache_kernel_bit_equal_to_fp4_gemm(gen, fmt, bm, bn):
    """The weight cache (4 m-tiles a CTA) bit for bit fused_mul's plain
    tile at the same tile and split count: every count from 1 to 4 and the
    default of each entry at the 16-row tiles, one split at the 64-row
    ones; its 16-row launches counted as stream launches."""
    for m, n, k in _W4A8_CASES[1:]:
        words, st, gs, eb = _fp4_operands(gen, fmt, n, k)
        a = _bf16(gen, m, k)
        wc = sol.SolutionId(bm, bn, eb, weight_cache=True)
        if not sol.is_feasible(wc, m, n, k):
            continue
        for splits in _wc_split_counts(m, n, words, bm, bn, eb):
            plain = fused.fused_mul(a, words, st, gs,
                                    sid=sol.SolutionId(bm, bn, eb),
                                    splits=splits)
            before = fused.fused_mul_wc.launches
            stream = fused.fused_mul_wc.stream_launches
            got = fused.fused_mul(a, words, st, gs, sid=wc, splits=splits)
            assert fused.fused_mul_wc.launches == before + 1
            assert fused.fused_mul_wc.stream_launches == stream + (bm == 16)
            assert torch.equal(got.view(torch.int16),
                               plain.view(torch.int16)), (m, n, k, splits)


@pytest.mark.parametrize("fmt", ["nvfp4", "mxfp4"])
@pytest.mark.parametrize("bn", [64, 128])
def test_weight_cache_16_row_tiles_every_split_count(gen, fmt, bn):
    """The weight cache's 16-row tiles (the stream body, 4 m-tiles a CTA)
    at m = 1 to 130 (one m-group partial, several, rows past m in every
    m-tile position), n = 336 (a ragged last n-tile), k = 640 padded to
    1024 (four steps): at 1 to 4 splits and both defaults bit for bit the
    plain 16-row tile at the same count, within the GEMM tolerance of the
    twin, a second launch the same bits."""
    n, k = 336, 640
    words, st, gs, eb = _fp4_operands(gen, fmt, n, k)
    wc = sol.SolutionId(16, bn, eb, weight_cache=True)
    for m in (1, 16, 17, 63, 64, 65, 130):
        a = _bf16(gen, m, k)
        want = fused.fused_mul_reference(a, words, st, gs, sid=wc)
        for splits in _wc_split_counts(m, n, words, 16, bn, eb):
            plain = fused.fused_mul(a, words, st, gs,
                                    sid=sol.SolutionId(16, bn, eb),
                                    splits=splits)
            got = fused.fused_mul(a, words, st, gs, sid=wc, splits=splits)
            again = fused.fused_mul_wc(a, words, st, gs, sid=wc,
                                       splits=splits)
            what = (m, bn, splits)
            assert torch.equal(got.view(torch.int16),
                               plain.view(torch.int16)), what
            assert torch.equal(again.view(torch.int16),
                               got.view(torch.int16)), what
            torch.testing.assert_close(
                got.float(), want.float(), rtol=2 ** -7,
                atol=2 ** -8 * want.float().abs().max().item())
    torch.cuda.synchronize()
    for buf in fused._COUNTERS.values():
        assert not buf.any()


def test_weight_cache_16_row_launch_counts_as_a_stream_launch(gen):
    """fused_mul_wc counts each launch in .launches, the 16-row ones also
    in .stream_launches, the 64-row ones not."""
    words, st, gs, eb = _fp4_operands(gen, "nvfp4", 256, 512)
    a = _bf16(gen, 300, 512)
    for bm, bn in sol.TILE_SHAPES:
        sid = sol.SolutionId(bm, bn, eb, weight_cache=True)
        launches = fused.fused_mul_wc.launches
        stream = fused.fused_mul_wc.stream_launches
        fused.fused_mul_wc(a, words, st, gs, sid=sid)
        assert fused.fused_mul_wc.launches == launches + 1
        assert fused.fused_mul_wc.stream_launches == stream + (bm == 16)


def test_weight_cache_16_row_tiles_replay_in_a_cuda_graph(gen):
    """The weight cache's 16-row tiles (16x64 and 16x128) captured in one
    CUDA graph: the four Llama-3-8B projections at m = 64 and default
    splits, and n = 336, k = 640 at m = 1 to 130 in nvfp4 and mxfp4 at
    their default splits and at 3. After one eager call, three replays
    (outputs zeroed before each) give the eager bits each time, which are
    the plain 16-row tile's at the same splits, and every split counter
    reads zero afterwards."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    calls = []
    shapes = [("nvfp4", 64, n, k, None) for k, n in _LLAMA8B_KN]
    shapes += [(fmt, m, 336, 640, s) for fmt in ("nvfp4", "mxfp4")
               for m in (1, 16, 17, 63, 64, 65, 130) for s in (None, 3)]
    for fmt, m, n, k, splits in shapes:
        words, st, gs, eb = _fp4_operands(gen, fmt, n, k)
        a = _bf16(gen, m, k)
        for bn in (64, 128):
            sid = sol.SolutionId(16, bn, eb, weight_cache=True)
            s_ = splits or fused.fp4_wc_splits(m, n, words.shape[0] * 8,
                                               sid, sms)
            calls.append((a, words, st, gs, sid, s_))
    eager = [fused.fused_mul(a, w, s, g, sid=sid, splits=sp)
             for a, w, s, g, sid, sp in calls]
    plain = [fused.fused_mul(a, w, s, g, sid=sol.SolutionId(16, sid.block_n,
                                                            sid.element_b),
                             splits=sp)
             for a, w, s, g, sid, sp in calls]
    torch.cuda.synchronize()
    for got, want in zip(eager, plain):
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fused.fused_mul(a, w, s, g, sid=sid, splits=sp)
                for a, w, s, g, sid, sp in calls]
    for _ in range(3):
        for out in outs:
            out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for out, want in zip(outs, eager):
            assert torch.equal(out.view(torch.int16), want.view(torch.int16))
    for buf in fused._COUNTERS.values():
        assert not buf.any()


@pytest.mark.parametrize("fmt", ["nvfp4", "mxfp4"])
def test_dequant_kernel_bit_equal_to_twin(gen, fmt):
    """k padded past itself (640 -> 1024) and a ragged n (336)."""
    quant, group = _QUANT[fmt]
    for n, k in ((336, 640), (128, 4096)):
        w = torch.randn((n, k), generator=gen, device="cuda") / math.sqrt(k)
        qw, sc, _ = quant(w)
        words = layout.repack_fp4_weights(qw, n, k,
                                          pad_to=layout.pad_multiple(group))
        st = layout.process_fp4_scales(sc, n, k, group_size=group)
        before = fused.dequant_tpu_layout.launches
        got = fused.dequant_tpu_layout(words, st)
        assert fused.dequant_tpu_layout.launches == before + 1
        want = fused.dequant_tpu_layout_reference(words, st)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("bm,bn", sol.TILE_SHAPES)
def test_hybrid_kernel_matches_fused_mul_and_twin(gen, bm, bn):
    """Ragged m, k padded past itself, nf and nd not multiples of the tile.
    block_m = 16: with one split the FP4 columns bit for bit fused_mul's at
    the same tile; at the default splits, 2, 3 and one split per step both
    halves against the twin at the GEMM tolerance. block_m = 64 (no split):
    the FP4 columns bit for bit fused_mul's at the default splits. The
    dense columns against the twin, and a second launch repeats the bits,
    at every split count."""
    for m, n, k, bnf, bnd in ((1, 512, 512, 384, 128),
                              (37, 1024, 640, 768, 256),
                              (70, 2048, 1024, 1536, 512)):
        w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
        hq = thybrid.quantize_hybrid(w, block_nf=bnf, block_nd=bnd)
        a = _bf16(gen, m, k)
        sid = sol.SolutionId(bm, bn)
        args = (a, hq["words"], hq["scales"], hq["gs"].reshape(1), hq["wd"])
        steps = hq["words"].shape[0] * 8 // khybrid.KSTEP
        plain = fused.fused_mul(*args[:4], sid=sid, splits=1)
        want_f, want_d = khybrid.hybrid_mul_reference(*args, sid=sid)
        runs = [None] if bm == 64 else [1, None, *sorted(
            {s for s in (2, 3, steps) if s <= steps})]
        for splits in runs:
            before = khybrid.hybrid_mul.launches
            outf, outd = khybrid.hybrid_mul(*args, sid=sid, splits=splits)
            assert khybrid.hybrid_mul.launches == before + 1
            if bm == 64 or splits == 1:
                assert torch.equal(outf.view(torch.int16),
                                   plain.view(torch.int16)), splits
            else:
                torch.testing.assert_close(
                    outf.float(), want_f.float(), rtol=2 ** -7,
                    atol=2 ** -8 * want_f.float().abs().max().item())
            torch.testing.assert_close(
                outd.float(), want_d.float(), rtol=2 ** -7,
                atol=2 ** -8 * want_d.float().abs().max().item())
            againf, againd = khybrid.hybrid_mul(*args, sid=sid, splits=splits)
            assert torch.equal(againf.view(torch.int16),
                               outf.view(torch.int16)), splits
            assert torch.equal(againd.view(torch.int16),
                               outd.view(torch.int16)), splits


@pytest.mark.parametrize("bn", [64, 128])
def test_hybrid_dense_prefill_tiles_alone_and_at_full_width(gen, bn):
    """The 64-row dense CTAs (csrc/dense_wgmma.cuh): a launch with no FP4
    columns (nf = 0) runs them alone, and its dense columns are the full
    launch's bit for bit; Llama-3-8B's w_down (k = 14336, n = 4096 split
    3072 + 1024) at m = 512: the FP4 columns bit for bit fused_mul's, the
    dense columns against the twin at the GEMM tolerance, a second launch
    bit for bit the first."""
    sid = sol.SolutionId(64, bn)
    for m, n, k, bnf, bnd in ((70, 1024, 640, 768, 256),
                              (130, 1280, 384, 960, 320),
                              (512, 4096, 14336, 768, 256)):
        w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
        hq = thybrid.quantize_hybrid(w, block_nf=bnf, block_nd=bnd)
        a = _bf16(gen, m, k)
        args = (a, hq["words"], hq["scales"], hq["gs"].reshape(1), hq["wd"])
        want_f, want_d = khybrid.hybrid_mul_reference(*args, sid=sid)
        outf, outd = khybrid.hybrid_mul(*args, sid=sid)
        againf, againd = khybrid.hybrid_mul(*args, sid=sid)
        assert torch.equal(outf.view(torch.int16),
                           fused.fused_mul(*args[:4], sid=sid).view(
                               torch.int16)), (m, k)
        torch.testing.assert_close(
            outd.float(), want_d.float(), rtol=2 ** -7,
            atol=2 ** -8 * want_d.float().abs().max().item())
        assert torch.equal(againf.view(torch.int16), outf.view(torch.int16))
        assert torch.equal(againd.view(torch.int16), outd.view(torch.int16))
        before = khybrid.hybrid_mul.launches
        nof, alone = khybrid.hybrid_mul(a, hq["words"][:, :0],
                                        hq["scales"][:, :0], args[3],
                                        hq["wd"], sid=sid)
        assert khybrid.hybrid_mul.launches == before + 1
        assert nof.shape == (m, 0)
        assert torch.equal(alone.view(torch.int16), outd.view(torch.int16))


def test_hybrid_kernel_rejects_bad_splits(gen):
    w = torch.randn((640, 1024), generator=gen, device="cuda") / 32
    hq = thybrid.quantize_hybrid(w, block_nf=768, block_nd=256)
    args = (_bf16(gen, 8, 640), hq["words"], hq["scales"],
            hq["gs"].reshape(1), hq["wd"])                 # kp 1024: 4 steps
    for sid, splits in ((sol.SolutionId(16, 64), 0),
                        (sol.SolutionId(16, 64), 5),
                        (sol.SolutionId(16, 128), (1, 0)),
                        (sol.SolutionId(64, 64), 2)):
        before = khybrid.hybrid_mul.launches
        with pytest.raises(ValueError, match="split"):
            khybrid.hybrid_mul(*args, sid=sid, splits=splits)
        assert khybrid.hybrid_mul.launches == before


def test_mul_fp4_diff_backward_runs_the_dequant_kernel(gen):
    """dA and dgs on the card against the same backward on the CPU
    (twins), within the GEMM tolerance."""
    m, n, k = 37, 336, 640
    w = torch.randn((n, k), generator=gen, device="cuda") / math.sqrt(k)
    qw, sc, gs = qref.quantize_nvfp4(w)
    words = layout.repack_fp4_weights(qw, n, k)
    st = layout.process_fp4_scales(sc, n, k, group_size=16)
    a0, g = _bf16(gen, m, k), _bf16(gen, m, n)
    grads = []
    for dev in ("cuda", "cpu"):
        a = a0.detach().to(dev).requires_grad_()
        gsd = gs.detach().to(dev).requires_grad_()
        y = tgemm.mul_fp4_diff("nvfp4", k, a, words.to(dev), st.to(dev), gsd)
        before = fused.dequant_tpu_layout.launches
        y.backward(g.to(dev))
        if dev == "cuda":
            assert fused.dequant_tpu_layout.launches == before + 1
        grads.append((a.grad.float().cpu(), gsd.grad.cpu()))
    (da, dgs), (da_ref, dgs_ref) = grads
    torch.testing.assert_close(da, da_ref, rtol=2 ** -7,
                               atol=2 ** -8 * da_ref.abs().max().item())
    torch.testing.assert_close(dgs, dgs_ref, rtol=2 ** -7, atol=0.0)


def _hp_error_bound(a, words, st, gs, got):
    """The high-precision rule: max|got - f64| against 4 max|f32 library -
    f64| + 2^-24 max(|A| @ |B|) |gs|, the f32 library product being the
    twin's (TF32 off). Returns (error, bound)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    n, k = words.shape[1], a.shape[1]
    deq = layout.dequant_from_tpu_layout(words, st, n, k).double()
    g = gs.double()
    exact = (a.double() @ deq) * g
    lib = fused.fused_mul_hp_reference(a.float(), words, st, gs, sid=None)
    scale = ((a.double().abs() @ deq.abs()) * g.abs()).max().item()
    err = (got.double() - exact).abs().max().item()
    lib_err = (lib.double() - exact).abs().max().item()
    return err, 4 * lib_err + 2 ** -24 * scale


def _hp_a(gen, m, k):
    """f32 activations over a wide range of magnitudes: rows scaled by
    2^-20 .. 2^19."""
    return torch.randn((m, k), generator=gen, device="cuda") * torch.exp2(
        torch.randint(-20, 20, (m, 1), generator=gen, device="cuda"))


def _hp_split_counts(m, n, words, bm, bn, eb):
    """The split counts both hp entries take: 1 to 4 (as kp / 256 allows)
    and the default of each, passed to both; 1 at block_m = 64."""
    if bm == 64:
        return [1]
    kp = words.shape[0] * 8
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sid = sol.SolutionId(bm, bn, eb, high_precision=True)
    return sorted({c for c in (1, 2, 3, 4) if c <= kp // fused.KSTEP}
                  | {fused.hp_splits(m, n, kp, sid, sms),
                     fused.hp_splits(m, n, kp, dataclasses.replace(
                         sid, weight_cache=True), sms)})


@pytest.mark.parametrize("fmt", ["nvfp4", "mxfp4"])
@pytest.mark.parametrize("bm,bn", sol.TILE_SHAPES)
def test_hp_kernels_match_twin_and_f64(gen, fmt, bm, bn):
    """fp4_gemm_hp and fp4_gemm_hp_wc on f32 activations of a wide range
    of magnitudes (ragged m and n, k padded past itself): within the
    high-precision rule of the f64 product at their default splits, and
    the weight-cache kernel bit for bit the plain one at the same tile and
    an equal, explicit split count (each split count both take)."""
    for m, n, k in _W4A8_CASES:
        words, st, gs, eb = _fp4_operands(gen, fmt, n, k)
        a = _hp_a(gen, m, k)
        sid = sol.SolutionId(bm, bn, eb, high_precision=True)
        before = fused.fused_mul_hp.launches
        got = fused.fused_mul(a, words, st, gs, sid=sid)
        assert fused.fused_mul_hp.launches == before + 1
        assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
        err, bound = _hp_error_bound(a, words, st, gs, got)
        assert err <= bound, (m, n, k, err, bound)
        wc = sol.SolutionId(bm, bn, eb, high_precision=True,
                            weight_cache=True)
        if not sol.is_feasible(wc, m, n, k):
            continue
        for splits in _hp_split_counts(m, n, words, bm, bn, eb):
            plain = fused.fused_mul(a, words, st, gs, sid=sid, splits=splits)
            before = fused.fused_mul_hp_wc.launches
            got_wc = fused.fused_mul(a, words, st, gs, sid=wc, splits=splits)
            assert fused.fused_mul_hp_wc.launches == before + 1
            assert torch.equal(got_wc.view(torch.int32),
                               plain.view(torch.int32)), (m, n, k, splits)


@pytest.mark.parametrize("fmt", ["nvfp4", "mxfp4"])
@pytest.mark.parametrize("bn", [64, 128])
def test_hp_16_row_tiles_every_split_count(gen, fmt, bn):
    """The high-precision 16-row tiles (the stream body's f32 form, 1 and
    HP_WC_GROUP m-tiles a CTA) at m = 1 to 65, n = 336 (a ragged last
    n-tile), k = 640 padded to 1024 (four steps): at 1 to 4 splits and
    both defaults within the high-precision rule of the f64 product, a
    second launch the same bits, the weight cache bit for bit the plain
    tile at the same count; each launch counted as a stream launch; the
    split counters zero afterwards."""
    n, k = 336, 640
    words, st, gs, eb = _fp4_operands(gen, fmt, n, k)
    sid = sol.SolutionId(16, bn, eb, high_precision=True)
    wc = dataclasses.replace(sid, weight_cache=True)
    for m in (1, 8, 16, 17, 33, 64, 65):
        a = _hp_a(gen, m, k)
        for splits in _hp_split_counts(m, n, words, 16, bn, eb):
            what = (m, bn, splits)
            stream = fused.fused_mul_hp.stream_launches
            got = fused.fused_mul(a, words, st, gs, sid=sid, splits=splits)
            again = fused.fused_mul_hp(a, words, st, gs, sid=sid,
                                       splits=splits)
            assert fused.fused_mul_hp.stream_launches == stream + 2
            err, bound = _hp_error_bound(a, words, st, gs, got)
            assert err <= bound, (what, err, bound)
            assert torch.equal(again.view(torch.int32),
                               got.view(torch.int32)), what
            if not sol.is_feasible(wc, m, n, k):
                continue
            stream = fused.fused_mul_hp_wc.stream_launches
            got_wc = fused.fused_mul(a, words, st, gs, sid=wc, splits=splits)
            assert fused.fused_mul_hp_wc.stream_launches == stream + 1
            assert torch.equal(got_wc.view(torch.int32),
                               got.view(torch.int32)), what
    torch.cuda.synchronize()
    _split_counts_zero()


def test_hp_16_row_tiles_replay_in_a_cuda_graph(gen):
    """The four Llama-3-8B projections through the high-precision 16-row
    tiles captured in one CUDA graph: fused_mul_hp at m = 8 (16x64 and
    16x128) and fused_mul_hp_wc at m = 64 (16x64), default splits. After
    one eager call, three replays (outputs zeroed before each) give the
    eager bits each time; the split counters read zero afterwards."""
    calls = []
    for k, n in _LLAMA8B_KN:
        words, st, gs, eb = _fp4_operands(gen, "nvfp4", n, k)
        for m, bn, wc in ((8, 64, False), (8, 128, False), (64, 64, True)):
            sid = sol.SolutionId(16, bn, eb, high_precision=True,
                                 weight_cache=wc)
            calls.append((_hp_a(gen, m, k), words, st, gs, sid))
    eager = [fused.fused_mul(a, w, s, g, sid=sid) for a, w, s, g, sid in calls]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fused.fused_mul(a, w, s, g, sid=sid)
                for a, w, s, g, sid in calls]
    for _ in range(3):
        for out in outs:
            out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for out, want in zip(outs, eager):
            assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    _split_counts_zero()


@pytest.mark.parametrize("bn", [64, 128])
def test_hp_64_row_tiles_at_llama_widths(gen, bn):
    """The high-precision 64-row tiles (the register-A wgmma body, 1 and
    HP_WC_GROUP m-tiles a CTA) at the four Llama-3-8B projections, m = 130
    (a ragged last m-tile), and on w_down (k = 14336) at m = 2048: within
    the high-precision rule of the f64 product, a second launch the same
    bits, the weight cache bit for bit the plain tile."""
    cases = [(130, k, n) for k, n in _LLAMA8B_KN] + [(2048, 14336, 4096)]
    for m, k, n in cases:
        words, st, gs, eb = _fp4_operands(gen, "nvfp4", n, k)
        a = _hp_a(gen, m, k)
        sid = sol.SolutionId(64, bn, eb, high_precision=True)
        got = fused.fused_mul(a, words, st, gs, sid=sid)
        again = fused.fused_mul(a, words, st, gs, sid=sid)
        got_wc = fused.fused_mul(a, words, st, gs,
                                 sid=dataclasses.replace(sid, weight_cache=True))
        err, bound = _hp_error_bound(a, words, st, gs, got)
        assert err <= bound, (m, k, n, err, bound)
        assert torch.equal(again.view(torch.int32), got.view(torch.int32))
        assert torch.equal(got_wc.view(torch.int32), got.view(torch.int32))


def test_hp_64_row_launches_count_as_wgmma_launches(gen):
    """Each 64-row hp call, plain and weight cache, adds one to its
    wrapper's wgmma_launches and none to stream_launches; a 16-row call
    adds none to wgmma_launches."""
    words, st, gs, eb = _fp4_operands(gen, "nvfp4", 256, 512)
    a = _hp_a(gen, 130, 512)
    for wrapper, wc in ((fused.fused_mul_hp, False),
                        (fused.fused_mul_hp_wc, True)):
        for bm, bn in sol.TILE_SHAPES:
            sid = sol.SolutionId(bm, bn, eb, high_precision=True,
                                 weight_cache=wc)
            before = (wrapper.launches, wrapper.wgmma_launches,
                      wrapper.stream_launches)
            fused.fused_mul(a, words, st, gs, sid=sid)
            wide = bm == 64
            assert (wrapper.launches, wrapper.wgmma_launches,
                    wrapper.stream_launches) == (
                before[0] + 1, before[1] + wide, before[2] + (not wide)), sid


def test_hp_64_row_tiles_replay_in_a_cuda_graph(gen):
    """The four Llama-3-8B projections at m = 130 through the 64-row hp
    tiles, plain and weight cache at 64x64 and 64x128, captured in one
    CUDA graph: after one eager call, two replays (outputs zeroed before
    each) give the eager bits each time."""
    calls = []
    for k, n in _LLAMA8B_KN:
        words, st, gs, eb = _fp4_operands(gen, "nvfp4", n, k)
        a = _hp_a(gen, 130, k)
        for bn in (64, 128):
            for wc in (False, True):
                calls.append((a, words, st, gs, sol.SolutionId(
                    64, bn, eb, high_precision=True, weight_cache=wc)))
    eager = [fused.fused_mul(a, w, s, g, sid=sid) for a, w, s, g, sid in calls]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fused.fused_mul(a, w, s, g, sid=sid)
                for a, w, s, g, sid in calls]
    for _ in range(2):
        for out in outs:
            out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for out, want in zip(outs, eager):
            assert torch.equal(out.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("fmt", ["nvfp4", "mxfp4"])
def test_every_listed_solution_launches(gen, fmt):
    """Every id get_fp4_solutions lists, hp included, through the public
    entry on the card: its kernel launches once and the output matches its
    twin (the GEMM tolerance; the hp rule for hp ids, whose output comes
    back in a's dtype)."""
    quant, group = _QUANT[fmt]
    eb = sol.ElementB.NVFP4 if group == 16 else sol.ElementB.MXFP4
    mul = tgemm.mul_nvfp4_a16 if fmt == "nvfp4" else tgemm.mul_mxfp4_a16
    counters = {(False, False): fused.fused_mul, (False, True):
                fused.fused_mul_wc, (True, False): fused.fused_mul_hp,
                (True, True): fused.fused_mul_hp_wc}
    for m, n, k in ((8, 256, 512), (100, 384, 1024)):
        w = torch.randn((n, k), generator=gen, device="cuda") / math.sqrt(k)
        qw, sc, gs = quant(w)
        words = layout.repack_fp4_weights(qw, n, k,
                                          pad_to=layout.pad_multiple(group))
        st = layout.process_fp4_scales(sc, n, k, group_size=group)
        gs = gs.reshape(1)
        a = torch.randn((m, k), generator=gen, device="cuda")
        ids = tgemm.get_fp4_solutions(m, n, k, element_b=eb)
        assert any(sol.SolutionId.from_repr(r).high_precision for r in ids)
        for r in ids:
            sid = sol.SolutionId.from_repr(r)
            counter = counters[(sid.high_precision, sid.weight_cache)]
            before = counter.launches
            got = mul(a, words, st, gs, m, n, k, r)
            assert counter.launches == before + 1, sid
            assert got.dtype == torch.float32
            if sid.high_precision:
                err, bound = _hp_error_bound(a, words, st, gs, got)
                assert err <= bound, (sid, err, bound)
            else:
                want = fused.fused_mul_reference(a, words, st, gs, sid=sid)
                torch.testing.assert_close(
                    got, want.float(), rtol=2 ** -7,
                    atol=2 ** -8 * want.float().abs().max().item())
        # require_high_precision on bf16 activations: the hp kernel, bf16 out
        hp = sol.SolutionHints(b_type=eb, require_high_precision=True)
        before = fused.fused_mul_hp.launches
        got = mul(a.to(torch.bfloat16), words, st, gs, m, n, k, hints=hp)
        assert fused.fused_mul_hp.launches == before + 1
        assert got.dtype == torch.bfloat16
        want = fused.fused_mul_hp(a.to(torch.bfloat16).float(), words, st, gs,
                                  sid=sol.choose_default_solution(
                                      m, n, k, eb, high_precision=True))
        assert torch.equal(got.view(torch.int16),
                           want.to(torch.bfloat16).view(torch.int16))


def test_cuda_time_returns_a_positive_median(gen):
    from petit_kernel_tpu_torch.utils import benchlib
    a = _bf16(gen, 1024, 1024)
    t = benchlib.cuda_time(lambda: a @ a, iters=5, warmup=1)
    assert 0 < t < 1.0
    t_warm = benchlib.cuda_time(lambda: a @ a, iters=5, warmup=1,
                                flush_l2=False)
    assert 0 < t_warm < 1.0


# -- decode blocks: the Engine's step graphs --------------------------------

_BLOCK_CFG = tllama.LlamaConfig.tiny(num_layers=3, max_seq_len=512)
_BLOCK_DTYPES = {"flat bf16": torch.bfloat16,
                 "headed fp8": torch.float8_e4m3fn}


@pytest.fixture(scope="module")
def block_params():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step graphs have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    return tllama.quantize_params(tllama.init_params(_BLOCK_CFG, g))


def _block_engine(params, layout, prompt_lens=(123, 40),
                  temps=(0.0, 0.7), eng=None):
    """Engine(max_batch=2) (or `eng`) with both slots decoding after one
    admission; prompts of prompt_lens seeded tokens, 200 new tokens
    each."""
    if eng is None:
        eng = tserving.Engine(params, _BLOCK_CFG, max_batch=2,
                              cache_dtype=_BLOCK_DTYPES[layout], seed=7)
    rng = torch.Generator().manual_seed(1)
    for i, (n, t) in enumerate(zip(prompt_lens, temps)):
        toks = torch.randint(0, eng.cfg.vocab_size, (n,), generator=rng)
        eng.add_request(tserving.Request(uid=i, tokens=toks.numpy().astype(
            "int32"), max_new_tokens=200, temperature=t))
    while eng._pf:
        eng._advance_prefill()
    assert eng.active.all()
    return eng


def _kv_tensors(eng):
    return eng.cache if eng.cache is not None else eng.pc.pages


def _block_snapshot(eng):
    """The KV tensors (cache or page pools), host positions and tokens,
    the generator and, for a PagedEngine, the allocator."""
    snap = dict(kv=[(k.clone(), v.clone()) for k, v in _kv_tensors(eng)],
                pos=eng.pos.copy(), last=eng.last_tok.copy(),
                gstate=eng.generator.get_state())
    if isinstance(eng, tserving.PagedEngine):
        snap["alloc"] = eng.pc.allocator_state()
    return snap


def _block_restore(eng, snap):
    for (k, v), (k0, v0) in zip(_kv_tensors(eng), snap["kv"]):
        k.copy_(k0)
        v.copy_(v0)
    eng.pos[:], eng.last_tok[:] = snap["pos"], snap["last"]
    eng.generator.set_state(snap["gstate"])
    if "alloc" in snap:
        eng.pc.restore_allocator(snap["alloc"])


def _kv_bytes(eng, end):
    """The KV a block must reproduce, as byte tensors: every byte of a
    contiguous cache; of a paged pool, each active slot's K and V of every
    layer gathered through its own block-table row over positions <
    end[slot] (a block takes a slot's pages up front, eager steps one at a
    time, so their physical pages differ)."""
    if eng.cache is not None:
        return [t.view(torch.uint8).clone() for kv in eng.cache for t in kv]
    return [t.view(torch.uint8) for slot in np.flatnonzero(eng.active)
            for t in tpaged.gather_slot_kv(eng.pc, slot, int(end[slot]))]


def _bytes_equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _eager_then_block(eng, steps):
    """From one snapshot: `steps` eager decodes (step()'s forward and
    sample_next, a PagedEngine taking its pages a position at a time),
    then, from the restored snapshot, one block of `steps` through the
    engine's step graphs (_run_decode_block: a PagedEngine's pages for the
    whole block first). Returns (eager tokens, eager logits, eager KV
    bytes, block tokens, block logits, block KV bytes), the KV bytes by
    _kv_bytes at the positions the eager steps reached."""
    snap = _block_snapshot(eng)
    want_logits, want_toks = [], []
    inner = eng._decode_logits

    def keep():
        lg = inner()
        want_logits.append(lg.clone())
        return lg

    eng._decode_logits = keep
    for _ in range(steps):
        want_toks.append(eng._decode())
        eng.pos[eng.active] += 1
        eng.last_tok[eng.active] = want_toks[-1][eng.active]
    eng._decode_logits = inner
    torch.cuda.synchronize()
    end = eng.pos.copy()
    want_kv = _kv_bytes(eng, end)
    _block_restore(eng, snap)
    if eng._blocks is None:
        eng._blocks = tserving._DecodeBlocks(eng)
    blocks = eng._blocks
    got_logits = []
    inner_step = blocks.step

    def step(window):
        lg, nxt = inner_step(window)
        got_logits.append(lg.clone())
        return lg, nxt

    blocks.step = step
    out = eng._read_block(eng._run_decode_block(eng.last_tok, eng.pos,
                                                steps))
    del blocks.step
    return (np.stack(want_toks), want_logits, want_kv, out, got_logits,
            _kv_bytes(eng, end))


@pytest.mark.parametrize("layout", sorted(_BLOCK_DTYPES))
def test_block_step_graph_replays_bit_for_bit_eager_steps(block_params,
                                                          layout):
    """A block of 3 steps in one window bucket: the step graph captured at
    its first use and replayed 3 times gives the eager steps' tokens, the
    logits of each step and both caches' bytes bit for bit (slot 1 samples
    at temperature 0.7 from the engine's generator). The capture counted
    the layout's KV append once a layer."""
    eng = _block_engine(block_params, layout, prompt_lens=(40, 30))
    append = (attention.kv_append_headed if layout == "headed fp8"
              else attention.kv_append)
    eng._blocks = tserving._DecodeBlocks(eng)
    captured = []
    inner = eng._blocks._step

    def counted(window):
        before = append.launches
        out = inner(window)
        captured.append(append.launches - before)
        return out

    eng._blocks._step = counted
    want, want_lg, want_kv, got, got_lg, got_kv = _eager_then_block(eng, 3)
    np.testing.assert_array_equal(got, want)
    for g, w in zip(got_lg, want_lg):
        assert torch.equal(g.view(torch.int16), w.view(torch.int16))
    assert _bytes_equal(got_kv, want_kv)
    assert list(eng._blocks.graphs) == [128]
    # one capture of the step; the replays count nothing
    assert captured == [_BLOCK_CFG.num_layers]


@pytest.mark.parametrize("layout", sorted(_BLOCK_DTYPES))
def test_block_across_a_window_bucket_bit_for_bit(block_params, layout):
    """A block of 6 steps from position 123: its steps attend through
    windows 128, 128, 128, 128, 256, 256 (two graphs), bit for bit 6 eager
    steps from a snapshot of the same state; every split counter reads
    zero after the block."""
    eng = _block_engine(block_params, layout)
    want, want_lg, want_kv, got, got_lg, got_kv = _eager_then_block(eng, 6)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got, want)
    for g, w in zip(got_lg, want_lg):
        assert torch.equal(g.view(torch.int16), w.view(torch.int16))
    assert _bytes_equal(got_kv, want_kv)
    assert sorted(eng._blocks.graphs) == [128, 256]
    for buf in fused._COUNTERS.values():
        assert not buf.any()


def test_block_dispatch_never_syncs(block_params):
    """With the bucket's graph captured, a block's dispatch (uploads, 4
    replays, the tokens' copy to pinned memory, the event) runs under
    torch.cuda.set_sync_debug_mode("error"); its read comes after."""
    eng = _block_engine(block_params, "flat bf16", prompt_lens=(40, 30))
    eng.step_block(2, waiters=False)            # captures window 128
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        blk = eng._dispatch_block(eng.last_tok, eng.pos, 4)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out = eng._read_block(blk)
    assert out.shape == (4, 2) and list(eng._blocks.graphs) == [128]


def _block_requests(n_new=20):
    rng = torch.Generator().manual_seed(2)
    return [tserving.Request(
        uid=i, tokens=torch.randint(0, _BLOCK_CFG.vocab_size, (n,),
                                    generator=rng).numpy().astype("int32"),
        max_new_tokens=n_new + 3 * i) for i, n in enumerate((50, 17))]


def test_pipelined_drain_equals_sequential_step_block(block_params):
    """Greedy, 2 requests of 20 and 23 new tokens: run(decode_block=4) (the
    burst admission, then the pipelined drain) gives the tokens of
    sequential step_block(4, waiters=False) calls after the same admission,
    and those of decode_block=1."""
    def make():
        return tserving.Engine(block_params, _BLOCK_CFG, max_batch=2)

    drained = make().run(_block_requests(), decode_block=4)
    eng = make()
    for r in _block_requests():
        eng.add_request(r)
    while eng._pf:
        eng._advance_prefill()
    while eng.active.any():
        eng.step_block(4, waiters=False)
    assert drained == eng.finished
    assert drained == make().run(_block_requests())


def test_one_step_graph_a_window_bucket(block_params):
    """A request decoding from position 100 to 330 runs through the buckets
    128, 256 and 512: the engine holds one graph for each, and the split
    counters read zero after."""
    eng = tserving.Engine(block_params, _BLOCK_CFG, max_batch=2)
    rng = torch.Generator().manual_seed(3)
    toks = torch.randint(0, _BLOCK_CFG.vocab_size, (100,), generator=rng)
    out = eng.run([tserving.Request(uid=0, tokens=toks.numpy().astype(
        "int32"), max_new_tokens=230)], decode_block=8)
    torch.cuda.synchronize()
    assert len(out[0]) == 230
    assert sorted(eng._blocks.graphs) == [128, 256, 512]
    assert eng._blocks.capture_s > 0
    for buf in fused._COUNTERS.values():
        assert not buf.any()


# -- decode blocks: PagedEngine and the Mixtral Engine ------------------------

FP8 = torch.float8_e4m3fn
# a narrow Mixtral whose widths the card's kernels take (head_dim 64)
_MOE_BLOCK_CFG = tmoe.MixtralConfig.tiny(
    vocab_size=512, hidden_size=256, intermediate_size=512, head_dim=64,
    max_seq_len=512)


@pytest.fixture(scope="module")
def moe_block_params():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step graphs have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    return tmoe.quantize_params(tmoe.init_params(_MOE_BLOCK_CFG, g),
                                _MOE_BLOCK_CFG)


def _paged_block_engine(params, **kw):
    """PagedEngine(max_batch=2, fp8 pool, page size 16) of the 3-layer
    Llama, admitted as _block_engine's (seeded prompts, slot 1 at 0.7)."""
    return _block_engine(params, None, eng=tserving.PagedEngine(
        params, _BLOCK_CFG, max_batch=2, page_size=16, cache_dtype=FP8,
        seed=7), **kw)


def _moe_block_engine(params, layout="flat bf16", **kw):
    """The narrow Mixtral's Engine(forward_fn=...) over a flat bf16 or
    headed fp8 cache, admitted as _block_engine's."""
    return _block_engine(params, None, eng=tserving.Engine(
        params, _MOE_BLOCK_CFG, max_batch=2, seed=7,
        forward_fn=tmoe.make_engine_forward(_MOE_BLOCK_CFG),
        cache_dtype=_BLOCK_DTYPES[layout]), **kw)


def _count_at_capture(eng, wrappers):
    """Give eng its decode blocks now and count each wrapper's launches in
    every captured step (a replay moves no counter)."""
    eng._blocks = tserving._DecodeBlocks(eng)
    counts, inner = [], eng._blocks._step

    def counted(window):
        before = [w.launches for w in wrappers]
        out = inner(window)
        counts.append([w.launches - b for w, b in zip(wrappers, before)])
        return out

    eng._blocks._step = counted
    return counts


def test_paged_block_across_a_window_bucket_bit_for_bit(block_params):
    """An fp8 PagedEngine (page size 16): a block of 6 steps from position
    123 (windows 128, 128, 128, 128, 256, 256; two graphs), its steps
    reading the block's static table, bit for bit 6 eager steps from a
    snapshot of the same state (allocator included): tokens, logits at
    every step, and each slot's K and V gathered through its own table.
    Each capture launched kv_append_paged and paged_decode_attention once
    a layer; every split counter reads zero after the block."""
    eng = _paged_block_engine(block_params)
    counts = _count_at_capture(eng, (attention.kv_append_paged,
                                     attention.paged_decode_attention))
    want, want_lg, want_kv, got, got_lg, got_kv = _eager_then_block(eng, 6)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got, want)
    for g, w in zip(got_lg, want_lg):
        assert torch.equal(g.view(torch.int16), w.view(torch.int16))
    assert _bytes_equal(got_kv, want_kv)
    assert sorted(eng._blocks.graphs) == [128, 256]
    np.testing.assert_array_equal(eng._blocks.tables.cpu().numpy(),
                                  eng.pc.tables)
    assert counts == [[_BLOCK_CFG.num_layers] * 2] * 2
    for buf in fused._COUNTERS.values():
        assert not buf.any()


@pytest.mark.parametrize("layout", sorted(_BLOCK_DTYPES))
def test_mixtral_block_across_a_window_bucket_bit_for_bit(moe_block_params,
                                                          layout):
    """The Mixtral Engine (flat bf16, headed fp8): a block of 6 steps
    across the 128-position bucket bit for bit 6 eager steps (tokens,
    logits, cache bytes; the routing glue and the atomic index_add_ of
    top-2 in the graphs). Each capture launched grouped_mul three times a
    layer and the layout's KV append once; split counters zero after."""
    eng = _moe_block_engine(moe_block_params, layout)
    append = (attention.kv_append_headed if layout == "headed fp8"
              else attention.kv_append)
    counts = _count_at_capture(eng, (grouped.grouped_mul, append))
    want, want_lg, want_kv, got, got_lg, got_kv = _eager_then_block(eng, 6)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got, want)
    for g, w in zip(got_lg, want_lg):
        assert torch.equal(g.view(torch.int16), w.view(torch.int16))
    assert _bytes_equal(got_kv, want_kv)
    assert sorted(eng._blocks.graphs) == [128, 256]
    n = _MOE_BLOCK_CFG.num_layers
    assert counts == [[3 * n, n]] * 2
    for buf in fused._COUNTERS.values():
        assert not buf.any()


@pytest.mark.parametrize("kind", ["paged", "mixtral"])
def test_paged_and_mixtral_block_dispatch_never_syncs(
        block_params, moe_block_params, kind):
    """The step's forward (_block_forward over the static buffers: the
    paged forward, or the Mixtral forward with its routing glue) run
    eagerly, and, with the bucket's graph captured, a block's dispatch
    (uploads with the block table, 4 replays, the tokens' copy, the
    event), each under torch.cuda.set_sync_debug_mode("error")."""
    eng = (_paged_block_engine(block_params, prompt_lens=(40, 30))
           if kind == "paged"
           else _moe_block_engine(moe_block_params, prompt_lens=(40, 30)))
    eng.step_block(2, waiters=False)            # captures window 128
    torch.cuda.synchronize()
    blocks = eng._blocks
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            eng._block_forward(blocks, 128, torch.zeros_like(blocks.active))
        blk = eng._run_decode_block(eng.last_tok, eng.pos, 4)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out = eng._read_block(blk)
    assert out.shape == (4, 2) and list(blocks.graphs) == [128]


def test_paged_drain_equals_sequential_step_block(block_params):
    """An fp8 PagedEngine (page size 16), greedy, 2 requests of 20 and 23
    new tokens: run(decode_block=4) (the burst admission, then the
    pipelined drain) gives the tokens of sequential step_block(4,
    waiters=False) calls after the same admission, and those of
    decode_block=1; every page is back in the pool after each."""
    def make():
        return tserving.PagedEngine(block_params, _BLOCK_CFG, max_batch=2,
                                    page_size=16, cache_dtype=FP8)

    eng_d = make()
    drained = eng_d.run(_block_requests(), decode_block=4)
    eng = make()
    for r in _block_requests():
        eng.add_request(r)
    while eng._pf:
        eng._advance_prefill()
    while eng.active.any():
        eng.step_block(4, waiters=False)
    assert drained == eng.finished
    eng_1 = make()
    assert drained == eng_1.run(_block_requests())
    for e in (eng_d, eng, eng_1):
        assert e.pages_in_use() == 0
        assert sorted(e.pc.free) == list(range(e.pc.num_pages))


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


@pytest.mark.parametrize("kind", ["Engine bf16", "Engine fp8",
                                  "PagedEngine fp8", "Mixtral Engine"])
@pytest.mark.parametrize("L", [37, 300, 1000, 2047])
def test_score_forward_on_the_card_matches_the_cpu(block_params,
                                                   moe_block_params, kind, L,
                                                   monkeypatch):
    """score_forward of a 2-row batch of L seeded tokens (L not a multiple
    of 16; 300 attends a 512 window, 1000 and 2047 windows of 1024 and
    2048 at max_seq_len 2048) on the card (flash prefill kernels, flat,
    headed and paged, on the scratch cache) against the same engine on the
    CPU (their twins): logits within 2^-5 * max|logits|.

    The Mixtral Engine's routing is a discrete choice. The two devices'
    hidden states differ by their kernels' rounding, and at long L some
    token's 2nd and 3rd router logits lie closer than that: it takes
    another expert there, and its logits move by their own size. So the
    card runs each layer on the CPU's routing, which holds the kernels to
    the bound at the CPU's expert buckets, and the card's own routing
    must be the CPU's at every token whose 2nd and 3rd router logits are
    at least 2^-5 * max|router logits| apart."""
    mixtral = kind == "Mixtral Engine"
    params = moe_block_params if mixtral else block_params
    cfg = dataclasses.replace(_MOE_BLOCK_CFG if mixtral else _BLOCK_CFG,
                              max_seq_len=2048)

    def make(p, device):
        if kind == "PagedEngine fp8":
            eng = tserving.PagedEngine(p, cfg, max_batch=2, page_size=16,
                                       cache_dtype=FP8)
        elif mixtral:
            eng = tserving.Engine(
                p, cfg, max_batch=2,
                forward_fn=tmoe.make_engine_forward(cfg),
                cache=tllama.init_cache(cfg, 2, device=device))
        else:
            eng = tserving.Engine(p, cfg, max_batch=2, cache_dtype=(
                FP8 if kind == "Engine fp8" else torch.bfloat16))
        return eng

    cpu_routes, card_routes = [], []
    route = tmoe.route

    def shared_route(x, router_w, top_k):
        gate_w, gate_idx = route(x, router_w, top_k)
        if x.device.type == "cpu":
            cpu_routes.append((gate_w, gate_idx, x.float() @ router_w.float()))
            return gate_w, gate_idx
        card_routes.append(gate_idx.cpu())
        gate_w, gate_idx, _ = cpu_routes[len(card_routes) - 1]
        return gate_w.to(x.device), gate_idx.to(x.device)

    monkeypatch.setattr(tmoe, "route", shared_route)
    toks = torch.randint(0, cfg.vocab_size, (2, L),
                         generator=torch.Generator().manual_seed(4))
    want = make(_to_cpu(params), "cpu").score_forward(toks).float()
    got = make(params, "cuda").score_forward(toks).float().cpu()
    assert got.shape == want.shape == (2, L, cfg.vocab_size)
    err = (got - want).abs().max().item()
    assert math.isfinite(err) and err <= 2 ** -5 * want.abs().max().item()
    assert len(card_routes) == len(cpu_routes) == (
        cfg.num_layers if mixtral else 0)
    for (_, cpu_idx, logits), card_idx in zip(cpu_routes, card_routes):
        top = logits.sort(-1, descending=True).values
        apart = top[:, 1] - top[:, 2] >= 2 ** -5 * top.abs().amax(-1)
        same = (card_idx.sort(-1).values == cpu_idx.sort(-1).values).all(-1)
        assert same[apart].all()


# -- SpecEngine: each speculative tick one replayed CUDA graph ----------------

def _spec_engine(params, layout, draft_layers=3, gamma=4, prompt_lens=(40,
                                                                        30)):
    """SpecEngine(max_batch=2) on the narrow 3-layer Llama, its draft the
    first `draft_layers` layers of the same params (3: the target itself),
    both slots decoding after admission (prompts of seeded tokens)."""
    dcfg = dataclasses.replace(_BLOCK_CFG, num_layers=draft_layers)
    draft = dict(params, layers=params["layers"][:draft_layers])
    eng = tserving.SpecEngine(params, _BLOCK_CFG, draft, dcfg, gamma=gamma,
                              gamma_adaptive=False, max_batch=2,
                              draft_fmt="nvfp4",
                              cache_dtype=_BLOCK_DTYPES[layout], seed=7)
    rng = torch.Generator().manual_seed(5)
    for i, n in enumerate(prompt_lens):
        toks = torch.randint(0, _BLOCK_CFG.vocab_size, (n,), generator=rng)
        eng.add_request(tserving.Request(uid=i, tokens=toks.numpy().astype(
            "int32"), max_new_tokens=60))
    while eng._pf:
        eng._advance_prefill()
    assert eng.active.all()
    return eng


def _both_caches(eng):
    return [t for kv in eng.cache + eng.dcache for t in kv]


@pytest.mark.parametrize("layout", sorted(_BLOCK_DTYPES))
@pytest.mark.parametrize("draft_layers", [1, 3])
def test_spec_tick_graph_replays_bit_for_bit_the_eager_tick(
        block_params, layout, draft_layers):
    """One tick at g = 4 (a verify at T = 5, m = 10) and at g = 11 (T =
    12, m = 24): the (g, window) graph, captured at its first use and
    replayed, gives the eager tick's tokens and n_acc from the same state,
    and both caches' bytes, bit for bit (force_accept 0.5, the generator
    restored). The capture counted the layout's KV append once a layer a
    draft step and once a layer for the verify."""
    append = (attention.kv_append_headed if layout == "headed fp8"
              else attention.kv_append)
    eng = _spec_engine(block_params, layout, draft_layers)
    eng.force_accept = 0.5
    eng._ticks = ticks = tserving._SpecTicks(eng)
    captured = []
    inner = ticks._tick

    def counted(g, window, mask, draw=True):
        before = append.launches
        out = inner(g, window, mask, draw)
        if torch.cuda.is_current_stream_capturing():
            captured.append(append.launches - before)
        return out

    ticks._tick = counted
    for g in (4, 11):
        window = 128
        snap = [t.clone() for t in _both_caches(eng)]
        gstate = eng.generator.get_state()
        with torch.inference_mode():
            ticks._upload()
            want = ticks._tick(g, window, ticks.active).cpu().numpy()
        want_kv = [t.view(torch.uint8).clone() for t in _both_caches(eng)]
        for t, t0 in zip(_both_caches(eng), snap):
            t.copy_(t0)
        eng.generator.set_state(gstate)
        got = ticks.run(g, window)
        np.testing.assert_array_equal(got, want)
        assert _bytes_equal([t.view(torch.uint8) for t in _both_caches(eng)],
                            want_kv)
        assert (got[:, g + 1] <= g - 1).all()
    assert sorted(ticks.graphs) == [(4, 128), (11, 128)]
    assert captured == [(g * draft_layers + _BLOCK_CFG.num_layers)
                        for g in (4, 11)]
    for buf in fused._COUNTERS.values():
        assert not buf.any()


def test_spec_streams_meet_the_tie_rule_on_the_card(block_params):
    """SpecEngine (adaptive, the target as its own draft and a 1-layer
    draft) against the plain Engine on the card, 2 requests of 60 tokens:
    the streams are equal or diverge first where the target's own
    score_forward logits (over prompt and tokens) have a top-2 gap below
    2^-5 * max|logits|. The target as its own draft accepts at least a
    quarter of what it proposes."""
    rng = torch.Generator().manual_seed(5)
    reqs = [tserving.Request(uid=i, tokens=torch.randint(
        0, _BLOCK_CFG.vocab_size, (n,), generator=rng).numpy().astype(
            "int32"), max_new_tokens=60) for i, n in enumerate((40, 30))]
    want = tserving.Engine(block_params, _BLOCK_CFG, max_batch=2).run(reqs)
    scorer = tserving.Engine(block_params, _BLOCK_CFG, max_batch=2)
    for draft_layers in (3, 1):
        dcfg = dataclasses.replace(_BLOCK_CFG, num_layers=draft_layers)
        eng = tserving.SpecEngine(
            block_params, _BLOCK_CFG,
            dict(block_params, layers=block_params["layers"][:draft_layers]),
            dcfg, gamma=7, max_batch=2, draft_fmt="nvfp4")
        got = eng.run(reqs)
        for r in reqs:
            a, b = got[r.uid], want[r.uid]
            diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
            if not diff:
                assert a == b
                continue
            i = diff[0]
            toks = np.concatenate([r.tokens, np.asarray(b[:i], np.int32)])
            lg = scorer.score_forward(np.stack([toks, toks]))[0, -1].float()
            top2 = lg.sort().values[-2:]
            assert (top2[1] - top2[0]).item() < \
                2 ** -5 * lg.abs().max().item(), (r.uid, i)
        assert eng.spec_stats["ticks"] > 0 and eng._ticks.graphs
        if draft_layers == 3:
            assert eng.spec_stats["accepted"] >= eng.spec_stats["proposed"] / 4


def test_spec_force_accept_one_on_the_card(block_params):
    """force_accept = 1.0: n_acc = g - 1 in every tick of every active
    slot, each tick a replay."""
    eng = _spec_engine(block_params, "headed fp8", draft_layers=1, gamma=5)
    eng.force_accept = 1.0
    eng._ticks = ticks = tserving._SpecTicks(eng)
    seen, inner = [], ticks.run

    def run(g, window):
        out = inner(g, window)
        seen.append((g, eng.active.copy(), out))
        return out

    ticks.run = run
    while eng.active.any():
        eng.step()
    assert seen
    for g, active, out in seen:
        assert (out[active, g + 1] == g - 1).all()


def test_capture_survives_dropped_engines(block_params):
    """An engine dropped with its graphs sits in a reference cycle (its
    _ticks / _blocks refer back to it). A later capture, with Python's
    collector set to run at every allocation, still succeeds: the capture
    helper collects first and keeps the collector off while capturing
    (a collection inside a capture destroyed the old graphs there and
    invalidated it)."""
    import gc

    old = gc.get_threshold()
    try:
        for _ in range(2):
            eng = _spec_engine(block_params, "flat bf16", draft_layers=1)
            eng.step()
            blk = _block_engine(block_params, "flat bf16",
                                prompt_lens=(40, 30), temps=(0.0, 0.0))
            blk.step_block(2, waiters=False)
            assert eng._ticks.graphs and blk._blocks.graphs
            del eng, blk
            gc.set_threshold(1, 1, 1)
        eng = _spec_engine(block_params, "headed fp8", draft_layers=3)
        while eng.active.any():
            eng.step()
        assert eng._ticks.graphs
    finally:
        gc.set_threshold(*old)


# -- tensor and expert parallelism on a one-rank NCCL group -----------------

_LLAMA8B_UNFUSED = (("wq", 4096, 4096), ("wk", 4096, 1024),
                    ("wv", 4096, 1024), ("wo", 4096, 4096),
                    ("w_gate", 4096, 14336), ("w_up", 4096, 14336),
                    ("w_down", 14336, 4096))


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A one-rank NCCL process group on the card (its communicator made
    at once) and its ("dp", "tp"), ("dp", "ep") and ("dp", "pp") meshes of
    shape (1, 1): every collective of parallel/ runs through NCCL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL has no CPU mode")
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    store = tmp_path_factory.mktemp("nccl") / "store"
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        yield {"tp": init_device_mesh("cuda", (1, 1),
                                      mesh_dim_names=("dp", "tp")),
               "ep": init_device_mesh("cuda", (1, 1),
                                      mesh_dim_names=("dp", "ep")),
               "pp": init_device_mesh("cuda", (1, 1),
                                      mesh_dim_names=("dp", "pp"))}
    finally:
        import gc
        gc.collect()
        torch.cuda.synchronize()
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def tp_block_params(nccl_mesh):
    """The narrow 3-layer Llama through quantize_params_tp at tp = 1: the
    unfused tree both the plain and the TP Engine serve."""
    from petit_kernel_tpu_torch.parallel import tp as ttp

    g = torch.Generator(device="cuda").manual_seed(0)
    return ttp.quantize_params_tp(tllama.init_params(_BLOCK_CFG, g),
                                  _BLOCK_CFG, nccl_mesh["tp"])


def _tp_engine(params, mesh, layout):
    from petit_kernel_tpu_torch.parallel import tp as ttp

    return tserving.Engine(
        params, _BLOCK_CFG, max_batch=2, seed=7,
        forward_fn=ttp.make_tp_step(_BLOCK_CFG, mesh),
        cache=ttp.init_cache_tp(_BLOCK_CFG, 2, mesh,
                                dtype=_BLOCK_DTYPES[layout]))


@pytest.mark.parametrize("layout", sorted(_BLOCK_DTYPES))
def test_tp_engine_tokens_equal_the_plain_engine(nccl_mesh, tp_block_params,
                                                 layout):
    """The TP Engine (make_tp_step, init_cache_tp) at tp = 1 over the
    unfused params gives the plain Engine's tokens over the same params
    bit for bit, eager and in decode blocks of 4: at one rank the
    all_reduces and all-gathers copy."""
    reqs = [tserving.Request(uid=i, tokens=(np.arange(7 + 30 * i) % 500
                                            ).astype(np.int32),
                             max_new_tokens=12) for i in range(3)]
    for block in (1, 4):
        plain = tserving.Engine(tp_block_params, _BLOCK_CFG, max_batch=2,
                                cache_dtype=_BLOCK_DTYPES[layout])
        want = plain.run(reqs, decode_block=block)
        got = _tp_engine(tp_block_params, nccl_mesh["tp"], layout).run(
            reqs, decode_block=block)
        assert got == want, (layout, block)


def _ep_block_params(mesh):
    from petit_kernel_tpu_torch.parallel import ep as tep

    g = torch.Generator(device="cuda").manual_seed(0)
    q = tmoe.quantize_params(tmoe.init_params(_MOE_BLOCK_CFG, g),
                             _MOE_BLOCK_CFG)
    for lp in q["layers"]:
        lp["experts"], lp["router"] = tep.place_experts_ep(
            lp["experts"], lp["router"], mesh)
    return q


@pytest.mark.parametrize("which", ["tp flat bf16", "tp headed fp8",
                                   "ep flat bf16"])
def test_parallel_block_replays_bit_for_bit_eager_steps(nccl_mesh,
                                                        tp_block_params,
                                                        which):
    """A TP Engine's (flat bf16, headed fp8) and an EP Engine's
    (make_ep_step over the narrow Mixtral) block of 6 steps from position
    123, each step a replay of its window's captured graph with the NCCL
    collectives inside, bit for bit 6 eager steps from a snapshot of the
    same state (tokens, logits, cache bytes); the EP step, like the plain
    Mixtral step, gives the plain Mixtral Engine's tokens."""
    from petit_kernel_tpu_torch.parallel import ep as tep

    kind, layout = which.split(" ", 1)
    if kind == "tp":
        eng = _block_engine(None, None, eng=_tp_engine(
            tp_block_params, nccl_mesh["tp"], layout))
    else:
        params = _ep_block_params(nccl_mesh["ep"])
        eng = _block_engine(None, None, eng=tserving.Engine(
            params, _MOE_BLOCK_CFG, max_batch=2, seed=7,
            forward_fn=tep.make_ep_step(_MOE_BLOCK_CFG, nccl_mesh["ep"])))
    want, want_lg, want_kv, got, got_lg, got_kv = _eager_then_block(eng, 6)
    np.testing.assert_array_equal(got, want)
    for g, w in zip(got_lg, want_lg):
        assert torch.equal(g.view(torch.int16), w.view(torch.int16))
    assert _bytes_equal(got_kv, want_kv)
    assert sorted(eng._blocks.graphs) == [128, 256]
    if kind == "ep":
        reqs = _block_requests(n_new=8)
        plain = tserving.Engine(
            params, _MOE_BLOCK_CFG, max_batch=2,
            forward_fn=tmoe.make_engine_forward(_MOE_BLOCK_CFG))
        ep_eng = tserving.Engine(
            params, _MOE_BLOCK_CFG, max_batch=2,
            forward_fn=tep.make_ep_step(_MOE_BLOCK_CFG, nccl_mesh["ep"]))
        assert ep_eng.run(reqs, decode_block=4) == plain.run(
            reqs, decode_block=4)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name,k,n", _LLAMA8B_UNFUSED)
def test_tp_shard_gemm_shapes_match_twin(gen, name, k, n, tp):
    """The GEMM shapes a tp-way rank launches at Llama-3-8B widths, each
    rank's shard in turn in this one process: quantize_linear_tp (wo and
    w_down k-sharded with a per-shard repack), local_linear_tp, then
    mul_nvfp4_a16 at m = 8 and 512 twice the same bits and within the
    GEMM tolerance of fused_mul_reference; the shards' columns side by
    side, or the sum of the k-shards' products, within the same tolerance
    of the unsharded product of the same codes."""
    from petit_kernel_tpu_torch.parallel import tp as ttp

    shard = "k" if name in ("wo", "w_down") else "n"
    w = tllama.normal(gen, (k, n), 1.0 / math.sqrt(k))
    full = tllama.quantize_linear(w, "nvfp4")
    g = ttp.quantize_linear_tp(w, tp, shard)
    for m in (8, 512):
        a = _bf16(gen, m, k)
        want = tgemm.mul_nvfp4_a16(a, full["words"], full["scales"],
                                   full["gs"], m, n, k, -1)
        parts = []
        for t in range(tp):
            loc = ttp.local_linear_tp(g, tp, shard, t)
            kl = k // tp if shard == "k" else k
            nl = loc["words"].shape[1]
            a_l = (a[:, t * kl:(t + 1) * kl].contiguous()
                   if shard == "k" else a)
            y = tgemm.mul_nvfp4_a16(a_l, loc["words"], loc["scales"],
                                    loc["gs"], m, nl, kl, -1)
            again = tgemm.mul_nvfp4_a16(a_l, loc["words"], loc["scales"],
                                        loc["gs"], m, nl, kl, -1)
            assert torch.equal(y.view(torch.int16), again.view(torch.int16))
            twin = fused.fused_mul_reference(
                a_l, loc["words"], loc["scales"], loc["gs"].reshape(1),
                sid=sol.SolutionId(16, 64))
            torch.testing.assert_close(
                y.float(), twin.float(), rtol=2 ** -7,
                atol=2 ** -8 * twin.float().abs().max().item())
            parts.append(y)
        total = (torch.cat(parts, dim=1) if shard == "n"
                 else sum(p.float() for p in parts))
        torch.testing.assert_close(
            total.float(), want.float(), rtol=2 ** -7,
            atol=2 ** -8 * want.float().abs().max().item())


def test_sp_forward_and_rs_gemm_equal_the_tp_path(nccl_mesh,
                                                  tp_block_params):
    """At tp = 1: make_tp_forward_sp on a (1, 64) prompt gives
    make_tp_forward's logits bit for bit, and mul_fp4_tp_rs over w_down
    at m = 8 and 96 gives mul_nvfp4_a16's bits (a one-rank reduce-scatter
    copies)."""
    from petit_kernel_tpu_torch.parallel import tp as ttp

    mesh = nccl_mesh["tp"]
    toks = torch.randint(0, _BLOCK_CFG.vocab_size, (1, 64), device="cuda",
                         generator=torch.Generator(device="cuda"
                                                   ).manual_seed(3))
    want = ttp.make_tp_forward(_BLOCK_CFG, mesh)(tp_block_params, toks)
    got = ttp.make_tp_forward_sp(_BLOCK_CFG, mesh)(tp_block_params, toks)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    layer = tp_block_params["layers"][0]["w_down"]
    k, n = _BLOCK_CFG.intermediate_size, layer["words"].shape[1]
    g = torch.Generator(device="cuda").manual_seed(4)
    for m in (8, 96):
        a = _bf16(g, m, k)
        y = ttp.mul_fp4_tp_rs(a, layer, mesh, k)
        ref = tgemm.mul_nvfp4_a16(a, layer["words"], layer["scales"],
                                  layer["gs"], m, n, k, -1)
        assert torch.equal(y.view(torch.int16), ref.view(torch.int16))


# -- pipeline parallelism, the dense TP training step, the fallback Engine --

def _tie_band_check(params, cfg, prompts, toks):
    """Each emitted token (B, n) of prompts (B, T0) is the cacheless
    llama.forward's argmax over the prompt and the tokens before it, or
    its logit lies within 2^-5 * max|logits| of the top."""
    T0 = prompts.shape[1]
    with torch.inference_mode():
        lg, _ = tllama.forward(params, torch.cat([prompts, toks[:, :-1]], 1),
                               cfg)
    lg = lg[:, T0 - 1:].float()
    gap = lg.amax(-1) - lg.gather(2, toks.long()[..., None])[..., 0]
    assert bool((gap <= 2 ** -5 * lg.abs().amax(-1)).all())


@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_pp_step_and_forward_at_one_stage(nccl_mesh, block_params, n_micro):
    """make_pp_step at pp = 1 (one stage, no point-to-point, the logits
    broadcast over a one-rank NCCL group) over the narrow 3-layer Llama
    (nvfp4), B = 4: 20 prompt tokens teacher-forced, then 12 greedy
    tokens, each within the tie rule of the cacheless forward (the prompt
    goes through decode steps, where greedy_decode prefills it, so a
    near-tie may break the other way). Each microbatch launches the KV
    append once a layer. make_pp_forward on (4, 64) tokens within the
    GEMM tolerance of llama.forward."""
    from petit_kernel_tpu_torch.parallel import pp as tpp

    mesh, cfg = nccl_mesh["pp"], _BLOCK_CFG
    placed = tpp.place_params_pp(block_params, mesh)
    assert placed["layers"]["wqkv"]["words"].shape[0] == cfg.num_layers
    g = torch.Generator(device="cuda").manual_seed(6)
    prompts = torch.randint(0, cfg.vocab_size, (4, 20), device="cuda",
                            generator=g)
    step = tpp.make_pp_step(cfg, mesh, n_micro, fmt="nvfp4")
    cache = tpp.init_cache_pp(cfg, 4, mesh)
    before = attention.kv_append.launches
    for t in range(20):
        logits, cache = step(placed, cache, prompts[:, t],
                             torch.full((4,), t, dtype=torch.int32,
                                        device="cuda"))
    assert attention.kv_append.launches - before == 20 * 3 * n_micro
    toks = [logits.argmax(-1).to(torch.int32)]
    for t in range(11):
        logits, cache = step(placed, cache, toks[-1],
                             torch.full((4,), 20 + t, dtype=torch.int32,
                                        device="cuda"))
        toks.append(logits.argmax(-1).to(torch.int32))
    toks = torch.stack(toks, 1)
    _tie_band_check(block_params, cfg, prompts, toks)
    x = torch.randint(0, cfg.vocab_size, (4, 64), device="cuda",
                      generator=g)
    got = tpp.make_pp_forward(cfg, mesh, 2, fmt="nvfp4")(placed, x)
    with torch.inference_mode():
        want, _ = tllama.forward(block_params, x, cfg)
    torch.testing.assert_close(
        got.float(), want.float(), rtol=2 ** -7,
        atol=2 ** -8 * want.float().abs().max().item())


def _nll(logits, targets):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long()[..., None]).mean()


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grads(v) for v in tree]
    return tree.grad


def _leaves_requiring_grad(tree):
    if isinstance(tree, dict):
        return {k: _leaves_requiring_grad(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_leaves_requiring_grad(v) for v in tree]
    return tree.detach().clone().requires_grad_()


def _tree_bits_equal(a, b):
    if isinstance(a, dict):
        return all(_tree_bits_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return all(_tree_bits_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("kind", ["tp", "sp"])
def test_tp_train_step_equals_the_plain_step_on_one_rank(nccl_mesh, kind):
    """make_tp_forward (or make_tp_forward_sp) over shard_dense_params at
    tp = 1, leaves that require grad: the loss and every gradient after
    loss.backward() bit for bit the plain dense step's (llama.forward), on
    the narrow dense Llama, (2, 64) input tokens: at one rank the NCCL
    collectives and their backwards copy."""
    from petit_kernel_tpu_torch.parallel import tp as ttp

    cfg, mesh = _BLOCK_CFG, nccl_mesh["tp"]
    dense = tllama.init_params(cfg, torch.Generator(device="cuda"
                                                    ).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 65), device="cuda",
                         generator=torch.Generator(device="cuda"
                                                   ).manual_seed(8))
    plain = _leaves_requiring_grad(dense)
    want = _nll(tllama.forward(plain, toks[:, :-1], cfg)[0], toks[:, 1:])
    want.backward()
    make = {"tp": ttp.make_tp_forward, "sp": ttp.make_tp_forward_sp}[kind]
    local = _leaves_requiring_grad(ttp.shard_dense_params(dense, mesh))
    logits = make(cfg, mesh, fmt="bf16")(local, toks[:, :-1])
    assert logits.grad_fn is not None
    got = _nll(logits, toks[:, 1:])
    got.backward()
    assert torch.equal(got, want)
    assert _tree_bits_equal(_grads(local), _grads(plain))


def _fallback_forward(cfg):
    def forward(p, toks, cache, pos):
        return tllama.forward(p, toks, cfg, cache, pos,
                              kv_window=cfg.max_seq_len)
    return forward


def test_fallback_engine_on_the_card_meets_the_cpu(block_params):
    """Engine(forward_fn=f), f taking neither kv_window nor write_mask, on
    the card, eager and in decode blocks of 4 (one step graph, no window
    key), against the same engine on the CPU: the streams are equal or
    first diverge where the card Engine's score_forward has a top-2 gap
    below 2^-5 * max|logits|."""
    reqs = _block_requests(n_new=12)
    want = tserving.Engine(_to_cpu(block_params), _BLOCK_CFG, max_batch=2,
                           forward_fn=_fallback_forward(_BLOCK_CFG)).run(
        reqs)
    scorer = tserving.Engine(block_params, _BLOCK_CFG, max_batch=2)
    for block in (1, 4):
        eng = tserving.Engine(block_params, _BLOCK_CFG, max_batch=2,
                              forward_fn=_fallback_forward(_BLOCK_CFG))
        got = eng.run(reqs, decode_block=block)
        if block > 1:
            assert list(eng._blocks.graphs) == [None]
        for r in reqs:
            a, b = got[r.uid], want[r.uid]
            diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
            if not diff:
                assert a == b
                continue
            i = diff[0]
            toks = np.concatenate([r.tokens, np.asarray(b[:i], np.int32)])
            lg = scorer.score_forward(np.stack([toks, toks]))[0, -1].float()
            top2 = lg.sort().values[-2:]
            assert (top2[1] - top2[0]).item() < \
                2 ** -5 * lg.abs().max().item(), (block, r.uid, i)


def test_fallback_block_replays_bit_for_bit_eager_steps(block_params):
    """The fallback Engine's block of 6 steps (flat bf16), each a replay of
    its one step graph, whose forward parks the rows that may not write at
    max_seq_len - 1 inside the graph: bit for bit 6 eager steps from a
    snapshot of the same state (tokens, logits, cache bytes)."""
    eng = _block_engine(None, None, eng=tserving.Engine(
        block_params, _BLOCK_CFG, max_batch=2, seed=7,
        forward_fn=_fallback_forward(_BLOCK_CFG)))
    want, want_lg, want_kv, got, got_lg, got_kv = _eager_then_block(eng, 6)
    np.testing.assert_array_equal(got, want)
    for g, w in zip(got_lg, want_lg):
        assert torch.equal(g.view(torch.int16), w.view(torch.int16))
    assert _bytes_equal(got_kv, want_kv)
    assert list(eng._blocks.graphs) == [None]


# -- the same across four cards (a 4-card host only) -------------------------

_PP4_CFG = tllama.LlamaConfig.tiny(num_layers=4)
_TRAIN4_CFG = tllama.LlamaConfig(
    vocab_size=128, hidden_size=128, intermediate_size=256, num_layers=2,
    num_heads=8, num_kv_heads=4, head_dim=16, max_seq_len=32)


@pytest.mark.skipif(torch.cuda.device_count() < 4,
                    reason="needs four CUDA cards in one host")
def test_pp_and_tp_training_across_four_cards(nccl_mesh, tmp_path):
    """One rank a card in a 4-rank NCCL group (tests/_torch_parallel_ranks.py
    with device="cuda"; the activations cross cards by NCCL point to point):
    make_pp_forward at (dp, pp) = (1, 4) and (2, 2), bf16 and nvfp4,
    within the Llama forward's bound, 2^-5 * max|logits|, of llama.forward
    on this process's card (the dense products run cuBLAS at m = 32 rows a
    microbatch against 64, another algorithm, one bf16 ulp apart on a few
    logits);
    make_pp_step at pp = 4, n_micro 2 and 4, its tokens and each stage's
    cache bit for bit the one-card pipeline's (pp = 1, the same
    microbatches) over the same layers; the dense TP and SP training steps
    at (dp, tp) = (2, 2) and (1, 4), every rank's loss within rtol 1e-3
    and every gradient within 2^-5 * max of its slice of the one-card
    plain step's (NCCL sums the ranks' partials in its own order)."""
    import _torch_parallel_ranks as ranks
    from petit_kernel_tpu_torch.parallel import pp as tpp

    g = torch.Generator().manual_seed(0)
    dense = tllama.init_params(_PP4_CFG, g)
    params = {"bf16": dense, "nvfp4": tllama.quantize_params(dense)}
    tokens = torch.randint(0, _PP4_CFG.vocab_size, (4, 16), generator=g)
    prompt = torch.randint(0, _PP4_CFG.vocab_size, (4, 6), generator=g)
    pp_res = ranks.finish(ranks.start("pp", 4, dict(
        cfg=dataclasses.asdict(_PP4_CFG), params=params,
        meshes={4: [(1, 4), (2, 2)]}, tokens=tokens, prompt=prompt,
        n_new=5, n_micro=[2, 4]), str(tmp_path / "pp"), device="cuda"))
    for fmt, p in params.items():
        p = _to_cuda(p)
        with torch.inference_mode():
            want, _ = tllama.forward(p, tokens.cuda(), _PP4_CFG, fmt=fmt)
        for key in ("1x4", "2x2"):
            got = pp_res[0][f"fwd {fmt} {key}"]
            for r in pp_res[1:]:
                assert torch.equal(r[f"fwd {fmt} {key}"], got)
            err = (got.float() - want.float().cpu()).abs().max().item()
            assert err <= 2 ** -5 * want.float().abs().max().item(), (
                fmt, key, err)
        placed = tpp.place_params_pp(p, nccl_mesh["pp"])
        for n_micro in (2, 4):
            step = tpp.make_pp_step(_PP4_CFG, nccl_mesh["pp"], n_micro,
                                    fmt=fmt)
            cache = tpp.init_cache_pp(_PP4_CFG, 4, nccl_mesh["pp"])
            run = pp_res[0][f"decode {fmt} {n_micro}"]
            seq = torch.cat([prompt, run["tokens"][:, :-1]], 1).cuda()
            for t in range(seq.shape[1]):
                logits, cache = step(placed, cache, seq[:, t], torch.full(
                    (4,), t, dtype=torch.int32, device="cuda"))
            assert torch.equal(logits.argmax(-1).int().cpu(),
                               run["tokens"][:, -1])
            for r in pp_res:
                s = r["stage"]
                ck, cv = r[f"decode {fmt} {n_micro}"]["cache"]
                assert torch.equal(r[f"decode {fmt} {n_micro}"]["tokens"],
                                   run["tokens"])
                assert torch.equal(ck[0], cache[0][s].cpu())
                assert torch.equal(cv[0], cache[1][s].cpu())

    tdense = tllama.init_params(_TRAIN4_CFG, g)
    ttoks = torch.randint(0, _TRAIN4_CFG.vocab_size, (4, 17), generator=g)
    tr_res = ranks.finish(ranks.start("train", 4, dict(
        cfg=dataclasses.asdict(_TRAIN4_CFG), dense=tdense, tokens=ttoks,
        lr=1e-3, meshes={4: [(2, 2), (1, 4)]}), str(tmp_path / "train"),
        device="cuda"))
    plain = _leaves_requiring_grad(_to_cuda(tdense))
    want = ranks.nll(tllama.forward(plain, ttoks[:, :-1].cuda(),
                                    _TRAIN4_CFG)[0], ttoks[:, 1:].cuda())
    want.backward()
    plain_grads = _flat_grads(_grads(plain))
    for key in ("tp 2x2", "sp 2x2", "tp 1x4", "sp 1x4"):
        tp = int(key[-1])
        for r in tr_res:
            run = r[key]
            assert abs(run["loss"] - want.item()) <= 1e-3 * want.item()
            t = run["tp_rank"]
            for path, got in _flat_grads(run["grads"]).items():
                w = plain_grads[path].float().cpu()
                if path.endswith(("wq/w", "wk/w", "wv/w", "w_gate/w",
                                  "w_up/w", "lm_head/w")):
                    n = w.shape[1] // tp
                    w = w[:, t * n:(t + 1) * n]
                elif path.endswith(("wo/w", "w_down/w")):
                    n = w.shape[0] // tp
                    w = w[t * n:(t + 1) * n]
                err = (got.float() - w).abs().max().item()
                assert err <= 2 ** -5 * w.abs().max().item(), (key, path)


def _to_cuda(tree):
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cuda(v) for v in tree]
    return tree.cuda()


def _flat_grads(tree, path=""):
    if isinstance(tree, dict):
        return {p: g for k, v in tree.items()
                for p, g in _flat_grads(v, f"{path}/{k}").items()}
    if isinstance(tree, list):
        return {p: g for i, v in enumerate(tree)
                for p, g in _flat_grads(v, f"{path}/{i}").items()}
    return {path: tree}
