"""The split-k 16-row (decode) tiles of fused_mul on the CPU.

fused_mul's 16-row tiles run csrc/fp4_stream.cuh with split-k
(csrc/fp4_gemm.cu fp4_stream_kernel): each output tile's kp is cut into
`splits` CTAs of whole 256-deep steps, and their f32 partials are summed in
split order. A CUDA kernel has no CPU mode, so these tests hold what
surrounds it against the JAX package:

- the split rule (fused.stream_splits, which hybrid_mul follows too):
  counts in [1, kp / 256], ranges that partition the steps with none
  empty, the most splits whose CTAs fit one wave of two per SM of the
  H100 (132 SMs) or one, one split at block_m = 64, and the counts the
  Llama-3-8B decode projections get;
- fused_mul's `splits` argument on CPU tensors: checked as on the card,
  ignored by the twin;
- the split sum played in numpy (per-split f32 partials of exact bf16
  products over the natural k of the split's steps, summed in split
  order, one bf16 rounding after * gs) against the JAX package's fused_mul
  (Pallas, interpret mode) on the same bytes, at the GEMM tolerance: rtol
  2^-7, atol 2^-8 * max|ref|, since both sum the same exact products in
  f32, in other orders, and round once to bf16.

The kernels themselves run on the card: tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import petit_kernel_tpu as pk
from petit_kernel_tpu.utils.testdata import make_gemm_data
from petit_kernel_tpu_torch.ops import layout as tlayout
from petit_kernel_tpu_torch.ops import solution as tsol
from petit_kernel_tpu_torch.ops.kernels import fused
from petit_kernel_tpu_torch.ops.kernels import hybrid as khybrid

torch.set_num_threads(1)

_H100_SMS = 132
# the four Llama-3-8B projections (k, n) and a ragged one (k padded past
# itself, n not a multiple of either tile)
_SHAPES = ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
           (640, 336))
_ENTRIES = {
    "nvfp4": pk.mul_nvfp4_a16,
    "mxfp4": pk.mul_mxfp4_a16,
    "nvfp4p2": pk.mul_nvfp4p2_a16,
    "nvfp4p2z": pk.mul_nvfp4p2z_a16,
    "mxfp4z": pk.mul_mxfp4z_a16,
}


def _split_ranges(steps, splits):
    """fp4_stream_kernel's k ranges: split s of a tile covers the steps
    [s * steps // splits, (s + 1) * steps // splits)."""
    return [(s * steps // splits, (s + 1) * steps // splits)
            for s in range(splits)]


# ---- the split rule ---------------------------------------------------------

@pytest.mark.parametrize("bn", [64, 128])
@pytest.mark.parametrize("m", [1, 4, 8, 16, 17, 32])
@pytest.mark.parametrize("k,n", _SHAPES)
def test_stream_splits_partition_k_and_fill_one_wave(k, n, m, bn):
    kp = tlayout.padded_k(k)
    steps = kp // fused.KSTEP
    splits = fused.stream_splits(m, n, 0, kp, 16, bn, _H100_SMS)[0]
    assert 1 <= splits <= steps
    ranges = _split_ranges(steps, splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == steps
    assert all(r0 < r1 for r0, r1 in ranges)                  # none empty
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    tiles = -(-m // 16) * -(-n // bn)
    # the most splits whose CTAs fit one wave of two per SM, at least one
    assert tiles * splits <= 2 * _H100_SMS or splits == 1, (splits, tiles)
    assert splits == steps or tiles * (splits + 1) > 2 * _H100_SMS
    assert fused.stream_splits(m, n, 0, kp, 64, bn, _H100_SMS) == (1, 1)


def test_stream_splits_at_the_llama_decode_shapes():
    """m = 8, block_n = 64 on 132 SMs: wqkv 96 tiles x 2 splits (192
    CTAs), wo 64 x 4 (256), w_gate_up 448 x 1, w_down 64 x 4 (14 steps
    each of 56)."""
    got = [fused.stream_splits(8, n, 0, k, 16, 64, _H100_SMS)[0]
           for k, n in _SHAPES[:4]]
    assert got == [2, 4, 1, 4]
    assert {r1 - r0 for r0, r1 in _split_ranges(56, 4)} == {14}


def test_one_split_rule_for_fused_and_hybrid():
    """hybrid_mul's rule is fused_mul's, with its dense columns: one
    function, one counter buffer."""
    assert khybrid.hybrid_splits is fused.stream_splits
    assert khybrid.KSTEP == fused.KSTEP
    assert not hasattr(khybrid, "_counters")
    assert not hasattr(khybrid, "_num_sms")


# ---- fused_mul(splits=...) on CPU tensors ------------------------------------

def _operands(m=5, n=128, k=640, fmt="nvfp4", seed=3):
    d = make_gemm_data(m, n, k, fmt, seed=seed)
    words = torch.from_numpy(d.words.view(np.int32))
    st = torch.from_numpy(d.scales_t.view(np.int16)).view(torch.bfloat16)
    a = torch.from_numpy(d.a).to(torch.bfloat16)
    gs = torch.tensor([d.global_scale], dtype=torch.float32)
    return d, a, words, st, gs


def _bits(t):
    return t.view(torch.int16).numpy()


@pytest.mark.parametrize("splits", [1, 3, "steps", None])
def test_fused_mul_cpu_splits_return_the_twin(splits):
    """An explicit split count (or None) is checked, and the twin's bits
    come back unchanged."""
    _, a, words, st, gs = _operands()
    sid = tsol.SolutionId(16, 64)
    steps = words.shape[0] * 8 // fused.KSTEP                     # kp 1024: 4
    if splits == "steps":
        splits = steps
    want = fused.fused_mul_reference(a, words, st, gs, sid=sid)
    got = fused.fused_mul(a, words, st, gs, sid=sid, splits=splits)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("bad", [0, "steps + 1", (1, 2), 1.0, "2"])
def test_fused_mul_cpu_rejects_bad_splits(bad):
    _, a, words, st, gs = _operands()
    steps = words.shape[0] * 8 // fused.KSTEP
    if bad == "steps + 1":
        bad = steps + 1
    with pytest.raises(ValueError, match="splits"):
        fused.fused_mul(a, words, st, gs, sid=tsol.SolutionId(16, 64),
                        splits=bad)


def test_fused_mul_cpu_splits_only_the_plain_16_row_tiles():
    """Block_m = 64 ids, high precision included, take one split; the
    16-row tiles split, plain, weight cache and high precision (the twin's
    bits either way, the hp twin's for an hp id)."""
    _, a, words, st, gs = _operands(m=70)
    for sid in (tsol.SolutionId(64, 128), tsol.SolutionId(64, 64),
                tsol.SolutionId(64, 64, weight_cache=True),
                tsol.SolutionId(64, 64, high_precision=True),
                tsol.SolutionId(64, 128, high_precision=True,
                                weight_cache=True)):
        a_ = a.float() if sid.high_precision else a
        assert fused.fused_mul(a_, words, st, gs, sid=sid,
                               splits=1).shape == (70, 128)
        with pytest.raises(ValueError, match="do not split"):
            fused.fused_mul(a_, words, st, gs, sid=sid, splits=2)
    want = fused.fused_mul_reference(a, words, st, gs, sid=None)
    for sid in (tsol.SolutionId(16, 64),
                tsol.SolutionId(16, 64, weight_cache=True)):
        got = fused.fused_mul(a, words, st, gs, sid=sid, splits=2)
        np.testing.assert_array_equal(_bits(got), _bits(want))
    want_hp = fused.fused_mul_hp_reference(a.float(), words, st, gs,
                                           sid=None)
    for sid in (tsol.SolutionId(16, 64, high_precision=True),
                tsol.SolutionId(16, 64, high_precision=True,
                                weight_cache=True)):
        got = fused.fused_mul(a.float(), words, st, gs, sid=sid, splits=2)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.view(torch.int32).numpy(),
                                      want_hp.view(torch.int32).numpy())


# ---- the split sum against the JAX package -----------------------------------

def _step_k(step, kp):
    """Natural k of one 256-deep step in the kernels' step order
    (csrc/fp4_gemm.cuh): per quarter j, j * kp / 4 + (step // 2) * 128 +
    (step % 2) * 8 + a * 16 + x for a, x in [0, 8)."""
    c, hf = divmod(step, 2)
    ax = (np.arange(8)[:, None] * 16 + np.arange(8)[None]).ravel()
    return np.concatenate([j * (kp // 4) + c * 128 + hf * 8 + ax
                           for j in range(4)])


def _split_sum(a, deq, gs, splits):
    """The split-k tile's arithmetic in numpy: a (m, k) bf16 values as f32,
    deq (kp, n) f32 decoded weights; per split an f32 sum of the exact
    products over its steps' natural k, the partials added in split order,
    then * gs and one bf16 rounding."""
    m, k = a.shape
    kp = deq.shape[0]
    a_pad = np.zeros((m, kp), np.float32)
    a_pad[:, :k] = a                     # the kernel zero-fills past k
    acc = np.zeros((m, deq.shape[1]), np.float32)
    for s0, s1 in _split_ranges(kp // fused.KSTEP, splits):
        ks = np.concatenate([_step_k(s, kp) for s in range(s0, s1)])
        acc = acc + a_pad[:, ks] @ deq[ks]
    out = torch.from_numpy(acc * np.float32(gs)).to(torch.bfloat16)
    return out.float().numpy()


def _assert_gemm_close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=2 ** -7,
                               atol=2 ** -8 * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("fmt", sorted(_ENTRIES))
def test_split_sum_matches_jax_fused_mul(fmt):
    """k = 640 (kp 1024: 4 steps) and 1152 (kp 1536 or 2048), m = 5 and 17:
    the numpy split sum at 1, 2, 3 and one split a step, and fused_mul at
    the same explicit counts on CPU tensors, against the JAX package."""
    for m, k in ((5, 640), (17, 1152)):
        n = 128
        d, a, words, st, gs = _operands(m, n, k, fmt, seed=m + k)
        kp = words.shape[0] * 8
        steps = kp // fused.KSTEP
        assert np.array_equal(np.sort(np.concatenate(
            [_step_k(s, kp) for s in range(steps)])), np.arange(kp))
        jmul = _ENTRIES[fmt]
        want = np.asarray(jmul(jnp.asarray(d.a, jnp.bfloat16),
                               jnp.asarray(d.words), jnp.asarray(d.scales_t),
                               jnp.float32(d.global_scale), m, n, k, -1,
                               interpret=True), np.float32)
        deq = tlayout.dequant_from_tpu_layout(words, st, n, kp).numpy()
        a32 = a.float().numpy()
        sid = tsol.SolutionId(16, 64, tsol.ElementB.NVFP4
                              if fmt.startswith("nvfp4")
                              else tsol.ElementB.MXFP4)
        for splits in sorted({1, 2, 3, steps}):
            what = f"{fmt} m={m} k={k} splits={splits}"
            _assert_gemm_close(_split_sum(a32, deq, d.global_scale, splits),
                               want, what)
            got = fused.fused_mul(a, words, st, gs, sid=sid, splits=splits)
            _assert_gemm_close(got.float().numpy(), want, what)
