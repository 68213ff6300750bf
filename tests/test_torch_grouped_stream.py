"""The grouped (MoE) FP4 GEMM's 16-row decode tiles on the CPU.

grouped_mul's 16-row tiles run csrc/fp4_stream.cuh with split-k
(csrc/grouped_fp4_gemm.cu grouped_stream_kernel): each expert's output
tiles are fused_mul's split-k tiles on its slice, and a tile whose bucket
rows are all empty (it starts at or past rows[e]) streams nothing and
writes bf16(0 * gs[e]). A CUDA kernel has no CPU mode, so these tests hold
what surrounds it against the JAX package:

- the split rule: fused.stream_splits over the 16-row CTAs of every
  expert (grouped.grouped_splits), one split at the Mixtral-8x7B cap-8
  projections on the H100 (132 SMs), more for a few narrow experts;
- grouped_mul's `splits` and `rows` arguments on CPU tensors: checked as on
  the card, ignored by the twin;
- the grouped split sum played in numpy per expert (tests/
  test_torch_stream.py's per-split f32 partials, summed in split order,
  one bf16 rounding after * gs), with the skipped tiles written as the
  kernel writes them, against the JAX package's grouped_mul (Pallas,
  interpret mode) on the same bytes, in mxfp4 and nvfp4, with one expert's
  bucket empty and one half-filled, at the GEMM tolerance: rtol 2^-7,
  atol 2^-8 * max|ref|, since both sum the same exact products in f32, in
  other orders, and round once to bf16; the skipped rows exactly zero in
  both;
- moe_mlp_partial's `rows`: each expert's count of kept (token, expert)
  pairs, with every row of the three grouped calls' inputs past it zero.

The kernel itself runs on the card: tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petit_kernel_tpu.models import moe as jmoe
from petit_kernel_tpu.ops.kernels import grouped as jgrouped
from petit_kernel_tpu.ops.solution import ElementB as JElementB
from petit_kernel_tpu_torch.models import convert
from petit_kernel_tpu_torch.models import moe as tmoe
from petit_kernel_tpu_torch.ops import layout as tlayout
from petit_kernel_tpu_torch.ops import solution as tsol
from petit_kernel_tpu_torch.ops.kernels import fused, grouped
from test_torch_stream import _assert_gemm_close, _split_sum

torch.set_num_threads(1)

_H100_SMS = 132
# Mixtral-8x7B's expert projections (k, n): w_gate, w_up, w_down
_MIXTRAL_KN = ((4096, 14336), (4096, 14336), (14336, 4096))


# ---- the split rule ---------------------------------------------------------

def test_grouped_splits_at_the_mixtral_decode_shapes():
    """E = 8, cap 8 (a 4-slot decode step), block_n 64: 8 x 224, 8 x 224
    and 8 x 64 tiles, 1792, 1792 and 512 CTAs, each past one wave of two
    per SM at one split."""
    got = [grouped.grouped_splits(8, 8, n, tlayout.padded_k(k), 16, 64,
                                  _H100_SMS) for k, n in _MIXTRAL_KN]
    assert got == [1, 1, 1]


@pytest.mark.parametrize("E,cap,k,n,bm,bn", [
    (2, 8, 640, 336, 16, 64), (2, 24, 1152, 128, 16, 128),
    (4, 8, 640, 336, 16, 64), (8, 8, 4096, 14336, 16, 64),
    (2, 128, 640, 336, 64, 128)])
def test_grouped_splits_are_the_fused_rule_over_every_expert(E, cap, k, n,
                                                             bm, bn):
    """One rule: stream_splits at m = E * ceil(cap / 16) * 16, whichever
    experts the rows skip; one split at block_m = 64."""
    kp = tlayout.padded_k(k)
    got = grouped.grouped_splits(E, cap, n, kp, bm, bn, _H100_SMS)
    m = E * -(-cap // bm) * bm
    assert got == fused.stream_splits(m, n, 0, kp, bm, bn, _H100_SMS)[0]
    if bm == 64:
        assert got == 1
    elif E == 2 and k == 640:
        # 2 experts x 6 tiles: every one of kp / 256 = 4 steps its own split
        assert got == kp // fused.KSTEP == 4


def test_one_split_rule_and_counter_buffer_for_grouped():
    """grouped_mul keeps no rule, counters or SM count of its own."""
    for name in ("stream_splits", "_counters", "_COUNTERS", "_num_sms"):
        assert not hasattr(grouped, name)


# ---- grouped_mul(splits=..., rows=...) on CPU tensors -----------------------

def _experts(E, cap, k, n, fmt, seed, filled=None):
    """(JAX operands, port operands) on the same bytes: experts quantized
    by the JAX package, xs with bucket e filled up to filled[e]."""
    rng = np.random.default_rng(seed)
    ex = jmoe.quantize_moe_linear(rng.standard_normal((E, k, n)) / 8, fmt)
    x = rng.standard_normal((E, cap, k)).astype(np.float32)
    if filled is not None:
        for e, f in enumerate(filled):
            x[e, f:] = 0
    xj = jnp.asarray(x, jnp.bfloat16)
    tex = convert.params_from_jax(
        {key: np.asarray(v) for key, v in ex.items()}, device="cpu")
    xt = convert.tensor_from_numpy(np.asarray(xj), device="cpu")
    return (xj, ex), (xt, tex)


def _bits(t):
    return t.view(torch.int16).numpy()


def test_grouped_mul_cpu_splits_and_rows_return_the_twin():
    _, (xs, ex) = _experts(3, 8, 640, 128, "mxfp4", 1, filled=(0, 4, 8))
    sid = tsol.SolutionId(16, 64, tsol.ElementB.MXFP4)
    want = grouped.grouped_mul_reference(xs, ex["words"], ex["scales"],
                                         ex["gs"], sid=sid)
    rows = torch.tensor([0, 4, 8], dtype=torch.int32)
    steps = ex["words"].shape[1] * 8 // fused.KSTEP
    for splits in (None, 1, 2, steps):
        got = grouped.grouped_mul(xs, ex["words"], ex["scales"], ex["gs"],
                                  sid=sid, splits=splits, rows=rows)
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("bad", [0, "steps + 1", 1.0, "2", (1, 2)])
def test_grouped_mul_cpu_rejects_bad_splits(bad):
    _, (xs, ex) = _experts(2, 8, 640, 128, "mxfp4", 2)
    if bad == "steps + 1":
        bad = ex["words"].shape[1] * 8 // fused.KSTEP + 1
    with pytest.raises(ValueError, match="splits"):
        grouped.grouped_mul(xs, ex["words"], ex["scales"], ex["gs"],
                            sid=tsol.SolutionId(16, 64, tsol.ElementB.MXFP4),
                            splits=bad)


def test_grouped_mul_cpu_splits_only_the_16_row_tiles():
    _, (xs, ex) = _experts(2, 40, 640, 128, "mxfp4", 3)
    sid = tsol.SolutionId(64, 128, tsol.ElementB.MXFP4)
    assert grouped.grouped_mul(xs, ex["words"], ex["scales"], ex["gs"],
                               sid=sid, splits=1).shape == (2, 40, 128)
    with pytest.raises(ValueError, match="do not split"):
        grouped.grouped_mul(xs, ex["words"], ex["scales"], ex["gs"], sid=sid,
                            splits=2)


@pytest.mark.parametrize("bad", ["int64", "E + 1", "(E, 1)", "list", "meta"])
def test_grouped_mul_cpu_rejects_bad_rows(bad):
    """rows: an int32 (E,) tensor on xs's device, or None."""
    _, (xs, ex) = _experts(2, 8, 640, 128, "mxfp4", 4)
    rows = {"int64": torch.zeros(2, dtype=torch.int64),
            "E + 1": torch.zeros(3, dtype=torch.int32),
            "(E, 1)": torch.zeros((2, 1), dtype=torch.int32),
            "list": [8, 8],
            "meta": torch.zeros(2, dtype=torch.int32, device="meta")}[bad]
    with pytest.raises(ValueError, match="rows"):
        grouped.grouped_mul(xs, ex["words"], ex["scales"], ex["gs"],
                            rows=rows)


# ---- the grouped split sum against the JAX package --------------------------

def _grouped_split_sum(xs, deq, gs, rows, splits):
    """grouped_stream_kernel's arithmetic in numpy: per expert the split-k
    tiles' sum (test_torch_stream._split_sum) over its bucket, and each
    16-row tile at or past rows[e] written as bf16(0 * gs[e])."""
    E, cap, _ = xs.shape
    out = np.stack([_split_sum(xs[e], deq[e], gs[e], splits)
                    for e in range(E)])
    for e in range(E):
        for m0 in range(0, cap, 16):
            if m0 >= rows[e]:
                zero = torch.tensor(0.0 * np.float32(gs[e]))
                out[e, m0:m0 + 16] = zero.to(torch.bfloat16).float().item()
    return out


@pytest.mark.parametrize("fmt", ["mxfp4", "nvfp4"])
@pytest.mark.parametrize("cap", [8, 24])
def test_grouped_split_sum_matches_jax_grouped_mul(fmt, cap):
    """E = 4, k = 640, n = 128; expert 0's bucket empty, expert 1's
    half-filled (at cap 24 its second tile is skipped), the others full:
    the numpy grouped split sum at 1, 2 and one split a step, and
    grouped_mul with the same splits and rows on CPU tensors, against the
    JAX package's grouped_mul."""
    E, k, n = 4, 640, 128
    filled = (0, cap // 2, cap, cap)
    (xj, jex), (xt, tex) = _experts(E, cap, k, n, fmt, 5 + cap,
                                    filled=filled)
    eb = JElementB.MXFP4 if fmt == "mxfp4" else JElementB.NVFP4
    want = np.asarray(jgrouped.grouped_mul(
        xj, jex["words"], jex["scales"], jex["gs"], element_b=eb,
        interpret=True), np.float32)
    kp = tex["words"].shape[1] * 8
    deq = np.stack([tlayout.dequant_from_tpu_layout(
        tex["words"][e], tex["scales"][e], n, kp).numpy() for e in range(E)])
    xs32 = xt.float().numpy()
    gs = tex["gs"].numpy()
    rows = torch.tensor(filled, dtype=torch.int32)
    for e, f in enumerate(filled):
        assert not want[e, -(-f // 16) * 16:].any()   # skipped rows: zeros
    sid = tsol.SolutionId(16, 64, tsol.ElementB.MXFP4 if fmt == "mxfp4"
                          else tsol.ElementB.NVFP4)
    for splits in sorted({1, 2, kp // fused.KSTEP}):
        what = f"{fmt} cap={cap} splits={splits}"
        model = _grouped_split_sum(xs32, deq, gs, filled, splits)
        _assert_gemm_close(model, want, what)
        for e, f in enumerate(filled):
            assert not model[e, -(-f // 16) * 16:].any(), what
        got = grouped.grouped_mul(xt, tex["words"], tex["scales"], tex["gs"],
                                  sid=sid, splits=splits, rows=rows)
        _assert_gemm_close(got.float().numpy(), want, what)


# ---- moe_mlp_partial passes each bucket's filled rows -----------------------

@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_moe_mlp_partial_rows_are_the_kept_pairs(monkeypatch, cf):
    """T = 12 tokens, top-2 over E = 4 experts (capacity_factor 0.5 drops
    pairs): every grouped call gets rows = min(pairs routed to e, cap), as
    int32 on x's device, and its input is zero from rows[e] on."""
    T, H, F, E = 12, 128, 256, 4
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((T, H))).to(torch.bfloat16)
    router = torch.from_numpy(rng.standard_normal((H, E))).to(torch.bfloat16)
    ex = {nm: convert.params_from_jax(
        {key: np.asarray(v) for key, v in jmoe.quantize_moe_linear(
            rng.standard_normal((E, kk, nn)) / 16, "mxfp4").items()},
        device="cpu")
        for nm, (kk, nn) in dict(w_gate=(H, F), w_up=(H, F),
                                 w_down=(F, H)).items()}
    cfg = tmoe.MoEConfig(num_experts=E, top_k=2, capacity_factor=cf)
    seen = []
    real = grouped.grouped_mul

    def spy(xs, *a, rows=None, **kw):
        seen.append((xs.clone(), rows))
        return real(xs, *a, rows=rows, **kw)

    monkeypatch.setattr(tmoe.grouped_mod, "grouped_mul", spy)
    tmoe.moe_mlp_partial(x, router, ex, cfg)
    cap = tmoe.capacity(T, cfg)
    _, idx = tmoe.route(x, router, 2)
    want = torch.bincount(idx.reshape(-1), minlength=E).clamp_max(cap)
    assert (want < cap).any() and (want > 0).all()
    if cf == 0.5:
        assert int(tmoe.routing_drop_count(x, router, cfg)) > 0
    assert len(seen) == 3
    for xs, rows in seen:
        assert rows.dtype == torch.int32 and rows.device == x.device
        assert torch.equal(rows.long(), want)
        for e in range(E):
            assert not xs[e, rows[e]:].float().any()
    for e in range(E):                                 # the kept rows live
        assert seen[0][0][e, :want[e]].float().abs().sum(-1).all()
