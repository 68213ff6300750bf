"""Port parity: the FP4 GEMM API of petit_kernel_tpu_torch against
petit_kernel_tpu's fused_mul (Pallas, interpret mode) on the same bytes.

Tolerance: rtol 2^-7 with atol 2^-8 * max|ref|. Both sum exactly
representable bf16 products in f32, so they differ only in summation order
and in one bf16 rounding of the output. Both are also held against the
host oracle gemm_reference at the JAX tests' 1%.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import petit_kernel_tpu as pk
import petit_kernel_tpu_torch as pt
from petit_kernel_tpu.numerics import reference as jref
from petit_kernel_tpu.utils.testdata import make_gemm_data
from petit_kernel_tpu_torch.ops import gemm as tgemm
from petit_kernel_tpu_torch.ops import solution as tsol

# xdist workers share the host's cores: one torch thread each keeps
# the port's CPU ops from oversubscribing them
torch.set_num_threads(1)

_ENTRIES = {
    "nvfp4": (pk.mul_nvfp4_a16, pt.mul_nvfp4_a16, "nvfp4"),
    "mxfp4": (pk.mul_mxfp4_a16, pt.mul_mxfp4_a16, "mxfp4"),
    "nvfp4p2": (pk.mul_nvfp4p2_a16, pt.mul_nvfp4p2_a16, "nvfp4"),
    "nvfp4p2z": (pk.mul_nvfp4p2z_a16, pt.mul_nvfp4p2z_a16, "nvfp4"),
    "mxfp4z": (pk.mul_mxfp4z_a16, pt.mul_mxfp4z_a16, "mxfp4"),
}


def _torch_operands(d):
    words = torch.from_numpy(d.words.view(np.int32))
    st = torch.from_numpy(d.scales_t.view(np.int16)).view(torch.bfloat16)
    return words, st


def _assert_gemm_close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=2 ** -7,
                               atol=2 ** -8 * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("k", [512, 640])
@pytest.mark.parametrize("fmt", sorted(_ENTRIES))
def test_gemm_matches_jax_fused_mul(fmt, k):
    jmul, tmul, oracle_fmt = _ENTRIES[fmt]
    n = 128
    for m in (1, 5, 16, 64):
        d = make_gemm_data(m, n, k, fmt, seed=m + k)
        a_bf = jnp.asarray(d.a, jnp.bfloat16)
        cj = jmul(a_bf, jnp.asarray(d.words), jnp.asarray(d.scales_t),
                  jnp.float32(d.global_scale), m, n, k, -1, interpret=True)
        words, st = _torch_operands(d)
        a_t = torch.from_numpy(d.a).to(torch.bfloat16)
        ct = tmul(a_t, words, st, float(d.global_scale), m, n, k)
        assert ct.dtype == torch.bfloat16 and tuple(ct.shape) == (m, n)
        cj = np.asarray(cj, np.float32)
        ct = ct.float().numpy()
        _assert_gemm_close(ct, cj, f"{fmt} m={m} k={k}")
        oracle = jref.gemm_reference(
            np.asarray(a_bf, np.float32), d.qweights, d.scales,
            d.global_scale, fmt=oracle_fmt)
        for c in (ct, cj):
            np.testing.assert_allclose(c, oracle, rtol=0.01, atol=0.01)


def test_gemm_input_dtypes_follow_the_jax_package():
    """fp16 and f32 inputs compute in bf16 and come back in their dtype."""
    m, n, k = 5, 128, 512
    d = make_gemm_data(m, n, k, "nvfp4", seed=9)
    words, st = _torch_operands(d)
    for dt, jdt in ((torch.float16, jnp.float16), (torch.float32,
                                                   jnp.float32)):
        a = torch.from_numpy(d.a).to(dt)
        ct = pt.mul_nvfp4_a16(a, words, st, d.global_scale, m, n, k)
        cj = pk.mul_nvfp4_a16(jnp.asarray(d.a, jdt), jnp.asarray(d.words),
                              jnp.asarray(d.scales_t),
                              jnp.float32(d.global_scale), m, n, k,
                              interpret=True)
        assert ct.dtype == dt
        _assert_gemm_close(ct.float().numpy(), cj, str(dt))


def test_gemm_empty_problem_returns_zeros():
    a = torch.zeros((0, 128), dtype=torch.bfloat16)
    out = pt.mul_nvfp4_a16(a, None, None, 1.0, 0, 128, 128)
    assert tuple(out.shape) == (0, 128) and out.dtype == torch.bfloat16


def test_gemm_error_contract():
    m, n, k = 4, 128, 512
    d = make_gemm_data(m, n, k, "nvfp4", seed=1)
    words, st = _torch_operands(d)
    a = torch.from_numpy(d.a).to(torch.bfloat16)
    bad = [
        (a[:, :256], words, st),                       # a shape
        (a.to(torch.int32), words, st),                # a dtype
        (a, words.float(), st),                        # b dtype
        (a, words[:-1], st),                           # b shape
        (a, words, st.float()),                        # s dtype
        (a, words, st[:-1]),                           # s shape
    ]
    for args in bad:
        with pytest.raises(ValueError):
            pt.mul_nvfp4_a16(*args, 1.0, m, n, k)
    # infeasible or mismatched explicit solution ids
    wrong_tile = tsol.SolutionId(64, 128).repr()      # block_m > 2*max(m, 16)
    with pytest.raises(ValueError):
        pt.mul_nvfp4_a16(a, words, st, 1.0, m, n, k, wrong_tile)
    mx_id = tsol.SolutionId(16, 64, tsol.ElementB.MXFP4).repr()
    with pytest.raises(ValueError):
        pt.mul_nvfp4_a16(a, words, st, 1.0, m, n, k, mx_id)
    with pytest.raises(ValueError):
        pt.mul_nvfp4_a16(a, words, st, 1.0, m, n, k, 0x3F << 14)
    hints = pt.PetitSolutionHints(b_type=tsol.ElementB.MXFP4)
    with pytest.raises(ValueError):
        pt.mul_nvfp4_a16(a, words, st, 1.0, m, n, k, hints=hints)
    # the high-precision entry runs and answers f32 for f32 activations
    # (tests/test_torch_solutions.py holds its numbers)
    hp = pt.PetitSolutionHints(require_high_precision=True)
    out = pt.mul_nvfp4_a16(a.float(), words, st, 1.0, m, n, k, hints=hp)
    assert out.dtype == torch.float32 and tuple(out.shape) == (m, n)
    # the differentiable entry keeps the contract of its forward
    with pytest.raises(ValueError):
        tgemm.mul_fp4_diff("nvfp4", k, a[:, :256], words, st, 1.0)
    # the W4A8 entries run (tests/test_torch_w4a8.py holds their numbers),
    # take the same shape contract and refuse a non-INT8 solution id
    for fn, fmt in ((pt.mul_nvfp4_a8, "nvfp4"), (pt.mul_mxfp4_a8, "mxfp4")):
        dq = make_gemm_data(m, n, k, fmt, seed=1)
        wq, sq = _torch_operands(dq)
        aq = torch.from_numpy(dq.a).to(torch.bfloat16)
        out = fn(aq, wq, sq, 1.0, m, n, k)
        assert out.dtype == torch.bfloat16 and tuple(out.shape) == (m, n)
        with pytest.raises(ValueError):
            fn(aq[:, :256], wq, sq, 1.0, m, n, k)
        with pytest.raises(ValueError, match="INT8"):
            fn(aq, wq, sq, 1.0, m, n, k, tsol.SolutionId(16, 64).repr())


def test_explicit_feasible_solution_runs():
    m, n, k = 20, 128, 512
    d = make_gemm_data(m, n, k, "nvfp4", seed=4)
    words, st = _torch_operands(d)
    a = torch.from_numpy(d.a).to(torch.bfloat16)
    ref = pt.mul_nvfp4_a16(a, words, st, d.global_scale, m, n, k)
    sols = pt.get_fp4_solutions(m, n, k)
    assert sols and all(isinstance(s, int) for s in sols)
    for r in sols:
        out = pt.mul_nvfp4_a16(a, words, st, d.global_scale, m, n, k, r)
        assert torch.equal(out, ref)


@pytest.mark.parametrize("bm,bn", tsol.TILE_SHAPES)
def test_solution_repr_round_trips(bm, bn):
    for eb in (tsol.ElementB.NVFP4, tsol.ElementB.MXFP4):
        for mt in tsol.MatmulType:
            for hp in (False, True):
                for wc in (False, True):
                    sid = tsol.SolutionId(bm, bn, eb, mt, hp, wc)
                    assert tsol.SolutionId.from_repr(sid.repr()) == sid
    with pytest.raises(ValueError):
        tsol.SolutionId(bm + 8, bn)


def test_heuristic_picks_a_compiled_tile():
    for m in (1, 8, 16, 17, 256, 1000):
        for n, k in ((6144, 4096), (4096, 14336), (128, 128)):
            sid = tsol.choose_default_solution(m, n, k)
            assert (sid.block_m, sid.block_n) in tsol.TILE_SHAPES
            assert tsol.is_feasible(sid, m, n, k), (m, n, k, sid)

