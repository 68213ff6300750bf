"""Port parity: the GEMM API's solution layer in petit_kernel_tpu_torch
against petit_kernel_tpu, on the same seeded inputs.

High precision: the port's hp entries (plain version on the CPU: the f32
product of f32(A) and the dequantized weights) against the JAX package's
(interpret mode, f32 dots at Precision.HIGHEST). Both are f32-accurate
products of the same exact operands and differ only in the order of the
sums, so f32 outputs agree within 2^-20 * max(|A| @ |B|) * |gs|, and bf16
and f16 outputs, each one rounding of such a sum, within one unit in the
last place of their dtype (or, where a sum cancels to a value below that
f32 bound's reach, within the bound plus one unit). Then the three-way
bf16 split of the hp kernel, the tuned table (bucketing and keys equal to
the JAX package's, lookup, fallback, grouped order, the W4A8 replacement,
persistence), the tuner with its timing replaced, the fabricated weights,
the suites of the CLI and the bench, and every id of the port's committed
tables against the dequant oracle.
"""

import dataclasses
import glob
import importlib.util
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import petit_kernel_tpu as pk
import petit_kernel_tpu_torch as pt
from petit_kernel_tpu import _cli as jcli
from petit_kernel_tpu.numerics import reference as jref
from petit_kernel_tpu.ops import gemm as jgemm
from petit_kernel_tpu.ops import solution as jsol
from petit_kernel_tpu.utils.testdata import make_gemm_data
from petit_kernel_tpu_torch import _cli as tcli
from petit_kernel_tpu_torch import bench as tbench
from petit_kernel_tpu_torch.ops import autotune as tauto
from petit_kernel_tpu_torch.ops import gemm as tgemm
from petit_kernel_tpu_torch.ops import solution as tsol
from petit_kernel_tpu_torch.ops.kernels import fused
from petit_kernel_tpu_torch.utils import benchlib

torch.set_num_threads(1)

_ROOT = os.path.join(os.path.dirname(__file__), "..")
_PORT = os.path.join(_ROOT, "petit_kernel_tpu_torch")
_FMTS = {"nvfp4": (pk.mul_nvfp4_a16, pt.mul_nvfp4_a16, jsol.ElementB.NVFP4,
                   tsol.ElementB.NVFP4),
         "mxfp4": (pk.mul_mxfp4_a16, pt.mul_mxfp4_a16, jsol.ElementB.MXFP4,
                   tsol.ElementB.MXFP4)}
_DTYPES = {"f32": (torch.float32, jnp.float32),
           "bf16": (torch.bfloat16, jnp.bfloat16),
           "f16": (torch.float16, jnp.float16)}


@pytest.fixture(autouse=True)
def _empty_table():
    """Every test starts and ends with an empty dispatch table."""
    tgemm.set_tuned_table({})
    yield
    tgemm.set_tuned_table({})


def _operands(d):
    words = torch.from_numpy(d.words.view(np.int32))
    st = torch.from_numpy(d.scales_t.view(np.int16)).view(torch.bfloat16)
    return words, st


def _abs_product_max(a32: np.ndarray, d, fmt: str) -> float:
    """max(|A| @ |B|) * |gs| over the dequantized weights."""
    deq = (jref.dequant_nvfp4 if fmt == "nvfp4" else jref.dequant_mxfp4)(
        d.qweights, d.scales)
    return float((np.abs(a32) @ np.abs(deq).T).max() * abs(d.global_scale))


def _ordinal(x: torch.Tensor) -> torch.Tensor:
    """16-bit floats as ordered integers: adjacent values differ by 1."""
    bits = x.view(torch.int16).int()
    return torch.where(bits < 0, -(bits & 0x7FFF), bits)


def _assert_hp_close(got: torch.Tensor, want, scale: float, what: str):
    want = torch.from_numpy(np.array(want.astype(jnp.float32),
                                     np.float32)).to(got.dtype)
    if got.dtype == torch.float32:
        err = (got - want).abs().max().item()
        assert err <= 2 ** -20 * scale, (what, err, 2 ** -20 * scale)
        return
    # one ulp of the dtype; where a sum cancels to a value that small, the
    # two f32 sums may differ by the f32 rule's bound, and one rounding
    # adds at most one ulp to it
    ulps = (_ordinal(got) - _ordinal(want)).abs()
    p, tiny = (7, 2.0 ** -133) if got.dtype == torch.bfloat16 else (10,
                                                                    2.0 ** -24)
    w = want.double()
    ulp = torch.exp2((torch.frexp(w).exponent - 1 - p).double()).clamp_min(
        tiny)
    near = (got.double() - w).abs() <= 2 ** -20 * scale + ulp
    assert bool(((ulps <= 1) | near).all()), (what, ulps.max().item())


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("fmt", sorted(_FMTS))
def test_hp_entries_match_jax(fmt, dtype):
    jmul, tmul, jeb, teb = _FMTS[fmt]
    tdt, jdt = _DTYPES[dtype]
    n, k = 256, 1024 if fmt == "mxfp4" else 640
    jh = pk.PetitSolutionHints(b_type=jeb, require_high_precision=True)
    th = pt.PetitSolutionHints(b_type=teb, require_high_precision=True)
    for m in (1, 7, 20):
        d = make_gemm_data(m, n, k, fmt, seed=100 + m)
        a_j = jnp.asarray(d.a, jdt)
        a32 = np.asarray(a_j, np.float32)
        cj = jmul(a_j, jnp.asarray(d.words), jnp.asarray(d.scales_t),
                  jnp.float32(d.global_scale), m, n, k, -1, interpret=True,
                  hints=jh)
        words, st = _operands(d)
        ct = tmul(torch.from_numpy(a32).to(tdt), words, st,
                  float(d.global_scale), m, n, k, hints=th)
        assert ct.dtype == tdt and tuple(ct.shape) == (m, n)
        assert cj.dtype == jdt
        _assert_hp_close(ct, cj, _abs_product_max(a32, d, fmt),
                         f"{fmt} {dtype} m={m}")


@pytest.mark.parametrize("fmt", sorted(_FMTS))
def test_explicit_hp_ids_match_jax(fmt):
    """Every hp id, weight cache included, that the port lists runs and
    equals the JAX package's hp entry (and its explicit hp weight-cache
    id) within the f32 rule."""
    jmul, tmul, jeb, teb = _FMTS[fmt]
    m, n, k = 20, 256, 1024
    d = make_gemm_data(m, n, k, fmt, seed=7)
    words, st = _operands(d)
    scale = _abs_product_max(d.a, d, fmt)
    j_ids = [r for r in pk.get_fp4_solutions(m, n, k, element_b=jeb)
             if jsol.SolutionId.from_repr(r).high_precision]
    j_wc = [r for r in j_ids if jsol.SolutionId.from_repr(r).weight_cache]
    assert j_wc
    cj = jmul(jnp.asarray(d.a), jnp.asarray(d.words),
              jnp.asarray(d.scales_t), jnp.float32(d.global_scale), m, n, k,
              j_wc[0], interpret=True)
    t_ids = [r for r in pt.get_fp4_solutions(m, n, k, element_b=teb)
             if tsol.SolutionId.from_repr(r).high_precision]
    assert any(tsol.SolutionId.from_repr(r).weight_cache for r in t_ids)
    a = torch.from_numpy(d.a)
    for r in t_ids:
        ct = tmul(a, words, st, float(d.global_scale), m, n, k, r)
        _assert_hp_close(ct, cj, scale, str(tsol.SolutionId.from_repr(r)))
    # an hp hint refuses a non-hp id, as in the JAX package
    plain = next(r for r in pt.get_fp4_solutions(m, n, k, element_b=teb)
                 if not tsol.SolutionId.from_repr(r).high_precision)
    with pytest.raises(ValueError, match="high-precision"):
        tmul(a, words, st, 1.0, m, n, k, plain,
             hints=pt.PetitSolutionHints(b_type=teb,
                                         require_high_precision=True))


def test_split_bf16x3_is_exact():
    """hi + mid + lo == a for |a| from 2^-110 to FLT_MAX, both signs,
    random mantissas; below 2^-110 within 2^-134 (lo on bf16's subnormal
    grid)."""
    rng = np.random.default_rng(3)
    n = 4096
    mant = rng.uniform(1.0, 2.0, n)
    sign = rng.choice([-1.0, 1.0], n)
    exps = rng.integers(-110, 128, n)
    vals = [sign * mant * np.exp2(exps.astype(np.float64))]
    fmax = np.finfo(np.float32).max
    top = np.nextafter(np.float32(fmax), np.float32(0), dtype=np.float32)
    vals.append(np.array([fmax, -fmax, top, 3.3961e38, 3.39e38, 2.0 ** -110,
                          1.999 * 2.0 ** -110, -1.5 * 2.0 ** -110]))
    vals.append(np.float32(rng.uniform(-1, 1, n)).astype(np.float64))
    a = torch.from_numpy(np.concatenate(vals).astype(np.float32))
    assert torch.isfinite(a).all()
    hi, mid, lo = fused.split_bf16x3(a)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, a.double())
    # each part takes the next 8 bits: |mid| < 2^-7 |a|, |lo| <= 2^-15 |a|
    assert bool((mid.double().abs() < 2.0 ** -7 * a.double().abs()).all())
    assert bool((lo.double().abs() <= 2.0 ** -15 * a.double().abs()).all())
    small = torch.from_numpy((sign * mant * np.exp2(
        rng.integers(-126, -110, n).astype(np.float64))).astype(np.float32))
    hi, mid, lo = fused.split_bf16x3(small)
    err = (hi.double() + mid.double() + lo.double() - small.double()).abs()
    assert err.max().item() <= 2.0 ** -134


def test_m_bucket_and_table_key_match_jax():
    for m in list(range(1, 130)) + [255, 256, 257, 1000, 2048, 2049, 16375]:
        assert tgemm._m_bucket(m) == jgemm._m_bucket(m), m
    for m, n, k in ((1, 4096, 4096), (44, 8192, 1024), (566, 7168, 8192)):
        for eb in (1, 2):
            for mt in (0, 1, 2):
                for hp in (False, True):
                    for grouped in (False, True):
                        want = jgemm._table_key(
                            m, n, k, jsol.ElementB(eb), jsol.MatmulType(mt),
                            hp, grouped)
                        got = tgemm._table_key(
                            m, n, k, tsol.ElementB(eb), tsol.MatmulType(mt),
                            hp, grouped)
                        assert got == want and len(got) == 7
                        assert [type(x) for x in got] == \
                            [type(x) for x in want]


def test_table_lookup_and_fallback():
    nv = tsol.ElementB.NVFP4
    m, n, k = 100, 256, 512
    heur = tsol.choose_default_solution(m, n, k, nv)
    pick = tsol.SolutionId(16, 128, nv, weight_cache=True)
    assert pick != heur and tsol.is_feasible(pick, m, n, k)
    key = tgemm._table_key(m, n, k, nv, tsol.MatmulType.BF16, False)
    tgemm.set_tuned_table({key: pick.repr()})
    assert tgemm.resolve_solution(m, n, k, nv) == pick
    # the bucket of m = 100 is 128: any m in (64, 128] takes the entry
    assert tgemm.resolve_solution(65, n, k, nv) == pick
    assert tgemm.resolve_solution(64, n, k, nv) == \
        tsol.choose_default_solution(64, n, k, nv)
    # an explicit id wins over the table; hp and fp16 keys are their own
    assert tgemm.resolve_solution(m, n, k, nv, solution_id=heur.repr()) \
        == heur
    assert not tgemm.resolve_solution(m, n, k, nv,
                                      high_precision=True).weight_cache
    # an entry infeasible at its shape falls back to the heuristic
    big = tsol.SolutionId(64, 128, nv, weight_cache=True)
    key16 = tgemm._table_key(16, n, k, nv, tsol.MatmulType.BF16, False)
    tgemm.set_tuned_table({key16: big.repr()})
    assert not tsol.is_feasible(big, 16, n, k)
    assert tgemm.resolve_solution(16, n, k, nv) == \
        tsol.choose_default_solution(16, n, k, nv)


def test_mul_dispatches_the_table_entry(monkeypatch):
    """mul_*_a16 with solution -1 hands the table's id to fused_mul, and
    the output equals the heuristic's (one function, any tile)."""
    m, n, k = 20, 256, 512
    d = make_gemm_data(m, n, k, "nvfp4", seed=5)
    words, st = _operands(d)
    a = torch.from_numpy(d.a).to(torch.bfloat16)
    ref = pt.mul_nvfp4_a16(a, words, st, d.global_scale, m, n, k)
    pick = tsol.SolutionId(16, 128, weight_cache=True)
    tgemm.set_tuned_table({tgemm._table_key(
        m, n, k, tsol.ElementB.NVFP4, tsol.MatmulType.BF16, False):
        pick.repr()})
    seen = []
    inner = fused.fused_mul

    def spy(*args, sid, **kw):
        seen.append(sid)
        return inner(*args, sid=sid, **kw)
    monkeypatch.setattr(fused, "fused_mul", spy)
    for mul in (pt.mul_nvfp4_a16, pt.mul_nvfp4p2_a16, pt.mul_nvfp4p2z_a16):
        assert torch.equal(mul(a, words, st, d.global_scale, m, n, k), ref)
    assert seen == [pick] * 3


def test_grouped_lookup_order():
    mx = tsol.ElementB.MXFP4
    cap, n, k = 100, 256, 1024
    dense_key = tgemm._table_key(cap, n, k, mx, tsol.MatmulType.BF16, False)
    grouped_key = tgemm._table_key(cap, n, k, mx, tsol.MatmulType.BF16,
                                   False, grouped=True)
    a, b = tsol.SolutionId(16, 128, mx), tsol.SolutionId(16, 64, mx)
    wc = tsol.SolutionId(16, 128, mx, weight_cache=True)
    heur = tsol.choose_default_solution(cap, n, k, mx)
    tgemm.set_tuned_table({dense_key: a.repr(), grouped_key: b.repr()})
    assert tgemm.resolve_grouped_solution(cap, n, k, mx) == b
    tgemm.set_tuned_table({dense_key: a.repr()})
    assert tgemm.resolve_grouped_solution(cap, n, k, mx) == a
    # a weight-cache entry has no grouped kernel: the next entry, then the
    # heuristic
    tgemm.set_tuned_table({dense_key: a.repr(), grouped_key: wc.repr()})
    assert tgemm.resolve_grouped_solution(cap, n, k, mx) == a
    tgemm.set_tuned_table({grouped_key: wc.repr()})
    assert tgemm.resolve_grouped_solution(cap, n, k, mx) == heur


def test_w4a8_turns_a_table_id_into_int8(monkeypatch):
    m, n, k = 20, 256, 512
    d = make_gemm_data(m, n, k, "nvfp4", seed=6)
    words, st = _operands(d)
    a = torch.from_numpy(d.a).to(torch.bfloat16)
    bf16_wc = tsol.SolutionId(16, 128, weight_cache=True, high_precision=True)
    tgemm.set_tuned_table({tgemm._table_key(
        m, n, k, tsol.ElementB.NVFP4, tsol.MatmulType.INT8, False):
        bf16_wc.repr()})
    seen = []
    inner = fused.fused_mul_w4a8

    def spy(*args, sid, **kw):
        seen.append(sid)
        return inner(*args, sid=sid, **kw)
    monkeypatch.setattr(fused, "fused_mul_w4a8", spy)
    out = pt.mul_nvfp4_a8(a, words, st, d.global_scale, m, n, k)
    assert seen == [tsol.SolutionId(16, 128, mfma_type=tsol.MatmulType.INT8)]
    tgemm.set_tuned_table({})
    assert torch.equal(out, pt.mul_nvfp4_a8(a, words, st, d.global_scale,
                                            m, n, k))


def test_save_and_load_round_trip(tmp_path, monkeypatch):
    monkeypatch.setattr(tauto, "_TABLE_DIR", str(tmp_path))
    assert not tauto.load_table("CARD")
    table = {tgemm._table_key(16, 4096, 4096, tsol.ElementB.NVFP4,
                              tsol.MatmulType.BF16, False): 0x4041,
             tgemm._table_key(300, 1024, 8192, tsol.ElementB.MXFP4,
                              tsol.MatmulType.INT8, False, True): 0x40C55}
    tgemm.set_tuned_table(table)
    path = tauto.save_table("CARD")
    assert path == str(tmp_path / "CARD.json") == tauto.table_path("CARD")
    tgemm.set_tuned_table({})
    assert tauto.load_table("CARD") and tgemm._TUNED_TABLE == table
    # saving merges into the file: earlier entries stay
    extra = {tgemm._table_key(8, 6144, 4096, tsol.ElementB.NVFP4,
                              tsol.MatmulType.BF16, True): 0x4043}
    tgemm.set_tuned_table(extra)
    tauto.save_table("CARD")
    assert tauto.load_table("CARD")
    assert tgemm._TUNED_TABLE == {**table, **extra}
    with open(path) as f:
        assert all(len(key.split(",")) == 7 for key in json.load(f))
    with open(tmp_path / "BAD.json", "w") as f:
        json.dump({"16,4096,4096,1,1,False,False,True": 1}, f)
    with pytest.raises(ValueError, match="7"):
        tauto.load_table("BAD")


@pytest.mark.parametrize("mt", [tsol.MatmulType.BF16, tsol.MatmulType.INT8])
def test_tune_shape_records_the_fastest(monkeypatch, mt):
    m, n, k = 100, 256, 512
    cands = tauto.candidate_solutions(m, n, k, mfma_type=mt)
    assert cands[0] == tsol.choose_default_solution(m, n, k, mfma_type=mt)
    assert set(cands) == set(tsol.get_solutions(m, n, k, mfma_type=mt))
    assert not any(s.high_precision for s in cands)
    fastest = cands[-2]
    timed = []

    def fake(sid, a, b, s, gs, **kw):
        kp = b.shape[0] * 8     # 512 for nvfp4, 1024 for mxfp4
        assert a.shape == (m, k) and b.shape == (kp // 8, n) and kp >= k
        assert s.shape == (kp // 16, n) and s.dtype == torch.bfloat16
        timed.append(sid)
        return 1e-4 if sid == fastest else 2e-4
    monkeypatch.setattr(tauto, "time_solution", fake)
    best = tauto.tune_shape(m, n, k, mfma_type=mt, device="cpu")
    assert best == fastest and timed == cands
    key = tgemm._table_key(m, n, k, tsol.ElementB.NVFP4, mt, False)
    assert tgemm._TUNED_TABLE == {key: fastest.repr()}
    # a budget spent at once keeps the first candidate, the heuristic's
    timed.clear()
    first = tauto.candidate_solutions(m, n, k, tsol.ElementB.MXFP4, mt)[0]
    assert tauto.tune_shape(m, n, k, tsol.ElementB.MXFP4, mt, device="cpu",
                            time_budget_s=0.0) == first
    assert timed == [first]


def test_tune_suite_without_saving(monkeypatch, tmp_path):
    monkeypatch.setattr(tauto, "_TABLE_DIR", str(tmp_path))
    monkeypatch.setattr(tauto, "time_solution",
                        lambda sid, *a, **kw: 1e-3 / (1 + sid.block_n))
    orig = tauto.tune_shape
    monkeypatch.setattr(tauto, "tune_shape",
                        lambda *a, **kw: orig(*a, device="cpu", **kw))
    got = tauto.tune_suite([(16, 256, 512), (100, 256, 512)], save=False)
    assert len(got) == 2 and not list(tmp_path.iterdir())
    assert all(tsol.SolutionId.from_repr(r).block_n == 128
               for r in got.values())


def test_timing_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    m, n, k = 16, 256, 512
    a = torch.zeros((m, k), dtype=torch.bfloat16)
    b = torch.zeros((k // 8, n), dtype=torch.int32)
    s = torch.ones((k // 16, n), dtype=torch.bfloat16)
    gs = torch.ones((1,))
    with pytest.raises(RuntimeError, match="CUDA"):
        tauto.time_solution(tsol.SolutionId(16, 64), a, b, s, gs)
    with pytest.raises(RuntimeError, match="CUDA"):
        benchlib.cuda_time(lambda: a + 1)
    with pytest.raises(RuntimeError):
        tauto.tune_grouped_shape(2, 8, 256, 1024)
    with pytest.raises(RuntimeError):
        tauto.table_path()
    for main in (tbench.main, tcli.bench_main):
        with pytest.raises(SystemExit) as e:
            main([])
        assert e.value.code not in (None, 0)


@pytest.mark.parametrize("fmt", [f for f in tbench.FORMATS
                                 if f != "hybrid"])
def test_random_weight_follows_the_format(fmt):
    """The tuner's and the bench's fabricated weights: the repack layout of
    the format, zero-free formats with no zero, pow2 formats with
    power-of-two scales."""
    n, k = 128, 512
    gen = torch.Generator().manual_seed(0)
    words, st, eb = tauto.random_weight(fmt, n, k, gen, device="cpu")
    group = 32 if fmt.startswith("mx") else 16
    kp = 1024 if group == 32 else k     # mxfp4 pads k to 1024
    assert eb == (tsol.ElementB.MXFP4 if group == 32 else tsol.ElementB.NVFP4)
    assert words.dtype == torch.int32 and tuple(words.shape) == (kp // 8, n)
    assert st.dtype == torch.bfloat16 and tuple(st.shape) == (kp // 16, n)
    deq = fused.dequant_tpu_layout(words, st, element_b=eb)[:k].float()
    assert torch.isfinite(deq).all() and bool((deq != 0).any())
    assert bool((deq != 0).all()) == fmt.endswith("z")
    scales = st[:k // 16].float()
    pow2 = bool((torch.frexp(scales).mantissa.abs() == 0.5).all())
    assert pow2 == (fmt in ("nvfp4p2", "nvfp4p2z", "mxfp4", "mxfp4z"))


def _jax_bench():
    """The repo's bench.py (the JAX package's bench), loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench", os.path.join(_ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_and_bench_suites_match_jax():
    assert tcli._NK_PAIRS == jcli._NK_PAIRS
    for spec, ms in ((None, "16,256,512"), (None, "16"),
                     ("6144,4096;4096,14336", "8,2048"), ("1024,128", "1")):
        assert tcli._parse_shapes(spec, ms) == jcli._parse_shapes(spec, ms)
    jb = _jax_bench()
    for name in ("SHAPES_NK", "SHAPES_NK_QUICK", "SHAPES_TRACE_MNK",
                 "SHAPES_70B_TP8"):
        assert getattr(tbench, name) == getattr(jb, name), name


def test_hp_dispatch_and_feasible_set_agree():
    """The tiles csrc/fp4_gemm_hp.cu dispatches are solution.py's (the
    plans of its two tile bodies refuse at compile time a tile over the
    shared memory of a block: HpPlan in fp4_stream.cuh, HpWgPlan in
    fp4_hp_wgmma.cuh); the hp ids are the other ids with the hp bit; there
    is no hp INT8 id."""
    def source(name):
        with open(os.path.join(_PORT, "csrc", name)) as f:
            return f.read()
    src = source("fp4_gemm_hp.cu")
    tiles = {(int(bm), int(bn)) for bm, bn in re.findall(
        r"block_m == (\d+) && block_n == (\d+)", src)}
    assert tiles == set(tsol.TILE_SHAPES)
    assert '#include "fp4_hp_wgmma.cuh"' in src
    assert "bytes <= WG_SMEM_LIMIT" in source("fp4_hp_wgmma.cuh")
    assert "static_assert(bytes <= 232448" in source("fp4_stream.cuh")
    for m, n, k in ((1, 4096, 4096), (20, 256, 512), (100, 6144, 4096),
                    (2048, 4096, 14336)):
        for eb in (tsol.ElementB.NVFP4, tsol.ElementB.MXFP4):
            plain = tsol.get_solutions(m, n, k, eb)
            hp = tsol.get_solutions(m, n, k, eb, high_precision=True)
            assert hp == [dataclasses.replace(s, high_precision=True)
                          for s in plain]
            assert not tsol.get_solutions(m, n, k, eb, tsol.MatmulType.INT8,
                                          high_precision=True)


def _table_cases():
    """Distinct (key, SolutionId) pairs of the port's committed tables."""
    cases = {}
    for path in sorted(glob.glob(os.path.join(_PORT, "tuned", "*.json"))):
        with open(path) as f:
            for key, r in json.load(f).items():
                cases.setdefault((int(r), int(key.split(",")[3])),
                                 (key, tsol.SolutionId.from_repr(int(r))))
    return sorted(cases.values())


_TABLE = _table_cases()


@pytest.mark.parametrize("key,sid", _TABLE,
                         ids=[f"{k}->{s.repr():#x}" for k, s in _TABLE])
def test_tuned_table_ids_match_the_oracle(key, sid):
    """Each id of the port's tables is feasible at its key and, at a shape
    with ragged m and n and at least two tiles (or weight-cache groups)
    per axis, runs through the public entry (the plain version here)
    within the JAX table sweep's tolerance of the dequant oracle."""
    fields = key.split(",")
    mb, kn, kk = int(fields[0]), int(fields[1]), int(fields[2])
    assert tsol.is_feasible(sid, mb, kn, kk), (key, sid)
    # two groups of the weight-cache kernels' 4 m-tiles (four of hp's 2)
    g = 4 if sid.weight_cache else 1
    m, n, k = 2 * g * sid.block_m + 5, 2 * sid.block_n + 16, 512
    assert tsol.is_feasible(sid, m, n, k)
    fmt = "nvfp4" if sid.element_b == tsol.ElementB.NVFP4 else "mxfp4"
    d = make_gemm_data(m, n, k, fmt, seed=sid.repr() & 0xFFFF)
    words, st = _operands(d)
    a = torch.from_numpy(d.a / 4).to(torch.bfloat16)
    if sid.mfma_type == tsol.MatmulType.INT8:
        mul = pt.mul_nvfp4_a8 if fmt == "nvfp4" else pt.mul_mxfp4_a8
        tol = 0.1
    else:
        mul = pt.mul_nvfp4_a16 if fmt == "nvfp4" else pt.mul_mxfp4_a16
        tol = 2e-2
    got = mul(a.float() if sid.high_precision else a, words, st,
              d.global_scale, m, n, k, sid.repr()).float().numpy()
    expect = jref.gemm_reference(a.float().numpy(), d.qweights, d.scales,
                                 d.global_scale, fmt=fmt)
    err = np.abs(got - expect) / np.maximum(np.abs(expect), 1.0)
    assert err.max() < tol, (sid, float(err.max()))


def test_h100_table_is_committed_and_covers_the_suites():
    path = os.path.join(_PORT, "tuned", "NVIDIA_H100_80GB_HBM3.json")
    with open(path) as f:
        keys = {tuple(k.split(",")) for k in json.load(f)}
    for fmt in ("1", "2"):
        for m, n, k in (tcli._parse_shapes(None, "16,256,512")
                        + tcli._parse_shapes(
                            "6144,4096;4096,4096;28672,4096;4096,14336",
                            "8,16,256,512,2048")):
            assert (str(tgemm._m_bucket(m)), str(n), str(k), fmt, "1",
                    "False", "False") in keys, (m, n, k, fmt)


def test_tuner_records_nothing_when_timing_fails(monkeypatch):
    """A fault of the reference (ROADMAP queue 3): its time_solution turns
    any failure into an infinite time, and tune_shape then records its
    first candidate as the shape's best, never timed. The port's timing
    raises, and nothing is recorded."""
    from petit_kernel_tpu.ops import autotune as jauto
    from petit_kernel_tpu.utils import benchlib as jbench

    def fail(*args, **kw):
        raise RuntimeError("no device time")
    monkeypatch.setattr(jbench, "marginal_time", fail)
    saved = dict(jgemm._TUNED_TABLE)
    try:
        jgemm.set_tuned_table({})
        best = jauto.tune_shape(16, 256, 512)
        key = jgemm._table_key(16, 256, 512, jsol.ElementB.NVFP4,
                               jsol.MatmulType.BF16, False)
        assert jgemm._TUNED_TABLE == {key: best.repr()}
    finally:
        jgemm.set_tuned_table(saved)
    monkeypatch.setattr(tauto.benchlib, "cuda_time", fail)
    with pytest.raises(RuntimeError, match="no device time"):
        tauto.tune_shape(16, 256, 512, device="cpu")
    assert tgemm._TUNED_TABLE == {}
