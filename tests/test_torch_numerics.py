"""Port parity: numerics, quantizers and the packed layout of
petit_kernel_tpu_torch against petit_kernel_tpu on the same inputs.

Tolerance: none. Quantizer outputs, repacked words and processed scales
must be byte-identical, so both packages feed their kernels the same bytes.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from petit_kernel_tpu.numerics import formats as jf
from petit_kernel_tpu.numerics import reference as jr
from petit_kernel_tpu.ops import layout as jl
from petit_kernel_tpu_torch.numerics import formats as tf
from petit_kernel_tpu_torch.numerics import reference as tr
from petit_kernel_tpu_torch.ops import layout as tl

# xdist workers share the host's cores: one torch thread each keeps
# the port's CPU ops from oversubscribing them
torch.set_num_threads(1)

_QUANT = {
    "nvfp4": (jr.quantize_nvfp4, tr.quantize_nvfp4, 16),
    "nvfp4p2": (jr.quantize_nvfp4_pow2, tr.quantize_nvfp4_pow2, 16),
    "nvfp4p2z": (jr.quantize_nvfp4_pow2z, tr.quantize_nvfp4_pow2z, 16),
    "mxfp4": (jr.quantize_mxfp4, tr.quantize_mxfp4, 32),
    "mxfp4z": (jr.quantize_mxfp4z, tr.quantize_mxfp4z, 32),
}


def _weights(rng, n, k):
    """Weights with mixed group magnitudes, exact E2M1 ties and an all-zero
    group, so rounding, saturation and zero handling are all exercised."""
    w = rng.standard_normal((n, k)).astype(np.float32)
    w *= np.exp2(rng.integers(-6, 4, size=(n, k // 16, 1))).repeat(16, -1
                                                                    ).reshape(n, k)
    w[0, :32] = 0.0
    w[1, :16] = np.array([0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0, 6.0] * 2,
                         np.float32) * np.float32(0.5)
    return w


def _u16(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def test_fp4_encode_matches_on_grid_and_ties():
    v = np.concatenate([np.linspace(-7, 7, 2801, dtype=np.float32),
                        np.array([0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0,
                                  -0.25, -2.5, -0.0, 0.0, 1e-30, 9.0],
                                 np.float32)])
    for zf in (False, True):
        want = jf.fp4_encode(v, zero_free=zf)
        got = tf.fp4_encode(torch.from_numpy(v), zero_free=zf).numpy()
        np.testing.assert_array_equal(got, want)


def test_pack_decode_and_scale_codecs_match():
    rng = np.random.default_rng(1)
    nib = rng.integers(0, 16, size=(6, 40)).astype(np.uint8)
    packed = tf.pack_fp4_pairs(torch.from_numpy(nib)).numpy()
    np.testing.assert_array_equal(packed, jf.pack_fp4_pairs(nib))
    np.testing.assert_array_equal(
        tf.unpack_fp4_pairs(torch.from_numpy(packed)).numpy(), nib)
    np.testing.assert_array_equal(
        tf.fp4_decode(torch.from_numpy(nib)).numpy(), jf.fp4_decode(nib))
    raw = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(
        tf.e4m3_decode(torch.from_numpy(raw)).numpy(), jf.e4m3_decode(raw))
    np.testing.assert_array_equal(
        tf.e8m0_decode(torch.from_numpy(raw)).numpy(), jf.e8m0_decode(raw))


def test_e4m3_encode_matches_ml_dtypes_on_quantizer_range():
    """torch's float8_e4m3fn cast gives ml_dtypes' bytes on [2^-9, 448]:
    every representable value, every midpoint between neighbours (ties to
    even) and a dense random sample."""
    reps = jf.e4m3_decode(np.arange(1, 0x7F, dtype=np.uint8))
    reps = reps[(reps >= 2.0 ** -9) & (reps <= 448)]
    mids = (reps[:-1] + reps[1:]) / 2
    rng = np.random.default_rng(2)
    rand = np.exp2(rng.uniform(-9, np.log2(448), 20000)).astype(np.float32)
    v = np.concatenate([reps, mids, np.nextafter(mids, 0),
                        np.nextafter(mids, 1e9), rand]).astype(np.float32)
    v = v[(v >= 2.0 ** -9) & (v <= 448)]
    np.testing.assert_array_equal(
        tf.e4m3_encode(torch.from_numpy(v)).numpy(), jf.e4m3_encode(v))


@pytest.mark.parametrize("fmt", sorted(_QUANT))
def test_quantizers_byte_identical(fmt):
    jq, tq, group = _QUANT[fmt]
    w = _weights(np.random.default_rng(3), 32, 256)
    qj, sj, gj = jq(w)
    qt, st, gt = tq(torch.from_numpy(w))
    np.testing.assert_array_equal(qt.numpy(), qj)
    np.testing.assert_array_equal(st.numpy(), sj)
    assert gt.dtype == torch.float32
    assert np.float32(gt.item()) == np.float32(gj)
    assert st.shape == (32, 256 // group)


@pytest.mark.parametrize("fmt", ["nvfp4", "mxfp4"])
def test_dequant_and_gemm_oracles_match(fmt):
    """The f32 oracles agree exactly on dequant and within f32 summation
    order (rtol 1e-6) on the GEMM."""
    jq, _, _ = _QUANT[fmt]
    rng = np.random.default_rng(8)
    qw, sc, gs = jq(_weights(rng, 32, 256))
    a = rng.standard_normal((5, 256)).astype(np.float32)
    jdeq = jr.dequant_nvfp4 if fmt == "nvfp4" else jr.dequant_mxfp4
    tdeq = tr.dequant_nvfp4 if fmt == "nvfp4" else tr.dequant_mxfp4
    qt, st = torch.from_numpy(qw), torch.from_numpy(sc)
    np.testing.assert_array_equal(tdeq(qt, st).numpy(), jdeq(qw, sc))
    got = tr.gemm_reference(torch.from_numpy(a), qt, st, float(gs), fmt=fmt)
    want = jr.gemm_reference(a, qw, sc, gs, fmt=fmt)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("fmt,k", [("nvfp4", 256), ("nvfp4", 640),
                                   ("mxfp4", 640), ("nvfp4p2z", 1024)])
def test_repack_and_scales_byte_identical(fmt, k):
    jq, _, group = _QUANT[fmt]
    n = 48
    qw, sc, _ = jq(_weights(np.random.default_rng(k), n, k))
    pad = jl.pad_multiple(group)
    wj = jl.repack_fp4_weights(qw, n, k, pad_to=pad, use_native=False)
    wt = tl.repack_fp4_weights(torch.from_numpy(qw), n, k, pad_to=pad)
    assert wt.dtype == torch.int32
    np.testing.assert_array_equal(wt.numpy().view(np.uint32), wj)
    sj = jl.process_fp4_scales(sc, n, k, group_size=group)
    stt = tl.process_fp4_scales(torch.from_numpy(sc), n, k, group_size=group)
    assert stt.dtype == torch.bfloat16
    np.testing.assert_array_equal(_u16(stt), sj.view(np.uint16))
    # the inverse walk and the dequant oracle agree as well
    np.testing.assert_array_equal(
        tl.unpack_fp4_weights(wt, n, k).numpy(),
        jl.unpack_fp4_weights(wj, n, k))
    np.testing.assert_array_equal(
        tl.dequant_from_tpu_layout(wt, stt, n, k).numpy(),
        jl.dequant_from_tpu_layout(wj, sj, n, k, group_size=group))


def test_process_scales_rejects_what_the_jax_package_rejects():
    n, k = 16, 128
    bad_sign = np.full((n, k // 16), 0x80 | 0x38, np.uint8)
    bad_mx = np.full((n, k // 32), 253, np.uint8)
    for sc, group in ((bad_sign, 16), (bad_mx, 32)):
        with pytest.raises(ValueError):
            jl.process_fp4_scales(sc, n, k, group_size=group)
        with pytest.raises(ValueError):
            tl.process_fp4_scales(torch.from_numpy(sc), n, k,
                                  group_size=group)


def test_port_imports_no_jax():
    """The port package and its modules import neither jax nor the JAX
    package."""
    code = ("import sys, petit_kernel_tpu_torch, "
            "petit_kernel_tpu_torch.models.serving, "
            "petit_kernel_tpu_torch.models.convert; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'petit_kernel_tpu.')) or "
            "m == 'petit_kernel_tpu']; print(bad); assert not bad")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
