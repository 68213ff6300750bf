"""Port parity: decode attention, flash prefill and the KV append of
petit_kernel_tpu_torch, flat and headed (paged or contiguous, bf16 or
fp8), against petit_kernel_tpu's Pallas kernels in interpret mode, on the
same inputs.

Tolerances: attention at rtol = atol = 2^-7 (both sum bf16 q.k products in
f32 and run the softmax in f32; they differ in summation order and in the
one bf16 rounding of the output). The KV append is bit-exact, masked rows
included.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from petit_kernel_tpu.models import llama as jllama
from petit_kernel_tpu.ops.kernels import attention as jattn
from petit_kernel_tpu_torch.models import convert
from petit_kernel_tpu_torch.models import llama as tllama
from petit_kernel_tpu_torch.ops.kernels import attention as tattn

# xdist workers share the host's cores: one torch thread each keeps
# the port's CPU ops from oversubscribing them
torch.set_num_threads(1)


def _bf16_pair(rng, shape):
    """The same bf16 values for both packages."""
    x = jnp.asarray(rng.standard_normal(shape, dtype=np.float32),
                    jnp.bfloat16)
    t = torch.from_numpy(np.array(x).view(np.int16)).view(torch.bfloat16)
    return x, t


def _np32(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


@pytest.mark.parametrize("hkv,h,d,nb", [(2, 8, 128, 2), (4, 28, 64, 2),
                                        (2, 2, 128, 1)])
def test_decode_attention_matches_jax_kernel(hkv, h, d, nb):
    B, S = 3, 256
    rng = np.random.default_rng(h + d)
    qj, qt = _bf16_pair(rng, (B, h, d))
    kj, kt = _bf16_pair(rng, (B, S, hkv, d))
    vj, vt = _bf16_pair(rng, (B, S, hkv, d))
    pos = np.array([5, 127, 130][:B], np.int32)
    pos = np.minimum(pos, nb * 128 - 1)
    want = jattn.decode_attention_contiguous(qj, kj, vj, jnp.asarray(pos),
                                             nb=nb, page_size=128,
                                             interpret=True)
    got = tattn.decode_attention_contiguous(qt, kt, vt, torch.from_numpy(pos),
                                            nb=nb, page_size=128)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, h, d)
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=2 ** -7,
                               atol=2 ** -7)


def test_decode_attention_window_cuts_positions():
    """Positions at or past nb * page_size are not attended even when
    pos[b] lies beyond them (the window contract of the JAX kernel)."""
    B, S, hkv, h, d = 2, 256, 2, 4, 64
    rng = np.random.default_rng(7)
    _, q = _bf16_pair(rng, (B, h, d))
    _, k = _bf16_pair(rng, (B, S, hkv, d))
    _, v = _bf16_pair(rng, (B, S, hkv, d))
    pos = torch.tensor([200, 255], dtype=torch.int32)
    cut = tattn.decode_attention_contiguous(q, k, v, pos, nb=1)
    k2, v2 = k.clone(), v.clone()
    k2[:, 128:] = 7.0
    v2[:, 128:] = -3.0
    assert torch.equal(cut, tattn.decode_attention_contiguous(
        q, k2, v2, pos, nb=1))


@pytest.mark.parametrize("hkv,h,d,T,pos0", [(2, 8, 128, 16, (0, 100)),
                                            (2, 4, 64, 32, (64, 0)),
                                            (4, 28, 64, 16, (7, 200))])
def test_flash_prefill_matches_jax_kernel(hkv, h, d, T, pos0):
    B, S = 2, 256
    rng = np.random.default_rng(T + h)
    qj, qt = _bf16_pair(rng, (B, T, h, d))
    kj, kt = _bf16_pair(rng, (B, S, hkv, d))
    vj, vt = _bf16_pair(rng, (B, S, hkv, d))
    p0 = np.array(pos0, np.int32)
    ns = -(-int(p0.max() + T) // 128)
    want = jattn.flash_prefill_attention(qj, kj, vj, jnp.asarray(p0), ns=ns,
                                         block_q=min(128, T), block_s=128,
                                         interpret=True)
    got = tattn.flash_prefill_attention(qt, kt, vt, torch.from_numpy(p0),
                                        ns=ns, block_s=128)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, T, h, d)
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=2 ** -7,
                               atol=2 ** -7)


@pytest.mark.parametrize("mask", [None, (1, 0, 1, 0)])
def test_kv_append_bit_exact_vs_jax_kernel(mask):
    B, S, hkv, d = 4, 64, 2, 128
    rng = np.random.default_rng(3)
    ckj, ckt = _bf16_pair(rng, (B, S, hkv, d))
    cvj, cvt = _bf16_pair(rng, (B, S, hkv, d))
    knj, knt = _bf16_pair(rng, (B, hkv, d))
    vnj, vnt = _bf16_pair(rng, (B, hkv, d))
    pos = np.array([0, 9, 63, 31], np.int32)
    mj = None if mask is None else jnp.asarray(mask, jnp.int32)
    mt = None if mask is None else torch.tensor(mask, dtype=torch.bool)
    ck_want, cv_want = jattn.kv_append(ckj, cvj, knj, vnj, jnp.asarray(pos),
                                       mj, interpret=True)
    ck_in, cv_in = ckt.clone(), cvt.clone()
    ck_out, cv_out = tattn.kv_append(ck_in, cv_in, knt, vnt,
                                     torch.from_numpy(pos), mt)
    assert ck_out is ck_in and cv_out is cv_in       # updated in place
    for got, want in ((ck_out, ck_want), (cv_out, cv_want)):
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy(),
            np.asarray(want).view(np.int16))


def test_kv_append_casts_to_cache_dtype_once():
    """f32 new values are rounded once to the bf16 cache (quantize_kv)."""
    B, S, hkv, d = 2, 8, 1, 64
    ck = torch.zeros((B, S, hkv, d), dtype=torch.bfloat16)
    cv = torch.zeros_like(ck)
    kn = torch.randn((B, hkv, d), generator=torch.Generator().manual_seed(0))
    tattn.kv_append(ck, cv, kn, kn, torch.tensor([1, 2], dtype=torch.int32))
    assert torch.equal(ck[0, 1], kn[0].to(torch.bfloat16))
    assert torch.equal(ck[1, 2], kn[1].to(torch.bfloat16))



# ---------------------------------------------------------------------------
# headed layouts: paged pools and contiguous headed caches, bf16 and fp8
# ---------------------------------------------------------------------------
#
# Tolerances as above (rtol = atol = 2^-7), on fp8 data without subnormals:
# the JAX decode kernel's SWAR upcast flushes fp8 subnormals to zero, the
# port converts them exactly (test_fp8_subnormals_* pins both). Headed KV
# appends are bit-exact.

_F8_MIN_NORMAL = 2.0 ** -6


def _kv_pair(rng, shape, dtype, subnormals=False, scale=1.0):
    """The same bf16 or fp8 e4m3 values for both packages. Without
    subnormals, fp8 magnitudes below the smallest normal are lifted to it."""
    if dtype == "bf16":
        return _bf16_pair(rng, shape)
    x = rng.standard_normal(shape, dtype=np.float32) * scale
    if not subnormals:
        x = np.where(np.abs(x) < _F8_MIN_NORMAL,
                     np.copysign(_F8_MIN_NORMAL, x), x)
    x = x.astype(ml_dtypes.float8_e4m3fn)
    return jnp.asarray(x), convert.tensor_from_numpy(x, device="cpu")


def _pool_setup(rng, dtype, B=2, hkv=2, h=8, d=64, ps=16, P=9,
                subnormals=False, scale=1.0):
    qj, qt = _bf16_pair(rng, (B, h, d))
    kj, kt = _kv_pair(rng, (P, hkv, ps, d), dtype, subnormals, scale)
    vj, vt = _kv_pair(rng, (P, hkv, ps, d), dtype, subnormals, scale)
    bt = rng.permutation(P)[:B * 4].reshape(B, 4).astype(np.int32)
    return (qj, kj, vj), (qt, kt, vt), bt


@pytest.mark.parametrize("dtype", ["bf16", "fp8"])
@pytest.mark.parametrize("pos", [(3, 40), (63, 17)])
def test_paged_decode_matches_jax_kernel(dtype, pos):
    """Page size 16, a permuted block table, ragged positions (one
    sequence shorter than a page)."""
    rng = np.random.default_rng(11)
    (qj, kj, vj), (qt, kt, vt), bt = _pool_setup(rng, dtype)
    p = np.array(pos, np.int32)
    nb = -(-int(p.max() + 1) // 16)
    want = jattn.paged_decode_attention(
        qj, kj, vj, jnp.asarray(bt), jnp.asarray(p), nb=nb, page_size=16,
        interpret=True, headed=True)
    got = tattn.paged_decode_attention(qt, kt, vt, torch.from_numpy(bt),
                                       torch.from_numpy(p), nb=nb,
                                       page_size=16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 8, 64)
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=2 ** -7,
                               atol=2 ** -7)


@pytest.mark.parametrize("dtype", ["bf16", "fp8"])
def test_decode_headed_matches_jax_kernel(dtype):
    B, hkv, h, d, S = 2, 2, 8, 128, 256
    rng = np.random.default_rng(12)
    qj, qt = _bf16_pair(rng, (B, h, d))
    kj, kt = _kv_pair(rng, (B, hkv, S, d), dtype)
    vj, vt = _kv_pair(rng, (B, hkv, S, d), dtype)
    pos = np.array([9, 200], np.int32)
    want = jattn.decode_attention_contiguous_headed(
        qj, kj, vj, jnp.asarray(pos), nb=2, page_size=128, interpret=True)
    got = tattn.decode_attention_contiguous_headed(
        qt, kt, vt, torch.from_numpy(pos), nb=2, page_size=128)
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=2 ** -7,
                               atol=2 ** -7)


@pytest.mark.parametrize("dtype", ["bf16", "fp8"])
@pytest.mark.parametrize("T,pos0", [(16, (0, 30)), (32, (5, 0))])
def test_flash_prefill_paged_matches_jax_kernel(dtype, T, pos0):
    rng = np.random.default_rng(T + 13)
    B, hkv, h, d, ps, P = 2, 2, 8, 64, 16, 9
    qj, qt = _bf16_pair(rng, (B, T, h, d))
    kj, kt = _kv_pair(rng, (P, hkv, ps, d), dtype)
    vj, vt = _kv_pair(rng, (P, hkv, ps, d), dtype)
    bt = rng.permutation(P)[:8].reshape(B, 4).astype(np.int32)
    p0 = np.array(pos0, np.int32)
    ns = -(-int(p0.max() + T) // ps)
    want = jattn.flash_prefill_paged(qj, kj, vj, jnp.asarray(bt),
                                     jnp.asarray(p0), ns=ns,
                                     block_q=min(128, T), interpret=True)
    got = tattn.flash_prefill_paged(qt, kt, vt, torch.from_numpy(bt),
                                    torch.from_numpy(p0), ns=ns)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, T, h, d)
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=2 ** -7,
                               atol=2 ** -7)


@pytest.mark.parametrize("dtype", ["bf16", "fp8"])
def test_flash_prefill_headed_matches_jax_kernel(dtype):
    B, T, hkv, h, d, S = 2, 16, 2, 8, 128, 256
    rng = np.random.default_rng(14)
    qj, qt = _bf16_pair(rng, (B, T, h, d))
    kj, kt = _kv_pair(rng, (B, hkv, S, d), dtype)
    vj, vt = _kv_pair(rng, (B, hkv, S, d), dtype)
    p0 = np.array([0, 130], np.int32)
    want = jattn.flash_prefill_attention(qj, kj, vj, jnp.asarray(p0), ns=2,
                                         block_q=T, block_s=128,
                                         interpret=True, headed=True)
    got = tattn.flash_prefill_attention(qt, kt, vt, torch.from_numpy(p0),
                                        ns=2, block_s=128, headed=True)
    np.testing.assert_allclose(_np32(got), _np32(want), rtol=2 ** -7,
                               atol=2 ** -7)


def test_fp8_subnormals_exact_in_port_flushed_in_jax():
    """The pin: on fp8 data that is mostly subnormal, the port attends the
    exact values, equal bit for bit to attention over pool.to(bf16); the JAX
    decode kernel flushes subnormals to zero and lies within the bound that
    flush allows (each value moves by at most 7 * 2^-9, each logit by
    delta = max_rows sum|q| * 7 * 2^-9 / sqrt(d)):
        |jax - port| <= 7*2^-9 + (exp(2 delta) - 1) * max|v| + 2^-7 * |port|
    """
    rng = np.random.default_rng(15)
    (qj, kj, vj), (qt, kt, vt), bt = _pool_setup(rng, "fp8",
                                                 subnormals=True,
                                                 scale=0.01)
    sub = (kt.view(torch.uint8) & 0x78) == 0
    assert sub.float().mean() > 0.5               # mostly subnormal or zero
    pos = np.array([40, 63], np.int32)
    pt, nb = torch.from_numpy(pos), 4
    got = tattn.paged_decode_attention(qt, kt, vt, torch.from_numpy(bt), pt,
                                       nb=nb, page_size=16)
    exact = tattn.paged_decode_attention(
        qt, kt.to(torch.bfloat16), vt.to(torch.bfloat16),
        torch.from_numpy(bt), pt, nb=nb, page_size=16)
    assert torch.equal(got.view(torch.int16), exact.view(torch.int16))
    want = _np32(jattn.paged_decode_attention(
        qj, kj, vj, jnp.asarray(bt), jnp.asarray(pos), nb=nb, page_size=16,
        interpret=True, headed=True))
    flush = 7 * 2.0 ** -9
    delta = float(qt.float().abs().sum(-1).max()) * flush / np.sqrt(64)
    bound = (flush + np.expm1(2 * delta) * float(vt.float().abs().max())
             + 2 ** -7 * np.abs(_np32(got)))
    err = np.abs(want - _np32(got))
    assert (err <= bound).all(), float((err - bound).max())
    assert err.max() > 0                         # the flush is visible


@pytest.mark.parametrize("dtype", ["bf16", "fp8"])
@pytest.mark.parametrize("mask", [None, (1, 0, 1)])
def test_kv_append_headed_bit_exact_vs_jax_kernel(dtype, mask):
    """Headed caches from each package's init_cache (the JAX one pads fp8 S
    to a multiple of 256, so only the first max_seq_len positions are
    compared), filled with the same bytes, then one masked append."""
    cfg = jllama.LlamaConfig.tiny(num_layers=1)
    B, hkv, d, S = 3, cfg.num_kv_heads, cfg.head_dim, cfg.max_seq_len
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float8_e4m3fn, torch.float8_e4m3fn))
    (jk, jv), = jllama.init_cache(cfg, B, jdt, headed=True)
    (tk, tv), = tllama.init_cache(cfg, B, tdt, headed=True,
                                   device="cpu")
    assert tuple(tk.shape) == (B, hkv, S, d) and jk.shape[2] >= S
    rng = np.random.default_rng(16)
    caches = []
    for jc in (jk, jv):
        nbytes = jc.dtype.itemsize
        raw = rng.integers(0, 2 ** (8 * nbytes), size=jc.shape,
                           dtype=np.uint8 if nbytes == 1 else np.uint16)
        nan = 0x7F if nbytes == 1 else 0x7F80     # no NaN bit patterns
        raw = np.where((raw & nan) == nan, 0, raw).astype(raw.dtype)
        caches.append(raw.view(np.asarray(jc).dtype))
    jk, jv = (jnp.asarray(c) for c in caches)
    tk, tv = (convert.tensor_from_numpy(c[:, :, :S], device="cpu")
              for c in caches)
    knj, knt = _bf16_pair(rng, (B, hkv, d))
    vnj, vnt = _bf16_pair(rng, (B, hkv, d))
    pos = np.array([0, 77, S - 1], np.int32)
    mj = None if mask is None else jnp.asarray(mask, jnp.int32)
    mt = None if mask is None else torch.tensor(mask, dtype=torch.bool)
    ck_want, cv_want = jattn.kv_append(jk, jv, knj, vnj, jnp.asarray(pos), mj,
                                       headed=True, interpret=True)
    ck_out, cv_out = tattn.kv_append(tk, tv, knt, vnt, torch.from_numpy(pos),
                                     mt, headed=True)
    assert ck_out is tk and cv_out is tv             # updated in place
    for got, want in ((ck_out, ck_want), (cv_out, cv_want)):
        w = np.asarray(want)[:, :, :S]
        np.testing.assert_array_equal(
            tattn._bits(got).numpy(),
            w.view(np.uint8 if w.dtype.itemsize == 1 else np.int16))


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


_OFF_CPU_CALLS = {
    "paged_decode_attention": lambda: tattn.paged_decode_attention(
        _meta(2, 8, 64), _meta(5, 2, 16, 64), _meta(5, 2, 16, 64),
        _meta(2, 2, dtype=torch.int32), _meta(2, dtype=torch.int32), nb=2,
        page_size=16),
    "decode_attention_contiguous_headed":
        lambda: tattn.decode_attention_contiguous_headed(
            _meta(2, 8, 64), _meta(2, 2, 32, 64), _meta(2, 2, 32, 64),
            _meta(2, dtype=torch.int32), nb=1, page_size=32),
    "flash_prefill_paged": lambda: tattn.flash_prefill_paged(
        _meta(2, 4, 8, 64), _meta(5, 2, 16, 64), _meta(5, 2, 16, 64),
        _meta(2, 2, dtype=torch.int32), _meta(2, dtype=torch.int32), ns=2),
    "flash_prefill_headed": lambda: tattn.flash_prefill_attention(
        _meta(2, 4, 8, 64), _meta(2, 2, 32, 64), _meta(2, 2, 32, 64),
        _meta(2, dtype=torch.int32), ns=1, block_s=32, headed=True),
    "kv_append_headed": lambda: tattn.kv_append(
        _meta(2, 2, 32, 64), _meta(2, 2, 32, 64), _meta(2, 2, 64),
        _meta(2, 2, 64), _meta(2, dtype=torch.int32), headed=True),
}


@pytest.mark.parametrize("name", sorted(_OFF_CPU_CALLS))
def test_headed_wrappers_never_fall_back_off_the_cpu(name):
    """Only CPU tensors take the plain twin: any other device goes to the
    kernel path, which raises for a non-CUDA device before it builds or
    launches anything, and counts no launch."""
    counter = getattr(tattn, name)
    before = counter.launches
    with pytest.raises(ValueError, match="unsupported device meta"):
        _OFF_CPU_CALLS[name]()
    assert counter.launches == before
