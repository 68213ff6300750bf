"""Port parity: decode attention, flash prefill and the KV append of
petit_kernel_tpu_torch against petit_kernel_tpu's Pallas kernels in
interpret mode, on the same inputs.

Tolerances: attention at rtol = atol = 2^-7 (both sum bf16 q.k products in
f32 and run the softmax in f32; they differ in summation order and in the
one bf16 rounding of the output). The KV append is bit-exact, masked rows
included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petit_kernel_tpu.ops.kernels import attention as jattn
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

