"""The causal flash prefill tile body, csrc/flash_prefill.cuh, on the CPU.

A CUDA kernel has no CPU mode, so these tests play the body's data
movement in numpy, byte for byte in a model of its shared memory: Q and K
stored 128-byte-swizzled (fp_chunk), V transposed in registers and stored
as V^T rows (fp_store_v), P split into hi and lo parts and stored swizzled, each
read back as a K-major wgmma descriptor reads it (16 deep, 32 bytes a
chunk, the hardware XOR of address bits 4-6 with bits 7-9); the online
softmax over 64-position tiles in the body's order (log2 units, the
scale folded into one fma), with its masks and its finite -1e30; fp8
upcast exactly (e4m3 -> f16 -> f32 -> bf16); K/V rows found through the
body's FlatKV and PagedKV offset formulas.

The played body is held against the JAX package's flash_prefill_attention
(Pallas interpret mode, flat and headed=True) and flash_prefill_paged on
the same numpy-seeded bytes. Tolerance rtol 2^-7, atol 2^-8 * max|ref|:
both sum exact bf16 q.k products in f32, in another order, run the
softmax in f32 and round the output to bf16 once; the body's P.V carries
p as hi + lo to about 2^-17 of p. fp8 subnormals are held against the
port's exact twin, not the JAX package (its decode kernel flushes them).

The kernels themselves run on the card: tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from petit_kernel_tpu.ops.kernels import attention as jattn
from petit_kernel_tpu_torch.models import convert
from petit_kernel_tpu_torch.ops.kernels import attention as tattn

torch.set_num_threads(1)

_ROW = 128                  # bytes of a swizzled row: 64 bf16
_QUARTER = 64 * _ROW        # 64 swizzled rows
_NEG = np.float32(-1e30)
_LOG2E = np.float32(1.4426950408889634)
_F8_MIN_NORMAL = 2.0 ** -6
_TIDS = np.arange(128)      # one warpgroup
_LANE, _WARP = _TIDS & 31, _TIDS >> 5
_SMEM_LIMIT, _SMEM_SM = 232448, 233472


def _plan(d):
    """FpPlan<d>: byte offsets of K, V^T and P in the aligned buffer."""
    q = d // 64 * _QUARTER
    k, v = q, d * _ROW
    k_off = q
    v_off = k_off + 2 * k
    p_off = v_off + 2 * v
    t_off = p_off + 2 * _QUARTER                 # two row tables
    return dict(k_off=k_off, k_bytes=k, v_off=v_off, v_bytes=v, p_off=p_off,
                t_off=t_off, bytes=t_off + 2 * 64 * 8 + 1024)


# ---- shared memory ----------------------------------------------------------

def _fp_chunk(r, c):
    """fp_chunk: byte offset of 16-byte chunk c of row r in a K-major
    operand of d/64 quarters."""
    return (c >> 3) * _QUARTER + r * _ROW + (((c & 7) ^ (r & 7)) << 4)


def _put16(smem, off, vals):
    """16-byte stores (cp.async or uint4): vals (n, 8) bf16 bit patterns."""
    idx = off[:, None] + np.arange(16)[None]
    smem[idx] = np.ascontiguousarray(vals, np.uint16).view(np.uint8).reshape(
        -1, 16)


def _put4(smem, off, words):
    """4-byte stores: words (n,) uint32."""
    idx = off[:, None] + np.arange(4)[None]
    smem[idx] = np.ascontiguousarray(words, "<u4").view(np.uint8).reshape(
        -1, 4)


def _put(smem, off, vals):
    """Stores of 2m bytes: vals (n, m) bf16 bit patterns."""
    n, m = vals.shape
    idx = off[:, None] + np.arange(2 * m)[None]
    smem[idx] = np.ascontiguousarray(vals, np.uint16).view(np.uint8).reshape(
        n, 2 * m)


def _wgmma_read(smem, start, rows):
    """The (rows, 16) bf16 bit patterns a K-major 128-byte-swizzled
    descriptor at byte `start` (a 1024-aligned base plus 32 bytes a
    16-deep chunk) gives: row r at start + 128r, its 16 values 2 bytes
    apart, the address XORed in bits 4-6 with its bits 7-9."""
    r = np.arange(rows)[:, None]
    addr = start + r * _ROW + 2 * np.arange(16)[None]
    phys = addr ^ (((addr >> 7) & 7) << 4)
    return smem[phys].astype(np.uint16) | (smem[phys + 1].astype(np.uint16)
                                           << 8)


def _f32(bits):
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _bf16_bits(x):
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _fp8_to_bf16_bits(b):
    """fp8x2_bf16x2: e4m3 -> f16 -> f32 -> bf16, each step exact."""
    f8 = torch.from_numpy(np.ascontiguousarray(b, np.uint8)).view(
        torch.float8_e4m3fn)
    return (f8.to(torch.float16).to(torch.float32).to(torch.bfloat16)
            .view(torch.int16).numpy().view(np.uint16))


# ---- the body ---------------------------------------------------------------

def _flash_prefill_body(q16, k16, v16, pos0, window, hkv, addr):
    """flash_prefill_tile for every CTA of the grid: q16 (B, T, H, d) bf16
    bits; k16, v16 the cache as flat bf16 bits (after the exact upcast the
    body does in registers); addr(b, h, p) the element offsets of rows.
    Returns (B, T, H, d) f32 of bf16 values."""
    B, T, H, d = q16.shape
    G, c8 = H // hkv, d // 8
    rows = T * G
    plan = _plan(d)
    out = np.zeros((B, T, H, d), np.float32)
    e = np.arange(64 * c8)                       # tid + 128 i of Q and K
    er, ec = e // c8, e % c8
    scale2 = np.float32(1 / np.sqrt(d)) * _LOG2E
    for b in range(B):
        p0 = int(pos0[b])
        for h in range(hkv):
            for tile in range(-(-rows // 64)):
                r0 = tile * 64
                last = min(r0 + 64, rows) - 1
                lim = min(p0 + last // G + 1, window)
                ntiles = -(-lim // 64) if lim > 0 else 0
                smem = np.zeros(plan["bytes"], np.uint8)
                row = np.arange(64) + r0
                row_lim = np.where(row < rows,
                                   np.minimum(p0 + row // G + 1, window), 0)
                # Q, zero past T*G
                qr = r0 + er
                ok = qr < rows
                t, g = np.where(ok, qr // G, 0), np.where(ok, qr % G, 0)
                vals = q16[b, t, h * G + g].reshape(-1, c8, 8)[e, ec]
                _put16(smem, _fp_chunk(er, ec), np.where(ok[:, None], vals, 0))
                o = np.zeros((64, d), np.float32)
                m_run = np.full(64, _NEG, np.float32)
                l_run = np.zeros(64, np.float32)
                for j in range(ntiles):
                    buf, kp0 = j & 1, 64 * j
                    kb = plan["k_off"] + buf * plan["k_bytes"]
                    vb = plan["v_off"] + buf * plan["v_bytes"]
                    tab = _fill_rows(addr, b, h, kp0, lim)
                    _store_k(smem, kb, k16, tab, kp0, lim, er, ec)
                    _store_vt(smem, vb, v16, tab, kp0, lim, d)
                    # S = Q K^T, d / 16 chunks, f32 sums
                    s = np.zeros((64, 64), np.float32)
                    for c in range(d // 16):
                        off = (c >> 2) * _QUARTER + 32 * (c & 3)
                        qa = _f32(_wgmma_read(smem, off, 64))
                        ka = _f32(_wgmma_read(smem, kb + off, 64))
                        s = (s + qa.astype(np.float64) @ ka.T.astype(
                            np.float64)).astype(np.float32)
                    # online softmax in log2 units: the row max of the
                    # masked raw S, scaled; p = 2^fma(s, scale2, -max)
                    pos = kp0 + np.arange(64)
                    valid = pos[None] < row_lim[:, None]
                    mx = np.maximum(m_run, np.where(valid, s, _NEG).max(1)
                                    * scale2)
                    alpha = np.exp2(m_run - mx)
                    arg = (s.astype(np.float64) * scale2
                           - mx[:, None]).astype(np.float32)
                    p = np.where(valid, np.exp2(arg), 0).astype(np.float32)
                    m_run = mx
                    l_run = l_run * alpha + p.sum(1, dtype=np.float32)
                    o *= alpha[:, None]
                    _store_p(smem, plan["p_off"], p)
                    # O += P V, hi and lo, 4 chunks of 16 positions
                    for c in range(4):
                        vt = _f32(_wgmma_read(smem, vb + 32 * c, d))
                        for part in range(2):
                            pa = _f32(_wgmma_read(
                                smem, plan["p_off"] + part * _QUARTER + 32 * c,
                                64))
                            o = (o + pa.astype(np.float64) @ vt.T.astype(
                                np.float64)).astype(np.float32)
                inv = np.where(l_run > 0, 1 / np.where(l_run > 0, l_run, 1),
                               0).astype(np.float32)
                keep = row < rows
                res = _f32(_bf16_bits(o * inv[:, None]))
                out[b, row[keep] // G, h * G + row[keep] % G] = res[keep]
    return out


def _fill_rows(addr, b, h, kp0, lim):
    """fp_fill_rows: the element offset of each of the tile's 64
    positions, 0 at or past lim."""
    pos = kp0 + np.arange(64)
    return np.where(pos < lim, addr(b, h, np.where(pos < lim, pos, 0)), 0)


def _store_k(smem, kb, k16, tab, kp0, lim, er, ec):
    """fp_copy_k / fp_store_k: chunk e % (d/8) of position e / (d/8),
    zeros at or past lim."""
    ok = kp0 + er < lim
    vals = k16[tab[er][:, None] + ec[:, None] * 8 + np.arange(8)[None]]
    _put16(smem, kb + _fp_chunk(er, ec), np.where(ok[:, None], vals, 0))


def _vt_thread(d):
    """fp_store_v's mapping: thread t takes chunk t / (64/VP) of the VP =
    d/16 positions from p0 = VP * (t % (64/VP))."""
    vp = d // 16
    return vp, _TIDS // (64 // vp), vp * (_TIDS % (64 // vp))


def _vt_offsets(dd, p0):
    """V^T row dd, positions from p0: chunk (p0 / 8) ^ (dd & 7), byte
    2 (p0 % 8)."""
    return dd * _ROW + (((p0 >> 3) ^ (dd & 7)) << 4) + 2 * (p0 & 7)


def _store_vt(smem, vb, v16, tab, kp0, lim, d):
    """fp_load_kv / fp_store_v's V: each thread's VP rows of 8 values
    (chunk c), value j of them stored as the VP positions of V^T row
    8c + j in one store."""
    vp, c, p0 = _vt_thread(d)
    vals = np.stack([np.where((kp0 + p0 + k < lim)[:, None],
                              v16[tab[p0 + k][:, None] + c[:, None] * 8
                                  + np.arange(8)[None]], 0)
                     for k in range(vp)], 1)          # (128, vp, 8)
    for j in range(8):
        dd = 8 * c + j
        _put(smem, vb + _vt_offsets(dd, p0), vals[:, :, j])


def _p_offsets(r, i, lane):
    """P row r, positions 8i + 2(l % 4) and + 1."""
    return r * _ROW + ((i ^ (r & 7)) << 4) + (lane & 3) * 4


def _store_p(smem, p_off, p):
    """The thread of (warp w, lane l) holds rows 16w + l/4 (+ 8) at
    positions 8i + 2(l % 4) (+ 1) of the S fragment: hi = bf16(p) and lo =
    bf16(p - hi) as bf16x2 words into the hi and lo P tiles."""
    for x in range(2):
        r = 16 * _WARP + (_LANE >> 2) + 8 * x
        for i in range(8):
            col = 8 * i + 2 * (_LANE & 3)
            pair = np.stack([p[r, col], p[r, col + 1]], 1)
            hi = _bf16_bits(pair)
            lo = _bf16_bits(pair - _f32(hi))
            for part, bits in enumerate((hi, lo)):
                w = bits[:, 0].astype(np.uint32) | (bits[:, 1].astype(
                    np.uint32) << 16)
                _put4(smem, p_off + part * _QUARTER + _p_offsets(r, i, _LANE),
                      w)


# ---- addressing and data ----------------------------------------------------

def _flat_addr(S, hkv, d):
    """FlatKV: ((b*S + p)*Hkv + h)*d."""
    return lambda b, h, p: ((b * S + p) * hkv + h) * d


def _paged_addr(bt, ps, page_stride, head_stride, d):
    """PagedKV: bt[b, p / ps]*page_stride + h*head_stride + (p % ps)*d."""
    return lambda b, h, p: (bt[b, p // ps].astype(np.int64) * page_stride
                            + h * head_stride + (p % ps) * d)


def _bf16_data(rng, shape):
    x = jnp.asarray(rng.standard_normal(shape, dtype=np.float32),
                    jnp.bfloat16)
    return x, np.array(x).view(np.uint16)


def _kv_data(rng, shape, dtype, subnormals=False, scale=1.0):
    """The same bf16 or fp8 e4m3 values for both packages and the body's
    bf16 bits after its exact upcast. Without subnormals, fp8 magnitudes
    below the smallest normal are lifted to it."""
    if dtype == "bf16":
        x, bits = _bf16_data(rng, shape)
        return x, bits.reshape(-1), torch.from_numpy(
            bits.view(np.int16)).view(torch.bfloat16)
    x = rng.standard_normal(shape, dtype=np.float32) * scale
    if not subnormals:
        x = np.where(np.abs(x) < _F8_MIN_NORMAL,
                     np.copysign(_F8_MIN_NORMAL, x), x)
    x = x.astype(ml_dtypes.float8_e4m3fn)
    return (jnp.asarray(x), _fp8_to_bf16_bits(x.view(np.uint8).reshape(-1)),
            convert.tensor_from_numpy(x, device="cpu"))


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=2 ** -7,
                               atol=2 ** -8 * np.abs(want).max())


_B, _T, _HKV, _S = 2, 20, 2, 256
# ragged starts; the second chunk runs past the window (240 or 256)
_POS0 = np.array([3, 245], np.int32)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_body_matches_jax_flat(G, d):
    """Flat bf16 cache, T = 20 (not a multiple of 64 / G: a ragged last
    row tile), window 240 (15 blocks of 16) below pos0 + T = 265 and not
    a multiple of 64 (a ragged last KV tile)."""
    rng = np.random.default_rng(100 + 10 * G + d)
    H = G * _HKV
    qj, q16 = _bf16_data(rng, (_B, _T, H, d))
    kj, k16, _ = _kv_data(rng, (_B, _S, _HKV, d), "bf16")
    vj, v16, _ = _kv_data(rng, (_B, _S, _HKV, d), "bf16")
    ns, block_s = 15, 16
    want = jattn.flash_prefill_attention(
        qj, kj, vj, jnp.asarray(_POS0), ns=ns, block_q=_T, block_s=block_s,
        interpret=True)
    got = _flash_prefill_body(q16, k16, v16, _POS0, ns * block_s, _HKV,
                              _flat_addr(_S, _HKV, d))
    _close(got, want)


@pytest.mark.parametrize("dtype", ["bf16", "fp8"])
@pytest.mark.parametrize("G,d", [(4, 128), (8, 64)])
def test_body_matches_jax_headed(G, d, dtype):
    """Headed (B, Hkv, S, d) cache, bf16 or fp8: one page of S positions a
    sequence (block-table entry b*Hkv, page and head stride S*d)."""
    rng = np.random.default_rng(200 + 10 * G + d)
    H = G * _HKV
    qj, q16 = _bf16_data(rng, (_B, _T, H, d))
    kj, k16, _ = _kv_data(rng, (_B, _HKV, _S, d), dtype)
    vj, v16, _ = _kv_data(rng, (_B, _HKV, _S, d), dtype)
    ns, block_s = 15, 16
    want = jattn.flash_prefill_attention(
        qj, kj, vj, jnp.asarray(_POS0), ns=ns, block_q=_T, block_s=block_s,
        interpret=True, headed=True)
    bt = (np.arange(_B) * _HKV)[:, None].astype(np.int32)
    got = _flash_prefill_body(q16, k16, v16, _POS0, ns * block_s, _HKV,
                              _paged_addr(bt, _S, _S * d, _S * d, d))
    _close(got, want)


def _pool(rng, dtype, ps, d, subnormals=False, scale=1.0):
    """A pool of 256 positions a sequence and one spare page, a permuted
    block table."""
    nb = _S // ps
    P = _B * nb + 1
    kj, k16, kt = _kv_data(rng, (P, _HKV, ps, d), dtype, subnormals, scale)
    vj, v16, vt = _kv_data(rng, (P, _HKV, ps, d), dtype, subnormals, scale)
    bt = rng.permutation(P)[:_B * nb].reshape(_B, nb).astype(np.int32)
    return (kj, vj), (k16, v16), (kt, vt), bt


@pytest.mark.parametrize("dtype", ["bf16", "fp8"])
@pytest.mark.parametrize("ps", [16, 128])
@pytest.mark.parametrize("G,d", [(1, 64), (4, 128), (8, 128)])
def test_body_matches_jax_paged(G, d, ps, dtype):
    """Paged pool, page size 16 (a KV tile spans 4 pages) or 128 (two KV
    tiles a page), permuted block table; window 240 at ps 16, 256 at
    ps 128, both below pos0 + T."""
    rng = np.random.default_rng(300 + 10 * G + d + ps)
    H = G * _HKV
    qj, q16 = _bf16_data(rng, (_B, _T, H, d))
    (kj, vj), (k16, v16), _, bt = _pool(rng, dtype, ps, d)
    ns = 15 if ps == 16 else 2
    want = jattn.flash_prefill_paged(qj, kj, vj, jnp.asarray(bt),
                                     jnp.asarray(_POS0), ns=ns, block_q=_T,
                                     interpret=True)
    got = _flash_prefill_body(q16, k16, v16, _POS0, ns * ps, _HKV,
                              _paged_addr(bt, ps, _HKV * ps * d, ps * d, d))
    _close(got, want)


@pytest.mark.parametrize("ps", [16, 128])
def test_body_fp8_subnormals_exact_against_port_twin(ps):
    """Mostly subnormal fp8 K/V (scale 0.01): the body's exact upcast
    against the port's twin, which attends pool.to(bf16) exactly."""
    rng = np.random.default_rng(400 + ps)
    G, d = 4, 64
    H = G * _HKV
    qj, q16 = _bf16_data(rng, (_B, _T, H, d))
    _, (k16, v16), (kt, vt), bt = _pool(rng, "fp8", ps, d, subnormals=True,
                                        scale=0.01)
    assert ((kt.view(torch.uint8) & 0x78) == 0).float().mean() > 0.5
    ns = 15 if ps == 16 else 2
    want = tattn.flash_prefill_paged(
        torch.from_numpy(q16.view(np.int16)).view(torch.bfloat16), kt, vt,
        torch.from_numpy(bt), torch.from_numpy(_POS0), ns=ns)
    got = _flash_prefill_body(q16, k16, v16, _POS0, ns * ps, _HKV,
                              _paged_addr(bt, ps, _HKV * ps * d, ps * d, d))
    _close(got, want.float().numpy())


def test_body_row_without_position_is_zero():
    """A window of 0 leaves every row without a valid position: the body
    walks no KV tile and writes zeros, never NaN."""
    rng = np.random.default_rng(500)
    d, G = 64, 4
    _, q16 = _bf16_data(rng, (1, 8, G * _HKV, d))
    _, k16, _ = _kv_data(rng, (1, 64, _HKV, d), "bf16")
    got = _flash_prefill_body(q16, k16, k16, np.array([0], np.int32), 0,
                              _HKV, _flat_addr(64, _HKV, d))
    assert np.isfinite(got).all() and not got.any()


# ---- the plan and the stores ------------------------------------------------

@pytest.mark.parametrize("d", [64, 128])
def test_plan_fits_two_blocks_an_sm(d):
    """FpPlan: every buffer 1024-aligned (the swizzle atom), Q, K and V^T
    double-buffered, P hi and lo and two row tables, two blocks an SM (the
    kernel's static_asserts)."""
    plan = _plan(d)
    for key in ("k_off", "k_bytes", "v_off", "v_bytes", "p_off", "t_off"):
        assert plan[key] % 1024 == 0
    assert plan["bytes"] <= _SMEM_LIMIT
    assert 2 * (plan["bytes"] + 1024) <= _SMEM_SM
    assert plan["bytes"] == {64: 59392, 128: 100352}[d]


def _conflict_free(off, width):
    """A warp's store of `width` bytes a lane runs in phases of 128 /
    width lanes; each phase must hit the 32 banks once."""
    per = 128 // width
    for ph in range(32 // per):
        lanes = off[ph * per:(ph + 1) * per]
        banks = {((o >> 2) + k) & 31 for o in lanes for k in range(width // 4)}
        if len(banks) != 32:
            return False
    return True


@pytest.mark.parametrize("d", [64, 128])
def test_transposed_and_p_stores_are_conflict_free(d):
    """Each store instruction of a warp (the V^T store of each value j, 16
    or 8 bytes a lane; a P hi or lo word for each (i, x)) hits every bank
    once a phase: the swizzle spreads a phase's lanes over one 128-byte
    row."""
    vp, c, p0 = _vt_thread(d)
    lane = np.arange(32)
    for warp in range(4):
        sl = slice(32 * warp, 32 * warp + 32)
        for j in range(8):
            assert _conflict_free(_vt_offsets(8 * c[sl] + j, p0[sl]), 2 * vp)
        for x in range(2):
            r = 16 * warp + (lane >> 2) + 8 * x
            for i in range(8):
                assert _conflict_free(_p_offsets(r, i, lane), 4)


@pytest.mark.parametrize("d", [64, 128])
def test_swizzled_stores_read_back_as_descriptor_reads(d):
    """fp_chunk stores followed by descriptor reads give back the operand
    (rows, d) in k order, quarter by quarter, 16 deep a chunk."""
    rng = np.random.default_rng(600 + d)
    a = rng.integers(0, 1 << 16, size=(64, d), dtype=np.uint16)
    smem = np.zeros(d // 64 * _QUARTER, np.uint8)
    e = np.arange(64 * d // 8)
    r, c = e // (d // 8), e % (d // 8)
    _put16(smem, _fp_chunk(r, c), a.reshape(64, d // 8, 8)[r, c])
    back = np.concatenate([
        _wgmma_read(smem, (c >> 2) * _QUARTER + 32 * (c & 3), 64)
        for c in range(d // 16)], axis=1)
    assert np.array_equal(back, a)
