"""The split-KV decode attention body, csrc/decode_attention.cuh, on the CPU.

A CUDA kernel has no CPU mode, so these tests check what surrounds it and
play its arithmetic in torch:

- the split plan (attention.decode_split_plan): every position below the
  window in exactly one split, none empty, chunks a multiple of 64, a
  function of (B, Hkv, window) alone;
- a model of the body in its order: CTA s takes the positions [s*chunk,
  (s+1)*chunk) below lim = min(pos[b] + 1, window), warp w the positions
  16w .. 16w + 15 of each 64-position tile, K/V rows found through the
  body's FlatKV and PagedKV offset formulas; per warp and tile one row max
  over its 16 logits in log2 units (the scale folded in), one rescale, p =
  2^(s*scale2 - m) zero past lim, P split into bf16 hi + lo and each part
  times V summed in f32; the warps merged in warp order, then the splits in
  split order, out = bf16(O / l).

The model is held against the JAX package's decode_attention_contiguous,
decode_attention_contiguous_headed and paged_decode_attention (Pallas
interpret mode) on the same numpy-seeded bytes, at the existing decode
parity's tolerance, rtol = atol = 2^-7: both sum exact bf16 q.k products
in f32 in another order and run the softmax in f32; the body's P.V carries
p as hi + lo to about 2^-17 of p; one bf16 rounding of the output. fp8 data
here has no subnormals (the JAX decode kernel flushes them); fp8 subnormals
are held against the port's exact twin instead.

The kernels themselves run on the card: tests/test_torch_cuda.py.
"""

import ctypes
import inspect
import math
import re

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from petit_kernel_tpu.ops.kernels import attention as jattn
from petit_kernel_tpu_torch.models import convert
from petit_kernel_tpu_torch.ops import _build
from petit_kernel_tpu_torch.ops.kernels import attention as tattn

torch.set_num_threads(1)

_CSRC = _build.CSRC
_NEG = -1e30
_LOG2E = 1.4426950408889634
_WARPS, _WP, _TILE = 4, 16, 64
_F8_MIN_NORMAL = 2.0 ** -6
_TOL = dict(rtol=2 ** -7, atol=2 ** -7)


# ---- the split plan -----------------------------------------------------------

_PAGE_SIZES = (16, 128, 256)


@pytest.mark.parametrize("ps", _PAGE_SIZES)
@pytest.mark.parametrize("batch", [1, 2, 4, 8])
def test_split_plan_covers_each_position_once(ps, batch):
    """Windows of nb pages from 128 to 2048 positions: split s covers
    [s*chunk, (s+1)*chunk) cut at the window, chunk % 64 == 0, no split is
    empty, and each position below the window lies in exactly one."""
    for hkv in (1, 8):
        for nb in range(max(1, 128 // ps), 2048 // ps + 1):
            window = nb * ps
            splits, chunk = tattn.decode_split_plan(batch, hkv, window)
            assert chunk % 64 == 0 and splits >= 1
            assert (splits - 1) * chunk < window <= splits * chunk
            owner = np.arange(window) // chunk
            assert owner.max() == splits - 1
            assert np.bincount(owner, minlength=splits).min() > 0


def test_split_plan_is_a_function_of_batch_heads_and_window():
    """The plan takes (batch, hkv, window) and an optional split count, never
    the positions or the page size: one window reached through pages of 16,
    128 and 256 gives one plan. About four CTAs an SM by default, at most
    one split a 64-position tile."""
    params = list(inspect.signature(tattn.decode_split_plan).parameters)
    assert params == ["batch", "hkv", "window", "splits"]
    for window in (256, 512, 1024, 2048):
        for batch in range(1, 9):
            plans = {tattn.decode_split_plan(batch, 8, (window // ps) * ps)
                     for ps in _PAGE_SIZES}
            assert len(plans) == 1
    # the Engine's decode shape and the kernels phase's
    assert tattn.decode_split_plan(4, 8, 512) == (8, 64)
    assert tattn.decode_split_plan(8, 8, 2048) == (8, 256)
    for batch, hkv, window in ((1, 1, 2048), (8, 8, 2048), (4, 8, 512),
                               (2, 2, 100)):
        want = -(-tattn.DECODE_CTAS // (batch * hkv))
        plan = tattn.decode_split_plan(batch, hkv, window)
        assert plan[0] <= min(-(-window // 64), want)
        assert plan == tattn.decode_split_plan(batch, hkv, window, want)


@pytest.mark.parametrize("window", [16, 64, 100, 512, 2048])
def test_split_plan_forced_counts(window):
    """A given split count is met where the tiles divide into it and cut to
    one split a tile at most; 0 raises."""
    tiles = -(-window // 64)
    for want in range(1, tiles + 3):
        splits, chunk = tattn.decode_split_plan(3, 2, window, want)
        assert splits <= min(want, tiles) and chunk % 64 == 0
        assert (splits - 1) * chunk < window <= splits * chunk
        if tiles % min(want, tiles) == 0:
            assert splits == min(want, tiles)
    assert tattn.decode_split_plan(3, 2, window, 1) == (1, tiles * 64)
    with pytest.raises(ValueError, match="splits"):
        tattn.decode_split_plan(3, 2, window, 0)


def test_split_plan_caps_the_merge_rows():
    """At most DECODE_MAX_SPLITS splits, the body's DA_MAX_SPLITS: the
    merge keeps every split's (m, l) rows in shared memory."""
    window = 64 * (tattn.DECODE_MAX_SPLITS + 100)
    splits, chunk = tattn.decode_split_plan(1, 1, window, 10 ** 6)
    assert splits <= tattn.DECODE_MAX_SPLITS and chunk == 128
    assert (splits - 1) * chunk < window <= splits * chunk


# ---- the body's model -----------------------------------------------------------

def _flat_addr(S, hkv, d):
    """FlatKV: element offset of (b, h, p) in a (B, S, Hkv, d) cache."""
    return lambda b, h, p: ((b * S + p) * hkv + h) * d


def _paged_addr(bt, ps, d, page_stride, head_stride):
    """PagedKV: bt[b, p // ps] * page_stride + h * head_stride + (p % ps) * d."""
    return lambda b, h, p: (bt[b, p // ps].astype(np.int64) * page_stride
                            + h * head_stride + (p % ps) * d)


def _rows(flat, offs, d):
    """The d values at each element offset of a flattened f32 cache."""
    return flat[torch.from_numpy(offs)[:, None] + torch.arange(d)[None]]


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _warp_state(qg, k, v, valid, state, scale2):
    """One warp's tile: its 16 logits per row, the rescale, P hi + lo."""
    m, l, o = state
    s = qg @ k.T                                   # (G, 16) f32
    x = torch.where(valid[None], s, torch.tensor(_NEG))
    m_new = torch.maximum(m, x.max(-1).values * scale2)
    alpha = torch.exp2(m - m_new)
    p = torch.where(valid[None], torch.exp2(x * scale2 - m_new[:, None]),
                    torch.tensor(0.0))
    hi = _bf16(p)
    lo = _bf16(p - hi)
    return (m_new, l * alpha + p.sum(-1),
            o * alpha[:, None] + hi @ v + lo @ v)


def _merge(states):
    """(m, l, O) of several parts merged in their order."""
    M = torch.stack([m for m, _, _ in states]).max(0).values
    L = torch.zeros_like(M)
    O = torch.zeros_like(states[0][2])
    for m, l, o in states:
        f = torch.exp2(m - M)
        L = L + l * f
        O = O + o * f[:, None]
    return M, L, O


def _decode_body(q, flat_k, flat_v, pos, addr, hkv, window, splits=None):
    """The body's order over (B, H, d) bf16 q and flattened f32 K/V caches
    whose rows `addr(b, h, p)` finds: returns (B, H, d) bf16."""
    B, H, d = q.shape
    G = H // hkv
    n, chunk = tattn.decode_split_plan(B, hkv, window, splits)
    scale2 = torch.tensor(1.0 / math.sqrt(d) * _LOG2E, dtype=torch.float32)
    out = torch.empty((B, H, d), dtype=torch.float32)
    for b in range(B):
        lim = min(int(pos[b]) + 1, window)
        nsplit = -(-lim // chunk) if lim > chunk else 1
        for h in range(hkv):
            qg = q[b, h * G:(h + 1) * G].float()
            parts = []
            for s in range(nsplit):
                end = min(lim, (s + 1) * chunk)
                warps = []
                for w in range(_WARPS):
                    state = (torch.full((G,), _NEG), torch.zeros(G),
                             torch.zeros(G, d))
                    for p0 in range(s * chunk + _WP * w, end, _TILE):
                        p = np.arange(p0, p0 + _WP)
                        valid = torch.from_numpy(p < end)
                        offs = addr(b, h, np.minimum(p, end - 1))
                        k = _rows(flat_k, offs, d) * valid[:, None]
                        v = _rows(flat_v, offs, d) * valid[:, None]
                        state = _warp_state(qg, k, v, valid, state, scale2)
                    warps.append(state)
                parts.append(_merge(warps))
            _, L, O = _merge(parts) if nsplit > 1 else parts[0]
            out[b, h * G:(h + 1) * G] = torch.where(
                L[:, None] > 0, O / L[:, None], torch.tensor(0.0))
    return out.to(torch.bfloat16)


# ---- shared inputs ----------------------------------------------------------------

def _bf16_pair(rng, shape):
    x = jnp.asarray(rng.standard_normal(shape, dtype=np.float32),
                    jnp.bfloat16)
    return x, torch.from_numpy(np.array(x).view(np.int16)).view(
        torch.bfloat16)


def _kv_pair(rng, shape, dtype, subnormals=False, scale=1.0):
    """The same bf16 or fp8 e4m3 values for both packages; without
    subnormals, fp8 magnitudes below the smallest normal are lifted to it."""
    if dtype == "bf16":
        return _bf16_pair(rng, shape)
    x = rng.standard_normal(shape, dtype=np.float32) * scale
    if not subnormals:
        x = np.where(np.abs(x) < _F8_MIN_NORMAL,
                     np.copysign(_F8_MIN_NORMAL, x), x)
    x = x.astype(ml_dtypes.float8_e4m3fn)
    return jnp.asarray(x), convert.tensor_from_numpy(x, device="cpu")


def _np32(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


# positions: 0 (every split past the first wholly past pos), the last and
# first position of a 64-position tile, one past a 16-position page, and
# one past the window (lim = window)
_POS = (0, 63, 64, 16, 200)
# (G, d): G query rows a kv head of 1, 4 and 8, head dims 64 and 128
_GD = ((1, 64), (4, 128), (8, 64), (8, 128))


@pytest.mark.parametrize("splits", [None, 1, 3])
@pytest.mark.parametrize("G,d", _GD)
def test_body_flat_matches_jax_kernel(G, d, splits):
    """Flat (B, S, Hkv, d) bf16 cache, window 192 (nb = 3 pages of 64)."""
    B, S, hkv, nb, page = len(_POS), 256, 2, 3, 64
    rng = np.random.default_rng(100 * G + d)
    qj, qt = _bf16_pair(rng, (B, G * hkv, d))
    kj, kt = _bf16_pair(rng, (B, S, hkv, d))
    vj, vt = _bf16_pair(rng, (B, S, hkv, d))
    pos = np.array(_POS, np.int32)
    want = jattn.decode_attention_contiguous(
        qj, kj, vj, jnp.asarray(pos), nb=nb, page_size=page, interpret=True)
    got = _decode_body(qt, kt.float().reshape(-1), vt.float().reshape(-1),
                       pos, _flat_addr(S, hkv, d), hkv, nb * page, splits)
    np.testing.assert_allclose(_np32(got), _np32(want), **_TOL)


@pytest.mark.parametrize("dtype", ["bf16", "fp8"])
@pytest.mark.parametrize("G,d", _GD)
def test_body_headed_matches_jax_kernel(dtype, G, d):
    """Headed (B, Hkv, S, d) cache, one page of S positions a sequence
    (table entry b * Hkv, page and head stride S * d), window 256."""
    B, S, hkv = len(_POS), 256, 2
    rng = np.random.default_rng(200 * G + d + (dtype == "fp8"))
    qj, qt = _bf16_pair(rng, (B, G * hkv, d))
    kj, kt = _kv_pair(rng, (B, hkv, S, d), dtype)
    vj, vt = _kv_pair(rng, (B, hkv, S, d), dtype)
    pos = np.array(_POS, np.int32)
    want = jattn.decode_attention_contiguous_headed(
        qj, kj, vj, jnp.asarray(pos), nb=2, page_size=128, interpret=True)
    table = (np.arange(B) * hkv)[:, None]
    addr = _paged_addr(table, S, d, S * d, S * d)
    got = _decode_body(qt, kt.float().reshape(-1), vt.float().reshape(-1),
                       pos, addr, hkv, 256)
    np.testing.assert_allclose(_np32(got), _np32(want), **_TOL)


@pytest.mark.parametrize("splits", [None, 2])
@pytest.mark.parametrize("dtype", ["bf16", "fp8"])
@pytest.mark.parametrize("G,d", _GD)
def test_body_paged_matches_jax_kernel(dtype, G, d, splits):
    """A (P, Hkv, 16, d) pool through a permuted block table: each
    64-position tile spans 4 pages; window 192 (nb = 12 pages)."""
    B, hkv, ps, nb = len(_POS), 2, 16, 12
    P = B * nb + 1
    rng = np.random.default_rng(300 * G + d + (dtype == "fp8"))
    qj, qt = _bf16_pair(rng, (B, G * hkv, d))
    kj, kt = _kv_pair(rng, (P, hkv, ps, d), dtype)
    vj, vt = _kv_pair(rng, (P, hkv, ps, d), dtype)
    bt = rng.permutation(P)[:B * nb].reshape(B, nb).astype(np.int32)
    pos = np.array(_POS, np.int32)
    want = jattn.paged_decode_attention(
        qj, kj, vj, jnp.asarray(bt), jnp.asarray(pos), nb=nb, page_size=ps,
        interpret=True, headed=True)
    addr = _paged_addr(bt, ps, d, hkv * ps * d, ps * d)
    got = _decode_body(qt, kt.float().reshape(-1), vt.float().reshape(-1),
                       pos, addr, hkv, nb * ps, splits)
    np.testing.assert_allclose(_np32(got), _np32(want), **_TOL)


@pytest.mark.parametrize("ps", [16, 128, 256])
def test_body_fp8_subnormals_match_the_exact_twin(ps):
    """Mostly subnormal fp8 pools at page sizes 16, 128 and 256: the body,
    which upcasts exactly, against the port's exact twin
    (paged_decode_reference), not the JAX kernel, which flushes them."""
    B, hkv, G, d, nb = 3, 2, 4, 64, max(1, 512 // ps)
    P = B * nb + 1
    rng = np.random.default_rng(400 + ps)
    _, q = _bf16_pair(rng, (B, G * hkv, d))
    _, k = _kv_pair(rng, (P, hkv, ps, d), "fp8", subnormals=True, scale=0.01)
    _, v = _kv_pair(rng, (P, hkv, ps, d), "fp8", subnormals=True, scale=0.01)
    assert ((k.view(torch.uint8) & 0x78) == 0).float().mean() > 0.5
    bt = rng.permutation(P)[:B * nb].reshape(B, nb).astype(np.int32)
    pos = np.array([0, 300, 511], np.int32)
    want = tattn.paged_decode_reference(q, k, v, torch.from_numpy(bt),
                                        torch.from_numpy(pos), nb=nb,
                                        page_size=ps)
    got = _decode_body(q, k.float().reshape(-1), v.float().reshape(-1), pos,
                       _paged_addr(bt, ps, d, hkv * ps * d, ps * d), hkv,
                       nb * ps)
    np.testing.assert_allclose(_np32(got), _np32(want), **_TOL)


def test_body_twin_and_split_counts_agree_at_full_width():
    """The kernels phase's shape cut to two sequences (H = 32, Hkv = 8, d =
    128, window 2048): the body at its default plan (32 splits of 64 here),
    at 1 split and at 5 agrees with the port's plain twin."""
    B, S, hkv, H, d = 2, 2048, 8, 32, 128
    rng = np.random.default_rng(5)
    _, q = _bf16_pair(rng, (B, H, d))
    _, k = _bf16_pair(rng, (B, S, hkv, d))
    _, v = _bf16_pair(rng, (B, S, hkv, d))
    pos = np.array([700, 2047], np.int32)
    want = tattn.decode_attention_reference(q, k, v, torch.from_numpy(pos),
                                            nb=16, page_size=128)
    for splits in (None, 1, 5):
        got = _decode_body(q, k.float().reshape(-1), v.float().reshape(-1),
                           pos, _flat_addr(S, hkv, d), hkv, S, splits)
        np.testing.assert_allclose(_np32(got), _np32(want), **_TOL)


def test_p_split_carries_p_to_2_pow_minus_17():
    """hi = bf16(p), lo = bf16(p - hi): |p - hi - lo| <= 2^-17 p over p in
    (0, 1], where hi alone errs by up to 2^-9 p."""
    p = torch.rand(200_000, generator=torch.Generator().manual_seed(0))
    p = p[p > 0]
    hi = _bf16(p)
    lo = _bf16(p - hi)
    assert ((p - hi - lo).abs() <= 2.0 ** -17 * p).all()
    assert ((p - hi).abs() / p).max() > 2.0 ** -10


# ---- the wrappers and the C entries --------------------------------------------------

def test_wrappers_check_splits_on_cpu_tensors():
    """`splits` is checked on CPU tensors too (the twin ignores it)."""
    rng = np.random.default_rng(6)
    _, q = _bf16_pair(rng, (2, 8, 64))
    _, k = _bf16_pair(rng, (2, 128, 2, 64))
    pos = torch.tensor([3, 100], dtype=torch.int32)
    base = tattn.decode_attention_contiguous(q, k, k, pos, nb=1)
    assert torch.equal(base, tattn.decode_attention_contiguous(
        q, k, k, pos, nb=1, splits=2))
    with pytest.raises(ValueError, match="splits"):
        tattn.decode_attention_contiguous(q, k, k, pos, nb=1, splits=0)
    kh = k.transpose(1, 2).contiguous()
    with pytest.raises(ValueError, match="splits"):
        tattn.decode_attention_contiguous_headed(q, kh, kh, pos, nb=1,
                                                 page_size=128, splits=0)
    pool = kh.reshape(4, 2, 64, 64)
    bt = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    with pytest.raises(ValueError, match="splits"):
        tattn.paged_decode_attention(q, pool, pool, bt, pos, nb=2,
                                     page_size=64, splits=0)


def _entry_args(src: str, name: str) -> list[str]:
    """The parameter names of extern "C" entry `name` in a source."""
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
    return [p.split()[-1].lstrip("*") for p in m[1].split(",")]


_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int": ctypes.c_int, "float": ctypes.c_float,
           "long long": ctypes.c_longlong}


@pytest.mark.parametrize("src,name", [
    ("decode_attention.cu", "pk_decode_attention"),
    ("paged_decode_attention.cu", "pk_paged_decode_attention")])
def test_c_entries_match_the_build_signatures(src, name):
    """Each decode entry's C parameter types, in order, are the ctypes
    types ops/_build.py declares for it, workspace and counters included;
    both launch the split body of decode_attention.cuh."""
    text = (_CSRC / src).read_text()
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
    types = [re.sub(r"\s*\w+$", "", p.strip()) for p in m[1].split(",")]
    assert tuple(_CTYPES[t] for t in types) == _build.SIGNATURES[name]
    args = _entry_args(text, name)
    assert args[args.index("out") + 1:args.index("out") + 3] == [
        "ws", "counters"]
    assert "splits" in args and "chunk" in args
    assert '#include "decode_attention.cuh"' in text
    assert "decode_split_launch<" in text
    assert "warp_sum" not in text and "<<<" not in text


def test_body_source_states_its_plan():
    """The header's constants are the model's: 4 warps of 16 positions a
    64-position tile, G <= 8, and a shared-memory plan of two blocks an SM
    (4 warps x stages x 32 rows of 2d bytes)."""
    text = (_CSRC / "decode_attention.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (DA_\w+) = (\d+);", text))
    assert int(consts["DA_WARPS"]) == _WARPS
    assert int(consts["DA_TILE"]) == _TILE == tattn.DECODE_TILE
    assert int(consts["DA_MAXG"]) == 8
    assert int(consts["DA_MAX_SPLITS"]) == tattn.DECODE_MAX_SPLITS
    stages = int(consts["DA_STAGES"])
    for d in (64, 128):
        plan = _WARPS * stages * 2 * _WP * 2 * d + 128
        assert 2 * (plan + 1024) <= 233472
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in text
    assert "cp.async.commit_group" in text and "atomicAdd" in text
