"""The KV write on the CPU: the flat, headed and paged appends of
petit_kernel_tpu_torch (ops/kernels/attention.py kv_append,
kv_append_headed, kv_append_paged, their plain twins, and the two callers
models/llama.py and models/paged.py _write_kv) against petit_kernel_tpu on
the same numpy-seeded inputs, and the append body (csrc/kv_append.cu)
played in Python on host memory.

- Parity: cache bytes bit for bit. The JAX references are the flat and
  headed kv_append kernels (Pallas interpret mode) for one token, the chunk
  write of petit_kernel_tpu/models/llama.py's attention (a vmapped
  dynamic_update_slice of quantize_kv, masked rows restored) for T > 1, and
  petit_kernel_tpu/models/paged.py _write_kv (an XLA scatter) for pages.
  K and V are strided views of one fused qkv tensor, as the Llama block
  makes them. A masked paged row writes the scratch page; with T > 1 which
  token lands there is unordered in the JAX package, so the scratch page
  is left out there.
- The fp8 rounding: every one of the 65,536 bf16 bit patterns through
  quantize_kv in both packages, and through a numpy model of the kernel's
  rounding (the hardware's saturating round to nearest even, then the
  lanes past 464 patched by c10's rule) in both of its overflow rules.
- The body: the wrappers' launch helpers run with a stand-in library whose
  entries play csrc/kv_append.cu's launch_append and kv_append_kernel on
  the tensors' memory, word by word, with the arguments the C source names;
  the cache bytes equal the twin's.

The kernel itself runs on the card: tests/test_torch_cuda.py.
"""

import ctypes
import re
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from petit_kernel_tpu.models import paged as jpaged
from petit_kernel_tpu.ops.kernels import attention as jattn
from petit_kernel_tpu_torch.models import llama as tllama
from petit_kernel_tpu_torch.models import paged as tpaged
from petit_kernel_tpu_torch.ops import _build
from petit_kernel_tpu_torch.ops.kernels import attention as tattn

# xdist workers share the host's cores: one torch thread each keeps
# the port's CPU ops from oversubscribing them
torch.set_num_threads(1)

FP8 = torch.float8_e4m3fn
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "fp8": (jnp.float8_e4m3fn, FP8)}
NQ = 4                    # query heads beside K and V in the fused tensor
MASKS = {"none": None, "all": (1, 1, 1), "mixed": (1, 0, 1)}


def _fused_kv(rng, B, T, hkv, d):
    """New K and V (B, T, hkv, d): numpy bf16 arrays for JAX, and the same
    values as strided views of one fused qkv tensor (B, T, (NQ + 2 hkv) d)
    for the port (models/llama.py _qkv's slices)."""
    s0, s1 = NQ * d, (NQ + hkv) * d
    raw = rng.standard_normal((B, T, s1 + hkv * d), dtype=np.float32).astype(
        ml_dtypes.bfloat16)
    qkv = torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
    npy = (np.ascontiguousarray(raw[..., s0:s1]).reshape(B, T, hkv, d),
           np.ascontiguousarray(raw[..., s1:]).reshape(B, T, hkv, d))
    views = (qkv[..., s0:s1].reshape(B, T, hkv, d),
             qkv[..., s1:].reshape(B, T, hkv, d))
    assert not views[1].is_contiguous()
    return npy, views


def _raw_cache(rng, shape, dtype):
    """Random cache bytes without NaN patterns, as numpy bits."""
    fp8 = dtype == "fp8"
    raw = rng.integers(0, 2 ** (8 if fp8 else 16), size=shape,
                       dtype=np.uint8 if fp8 else np.uint16)
    nan = 0x7F if fp8 else 0x7F80
    return np.where((raw & nan) == nan, 0, raw).astype(raw.dtype)


def _jax_array(raw, dtype):
    return jnp.asarray(raw.view(DTYPES[dtype][0]))


def _torch_tensor(raw, dtype):
    t = torch.from_numpy(raw.copy().view(np.uint8 if dtype == "fp8"
                                         else np.int16))
    return t.view(DTYPES[dtype][1])


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return tattn._bits(x).numpy()
    x = np.asarray(x)
    return x.view(np.uint8 if x.dtype.itemsize == 1 else np.int16)


def _port_mask(mask, kind):
    """The mask as the port receives it: the engine's bool, or int32."""
    if mask is None:
        return None
    return torch.tensor(mask, dtype=torch.int32 if kind == "all"
                        else torch.bool)


def _jax_chunk_write(c, new, pos0, keep, headed):
    """The JAX package's chunk write (petit_kernel_tpu/models/llama.py,
    attention with a cache and T > 1): quantize_kv(new) written at pos[:, 0]
    with a vmapped dynamic_update_slice, masked rows restored."""
    kw = new.transpose(0, 2, 1, 3) if headed else new
    at = (0, 1, 0) if headed else (1, 0, 0)

    def start(s):
        return tuple(s if a else 0 for a in at)

    def upd1(c1, n1, s, a):
        old = jax.lax.dynamic_slice(c1, start(s), n1.shape)
        return jax.lax.dynamic_update_slice(c1, jnp.where(a, n1, old),
                                            start(s))

    return jax.vmap(upd1)(c, jattn.quantize_kv(kw, c.dtype), pos0, keep)


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("dtype", ["bf16", "fp8"])
@pytest.mark.parametrize("layout", ["flat", "headed"])
def test_cache_write_matches_jax(layout, dtype, T, mask, pos_dtype):
    """kv_append (flat, or headed=True), its twin and llama._write_kv write
    the bytes the JAX package writes: its append kernel for one token, its
    chunk write for five."""
    B, S, hkv, d = 3, 32, 2, 64
    headed = layout == "headed"
    rng = np.random.default_rng(T + 2 * (dtype == "fp8") + 4 * headed)
    shape = (B, hkv, S, d) if headed else (B, S, hkv, d)
    caches = [_raw_cache(rng, shape, dtype) for _ in range(2)]
    (kn, vn), (kt, vt) = _fused_kv(rng, B, T, hkv, d)
    pos0 = np.array([0, 11, S - T], np.int32)
    pos = pos0[:, None] + np.arange(T, dtype=np.int32)
    m = MASKS[mask]
    jk, jv = (_jax_array(c, dtype) for c in caches)
    if T == 1:
        want = jattn.kv_append(
            jk, jv, jnp.asarray(kn[:, 0]), jnp.asarray(vn[:, 0]),
            jnp.asarray(pos0), None if m is None else jnp.asarray(m),
            headed=headed, interpret=True)
    else:
        keep = jnp.asarray(np.ones(B, bool) if m is None else np.array(m) > 0)
        want = [_jax_chunk_write(c, jnp.asarray(n), jnp.asarray(pos0), keep,
                                 headed) for c, n in ((jk, kn), (jv, vn))]
    pos_t = torch.from_numpy(pos).to(pos_dtype)
    mask_t = _port_mask(m, mask)
    twin = tattn.kv_append_headed_reference if headed \
        else tattn.kv_append_reference
    one = (kt[:, 0], vt[:, 0], pos_t[:, 0]) if T == 1 else (kt, vt, pos_t)
    for write in (
            lambda c: twin(*c, *one, mask_t),
            lambda c: tattn.kv_append(*c, *one, mask_t, headed=headed),
            lambda c: tllama._write_kv(*c, kt, vt, pos_t, mask_t, headed)):
        got = [_torch_tensor(c, dtype) for c in caches]
        write(got)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_bytes(g), _bytes(w))


def _pools(rng, dtype, P=9, hkv=2, ps=8, d=64):
    """A pool pair's bytes and block tables: row 0 on pages 3, 0, 7, row 1
    on 5, 1, row 2 on 2, 6, 4; the rest of each row (and page 8, the
    scratch page) untouched."""
    pools = [_raw_cache(rng, (P, hkv, ps, d), dtype) for _ in range(2)]
    bt = np.full((3, 4), P - 1, np.int32)
    for row, pages in enumerate(((3, 0, 7), (5, 1), (2, 6, 4))):
        bt[row, :len(pages)] = pages
    return pools, bt


@pytest.mark.parametrize("pos_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("dtype", ["bf16", "fp8"])
def test_pool_write_matches_jax(dtype, T, mask, pos_dtype):
    """kv_append_paged, its twin and paged._write_kv write the bytes of the
    JAX package's paged._write_kv, chunks crossing pages included."""
    B, hkv, ps, d = 3, 2, 8, 64
    rng = np.random.default_rng(10 + T + 2 * (dtype == "fp8"))
    pools, bt = _pools(rng, dtype, hkv=hkv, ps=ps, d=d)
    (kn, vn), (kt, vt) = _fused_kv(rng, B, T, hkv, d)
    pos = np.array([[5], [14], [19]], np.int32) + np.arange(T, dtype=np.int32)
    m = MASKS[mask]
    want = jpaged._write_kv(
        tuple(_jax_array(p, dtype) for p in pools), jnp.asarray(bt),
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos), ps,
        write_mask=None if m is None else jnp.asarray(np.array(m) > 0))
    pos_t = torch.from_numpy(pos).to(pos_dtype)
    mask_t = _port_mask(m, mask)
    bt_t = torch.from_numpy(bt)
    one = (kt[:, 0], vt[:, 0], pos_t[:, 0]) if T == 1 else (kt, vt, pos_t)
    keep = slice(None) if T == 1 or m is None or all(m) else slice(0, -1)
    for write in (
            lambda c: tattn.kv_append_paged_reference(*c, bt_t, *one, ps,
                                                      mask_t),
            lambda c: tattn.kv_append_paged(*c, bt_t, *one, ps, mask_t),
            lambda c: tpaged._write_kv(c, bt_t, kt, vt, pos_t, ps, mask_t)):
        got = [_torch_tensor(p, dtype) for p in pools]
        write(got)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_bytes(g)[keep], _bytes(w)[keep])


# ---------------------------------------------------------------------------
# the fp8 rounding
# ---------------------------------------------------------------------------

_BF16_BITS = np.arange(1 << 16, dtype=np.uint32)


def _fp8_model(h: np.ndarray, saturate: bool) -> np.ndarray:
    """csrc/kv_append.cu fp8x4 on an array of bf16 bit patterns: the
    round to nearest even with saturation of cvt.rn.satfinite (here c10's
    integer arithmetic, fp8e4m3fn_from_fp32_value, in its saturating form,
    which the hardware's rounding equals on every input that is not NaN),
    then the lanes past 464 set by c10's rule: NaN with the sign, or +-448
    where saturate."""
    with np.errstate(invalid="ignore"):
        r = _satfinite(h)
    mag = h.astype(np.uint32) & 0x7FFF
    sign = ((h.astype(np.uint32) >> 8) & 0x80).astype(np.uint8)
    top = np.where((mag > 0x7F80) | (not saturate), 0x7F, 0x7E)
    return np.where(mag > 0x43E8, top.astype(np.uint8) | sign, r)


def _satfinite(h: np.ndarray) -> np.ndarray:
    f = h.astype(np.uint32) << np.uint32(16)
    sign = f & np.uint32(0x80000000)
    f = f ^ sign
    denorm = np.uint32(141 << 23)
    sub = ((f.view(np.float32) + denorm.view(np.float32)).view(np.uint32)
           - denorm)
    norm = (f + np.uint32((7 - 127) % (1 << 9) << 23) + np.uint32(0x7FFFF)
            + ((f >> np.uint32(20)) & np.uint32(1))) >> np.uint32(20)
    r = np.where(f >= (1087 << 20), 0x7E,
                 np.where(f < (121 << 23), sub, np.minimum(norm, 0x7E)))
    return (r.astype(np.uint32) | (sign >> np.uint32(24))).astype(np.uint8)


def _is_nan8(b: np.ndarray) -> np.ndarray:
    return (b & 0x7F) == 0x7F


def _bf16_all():
    return torch.from_numpy(_BF16_BITS.astype(np.uint16).view(np.int16)
                            ).view(torch.bfloat16)


def test_fp8_cast_of_every_bf16_pattern_against_jax():
    """quantize_kv to fp8 in both packages over all 65,536 bf16 patterns:
    NaN as NaN, every input of magnitude at most 464 bit for bit. Past 464
    (and at inf) the JAX package gives NaN with the sign; the port gives
    what the installed torch's cast gives, NaN with the sign or +-448
    (fp8_saturates), and its kernel follows it (ROADMAP.md section 3)."""
    x = _BF16_BITS.astype(np.uint16).view(ml_dtypes.bfloat16)
    want = np.asarray(jattn.quantize_kv(jnp.asarray(x), jnp.float8_e4m3fn)
                      ).view(np.uint8)
    got = tattn.quantize_kv(_bf16_all(), FP8).view(torch.uint8).numpy()
    f = x.astype(np.float32)
    nan = np.isnan(f)
    over = ~nan & (np.abs(f) > 464)
    assert _is_nan8(got[nan]).all() and _is_nan8(want[nan]).all()
    same = ~nan & ~over
    np.testing.assert_array_equal(got[same], want[same])
    sign = ((_BF16_BITS >> 8) & 0x80).astype(np.uint8)
    np.testing.assert_array_equal(want[over], 0x7F | sign[over])
    top = 0x7E if tattn.fp8_saturates() else 0x7F
    np.testing.assert_array_equal(got[over], top | sign[over])
    assert over.sum() == 2 * (0x7F80 - 0x43E8)      # 466 up to inf, both signs


def test_kernel_fp8_rounding_is_torch_and_jax_on_every_bf16_pattern():
    """The kernel's rounding, in the installed torch's overflow rule,
    equals torch's cast bit for bit (NaN signs included) on all 65,536
    patterns; in the other rule it equals the other implementation: JAX's
    cast (NaN as NaN) when torch saturates, and torch's saturating c10 rule
    checked lane by lane otherwise."""
    sat = tattn.fp8_saturates()
    torch_bits = _bf16_all().to(FP8).view(torch.uint8).numpy()
    np.testing.assert_array_equal(_fp8_model(_BF16_BITS, sat), torch_bits)
    other = _fp8_model(_BF16_BITS, not sat)
    x = _BF16_BITS.astype(np.uint16).view(ml_dtypes.bfloat16)
    jax_bits = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)
                          ).view(np.uint8)
    if sat:
        nan = np.isnan(x.astype(np.float32))
        np.testing.assert_array_equal(other[~nan], jax_bits[~nan])
        assert _is_nan8(other[nan]).all()
    else:
        over = _is_nan8(torch_bits) & ~np.isnan(x.astype(np.float32))
        np.testing.assert_array_equal(other[~over], torch_bits[~over])
        np.testing.assert_array_equal(other[over] & 0x7F, 0x7E)


# ---------------------------------------------------------------------------
# the C entries and the body, played
# ---------------------------------------------------------------------------

_SRC = (_build.CSRC / "kv_append.cu").read_text()
_CTYPES = {"void*": ctypes.c_void_p, "const void*": ctypes.c_void_p,
           "int": ctypes.c_int, "long long": ctypes.c_longlong}
ENTRIES = ("pk_kv_append", "pk_kv_append_headed", "pk_kv_append_paged")


def _params(entry):
    """(type, name) of each parameter of extern "C" entry `entry`."""
    m = re.search(rf'extern "C" int {entry}\(([^)]*)\)', _SRC)
    return [(re.sub(r"\s*\**\w+$", "", p.strip()).replace(" *", "*"),
             p.split()[-1].lstrip("*")) for p in m[1].split(",")]


@pytest.mark.parametrize("entry", ENTRIES)
def test_c_entries_match_the_build_signatures(entry):
    """Each entry's C parameter types, in order, are the ctypes types
    ops/_build.py declares; the three share the new rows', positions' and
    mask's arguments and end in launch_append, the one launch site."""
    params = _params(entry)
    assert tuple(_CTYPES[t] for t, _ in params) == _build.SIGNATURES[entry]
    names = [n for _, n in params]
    flat = [n for _, n in _params("pk_kv_append")]
    assert names[-16:] == flat[-16:]
    assert names[-14:-10] == ["elt", "cast", "k_sb", "k_st"]
    body = _SRC[_SRC.index(f'extern "C" int {entry}('):]
    body = body[:body.index("\n}\n")]
    assert "return launch_append(a, B, d, elt, cast," in body
    assert _SRC.count("<<<") == 2                 # the two CAST instances
    assert _SRC.index("<<<") > _SRC.index("int launch_append(")


def _read_int(addr: int, nbytes: int) -> int:
    return {1: ctypes.c_uint8, 4: ctypes.c_int32,
            8: ctypes.c_int64}[nbytes].from_address(addr).value


def _play(entry: str, a: dict) -> int:
    """csrc/kv_append.cu on host memory: the entry's layout, launch_append's
    checks, then kv_append_kernel for every (t, b) CTA and every thread's
    unit of a head's K and V rows, in the source's index arithmetic."""
    B, T, Hkv, d = a["B"], a["T"], a["Hkv"], a["d"]
    elt, cast = a["elt"], a["cast"]
    if entry == "pk_kv_append_paged":
        ck, cv, table = a["kp"], a["vp"], a["table"]
        ps, pages = a["ps"], a["P"]
        page_stride, head_stride, row_stride = Hkv * ps * d, ps * d, d
    else:
        ck, cv, table, ps, pages = a["ck"], a["cv"], None, a["S"], 0
        page_stride, head_stride, row_stride = (
            (Hkv * ps * d, ps * d, d) if entry == "pk_kv_append_headed"
            else (ps * Hkv * d, d, Hkv * d))
    if B <= 0 or T <= 0:
        return 0
    assert cast in (0, 1, 2) and (cast == 0 or elt == 1) and elt in (1, 2)
    assert (d * elt) % 16 == 0 and a["pos_bytes"] in (4, 8)
    assert a["mask"] is None or a["mask_bytes"] in (1, 4)
    src_elt = 2 if cast else elt
    unit = 8 if cast else 16              # a thread's cache bytes
    row_words = d * elt // unit
    assert all(x % 16 == 0 for x in (ck, cv, a["kn"], a["vn"]))
    assert all(a[s] * src_elt % 16 == 0 for s in (
        "k_sb", "k_st", "k_sh", "v_sb", "v_st", "v_sh"))
    for b in range(B):
        for t in range(T):
            ip = b * a["pos_sb"] + t * a["pos_st"]
            p = _read_int(a["pos"] + ip * a["pos_bytes"], a["pos_bytes"])
            keep = a["mask"] is None or _read_int(
                a["mask"] + b * a["mask_sb"] * a["mask_bytes"],
                a["mask_bytes"]) != 0
            if table is None:
                if not keep or p < 0 or p >= ps:
                    continue
                page, off = b, p
            elif keep:
                if p < 0 or p // ps >= a["max_pages"]:
                    continue
                page = _read_int(table + 4 * (b * a["table_sb"] + p // ps), 4)
                if page < 0 or page >= pages:
                    continue
                off = p % ps
            else:
                if t != T - 1:
                    continue
                page, off = pages - 1, 0
            dst0 = (page * page_stride + off * row_stride) * elt
            for u in range(Hkv * row_words):
                h, w = divmod(u, row_words)
                for x, cache in (("k", ck), ("v", cv)):
                    src = (b * a[x + "_sb"] + t * a[x + "_st"]
                           + h * a[x + "_sh"])
                    x16 = ctypes.string_at(
                        a[x + "n"] + src * src_elt + 16 * w, 16)
                    word = (_fp8_model(np.frombuffer(x16, np.uint16),
                                       cast == 2).tobytes() if cast else x16)
                    ctypes.memmove(cache + dst0 + h * head_stride * elt
                                   + unit * w, word, unit)
    return 0


class _Library:
    """Stands in for the built library: each pk_kv_append* entry binds its
    arguments to the C source's parameter names and plays the body."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        names = [n for _, n in _params(entry)]

        def launch(*args):
            assert len(args) == len(names)
            a = dict(zip(names, args))
            self.calls.append((entry, a))
            return _play(entry, a)
        return launch


@pytest.fixture
def library(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return lib


ROWS = {"bf16 copy": (torch.bfloat16, torch.bfloat16),
        "bf16 to fp8": (torch.bfloat16, FP8),
        "fp8 copy": (FP8, FP8),
        "f32 to fp8": (torch.float32, FP8)}
MASK_KINDS = ("none", "bool", "uint8", "int32")


def _new_rows(rng, B, T, hkv, d, dtype, misaligned):
    """K and V of `dtype`: fused views (bf16), or contiguous tensors, or, with
    misaligned, views one element off a 16-byte boundary."""
    if dtype == torch.bfloat16 and not misaligned:
        return _fused_kv(rng, B, T, hkv, d)[1]
    out = []
    for _ in range(2):
        x = torch.from_numpy(rng.standard_normal(B * T * hkv * d + 1,
                                                 dtype=np.float32)).to(dtype)
        x = x[1:] if misaligned else x[:-1]
        out.append(x.reshape(B, T, hkv, d))
    return out


@pytest.mark.parametrize("mask_kind", MASK_KINDS)
@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("rows", sorted(ROWS))
@pytest.mark.parametrize("layout", ["flat", "headed", "paged"])
def test_body_played_equals_the_twin(library, layout, rows, T, mask_kind):
    """The launch helpers the wrappers call, with the stand-in library:
    the body played on the tensors' memory leaves the cache bytes of the
    twin. Masks of each accepted dtype, int32 and int64 positions,
    positions outside the cache or past the block table's width, fused
    views read in place (the kn and vn pointers are the views'), misaligned
    views copied."""
    src, cache = ROWS[rows]
    B, hkv, d, S, ps = 3, 2, 64, 24, 8
    misaligned = mask_kind == "uint8"
    rng = np.random.default_rng(len(rows) + T + 7 * len(layout))
    k, v = _new_rows(rng, B, T, hkv, d, src, misaligned)
    pos = torch.tensor([[0], [9], [S - T]]) + torch.arange(T)
    if T > 1:
        pos[1, 2] = -1                        # writes nothing
        pos[2, 3] = S + 40                    # past S, past the table
    pos = pos.to(torch.int64 if T > 1 else torch.int32)
    mask = None if mask_kind == "none" else torch.tensor(
        [1, 0, 1], dtype={"bool": torch.bool, "uint8": torch.uint8,
                          "int32": torch.int32}[mask_kind])
    if layout == "paged":
        P = 12
        shape = (P, hkv, ps, d)
        bt = torch.tensor([[3, 0, 7, 11], [5, 1, 9, 11], [2, 6, 4, 8]],
                          dtype=torch.int32)
    else:
        shape = (B, S, hkv, d) if layout == "flat" else (B, hkv, S, d)
    elt = 1 if cache == FP8 else 2
    raw = [torch.from_numpy(rng.integers(
        0, 256, size=(*shape[:-1], shape[-1] * elt), dtype=np.uint8).view(
            np.uint8 if elt == 1 else np.int16)).view(cache)
        for _ in range(2)]
    want = [c.clone() for c in raw]
    got = [c.clone() for c in raw]
    if layout == "paged":
        tattn.kv_append_paged_reference(*want, bt, k, v, pos, ps, mask)
        launched = tattn._launch_pool(*got, bt, k, v, pos, mask)
    else:
        twin = (tattn.kv_append_reference if layout == "flat"
                else tattn.kv_append_headed_reference)
        twin(*want, k, v, pos, mask)
        entry = ("pk_kv_append" if layout == "flat"
                 else "pk_kv_append_headed")
        launched = tattn._launch_cache(layout, entry, *got, k, v, pos, mask,
                                       S)
    assert launched and len(library.calls) == 1
    entry, a = library.calls[0]
    assert a["cast"] == (0 if src != torch.bfloat16 or cache != FP8
                         else 1 + tattn.fp8_saturates())
    if src == cache and not misaligned:
        assert (a["kn"], a["vn"]) == (k.data_ptr(), v.data_ptr())
    for g, w, r in zip(got, want, raw):
        np.testing.assert_array_equal(_bytes(g), _bytes(w))
        assert not np.array_equal(_bytes(g), _bytes(r))


def test_empty_chunk_launches_nothing(library):
    """A chunk of no tokens returns without a launch (and the wrappers
    count none)."""
    ck = torch.zeros((2, 16, 2, 64), dtype=torch.bfloat16)
    k = torch.zeros((2, 0, 2, 64), dtype=torch.bfloat16)
    pos = torch.zeros((2, 0), dtype=torch.int32)
    assert not tattn._launch_cache("kv_append", "pk_kv_append", ck, ck, k, k,
                                   pos, None, 16)
    assert library.calls == []


@pytest.mark.parametrize("bad", ["pos dtype", "table dtype", "cache dtype",
                                 "shape", "mask shape"])
def test_kernel_path_raises_on_what_it_does_not_take(library, bad):
    """The launch helpers raise (before any launch) on float positions,
    int64 block tables and f32 caches; the wrappers raise on chunk and mask
    shapes that do not fit the cache."""
    kp = torch.zeros((5, 2, 8, 64), dtype=torch.bfloat16)
    k = torch.zeros((2, 1, 2, 64), dtype=torch.bfloat16)
    pos = torch.zeros((2, 1), dtype=torch.int32)
    bt = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        if bad == "pos dtype":
            tattn._launch_pool(kp, kp, bt, k, k, pos.float(), None)
        elif bad == "table dtype":
            tattn._launch_pool(kp, kp, bt.long(), k, k, pos, None)
        elif bad == "cache dtype":
            tattn._launch_pool(kp.float(), kp.float(), bt, k, k, pos, None)
        elif bad == "shape":
            tattn.kv_append_paged(kp, kp, bt, k[:, :, :1], k, pos, 8)
        else:
            tattn.kv_append(torch.zeros((2, 16, 2, 64)),
                            torch.zeros((2, 16, 2, 64)), k, k, pos,
                            torch.ones(3, dtype=torch.bool))
    assert library.calls == []
