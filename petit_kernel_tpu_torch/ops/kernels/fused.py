"""Fused FP4-dequant + GEMM: the CUDA kernels' wrappers and their plain
twins.

Counterpart of petit_kernel_tpu/ops/kernels/fused.py: fused_mul (bf16
activations; f32 ones for a high-precision solution), fused_mul_w4a8 (W4A8:
int8 activations, the FP4 weights requantized to int8 in the kernel) and
dequant_tpu_layout (the weights to a bf16 matrix, for the backward pass of
gemm.mul_fp4_diff). Seven kernels, one wrapper each, each with its own
launch count:

  fused_mul          csrc/fp4_gemm.cu pk_fp4_gemm (bf16: split-k 16-row
                     tiles on the stream body, csrc/fp4_stream.cuh; wgmma
                     64-row tiles, csrc/fp4_wgmma.cuh)
  fused_mul_wc       csrc/fp4_gemm.cu pk_fp4_gemm_wc (weight cache, 4
                     m-tiles a CTA: split-k 16-row tiles on the stream
                     body, 64-row tiles on csrc/fp4_wgmma.cuh)
  fused_mul_hp       csrc/fp4_gemm_hp.cu pk_fp4_gemm_hp (f32 A, three bf16
                     MMAs per fragment, f32 out: split-k 16-row tiles on
                     the stream body's f32 form, csrc/fp4_stream.cuh)
  fused_mul_hp_wc    csrc/fp4_gemm_hp.cu pk_fp4_gemm_hp_wc (weight cache,
                     2 m-tiles a CTA, on the same two bodies)
  fused_mul_w4a8     csrc/fp4_gemm_w4a8.cu pk_fp4_gemm_w4a8 (64-row tiles:
                     int8 wgmma, csrc/w4a8_wgmma.cuh; 16-row tiles: the
                     split-k int8 stream body, csrc/w4a8_stream.cuh)
  fused_mul_w4a8_wc  csrc/fp4_gemm_w4a8.cu pk_fp4_gemm_w4a8_wc (the same
                     two bodies, 4 m-tiles a CTA)
  dequant_tpu_layout csrc/fp4_dequant.cu pk_fp4_dequant

fused_mul hands a high_precision solution id to fused_mul_hp (or
fused_mul_hp_wc), and fused_mul and fused_mul_w4a8 hand a weight_cache id
to their _wc wrapper, as the JAX package's fused_mul picks its kernel body.
fused_mul_reference, fused_mul_hp_reference, fused_mul_w4a8_reference and
dequant_tpu_layout_reference are the same functions in plain PyTorch; a
wrapper takes its twin only for tensors on the CPU, and for CUDA tensors
it launches its kernel or raises.

The 16-row tiles of fused_mul, fused_mul_wc, fused_mul_hp and
fused_mul_hp_wc, of hybrid_mul (kernels/hybrid.py), of grouped_mul
(kernels/grouped.py) and of fused_mul_w4a8 cut each output tile's k range
over several CTAs: stream_splits is the rule for all of them
(fp4_wc_splits, hp_splits and w4a8_splits count the CTAs of m-groups and
the CTAs an SM their plan allows), and one buffer of split counters per
(device, stream) serves them all (_counters).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import _build
from .. import layout
from ..solution import ElementB, SolutionId


def fused_mul_reference(a: torch.Tensor, words: torch.Tensor,
                        scales_t: torch.Tensor, global_scale: torch.Tensor,
                        *, sid: SolutionId) -> torch.Tensor:
    """Plain PyTorch fused_mul: bf16((a @ dequant(words, scales)) * gs).

    Value times scale is exact in bf16 (a 2-bit by a 4-bit significand), so
    the f32 dequant holds the numbers of the kernel's bf16 B tile; the
    products are exact in f32, and the f32 matmul sums them, as the
    kernel's f32 accumulators do (in another order)."""
    del sid  # one decode serves every scale path and both kernel structures
    b = layout.dequant_from_tpu_layout(words, scales_t, words.shape[1],
                                       a.shape[1])
    acc = a.to(torch.bfloat16).float() @ b
    return (acc * global_scale.float()).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# Split-k of the 16-row (decode) tiles, csrc/fp4_stream.cuh: fused_mul's,
# hybrid_mul's and grouped_mul's
# ---------------------------------------------------------------------------

KSTEP = 256                 # natural k per step of the kernels
STREAM_BLOCK_M = 16         # the tiles that split k
# bytes a CTA streams per weight: FP4 a 4-bit value and a bf16 scale per 16
# k; dense a bf16
FP4_BYTES_PER_WEIGHT = 0.625
DENSE_BYTES_PER_WEIGHT = 2.0


@functools.lru_cache(maxsize=4096)
def stream_splits(m: int, nf: int, nd: int, kp: int, block_m: int,
                  block_n: int, num_sms: int,
                  per_sm: int = 2) -> tuple[int, int]:
    """(splits of an FP4 tile's k, splits of a dense tile's k) for a launch
    of nf FP4 columns (fused_mul: all n; hybrid_mul: its FP4 columns) and
    nd dense bf16 columns (fused_mul: 0): 1 and 1 for block_m = 64, whose
    tiles do not split. Split s of S covers the 256-deep steps
    [s * steps // S, (s + 1) * steps // S) of its tile.

    At block_m = 16 a CTA streams about the bytes of its k range, so the
    two kinds are balanced by bytes: a dense tile moves 2 / 0.625 = 3.2
    times an FP4 tile's bytes per step and takes round(3.2 * sf) splits
    (at most one per step) beside the FP4 tiles' sf. The stream body is
    bound per SM (on the H100 one CTA streams about 7.5 GB/s, two on one
    SM about 8.7), so what counts is the most work any SM gets: sf is the
    largest count whose CTAs fit one wave of `per_sm` CTAs an SM (what the
    kernel's shared-memory plan allows: two for these tiles, 2 * num_sms
    slots), and 1 where even one split does not fit. A launch past one
    wave leaves a tail (wo and w_down at 5 splits: 320 CTAs on 264 slots);
    one that fits gives each SM one or two CTAs of equal depth."""
    if block_m != STREAM_BLOCK_M:
        return 1, 1
    steps = kp // KSTEP
    m_tiles = -(-m // block_m)
    f_tiles, d_tiles = -(-nf // block_n), -(-nd // block_n)
    ratio = DENSE_BYTES_PER_WEIGHT / FP4_BYTES_PER_WEIGHT
    best = None
    for sf in range(1, steps + 1):
        sd = min(steps, max(1, round(sf * ratio)))
        if best and m_tiles * (f_tiles * sf + d_tiles * sd) > per_sm * num_sms:
            break
        best = sf, sd
    return best


def _check_splits(where: str, splits, kp: int, splittable: bool) -> int:
    """An explicit k-split count, or ValueError: an int in [1, kp / 256],
    above 1 only for tiles that split (`splittable`)."""
    steps = kp // KSTEP
    if not isinstance(splits, int) or not 1 <= splits <= steps:
        raise ValueError(f"{where}: splits must be an int in [1, {steps}] "
                         f"(kp / {KSTEP}), got {splits!r}")
    if not splittable and splits != 1:
        raise ValueError(f"{where}: these tiles do not split k (only the "
                         f"16-row tiles do), got splits {splits!r}")
    return splits


# m-tiles a CTA of the weight-cache kernels (csrc/fp4_gemm.cuh WC_GROUP)
WC_GROUP = 4
# CTAs an SM of the FP4 weight cache's 16-row tiles by block_n: their
# two-stage rings of 16 * WC_GROUP A rows (csrc/fp4_stream.cuh FsPlan)
FP4_WC_PER_SM = {64: 2, 128: 1}


def _group_splits(m: int, n: int, kp: int, sid: SolutionId, num_sms: int,
                  group: int, per_sm: int) -> int:
    """stream_splits over the CTAs of a launch whose CTAs run `group`
    m-tiles of 16 rows (ceil(m / 16 group) m-groups), `per_sm` CTAs an SM;
    1 for block_m = 64."""
    if sid.block_m != STREAM_BLOCK_M:
        return 1
    return stream_splits(-(-m // (STREAM_BLOCK_M * group)) * STREAM_BLOCK_M,
                         n, 0, kp, STREAM_BLOCK_M, sid.block_n, num_sms,
                         per_sm)[0]


def fp4_wc_splits(m: int, n: int, kp: int, sid: SolutionId,
                  num_sms: int) -> int:
    """k-splits of fused_mul_wc's tiles: the 16-row ones run ceil(m / 64)
    m-groups of WC_GROUP tiles, FP4_WC_PER_SM CTAs an SM; the 64-row ones
    take 1."""
    return _group_splits(m, n, kp, sid, num_sms, WC_GROUP,
                         FP4_WC_PER_SM[sid.block_n])


# m-tiles a CTA of the high-precision weight cache (csrc/fp4_gemm.cuh
# HP_WC_GROUP)
HP_WC_GROUP = 2
# CTAs an SM of the high-precision 16-row tiles by (block_n, m-tiles a
# CTA): their rings of f32 A rows (csrc/fp4_stream.cuh HpPlan)
HP_PER_SM = {(64, 1): 2, (128, 1): 2, (64, HP_WC_GROUP): 2,
             (128, HP_WC_GROUP): 1}


def hp_splits(m: int, n: int, kp: int, sid: SolutionId,
              num_sms: int) -> int:
    """k-splits of fused_mul_hp's and fused_mul_hp_wc's tiles: the 16-row
    ones have ceil(m / 16) m-tiles, the weight cache's ceil(m / 32)
    m-groups of HP_WC_GROUP tiles a CTA, HP_PER_SM CTAs an SM; the 64-row
    ones take 1."""
    group = HP_WC_GROUP if sid.weight_cache else 1
    return _group_splits(m, n, kp, sid, num_sms, group,
                         HP_PER_SM[sid.block_n, group])


def w4a8_splits(m: int, n: int, kp: int, sid: SolutionId,
                num_sms: int) -> int:
    """k-splits of fused_mul_w4a8's tiles: the plain 16-row tiles have
    ceil(m / 16) m-tiles, the weight cache's ceil(m / 64) m-groups of
    WC_GROUP tiles a CTA, two CTAs an SM; both stream 0.625 bytes a
    weight, as fused_mul's do. The 64-row tiles take 1."""
    return _group_splits(m, n, kp, sid, num_sms,
                         WC_GROUP if sid.weight_cache else 1, 2)


@functools.cache
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# per (device, stream): the split counters of the 16-row stream kernels,
# zero between launches (the last CTA of each tile resets its own); launches
# on one stream run in order, so fused_mul, hybrid_mul and grouped_mul
# share them
_COUNTERS: dict = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def _check(where: str, a, words, scales_t, global_scale, *extra):
    """The kernels' operand contract; returns kp. `extra` holds further
    (name, tensor, dtype, shape) operands."""
    m, k = a.shape
    kw, n = words.shape
    kp = kw * 8
    for name, t in (("words", words), ("scales_t", scales_t),
                    ("global_scale", global_scale),
                    *((e[0], e[1]) for e in extra)):
        if t.device != a.device:
            raise ValueError(f"{where}: {name} is on {t.device}, a on "
                             f"{a.device}")
    if words.dtype != torch.int32 or scales_t.dtype != torch.bfloat16 \
            or global_scale.dtype != torch.float32:
        raise ValueError(f"{where}: words int32, scales bf16, global_scale "
                         "f32 expected")
    if tuple(scales_t.shape) != (kp // 16, n) or kp < k or k % 128 \
            or kp % 256 or n % 16 or global_scale.numel() != 1:
        raise ValueError(f"{where}: bad shapes a {tuple(a.shape)}, words "
                         f"{tuple(words.shape)}, scales "
                         f"{tuple(scales_t.shape)}")
    for name, t, dtype, shape in extra:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{where}: {name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    return kp


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous at a 16-byte boundary: the kernels copy their operands
    in 16-byte pieces, so a view at another offset is cloned."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _launch(entry: str, *args) -> None:
    code = getattr(_build.library(), entry)(*args)
    _build.check(entry, code)


def _fused_mul_cuda(entry: str, a, words, scales_t, global_scale, sid,
                    dtype=torch.bfloat16, splits=1, group=1):
    """Launch `entry` on A of `dtype` (bf16, f32 for the high-precision
    kernels) into an output of the same dtype, with the k-split count, its
    workspace and the split counters, for CTAs of `group` m-tiles."""
    if a.device.type != "cuda":
        raise ValueError(f"{entry}: unsupported device {a.device}")
    if a.dtype != dtype:
        raise ValueError(f"{entry}: a must be {dtype}, got {a.dtype}")
    kp = _check(entry, a, words, scales_t, global_scale)
    m, k = a.shape
    n = words.shape[1]
    # the kernels copy A, the words and the scales in 16-byte pieces
    a, words, scales_t = _aligned(a), _aligned(words), _aligned(scales_t)
    out = torch.empty((m, n), dtype=dtype, device=a.device)
    if m == 0 or n == 0:
        return out, False
    stream = torch.cuda.current_stream(a.device).cuda_stream
    ws_ptr = cnt_ptr = None
    if splits > 1:
        rows = sid.block_m * group
        tiles = -(-m // rows) * -(-n // sid.block_n)
        ws = torch.empty(tiles * splits * rows * sid.block_n,
                         dtype=torch.float32, device=a.device)
        ws_ptr = ws.data_ptr()
        cnt_ptr = _counters(a.device, stream, tiles).data_ptr()
    _launch(entry, a.data_ptr(), words.data_ptr(), scales_t.data_ptr(),
            global_scale.data_ptr(), out.data_ptr(), ws_ptr, cnt_ptr, m, n, k,
            kp, sid.block_m, sid.block_n, splits, stream)
    return out, True


def fused_mul(a: torch.Tensor, words: torch.Tensor, scales_t: torch.Tensor,
              global_scale: torch.Tensor, *, sid: SolutionId,
              splits: int | None = None) -> torch.Tensor:
    """c[m, n] = bf16((a[m, k] @ dequant(words, scales)[k, n]) * gs).

    a        : (m, k) bf16, natural k order, k % 128 == 0
    words    : (kp/8, n) int32, the shared packed layout (ops/layout.py)
    scales_t : (kp/16, n) bf16 processed scales
    global_scale : f32 tensor of one element, on a's device (read by the
               kernel from device memory: no host sync)
    sid      : the (block_m, block_n) tile to launch; a high_precision sid
               goes to fused_mul_hp or fused_mul_hp_wc (then a is f32 and
               so is the result), a weight_cache sid to fused_mul_wc
    splits   : k-splits of each 16-row output tile, an int in [1, kp /
               256]; only the block_m = 16 tiles split, plain, weight cache
               and high precision (the 64-row ids take 1). Default
               stream_splits' count on the card (fp4_wc_splits' for a
               weight_cache id, hp_splits' for a high_precision one);
               checked but unused on the CPU. The f32 partials are summed
               in split order, so every launch repeats its bits; the weight
               cache's 16-row tiles and the grouped kernel's run the same
               tile body, so at the same split count they give these bits
               (the high-precision weight cache those of fused_mul_hp).

    Launches csrc/fp4_gemm.cu for CUDA tensors (counted in
    fused_mul.launches; the 64-row tiles, whose kernel is the wgmma body of
    csrc/fp4_wgmma.cuh, also in fused_mul.wgmma_launches); runs
    fused_mul_reference for CPU tensors. Nothing syncs with the host, so a
    CUDA graph can capture it.
    """
    kp = words.shape[0] * 8
    if splits is not None:
        _check_splits("fused_mul", splits, kp, sid.block_m == STREAM_BLOCK_M)
    if sid.high_precision:
        hp = fused_mul_hp_wc if sid.weight_cache else fused_mul_hp
        return hp(a, words, scales_t, global_scale, sid=sid, splits=splits)
    if sid.weight_cache:
        return fused_mul_wc(a, words, scales_t, global_scale, sid=sid,
                            splits=splits)
    if a.device.type == "cpu":
        return fused_mul_reference(a, words, scales_t, global_scale, sid=sid)
    if splits is None and a.device.type == "cuda":
        splits = stream_splits(a.shape[0], words.shape[1], 0, kp, sid.block_m,
                               sid.block_n, _num_sms(a.device.index))[0]
    out, launched = _fused_mul_cuda("pk_fp4_gemm", a, words, scales_t,
                                    global_scale, sid, splits=splits)
    fused_mul.launches += launched
    if launched and sid.block_m == 64:
        fused_mul.wgmma_launches += 1
    return out


def fused_mul_wc(a: torch.Tensor, words: torch.Tensor,
                 scales_t: torch.Tensor, global_scale: torch.Tensor, *,
                 sid: SolutionId, splits: int | None = None) -> torch.Tensor:
    """fused_mul through the weight-cache kernel (pk_fp4_gemm_wc): each CTA
    runs WC_GROUP = 4 m-tiles of sid's (block_m, block_n) and decodes each
    weight block once for all of them (the 64-row tiles: one warpgroup an
    m-tile on csrc/fp4_wgmma.cuh; the 16-row tiles: the split-k stream body
    of csrc/fp4_stream.cuh, each B fragment feeding several m-tiles'
    MMAs). splits as fused_mul's; default fp4_wc_splits' count (the 16-row
    tiles split, their CTAs counted by m-groups of 64 rows). Bit for bit
    fused_mul's result at the same tile and split count. Counted in
    fused_mul_wc.launches, the 16-row tiles also in
    fused_mul_wc.stream_launches; fused_mul_reference on the CPU."""
    kp = words.shape[0] * 8
    if splits is not None:
        _check_splits("fused_mul_wc", splits, kp,
                      sid.block_m == STREAM_BLOCK_M)
    if a.device.type == "cpu":
        return fused_mul_reference(a, words, scales_t, global_scale, sid=sid)
    if splits is None and a.device.type == "cuda":
        splits = fp4_wc_splits(a.shape[0], words.shape[1], kp, sid,
                               _num_sms(a.device.index))
    out, launched = _fused_mul_cuda("pk_fp4_gemm_wc", a, words, scales_t,
                                    global_scale, sid, splits=splits,
                                    group=WC_GROUP)
    fused_mul_wc.launches += launched
    if launched and sid.block_m == STREAM_BLOCK_M:
        fused_mul_wc.stream_launches += 1
    return out


fused_mul.launches = 0
fused_mul.wgmma_launches = 0
fused_mul_wc.launches = 0
fused_mul_wc.stream_launches = 0


# ---------------------------------------------------------------------------
# High precision: f32 activations, an f32-accurate product, f32 out (the
# JAX package's high_precision=True kernel bodies, Precision.HIGHEST dots).
# ---------------------------------------------------------------------------

def split_bf16x3(a: torch.Tensor):
    """The high-precision kernel's split of f32 values into three bf16
    parts (csrc/fp4_stream.cuh split3): hi = a truncated to bf16, mid = (a -
    hi) truncated, lo = bf16_rn(a - hi - mid). Both differences are exact in
    f32, so hi + mid + lo == a exactly for 2^-110 <= |a| <= FLT_MAX; below,
    lo rounds on bf16's subnormal grid (an error under 2^-133)."""
    def trunc(x):
        return (x.view(torch.int32) & -65536).view(torch.float32)
    a = a.float()
    hi = trunc(a)
    r = a - hi
    mid = trunc(r)
    lo = r - mid
    return hi.to(torch.bfloat16), mid.to(torch.bfloat16), lo.to(torch.bfloat16)


def fused_mul_hp_reference(a: torch.Tensor, words: torch.Tensor,
                           scales_t: torch.Tensor, global_scale: torch.Tensor,
                           *, sid: SolutionId) -> torch.Tensor:
    """Plain PyTorch fused_mul_hp: (f32(a) @ dequant(words, scales)) * gs in
    f32. For bf16 a it computes what fused_mul_reference does before that
    one's bf16 rounding. On the card the f32 product must not run in TF32,
    which keeps 10 of f32's 23 mantissa bits: it raises unless
    torch.backends.cuda.matmul.allow_tf32 is False."""
    del sid  # both kernel structures compute the same function
    if a.device.type == "cuda" and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("fused_mul_hp_reference: TF32 matmuls are on; set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    b = layout.dequant_from_tpu_layout(words, scales_t, words.shape[1],
                                       a.shape[1])
    return (a.float() @ b) * global_scale.float()


def _fused_mul_hp(wrapper, entry: str, a, words, scales_t, global_scale,
                  sid: SolutionId, splits):
    """fused_mul_hp and fused_mul_hp_wc: check splits, run the twin on the
    CPU, else launch `entry` (hp_splits' count by default) and count it."""
    kp = words.shape[0] * 8
    if splits is not None:
        _check_splits(wrapper.__name__, splits, kp,
                      sid.block_m == STREAM_BLOCK_M)
    if a.device.type == "cpu":
        return fused_mul_hp_reference(a, words, scales_t, global_scale,
                                      sid=sid)
    wc = wrapper is fused_mul_hp_wc
    if splits is None and a.device.type == "cuda":
        splits = hp_splits(a.shape[0], words.shape[1], kp,
                           dataclasses.replace(sid, weight_cache=wc),
                           _num_sms(a.device.index))
    out, launched = _fused_mul_cuda(entry, a, words, scales_t, global_scale,
                                    sid, dtype=torch.float32, splits=splits,
                                    group=HP_WC_GROUP if wc else 1)
    wrapper.launches += launched
    if launched:
        if sid.block_m == STREAM_BLOCK_M:
            wrapper.stream_launches += 1
        else:
            wrapper.wgmma_launches += 1
    return out


def fused_mul_hp(a: torch.Tensor, words: torch.Tensor,
                 scales_t: torch.Tensor, global_scale: torch.Tensor, *,
                 sid: SolutionId, splits: int | None = None) -> torch.Tensor:
    """c[m, n] = f32((a[m, k] @ dequant(words, scales)[k, n]) * gs) for f32 a
    (natural k order, k % 128 == 0), an f32-accurate product through three
    bf16 MMAs a fragment, one per part of A (split_bf16x3). The other
    operands are fused_mul's. splits: k-splits of each 16-row output tile,
    an int in [1, kp / 256] (the 64-row tiles take 1); default hp_splits'
    count on the card, checked but unused on the CPU. The f32 partials are
    summed in split order, so every launch repeats its bits.
    Launches csrc/fp4_gemm_hp.cu pk_fp4_gemm_hp for CUDA tensors (counted in
    fused_mul_hp.launches; the 16-row tiles, the split-k stream body of
    csrc/fp4_stream.cuh on f32 A, also in fused_mul_hp.stream_launches, the
    64-row tiles, the register-A wgmma body of csrc/fp4_hp_wgmma.cuh, in
    fused_mul_hp.wgmma_launches); runs fused_mul_hp_reference for CPU
    tensors."""
    return _fused_mul_hp(fused_mul_hp, "pk_fp4_gemm_hp", a, words, scales_t,
                         global_scale, sid, splits)


def fused_mul_hp_wc(a: torch.Tensor, words: torch.Tensor,
                    scales_t: torch.Tensor, global_scale: torch.Tensor, *,
                    sid: SolutionId,
                    splits: int | None = None) -> torch.Tensor:
    """fused_mul_hp through the weight-cache kernel (pk_fp4_gemm_hp_wc):
    each CTA runs HP_WC_GROUP = 2 m-tiles of sid's (block_m, block_n) and
    decodes each weight block once for both (the 16-row tiles: each decoded
    B fragment feeds both m-tiles' MMAs). splits as fused_mul_hp's; default
    hp_splits' count for CTAs of 2 m-tiles. Bit for bit fused_mul_hp's
    result at the same tile and split count. Counted in
    fused_mul_hp_wc.launches, the 16-row tiles also in
    fused_mul_hp_wc.stream_launches, the 64-row tiles (one warpgroup an
    m-tile) in fused_mul_hp_wc.wgmma_launches; fused_mul_hp_reference on
    the CPU."""
    return _fused_mul_hp(fused_mul_hp_wc, "pk_fp4_gemm_hp_wc", a, words,
                         scales_t, global_scale, sid, splits)


fused_mul_hp.launches = 0
fused_mul_hp.stream_launches = 0
fused_mul_hp.wgmma_launches = 0
fused_mul_hp_wc.launches = 0
fused_mul_hp_wc.stream_launches = 0
fused_mul_hp_wc.wgmma_launches = 0


# ---------------------------------------------------------------------------
# Standalone dequant: the packed weights to a bf16 (kp, n) matrix, the
# backward pass of gemm.mul_fp4_diff.
# ---------------------------------------------------------------------------

def dequant_tpu_layout_reference(words: torch.Tensor,
                                 scales_t: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch dequant_tpu_layout. Value times scale is exact in f32
    and rounds once to bf16, as in the kernel."""
    kp, n = words.shape[0] * 8, words.shape[1]
    return layout.dequant_from_tpu_layout(words, scales_t, n, kp).to(
        torch.bfloat16)


def dequant_tpu_layout(words: torch.Tensor, scales_t: torch.Tensor, *,
                       element_b: ElementB = ElementB.NVFP4) -> torch.Tensor:
    """Packed words (kp/8, n) int32 and processed scales (kp/16, n) bf16 ->
    bf16 (kp, n) in natural k order, padded rows included (stored zeros,
    padding too, give +0.0).

    element_b names the format only: the scales arrive decoded, so one
    decode serves NVFP4 and MXFP4, as in the JAX package. Launches
    csrc/fp4_dequant.cu for CUDA tensors (counted in
    dequant_tpu_layout.launches); runs dequant_tpu_layout_reference for CPU
    tensors."""
    del element_b
    kw, n = words.shape
    kp = kw * 8
    if words.dtype != torch.int32 or scales_t.dtype != torch.bfloat16 \
            or tuple(scales_t.shape) != (kp // 16, n) or kp % 256:
        raise ValueError(f"dequant_tpu_layout: words int32 (kp/8, n) and "
                         f"scales bf16 (kp/16, n) expected, got "
                         f"{words.dtype} {tuple(words.shape)}, "
                         f"{scales_t.dtype} {tuple(scales_t.shape)}")
    if scales_t.device != words.device:
        raise ValueError(f"dequant_tpu_layout: scales on {scales_t.device}, "
                         f"words on {words.device}")
    if words.device.type == "cpu":
        return dequant_tpu_layout_reference(words, scales_t)
    if words.device.type != "cuda":
        raise ValueError(f"dequant_tpu_layout: unsupported device "
                         f"{words.device}")
    words, scales_t = words.contiguous(), scales_t.contiguous()
    out = torch.empty((kp, n), dtype=torch.bfloat16, device=words.device)
    if kp == 0 or n == 0:
        return out
    _launch("pk_fp4_dequant", words.data_ptr(), scales_t.data_ptr(),
            out.data_ptr(), kp, n,
            torch.cuda.current_stream(words.device).cuda_stream)
    dequant_tpu_layout.launches += 1
    return out


dequant_tpu_layout.launches = 0


# ---------------------------------------------------------------------------
# W4A8: per-token int8 activations, FP4 weights requantized to int8 per
# column, int32 sums. The order of every rounding below is the JAX
# package's (fused.py:585-590, 621-626, 509-523): it decides the bits.
# ---------------------------------------------------------------------------

# k-chunk of the twin's float32 products: 1024 * 127 * 127 < 2^24, so every
# partial sum of integer products is exact in f32, in any order
_EXACT_K = 1024
# The JAX package writes `x / 127.0`; XLA compiles a division by a constant
# as a multiply by its f32 reciprocal, and the port computes what XLA does
_INV127 = float(np.float32(1) / np.float32(127))
_F32_TINY = float(np.finfo(np.float32).tiny)


def w4a8_requant_constants(scales_t: torch.Tensor):
    """Per-column requantization constants of the W4A8 kernel, from the
    processed scales (kp/16, n) bf16, padded rows included:
    colmax = 6 * max(scales) per column (0 -> 1), r_t = bf16(s * (127 /
    colmax)) (kp/16, n), acol = colmax * f32(1/127) (1, n) f32. As XLA does,
    an f32 r below the smallest normal is flushed to 0 (only scales far
    below their column's largest give one, and such an r requantizes every
    weight to 0 either way). Engines compute these once at init
    (models/serving.py) and pass them to every call."""
    s32 = scales_t.float()
    colmax = 6.0 * s32.amax(dim=0, keepdim=True)
    colmax = torch.where(colmax == 0, 1.0, colmax)
    # a true division: torch computes `127.0 / colmax` as 127 * (1 / colmax)
    r = s32 * (colmax.new_tensor(127.0) / colmax)
    r = torch.where(r.abs() < _F32_TINY, 0.0, r)
    return r.to(torch.bfloat16), colmax * _INV127


def quantize_activations(a: torch.Tensor):
    """Per-token int8 activations: arow = max|f32(a)| * f32(1/127) per row
    (0 -> 1), (m, 1) f32, and a_i8 = rne(f32(a) / arow), a true
    division."""
    af = a.float()
    arow = af.abs().amax(dim=1, keepdim=True) * _INV127
    arow = torch.where(arow == 0, 1.0, arow)
    return torch.round(af / arow).to(torch.int8), arow


def _int_matmul(a_i8: torch.Tensor, b_i8: torch.Tensor) -> torch.Tensor:
    """The exact integer product a_i8 @ b_i8, as float64 (m, n): float32
    matmuls over k-chunks of _EXACT_K (each exact), summed in float64
    (exact below 2^53). Torch's int8 matmul would wrap in int8, and CUDA
    torch has no integer matmul; TF32 must be off, as the caller sets."""
    m, k = a_i8.shape
    acc = torch.zeros((m, b_i8.shape[1]), dtype=torch.float64,
                      device=a_i8.device)
    for k0 in range(0, k, _EXACT_K):
        acc += (a_i8[:, k0:k0 + _EXACT_K].float()
                @ b_i8[k0:k0 + _EXACT_K].float()).double()
    return acc


def requantized_weights(words: torch.Tensor, r_t: torch.Tensor,
                        k: int) -> torch.Tensor:
    """The kernel's int8 B (k, n): rne(bf16(decode(w) * r_t[k // 16])),
    the product exact in f32 and rounded to bf16 once; stored zeros give
    0."""
    b = layout.dequant_from_tpu_layout(words, r_t, words.shape[1], k)
    return torch.round(b.to(torch.bfloat16).float()).to(torch.int8)


def fused_mul_w4a8_reference(a: torch.Tensor, words: torch.Tensor,
                             scales_t: torch.Tensor,
                             global_scale: torch.Tensor, *, sid: SolutionId,
                             r_t=None, acol=None) -> torch.Tensor:
    """Plain PyTorch fused_mul_w4a8, with the kernel's numerics step for
    step: out = bf16(((f32(Σ a_i8 · b_i8) * arow) * acol) * gs). The
    integer sum is exact in both, so the two agree bit for bit."""
    del sid  # both kernel structures compute the same function
    if r_t is None or acol is None:
        r_t, acol = w4a8_requant_constants(scales_t)
    a_i8, arow = quantize_activations(a)
    acc = _int_matmul(a_i8, requantized_weights(words, r_t, a.shape[1]))
    out = ((acc.float() * arow) * acol.reshape(1, -1)) * global_scale.float()
    return out.to(torch.bfloat16)


def launch_w4a8(a_i8, arow, words, r_t, acol, global_scale, out,
                sid: SolutionId, splits: int | None = None) -> None:
    """One launch of pk_fp4_gemm_w4a8 (pk_fp4_gemm_w4a8_wc for a
    weight_cache sid) on activations quantized beforehand, into `out` (m,
    n) bf16, with the k-split workspace and counters; splits None takes
    w4a8_splits. The operands are contiguous CUDA tensors at 16-byte
    boundaries (the kernels copy A8, the words and R in 16-byte pieces).
    Not counted: the wrappers count their launches."""
    m, k = a_i8.shape
    kp, n = words.shape[0] * 8, words.shape[1]
    if splits is None:
        splits = w4a8_splits(m, n, kp, sid, _num_sms(a_i8.device.index))
    stream = torch.cuda.current_stream(a_i8.device).cuda_stream
    ws_ptr = cnt_ptr = None
    if splits > 1:
        rows = STREAM_BLOCK_M * (WC_GROUP if sid.weight_cache else 1)
        tiles = -(-m // rows) * -(-n // sid.block_n)
        ws = torch.empty(tiles * splits * rows * sid.block_n,
                         dtype=torch.int32, device=a_i8.device)
        ws_ptr = ws.data_ptr()
        cnt_ptr = _counters(a_i8.device, stream, tiles).data_ptr()
    _launch("pk_fp4_gemm_w4a8_wc" if sid.weight_cache else "pk_fp4_gemm_w4a8",
            a_i8.data_ptr(), arow.data_ptr(), words.data_ptr(),
            r_t.data_ptr(), acol.data_ptr(), global_scale.data_ptr(),
            out.data_ptr(), ws_ptr, cnt_ptr, m, n, k, kp, sid.block_m,
            sid.block_n, splits, stream)


def _fused_mul_w4a8_cuda(entry: str, a, words, scales_t, global_scale, sid,
                         r_t, acol, splits):
    if a.device.type != "cuda":
        raise ValueError(f"{entry}: unsupported device {a.device}")
    m, k = a.shape
    n = words.shape[1]
    if r_t is None or acol is None:
        r_t, acol = w4a8_requant_constants(scales_t)
    _check(entry, a, words, scales_t, global_scale,
           ("r_t", r_t, torch.bfloat16, tuple(scales_t.shape)),
           ("acol", acol, torch.float32, (1, n)))
    a_i8, arow = quantize_activations(a)
    # the kernels copy A8, the words and R in 16-byte pieces
    a_i8, words, r_t = _aligned(a_i8), _aligned(words), _aligned(r_t)
    acol, arow = acol.contiguous(), arow.contiguous()
    out = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    if m == 0 or n == 0:
        return out, False
    launch_w4a8(a_i8, arow, words, r_t, acol, global_scale, out, sid, splits)
    return out, True


def _count_w4a8(wrapper, sid: SolutionId, launched: bool) -> None:
    wrapper.launches += launched
    if launched:
        if sid.block_m == 64:
            wrapper.wgmma_launches += 1
        else:
            wrapper.stream_launches += 1


def fused_mul_w4a8(a: torch.Tensor, words: torch.Tensor,
                   scales_t: torch.Tensor, global_scale: torch.Tensor, *,
                   sid: SolutionId, r_t=None, acol=None,
                   splits: int | None = None) -> torch.Tensor:
    """W4A8 fused_mul over the same (words, scales_t) operands:
    bf16(((f32(Σ_k a_i8 · b_i8) * arow) * acol) * gs).

    a is quantized per token to int8 here, in torch (XLA glue in the JAX
    package): quantize_activations. r_t (kp/16, n) bf16 and acol (1, n) f32
    are w4a8_requant_constants(scales_t), computed per call unless given.
    sid: the (block_m, block_n) tile; a weight_cache sid goes to
    fused_mul_w4a8_wc. splits: k-splits of each 16-row output tile, an int
    in [1, kp / 256]; the 64-row tiles take 1. Default w4a8_splits' count
    on the card; checked but unused on the CPU. The integer sums are exact,
    so every tile and split count gives the same bits.

    Launches csrc/fp4_gemm_w4a8.cu for CUDA tensors (counted in
    fused_mul_w4a8.launches; the 64-row tiles, whose kernel is the int8
    wgmma body of csrc/w4a8_wgmma.cuh, also in
    fused_mul_w4a8.wgmma_launches, the 16-row tiles, the split-k int8
    stream body of csrc/w4a8_stream.cuh, in
    fused_mul_w4a8.stream_launches); runs fused_mul_w4a8_reference for CPU
    tensors."""
    if sid.weight_cache:
        return fused_mul_w4a8_wc(a, words, scales_t, global_scale, sid=sid,
                                 r_t=r_t, acol=acol, splits=splits)
    if splits is not None:
        _check_splits("fused_mul_w4a8", splits, words.shape[0] * 8,
                      sid.block_m == STREAM_BLOCK_M)
    if a.device.type == "cpu":
        return fused_mul_w4a8_reference(a, words, scales_t, global_scale,
                                        sid=sid, r_t=r_t, acol=acol)
    out, launched = _fused_mul_w4a8_cuda("pk_fp4_gemm_w4a8", a, words,
                                         scales_t, global_scale, sid, r_t,
                                         acol, splits)
    _count_w4a8(fused_mul_w4a8, sid, launched)
    return out


def fused_mul_w4a8_wc(a: torch.Tensor, words: torch.Tensor,
                      scales_t: torch.Tensor, global_scale: torch.Tensor, *,
                      sid: SolutionId, r_t=None, acol=None,
                      splits: int | None = None) -> torch.Tensor:
    """fused_mul_w4a8 through the weight-cache kernel
    (pk_fp4_gemm_w4a8_wc): each CTA runs 4 m-tiles of one n-tile and
    requantizes each weight block once for all of them. Bit for bit
    fused_mul_w4a8's result. splits as fused_mul_w4a8's (the 16-row tiles
    split k; their default counts the CTAs of 64 rows). Counted in
    fused_mul_w4a8_wc.launches; the 64-row tiles, whose kernel is the int8
    wgmma body of csrc/w4a8_wgmma.cuh with its m-tiles sharing one
    requantization, also in fused_mul_w4a8_wc.wgmma_launches, the 16-row
    tiles, the stream body of csrc/w4a8_stream.cuh, in
    fused_mul_w4a8_wc.stream_launches. The twin on the CPU."""
    if splits is not None:
        _check_splits("fused_mul_w4a8_wc", splits, words.shape[0] * 8,
                      sid.block_m == STREAM_BLOCK_M)
    if a.device.type == "cpu":
        return fused_mul_w4a8_reference(a, words, scales_t, global_scale,
                                        sid=sid, r_t=r_t, acol=acol)
    out, launched = _fused_mul_w4a8_cuda(
        "pk_fp4_gemm_w4a8_wc", a, words, scales_t, global_scale,
        dataclasses.replace(sid, weight_cache=True), r_t, acol, splits)
    _count_w4a8(fused_mul_w4a8_wc, sid, launched)
    return out


fused_mul_w4a8.launches = 0
fused_mul_w4a8.wgmma_launches = 0
fused_mul_w4a8.stream_launches = 0
fused_mul_w4a8_wc.launches = 0
fused_mul_w4a8_wc.wgmma_launches = 0
fused_mul_w4a8_wc.stream_launches = 0
