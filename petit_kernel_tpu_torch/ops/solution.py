"""Kernel solution space for the Hopper FP4 GEMM: encoding, feasibility,
heuristic.

Counterpart of petit_kernel_tpu/ops/solution.py. There a SolutionId names
a Pallas block shape bounded by the TPU's VMEM budget; here it names one of
the tile shapes compiled into the CUDA kernels. They walk the packed weights
32 word rows (256 k) at a time, so there is no block-k parameter: a tile
is (block_m, block_n), and the instances built are TILE_SHAPES below, for
every kernel: the bf16 GEMM (csrc/fp4_gemm.cu) for MatmulType FP16 and
BF16, the W4A8 GEMM (csrc/fp4_gemm_w4a8.cu) for MatmulType INT8, the
high-precision GEMM (csrc/fp4_gemm_hp.cu, f32 activations) for
high_precision=True, and the weight-cache variant of each
(weight_cache=True), which runs several of the tiles per CTA and decodes
each weight block once for them: 4 tiles in the bf16 and W4A8 kernels
(WC_GROUP), 2 in the high-precision one (HP_WC_GROUP).

An id is feasible where a compiled kernel serves it. Each kernel
instance must fit the 227 KB of shared memory a Hopper block may use, and
each .cu file refuses at compile time (static_assert) a tile that does not.
The high-precision kernels stage A as f32, which doubles A's part of the
budget: with 4 tiles a CTA, the 64-row weight-cache tiles would ask for
270,336 bytes (64 x 64) and more. The high-precision weight-cache kernel
therefore runs 2 tiles a CTA, where every tile fits (at most 219,136
bytes, 64 x 128). The high-precision ids are then exactly the other ids
with the hp bit, for every shape, and a tuned table can name any of them.
There is no high-precision W4A8 kernel, so an hp INT8 id is infeasible.

The integer `repr` round-trips (SolutionId.from_repr(sid.repr()) == sid),
like the reference library's SolutionId::Repr()/FromRepr. The JAX
package's pow2_scale and zero_free bits have no counterpart: the kernel
decodes every value exactly and multiplies by its bf16 scale, so one
instance serves nvfp4, nvfp4p2, nvfp4p2z, mxfp4 and mxfp4z alike.
"""

from __future__ import annotations

import dataclasses
import enum


class ElementB(enum.IntEnum):
    """Quantized weight format."""
    INT4 = 0       # reserved, not implemented (parity with the reference)
    NVFP4 = 1
    MXFP4 = 2


class MatmulType(enum.IntEnum):
    """Activation/output dtype class. INT8 is the W4A8 path: int8
    activations, FP4 weights requantized to int8 in the kernel
    (csrc/fp4_gemm_w4a8.cu)."""
    FP16 = 0
    BF16 = 1
    INT8 = 2


# (block_m, block_n) tiles compiled into csrc/fp4_gemm.cu. block_m = 16
# serves decode (one m16 MMA row block, narrow n for more CTAs on the
# weight stream); block_m = 64 serves prefill.
TILE_SHAPES = ((16, 64), (16, 128), (64, 64), (64, 128))
BLOCK_M_UNIT = 16
BLOCK_N_UNIT = 64


@dataclasses.dataclass(frozen=True, order=True)
class SolutionId:
    block_m: int
    block_n: int
    element_b: ElementB = ElementB.NVFP4
    mfma_type: MatmulType = MatmulType.BF16
    high_precision: bool = False
    # the weight-cache kernel: 4 m-tiles per CTA (2 for high precision)
    # share each decoded weight block (the JAX package's _fused_kernel_wc /
    # _fused_kernel_w4a8_wc)
    weight_cache: bool = False

    def __post_init__(self):
        if (self.block_m <= 0 or self.block_m % BLOCK_M_UNIT
                or self.block_n <= 0 or self.block_n % BLOCK_N_UNIT):
            raise ValueError(f"bad tile ({self.block_m}, {self.block_n})")

    # [wc:1][n:8][m:8][element_b:3][mfma:2][hp:1]
    def repr(self) -> int:
        return (int(self.weight_cache) << 22
                | (self.block_n // BLOCK_N_UNIT) << 14
                | (self.block_m // BLOCK_M_UNIT) << 6
                | int(self.element_b) << 3
                | int(self.mfma_type) << 1
                | int(self.high_precision))

    @classmethod
    def from_repr(cls, r: int) -> "SolutionId":
        return cls(
            block_m=((r >> 6) & 0xFF) * BLOCK_M_UNIT,
            block_n=((r >> 14) & 0xFF) * BLOCK_N_UNIT,
            element_b=ElementB((r >> 3) & 0x7),
            mfma_type=MatmulType((r >> 1) & 0x3),
            high_precision=bool(r & 1),
            weight_cache=bool((r >> 22) & 1),
        )


@dataclasses.dataclass(frozen=True)
class SolutionHints:
    """Soft preferences threaded through solution resolution (the
    reference's PetitSolutionHints). require_high_precision restricts
    resolution to high-precision solutions."""
    a_type: MatmulType = MatmulType.BF16
    b_type: ElementB = ElementB.NVFP4
    c_type: MatmulType = MatmulType.BF16
    require_high_precision: bool = False


def default_hints(device_name: str | None = None,
                  b_type: ElementB = ElementB.NVFP4) -> SolutionHints:
    """Default hints. The kernel decodes stored zeros to exact 0 and keeps
    every product exact in bf16, so no card needs the high-precision path
    for correctness."""
    del device_name
    return SolutionHints(b_type=b_type)


def is_feasible(sid: SolutionId, m: int, n: int, k: int) -> bool:
    """Whether a compiled kernel serves sid at (m, n, k). The kernels mask
    ragged m and n edges and zero-fill A past k, so only the tile set, the
    missing hp W4A8 kernel, k % 128 and a soft cap on wasted tile rows and
    columns apply; a weight-cache id needs more than one m-tile to share
    its decodes (m > block_m), as in the JAX package."""
    if (sid.block_m, sid.block_n) not in TILE_SHAPES:
        return False
    if sid.high_precision and sid.mfma_type == MatmulType.INT8:
        return False
    if k % 128 != 0:
        return False
    if sid.block_m > 2 * max(m, BLOCK_M_UNIT):
        return False
    if sid.block_n > 2 * max(n, BLOCK_N_UNIT):
        return False
    if sid.weight_cache and m <= sid.block_m:
        return False
    return True


def get_solutions(m: int, n: int, k: int,
                  element_b: ElementB = ElementB.NVFP4,
                  mfma_type: MatmulType = MatmulType.BF16,
                  high_precision: bool = False) -> list[SolutionId]:
    """Feasible solutions for a problem shape, with and without the weight
    cache."""
    out = []
    for bm, bn in TILE_SHAPES:
        for wc in (False, True):
            sid = SolutionId(bm, bn, element_b, mfma_type, high_precision,
                             weight_cache=wc)
            if is_feasible(sid, m, n, k):
                out.append(sid)
    return out


def choose_default_solution(m: int, n: int, k: int,
                            element_b: ElementB = ElementB.NVFP4,
                            mfma_type: MatmulType = MatmulType.BF16,
                            high_precision: bool = False) -> SolutionId:
    """Heuristic: decode (m <= 32) takes the m16 tile with narrow n, so a
    4096-wide projection launches 64+ CTAs on the weight stream; larger m
    takes the 64-row tile, 128 wide where n is wide enough to fill the
    card with CTAs. It never picks the weight cache, which only an explicit
    id (the autotuner's route) selects, as in the JAX package."""
    if k % 128 != 0:
        raise ValueError(f"no feasible solution for k={k}")
    if m <= 32:
        bm, bn = 16, 64
    else:
        bm = 64
        bn = 128 if -(-m // 64) * -(-n // 128) >= 132 else 64
    return SolutionId(bm, bn, element_b, mfma_type, high_precision)
