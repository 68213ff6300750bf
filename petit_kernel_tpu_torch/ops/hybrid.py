"""Hybrid FP4 + BF16 quantization: the most salient columns stay dense
(torch).

Counterpart of petit_kernel_tpu/ops/hybrid.py: column selection by weight
salience, the FP4 quantization and repack of the other columns, and the
public mul that runs both halves (ops/kernels/hybrid.py) and puts the
outputs back in the checkpoint's column order. Everything here is torch on
the input's device. One difference in the stored layer: `wd` keeps natural
k order, (kp, nd), where the JAX package pi-permutes it to its kernel's A
order (models/convert.py undoes that permutation for JAX trees).
"""

from __future__ import annotations

import dataclasses

import torch

from ..numerics import reference as ref_numerics
from . import layout as layout_mod
from .kernels import hybrid as hybrid_kernel


@dataclasses.dataclass(frozen=True)
class HybridMeta:
    """Split metadata of a hybrid layer: the column blocks it was split
    with (n_fp4 : n_dense = block_nf : block_nd) and its k."""
    block_nf: int
    block_nd: int
    size_k: int


def quantize_hybrid(w_kn: torch.Tensor, *, block_nf: int = 1536,
                    block_nd: int = 512, fmt: str = "nvfp4") -> dict:
    """Split a dense (k, n) weight into FP4 columns and salient dense
    columns: {"words", "scales", "gs", "wd", "inv_perm", "meta"}.

    n must be divisible by block_nf + block_nd; n * block_nd / (block_nf +
    block_nd) columns stay dense. Salience is the column's max |w|; the
    dense set is the top nd by a stable ascending sort, in increasing
    column order. (The JAX package sorts with numpy's default, unstable
    algorithm, so where columns tie at the cut the two may keep different
    ones.) The other columns quantize with `fmt` ("nvfp4", else MXFP4);
    wd is (kp, nd) bf16 in natural k order, zero past k; inv_perm (n,)
    int32 maps [fp4 columns | dense columns] back to the original order."""
    w = w_kn.float()
    k, n = w.shape
    step = block_nf + block_nd
    if n % step:
        raise ValueError(f"n = {n} is not a multiple of block_nf + block_nd "
                         f"= {step}")
    nd = n // step * block_nd
    sal = w.abs().amax(dim=0)
    order = torch.sort(sal, stable=True).indices
    dense_idx = torch.sort(order[n - nd:]).values
    keep = torch.ones(n, dtype=torch.bool, device=w.device)
    keep[dense_idx] = False
    fp4_idx = keep.nonzero().squeeze(1)
    perm = torch.cat([fp4_idx, dense_idx])
    if fmt == "nvfp4":
        quant, group = ref_numerics.quantize_nvfp4, 16
    else:
        quant, group = ref_numerics.quantize_mxfp4, 32
    nf = n - nd
    qw, scales, gs = quant(w[:, fp4_idx].T.contiguous())   # (nf, k)
    words = layout_mod.repack_fp4_weights(
        qw, nf, k, pad_to=layout_mod.pad_multiple(group))
    st = layout_mod.process_fp4_scales(scales, nf, k, group_size=group)
    kp = words.shape[0] * 8
    wd = torch.zeros((kp, nd), dtype=torch.bfloat16, device=w.device)
    wd[:k] = w[:, dense_idx].to(torch.bfloat16)
    return {"words": words, "scales": st, "gs": gs.reshape(()), "wd": wd,
            "inv_perm": torch.argsort(perm).to(torch.int32),
            "meta": HybridMeta(block_nf, block_nd, k)}


def mul_hybrid(a: torch.Tensor, hq: dict) -> torch.Tensor:
    """(m, k) @ a hybrid-quantized (k, n) -> (m, n) bf16 in the original
    column order: hybrid_mul's two outputs side by side, gathered by
    inv_perm."""
    outf, outd = hybrid_kernel.hybrid_mul(
        a, hq["words"], hq["scales"], hq["gs"].reshape(1), hq["wd"])
    return torch.cat([outf, outd], dim=1).index_select(1, hq["inv_perm"])
