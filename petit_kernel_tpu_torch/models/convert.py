"""Convert JAX-package state into the port's, bit for bit.

The JAX package (petit_kernel_tpu.models.llama) holds params as nested
dicts and lists of arrays, and a KV cache or page pool as a list of
per-layer (k, v) arrays. `params_from_jax` and `kv_from_jax` take those
with every leaf already a numpy array (for example
`jax.tree.map(np.asarray, p)`) and return the same structure of torch
tensors:

  bfloat16 leaves (numpy dtype name "bfloat16", or uint16 bit patterns)
      -> torch.bfloat16 with the same bits
  float8_e4m3fn leaves (numpy dtype name) -> torch.float8_e4m3fn, same bits
  uint32 packed words -> torch.int32 with the same bits
  every other numpy dtype -> the matching torch dtype

The tensors land on `device`, by default the CUDA card; without a card
each function raises unless the caller passes device="cpu". A Mixtral
tree (models/moe.py) converts as it is: stacked expert words (E, kp/8, n)
become int32, their scales stay bf16 and their global scales (E,) f32.

A hybrid layer (quantize_params(..., "hybrid"), a dict with "wd") changes
on the way: its static "meta" (the JAX package's HybridMeta) becomes the
port's ops.hybrid.HybridMeta, "inv_perm" an int32 index tensor, and "wd",
stored by the JAX package in its kernel's pi-permuted k order
(ops/hybrid.py permute_k_for_a), goes back to natural k order, the order
in which the port's kernels read A. The permuted copy is not carried.

`params_tp_from_jax`, `params_ep_from_jax` and `params_pp_from_jax` take
the JAX package's quantize_params_tp, quantize_params_ep and
place_params_pp output, every global array gathered to numpy, and return
one rank's local tree (parallel/tp.py, parallel/ep.py, parallel/pp.py): a
rank's column, packed-row, expert or layer block of each sharded leaf, the
replicated leaves whole.

This module imports neither JAX nor ml_dtypes: bfloat16 and float8 arrays
are read through integer views of their bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.hybrid import HybridMeta
from .llama import resolve_device


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """One leaf: numpy array (or scalar) -> torch tensor on `device`
    (default the CUDA card), same bits."""
    device = resolve_device(device)
    a = np.array(a)            # an owned, writable, contiguous copy
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    elif a.dtype.name == "float8_e4m3fn":
        t = torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    elif a.dtype == np.uint32:
        t = torch.from_numpy(a.view(np.int32))
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def unpermute_k(wd_permuted: np.ndarray) -> np.ndarray:
    """(kp, nd) rows in the JAX hybrid kernel's A order -> natural k: the
    (16, 8) transpose inside each 128-row chunk that undoes
    permute_k_for_a (the transform dequant_tpu_layout also undoes)."""
    kp, nd = wd_permuted.shape
    return (wd_permuted.reshape(kp // 128, 16, 8, nd).swapaxes(1, 2)
            .reshape(kp, nd))


def _hybrid_from_jax(layer: dict, device) -> dict:
    meta = layer["meta"]
    out = {k: params_from_jax(v, device) for k, v in layer.items()
           if k not in ("meta", "wd")}
    out["wd"] = tensor_from_numpy(unpermute_k(np.asarray(layer["wd"])),
                                  device)
    out["meta"] = HybridMeta(meta.block_nf, meta.block_nd, meta.size_k)
    return out


def params_from_jax(tree, device=None):
    """JAX params tree (numpy leaves) -> the port's params tree on `device`
    (default the CUDA card); hybrid layers as the module docstring says."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        if "wd" in tree:
            return _hybrid_from_jax(tree, device)
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    return tensor_from_numpy(tree, device)


def kv_from_jax(pairs, device=None) -> list:
    """A JAX KV cache or page pool, a list of per-layer (k, v) numpy
    arrays, -> the port's list of (k, v) tensors, same shapes and bits.
    (A JAX headed fp8 cache carries its S axis padded to a multiple of 256;
    the port attends it as it is.) On `device`, default the CUDA card."""
    device = resolve_device(device)
    return [(tensor_from_numpy(k, device), tensor_from_numpy(v, device))
            for k, v in pairs]


def params_tp_from_jax(tree, tp: int, rank: int, device=None) -> dict:
    """The JAX package's quantize_params_tp tree (numpy leaves, each array
    gathered whole) -> rank `rank`'s local tree of a tp-way mesh on
    `device` (default the CUDA card), as the port's quantize_params_tp
    gives it: columns of the column-parallel projections and lm_head,
    packed-row blocks of wo and w_down (parallel.tp.local_params_tp)."""
    from ..parallel import tp as tp_mod
    return tp_mod.local_params_tp(params_from_jax(tree, device), tp, rank)


def params_ep_from_jax(tree, ep: int, rank: int, device=None) -> dict:
    """The JAX package's quantize_params_ep tree (numpy leaves, each
    expert stack gathered whole) -> rank `rank`'s local tree of an ep-way
    mesh on `device` (default the CUDA card): experts [rank E/ep,
    (rank+1) E/ep) of each layer's stacks, the rest whole."""
    from ..parallel import ep as ep_mod
    out = params_from_jax(tree, device)
    for lp in out["layers"]:
        lp["experts"] = ep_mod.local_experts_ep(lp["experts"], ep, rank)
    return out


def params_pp_from_jax(tree, pp: int, stage: int, device=None) -> dict:
    """The JAX package's place_params_pp tree (numpy leaves, the stacked
    layers gathered whole) -> stage `stage`'s tree of a pp-way mesh on
    `device` (default the CUDA card), as the port's place_params_pp gives
    it: layers [stage L/pp, (stage+1) L/pp) of each stacked leaf, embed,
    final_norm and lm_head whole."""
    from ..parallel import pp as pp_mod
    out = params_from_jax(tree, device)
    out["layers"] = pp_mod.local_layers_pp(out["layers"], pp, stage)
    return out
