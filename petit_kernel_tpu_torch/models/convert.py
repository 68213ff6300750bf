"""Convert a JAX-package params tree into the port's, bit for bit.

The JAX package (petit_kernel_tpu.models.llama) holds params as nested
dicts and lists of arrays. `params_from_jax` takes that tree with every
leaf already a numpy array (for example `jax.tree.map(np.asarray, p)`) and
returns the same tree of torch tensors, dense or quantized:

  bfloat16 leaves (numpy dtype name "bfloat16", or uint16 bit patterns)
      -> torch.bfloat16 with the same bits
  uint32 packed words -> torch.int32 with the same bits
  every other numpy dtype -> the matching torch dtype

This module imports neither JAX nor ml_dtypes: a bfloat16 array is read
through a uint16 view of its bytes.
"""

from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """One leaf: numpy array (or scalar) -> torch tensor, same bits."""
    a = np.array(a)            # an owned, writable, contiguous copy
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    elif a.dtype == np.uint32:
        t = torch.from_numpy(a.view(np.int32))
    else:
        t = torch.from_numpy(a)
    return t if device is None else t.to(device)


def params_from_jax(tree, device=None):
    """JAX params tree (numpy leaves) -> the port's params tree."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    return tensor_from_numpy(tree, device)
