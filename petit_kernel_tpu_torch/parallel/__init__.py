"""Tensor and expert parallelism over torch.distributed (torch).

Counterpart of petit_kernel_tpu/parallel: `tp` (Megatron tensor
parallelism for the Llama family: quantize_params_tp, make_tp_forward,
make_tp_forward_sp, mul_fp4_tp_rs, init_cache_tp and make_tp_step, the
serving engines' forward_fn) and `ep` (expert parallelism for Mixtral:
quantize_params_ep, make_moe_mlp_ep, make_ep_step). A JAX Mesh becomes a
torch.distributed DeviceMesh with the same axis names ("dp", "tp", "ep");
each rank holds its local shards and runs what the JAX package's shard_map
body runs, with torch.distributed collectives on the axes' groups. The
caller starts the process group; a "cpu" mesh (gloo) builds on the CPU,
any other on the CUDA card. Pipeline parallelism (parallel/pp.py) is not
ported yet.
"""

from . import ep, tp
from .ep import (local_experts_ep, make_ep_step, make_moe_mlp_ep,
                 place_experts_ep, quantize_params_ep)
from .tp import (init_cache_tp, local_linear_tp, local_params_tp,
                 make_tp_forward, make_tp_forward_sp, make_tp_step,
                 mul_fp4_tp_rs, quantize_linear_tp, quantize_params_tp,
                 shard_dense_params)

__all__ = [
    "ep", "tp", "init_cache_tp", "local_experts_ep", "local_linear_tp",
    "local_params_tp",
    "make_ep_step", "make_moe_mlp_ep", "make_tp_forward",
    "make_tp_forward_sp", "make_tp_step", "mul_fp4_tp_rs",
    "place_experts_ep", "quantize_linear_tp", "quantize_params_ep",
    "quantize_params_tp", "shard_dense_params",
]
