"""Tensor, expert and pipeline parallelism over torch.distributed
(torch).

Counterpart of petit_kernel_tpu/parallel: `tp` (Megatron tensor
parallelism for the Llama family: quantize_params_tp, make_tp_forward,
make_tp_forward_sp, mul_fp4_tp_rs, init_cache_tp and make_tp_step, the
serving engines' forward_fn), `ep` (expert parallelism for Mixtral:
quantize_params_ep, make_moe_mlp_ep, make_ep_step) and `pp` (GPipe
pipeline parallelism for the Llama stack: stack_layers, place_params_pp,
init_cache_pp, make_pp_step, make_pp_forward). make_tp_forward and
make_tp_forward_sp also train over shard_dense_params shards (their
collectives carry the backward). A JAX Mesh becomes a torch.distributed
DeviceMesh with the same axis names ("dp", "tp", "ep", "pp");
each rank holds its local shards and runs what the JAX package's shard_map
body runs, with torch.distributed collectives on the axes' groups. The
caller starts the process group; a "cpu" mesh (gloo) builds on the CPU,
any other on the CUDA card.
"""

from . import ep, pp, tp
from .ep import (local_experts_ep, make_ep_step, make_moe_mlp_ep,
                 place_experts_ep, quantize_params_ep)
from .pp import (init_cache_pp, make_pp_forward, make_pp_step,
                 place_params_pp, stack_layers)
from .tp import (init_cache_tp, local_linear_tp, local_params_tp,
                 make_tp_forward, make_tp_forward_sp, make_tp_step,
                 mul_fp4_tp_rs, quantize_linear_tp, quantize_params_tp,
                 shard_dense_params)

__all__ = [
    "ep", "pp", "tp", "init_cache_pp", "init_cache_tp", "local_experts_ep",
    "local_linear_tp", "local_params_tp", "make_ep_step", "make_moe_mlp_ep",
    "make_pp_forward", "make_pp_step", "make_tp_forward",
    "make_tp_forward_sp", "make_tp_step", "mul_fp4_tp_rs",
    "place_experts_ep", "place_params_pp", "quantize_linear_tp",
    "quantize_params_ep", "quantize_params_tp", "shard_dense_params",
    "stack_layers",
]
