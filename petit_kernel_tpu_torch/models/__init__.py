"""Models over the FP4 GEMM (torch): the Llama family (`llama`), Mixtral
MoE over the grouped expert GEMM (`moe`), the paged KV cache (`paged`),
the serving engines (`serving`: Engine serves Mixtral through
forward_fn=moe.make_engine_forward(cfg)) and JAX-state conversion
(`convert`)."""

from . import convert, llama, moe, paged, serving

__all__ = ["convert", "llama", "moe", "paged", "serving"]
