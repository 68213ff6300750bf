"""Models over the FP4 GEMM (torch): the Llama family (`llama`), Mixtral
MoE over the grouped expert GEMM (`moe`), the paged KV cache (`paged`),
the serving engines (`serving`: Engine serves Mixtral through
forward_fn=moe.make_engine_forward(cfg)), the eval harness (`eval`:
log-likelihood, multiple choice, perplexity, the FP4 accuracy delta;
imported by name, as it shadows the builtin), the HF checkpoint loader
(`loader`) and JAX-state conversion (`convert`)."""

from . import convert, llama, loader, moe, paged, serving

__all__ = ["convert", "llama", "loader", "moe", "paged", "serving"]
