"""Models over the FP4 GEMM (torch): the Llama family (`llama`), Mixtral
MoE over the grouped expert GEMM (`moe`), the paged KV cache (`paged`),
the serving engines (`serving`: Engine serves Mixtral through
forward_fn=moe.make_engine_forward(cfg)), the eval harness (`eval`:
log-likelihood, multiple choice, perplexity, the FP4 accuracy delta;
imported by name, as it shadows the builtin), the HF checkpoint loader
(`loader`), JAX-state conversion (`convert`), and the cluster tier: the
Cluster router over replicas (`cluster`) and replicas in processes of
their own behind a pipe (`rpc`)."""

from . import cluster, convert, llama, loader, moe, paged, rpc, serving

__all__ = ["cluster", "convert", "llama", "loader", "moe", "paged", "rpc",
           "serving"]
