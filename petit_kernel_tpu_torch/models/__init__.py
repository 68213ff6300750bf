"""Llama model, paged KV cache, checkpoint conversion and serving engines
(torch)."""
