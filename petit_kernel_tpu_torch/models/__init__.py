"""Llama model, checkpoint conversion and serving engine (torch)."""
