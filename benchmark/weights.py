"""Raw model weights from the seed, made on the device in a few large calls.

The benchmark makes these and hands the same tensors to both sides: the
program's set-up quantizes them (families/), and the plain reference
(reference/) makes them again, layer by layer, and quantizes them itself.
Every tensor comes from a torch.Generator of its own, seeded from (seed,
purpose, layer), so one layer can be made without the others.

Shapes are (k, n) for a projection y = x @ w; scales follow the usual
random init: normal / sqrt(k) for projections, normal * 0.02 for the
embedding and the output head, unit norms.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# purposes of the seed streams
EMBED, LAYER, TRAFFIC, SAMPLE = 0, 1, 2, 3
# the traffic's own streams
STRATUM, STAGGER = 0, 1


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one purpose of a run's seed (any whole number)."""
    words = [seed % 2**32, (seed // 2**32) % 2**32, int(seed < 0), *tags]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def generator(seed: int, *tags: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    t = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (t * scale).to(torch.bfloat16)


def sizes(conf: dict) -> dict:
    """The widths of a configuration file, under short names."""
    h = conf["hidden_size"]
    nq = conf["num_attention_heads"]
    d = conf.get("head_dim") or h // nq
    return dict(h=h, f=conf["intermediate_size"],
                layers=conf["num_hidden_layers"], nq=nq,
                nkv=conf["num_key_value_heads"], d=d,
                vocab=conf["vocab_size"])


def head(conf: dict, seed: int, device) -> dict:
    """embed (V, h), final_norm (h,), lm_head (h, V), bf16."""
    s = sizes(conf)
    g = generator(seed, EMBED, device=device)
    return {"embed": _normal(g, (s["vocab"], s["h"]), 0.02),
            "final_norm": torch.ones(s["h"], dtype=torch.bfloat16,
                                     device=device),
            "lm_head": _normal(g, (s["h"], s["vocab"]), 0.02)}


def layer(conf: dict, seed: int, i: int, device) -> dict:
    """Decoder layer i: attn_norm, mlp_norm (h,); wq, wk, wv, wo, w_gate,
    w_up, w_down. All bf16."""
    s = sizes(conf)
    h, f, d = s["h"], s["f"], s["d"]
    g = generator(seed, LAYER, i, device=device)

    def proj(*shape):
        return _normal(g, shape, 1.0 / math.sqrt(shape[-2]))

    lp = {"attn_norm": torch.ones(h, dtype=torch.bfloat16, device=device),
          "mlp_norm": torch.ones(h, dtype=torch.bfloat16, device=device),
          "wq": proj(h, s["nq"] * d), "wk": proj(h, s["nkv"] * d),
          "wv": proj(h, s["nkv"] * d), "wo": proj(s["nq"] * d, h),
          "w_gate": proj(h, f), "w_up": proj(h, f), "w_down": proj(f, h)}
    return lp
