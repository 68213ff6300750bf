"""The port's dense Llama-architecture path (models/llama.py, paged.py,
serving.py) built for a configuration file: the benchmark's raw weights
quantized by the port's own set-up, one layer at a time, and served by
PagedEngine or Engine as serve.engine says."""

from __future__ import annotations

import torch

from petit_kernel_tpu_torch.models import llama, serving

from .. import weights

KV_DTYPES = {"fp8": torch.float8_e4m3fn, "bf16": torch.bfloat16}


def model_config(conf: dict) -> llama.LlamaConfig:
    s = weights.sizes(conf)
    return llama.LlamaConfig(
        vocab_size=s["vocab"], hidden_size=s["h"], intermediate_size=s["f"],
        num_layers=s["layers"], num_heads=s["nq"], num_kv_heads=s["nkv"],
        head_dim=s["d"], rope_theta=float(conf["rope_theta"]),
        rms_eps=conf["rms_norm_eps"],
        max_seq_len=conf["max_position_embeddings"])


def _check_formats(conf: dict) -> str:
    fmts = conf["serve"]["weights"]
    groups = [list(g) for g in conf["serve"].get("quant_groups", [])]
    if fmts["attention"] != fmts["mlp"] or groups != [
            ["wq", "wk", "wv"], ["w_gate", "w_up"]]:
        raise ValueError("the port's dense path quantizes every projection "
                         "in one format, wq|wk|wv and w_gate|w_up as one "
                         "tensor each")
    return fmts["mlp"]


def params(conf: dict, seed: int, device) -> dict:
    """Quantized params on `device`, built layer by layer."""
    fmt = _check_formats(conf)
    hw = weights.head(conf, seed, device)
    out = {"embed": hw["embed"], "final_norm": hw["final_norm"],
           "lm_head": {"w": hw["lm_head"]}, "layers": []}
    for i in range(conf["num_hidden_layers"]):
        raw = weights.layer(conf, seed, i, device)
        tree = {k: (v if k.endswith("norm") else {"w": v})
                for k, v in raw.items()}
        out["layers"] += llama.quantize_params(
            {**out, "layers": [tree]}, fmt)["layers"]
        del raw, tree
    return out


def build(conf: dict, seed: int, slots: int, device) -> serving.Engine:
    serve = conf["serve"]
    fmt = _check_formats(conf)
    cfg = model_config(conf)
    p = params(conf, seed, device)
    kv = KV_DTYPES[serve["kv_dtype"]]
    if serve["engine"] == "paged":
        return serving.PagedEngine(p, cfg, max_batch=slots,
                                   page_size=serve["page_size"],
                                   cache_dtype=kv, fmt=fmt)
    return serving.Engine(p, cfg, max_batch=slots, cache_dtype=kv, fmt=fmt)
