"""HuggingFace checkpoint loader (torch): safetensors -> the port's params.

Counterpart of petit_kernel_tpu/models/loader.py: load a Llama-family
checkpoint directory (config.json and *.safetensors shards) into the
port's params tree, on `device` (default the CUDA card), quantizing or
repacking every projection there. Two flavours:
  1. Dense bf16/f16/f32 (standard HF Llama, Qwen2 with its q/k/v biases):
     quantized with llama.quantize_linear in `fmt`, or kept dense for
     fmt="bf16".
  2. Pre-quantized ModelOpt NVFP4, per linear
        {prefix}.weight          uint8 (n, k/2) packed E2M1 pairs
        {prefix}.weight_scale    float8_e4m3fn (n, k/16) block scales
        {prefix}.weight_scale_2  float32 () global scale
     repacked as they are (layout.repack_fp4_weights,
     process_fp4_scales); fmt "nvfp4p2" and "nvfp4p2z" requantize them to
     pow2 scales first.
Layers stay unfused (wq, wk, wv, w_gate, w_up), as the JAX loader leaves
them; llama.attention and llama.mlp serve them so.

The shards are read by read_safetensors, this module's own reader of the
format (no safetensors package): tensors are CPU views over an mmap of
each shard, copied once to the device. Repacked projections are cached in
<path>/petit_tpu_cache/<fmt>.npz under the JAX loader's keys and bits
(words as uint32, scales as uint16 bf16 bits, gs as a float32 scalar), so
either package reads the other's cache; a cache older than a shard, or
unreadable, is ignored.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Optional

import numpy as np
import torch

from . import llama
from .convert import tensor_from_numpy
from ..numerics import reference as ref_numerics
from ..ops import layout as layout_mod

_HF_LAYER_MAP = {
    "input_layernorm.weight": "attn_norm",
    "post_attention_layernorm.weight": "mlp_norm",
    "self_attn.q_proj": "wq",
    "self_attn.k_proj": "wk",
    "self_attn.v_proj": "wv",
    "self_attn.o_proj": "wo",
    "mlp.gate_proj": "w_gate",
    "mlp.up_proj": "w_up",
    "mlp.down_proj": "w_down",
}

# the safetensors dtypes the loader meets, by their header name
SAFETENSORS_DTYPES = {
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "F32": torch.float32,
    "U8": torch.uint8,
    "F8_E4M3": torch.float8_e4m3fn,
    "I32": torch.int32,
}


def config_from_hf(hf: dict) -> llama.LlamaConfig:
    return llama.LlamaConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads",
                            hf["num_attention_heads"]),
        head_dim=hf.get("head_dim", hf["hidden_size"]
                        // hf["num_attention_heads"]),
        rope_theta=hf.get("rope_theta", 500000.0),
        rms_eps=hf.get("rms_norm_eps", 1e-5),
        # Qwen2/Qwen2.5: the Llama architecture with q/k/v biases
        attn_bias=(hf.get("attention_bias", False)
                   or any("Qwen2" in a
                          for a in hf.get("architectures", []))),
    )


def read_safetensors(file: str) -> dict:
    """Every tensor of one .safetensors file, by name, as CPU tensors over
    a copy-on-write mmap of the file (nothing is read until used). The
    format: an 8-byte little-endian header length, a JSON header mapping
    each name to its dtype, shape and data_offsets (relative to the end of
    the header), then the raw little-endian bytes. Raises ValueError on a
    dtype outside SAFETENSORS_DTYPES or a size that does not match."""
    with open(file, "rb") as f:
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    (n,) = struct.unpack("<Q", buf[:8])
    header = json.loads(buf[8:8 + n])
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt = info["dtype"]
        if dt not in SAFETENSORS_DTYPES:
            raise ValueError(f"{file}: tensor {name!r} has dtype {dt}; the "
                             f"loader reads {sorted(SAFETENSORS_DTYPES)}")
        dtype = SAFETENSORS_DTYPES[dt]
        shape = [int(s) for s in info["shape"]]
        start, end = info["data_offsets"]
        size = int(np.prod(shape)) * dtype.itemsize
        if end - start != size:
            raise ValueError(f"{file}: tensor {name!r} ({dt}, {shape}) "
                             f"holds {end - start} bytes, not {size}")
        if size == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        raw = torch.frombuffer(buf, dtype=torch.uint8, count=size,
                               offset=8 + n + start)
        out[name] = raw.view(dtype).reshape(shape)
    return out


def _open_all_tensors(path: str) -> dict:
    """Every tensor of all *.safetensors files under path (read_safetensors
    views)."""
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {path}")
    tensors = {}
    for f in files:
        tensors.update(read_safetensors(os.path.join(path, f)))
    return tensors


def _to(t: torch.Tensor, device, dtype=None) -> torch.Tensor:
    """A copy of a checkpoint tensor on `device`: never a view of the
    shard's mmap."""
    return t.to(device=device, dtype=dtype or t.dtype, copy=True)


def _make_quantized_layer(tensors: dict, prefix: str, fmt: str,
                          device) -> dict:
    """The quantized-linear dict of the HF linear `prefix`, from dense or
    pre-quantized (ModelOpt NVFP4) checkpoint tensors, built on
    `device`."""
    wkey = f"{prefix}.weight"
    skey = f"{prefix}.weight_scale"
    gkey = f"{prefix}.weight_scale_2"
    if skey in tensors:  # pre-quantized ModelOpt NVFP4
        qw = _to(tensors[wkey], device).view(torch.uint8)
        scales = _to(tensors[skey], device).view(torch.uint8)
        gs = _to(tensors[gkey], device, torch.float32).reshape(())
        if fmt in ("nvfp4p2", "nvfp4p2z"):
            # serve the exact-NVFP4 checkpoint on pow2 scales: a re-round,
            # opt-in through fmt ("nvfp4p2z" also rounds away zero codes)
            qw, scales, gs = ref_numerics.requantize_nvfp4_pow2(
                qw, scales, gs, zero_free=(fmt == "nvfp4p2z"))
        n, kb = qw.shape
        k = kb * 2
        words = layout_mod.repack_fp4_weights(qw, n, k)
        st = layout_mod.process_fp4_scales(scales, n, k, group_size=16)
        return {"words": words, "scales": st,
                "gs": gs.reshape(()).to(torch.float32)}
    w = _to(tensors[wkey], device, torch.float32)   # HF: (n, k) = (out, in)
    return llama.quantize_linear(w.T, fmt)


def _cache_file(path: str, fmt: str) -> str:
    return os.path.join(path, "petit_tpu_cache", f"{fmt}.npz")


def _load_repack_cache(path: str, fmt: str):
    """{(layer, name): {"words", "scales", "gs"} numpy arrays} from the
    repack cache if it is newer than every safetensors shard, else None
    (also for a corrupt or partial cache)."""
    cache = _cache_file(path, fmt)
    if not os.path.exists(cache):
        return None
    src = max((os.path.getmtime(os.path.join(path, f))
               for f in os.listdir(path) if f.endswith(".safetensors")),
              default=0.0)
    if os.path.getmtime(cache) < src:
        return None
    try:
        with np.load(cache) as raw:
            out: dict = {}
            for key in raw.files:
                li, name, part = key.split("/")
                out.setdefault((int(li), name), {})[part] = raw[key]
        return out
    except Exception:
        return None  # corrupt or partial cache: repack afresh


def _save_repack_cache(path: str, fmt: str, layers: list) -> None:
    """Best effort: write every quantized projection so that a reload skips
    the repack; a read-only checkpoint directory is skipped. The bits are
    the JAX loader's: words uint32, scales the uint16 bits of bf16, gs a
    float32 scalar."""
    arrays = {}
    for li, lp in enumerate(layers):
        for name, val in lp.items():
            if isinstance(val, dict) and "words" in val:
                arrays[f"{li}/{name}/words"] = (
                    val["words"].cpu().numpy().view(np.uint32))
                arrays[f"{li}/{name}/scales"] = (
                    val["scales"].cpu().view(torch.int16).numpy()
                    .view(np.uint16))
                arrays[f"{li}/{name}/gs"] = np.asarray(
                    val["gs"].cpu().numpy(), np.float32).reshape(())
    try:
        target = _cache_file(path, fmt)
        os.makedirs(os.path.dirname(target), exist_ok=True)
        tmp = target + ".tmp"
        np.savez(tmp, **arrays)
        # np.savez appends .npz to a name without it
        os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", target)
    except OSError:
        pass  # read-only checkpoint directory: no cache


def load_llama(path: str, fmt: str = "nvfp4",
               cfg: Optional[llama.LlamaConfig] = None,
               use_cache: bool = True, device=None):
    """Load an HF Llama checkpoint directory -> (cfg, params) on `device`
    (default the CUDA card; llama.resolve_device raises without one).

    fmt: "nvfp4", "mxfp4", "nvfp4p2", "nvfp4p2z", "mxfp4z", "w4a8" (the
    nvfp4 container), "hybrid" or "bf16" (dense). Pre-quantized ModelOpt
    NVFP4 projections are repacked as they are ("nvfp4p2" and "nvfp4p2z"
    requantize them). Tied embeddings (no lm_head.weight) give lm_head
    {"w": embed.T}; Qwen2 q/k/v biases are kept bf16 as "b". With
    use_cache, repacked projections come from and go to
    <path>/petit_tpu_cache/<fmt>.npz (never for "bf16" or "hybrid", whose
    dense columns the cache does not hold)."""
    device = llama.resolve_device(device)
    if cfg is None:
        with open(os.path.join(path, "config.json")) as f:
            cfg = config_from_hf(json.load(f))
    tensors = _open_all_tensors(path)
    cacheable = use_cache and fmt not in ("bf16", "hybrid")
    cached = _load_repack_cache(path, fmt) if cacheable else None

    def bf16(key):
        return _to(tensors[key], device, torch.float32).to(torch.bfloat16)

    def dense(key):
        return {"w": bf16(key).T.contiguous()}

    embed = bf16("model.embed_tokens.weight")
    params = {
        "embed": embed,
        "final_norm": bf16("model.norm.weight"),
        "lm_head": (dense("lm_head.weight") if "lm_head.weight" in tensors
                    else {"w": embed.T}),      # tied embeddings
        "layers": [],
    }
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        lp = {"attn_norm": bf16(pre + "input_layernorm.weight"),
              "mlp_norm": bf16(pre + "post_attention_layernorm.weight")}
        for hf_name, ours in _HF_LAYER_MAP.items():
            if ours in ("attn_norm", "mlp_norm"):
                continue
            prefix = pre + hf_name
            if fmt == "bf16":
                lp[ours] = dense(prefix + ".weight")
            elif cached is not None and (i, ours) in cached:
                c = cached[(i, ours)]
                lp[ours] = {"words": tensor_from_numpy(c["words"], device),
                            "scales": tensor_from_numpy(c["scales"], device),
                            "gs": tensor_from_numpy(c["gs"], device).to(
                                torch.float32).reshape(())}
            else:
                lp[ours] = _make_quantized_layer(tensors, prefix, fmt,
                                                 device)
            if prefix + ".bias" in tensors:    # Qwen2 q/k/v bias, bf16
                lp[ours]["b"] = bf16(prefix + ".bias")
        params["layers"].append(lp)
    if cacheable and cached is None:
        _save_repack_cache(path, fmt, params["layers"])
    return cfg, params
