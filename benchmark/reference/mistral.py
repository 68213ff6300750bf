"""Plain float32 reference of the dense Mistral family (Mistral-7B:
SwiGLU MLPs).

It follows the original Mistral reference code (mistral-inference):
pre-norm decoder layers, RMSNorm, grouped-query attention with rotary
embeddings on interleaved pairs of each head's dimensions, causal softmax.
Departures, each what the configuration file states about how the model
is served:

- the weights are the benchmark's raw bf16 weights (weights.py) quantized
  and dequantized here by the recipe the configuration names, "nvfp4":
  blocks of 16 along k, an E4M3 scale rounded up so that no value
  saturates, one f32 global scale amax / (6 * 448) for each tensor, or for
  each group of tensors listed together in serve.quant_groups, values
  rounded to E2M1 half to even; the embedding and the output head stay
  bf16;
- keys and values are rounded to the cache's dtype (serve.kv_dtype) as
  the cache stores them.

Everything else is float32, with TF32 off. Nothing here imports the
program. A variant (Variant) may round the input of every matrix product
and store the keys and values in another dtype: the precision control.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from .. import weights

KV_DTYPES = {"fp8": torch.float8_e4m3fn, "bf16": torch.bfloat16}


def round_e2m1(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest E2M1 value (0, .5, 1, 1.5, 2, 3, 4, 6 and
    negatives), ties to the even code, saturating at 6. The grid's step is
    .5 below 2, 1 below 4 and 2 up to 6; on each stretch the even codes
    are the even multiples of the step, so torch.round (half to even)
    of x / step picks them."""
    a = x.abs().clamp(max=6.0)
    q = torch.where(a < 2, torch.round(a * 2) / 2,
                    torch.where(a < 4, torch.round(a), torch.round(a / 2) * 2))
    return torch.copysign(q, x)


def _e4m3_grid(device) -> torch.Tensor:
    """Every positive finite E4M3 value, ascending (bytes 1..126)."""
    codes = torch.arange(1, 127, dtype=torch.uint8, device=device)
    return codes.view(torch.float8_e4m3fn).float()


def nvfp4(w_nk: torch.Tensor) -> torch.Tensor:
    """Quantize (n, k) f32 to NVFP4 and back to f32: per 16 values along k
    the smallest E4M3 scale s with amax / 6 <= s * gs, gs = amax of the
    whole tensor / (6 * 448)."""
    n, k = w_nk.shape
    wg = w_nk.reshape(n, k // 16, 16)
    amax = wg.abs().amax()
    gs = torch.where(amax > 0, amax / (6.0 * 448.0), 1.0)
    sf = wg.abs().amax(dim=-1) / 6.0 / gs
    grid = _e4m3_grid(w_nk.device)
    idx = torch.searchsorted(grid, sf.contiguous()).clamp(max=len(grid) - 1)
    s = grid[idx]
    q = round_e2m1(wg / (s * gs)[:, :, None])
    return (q * s[:, :, None] * gs).reshape(n, k)


QUANTIZE = {"nvfp4": nvfp4}


def dequantized(w_kn: torch.Tensor, fmt: str) -> torch.Tensor:
    """(k, n) bf16 -> (k, n) f32 as the format stores it."""
    return QUANTIZE[fmt](w_kn.float().T).T


def _layer_weights(conf: dict, seed: int, i: int, device) -> dict:
    """Layer i's weights as served, f32: projections (k, n) dequantized
    (a quant group quantized as one tensor concatenated along n), the
    norms as stored."""
    serve = conf["serve"]
    fmts = serve["weights"]
    raw = weights.layer(conf, seed, i, device)
    out = {name: raw[name].float() for name in ("attn_norm", "mlp_norm")}
    groups = [list(g) for g in serve.get("quant_groups", [])]
    names = ["wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"]
    grouped = {n for g in groups for n in g}
    groups += [[n] for n in names if n not in grouped]
    for g in groups:
        fmt = fmts["attention" if g[0] in ("wq", "wk", "wv", "wo")
                   else "mlp"]
        w = dequantized(torch.cat([raw[n] for n in g], dim=1), fmt)
        for n, part in zip(g, w.split([raw[n].shape[1] for n in g], dim=1)):
            out[n] = part
    del raw
    return out


def _rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (L, heads, d) at positions 0..L-1, on the
    interleaved pairs (x[2i], x[2i + 1])."""
    L, _, d = x.shape
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    ang = torch.arange(L, dtype=torch.float32, device=x.device)[:, None,
                                                               None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).reshape(x.shape)


@dataclasses.dataclass(frozen=True)
class Variant:
    """One forward of the reference: `act` rounds every matrix product's
    input (None: float32), `kv` the cache's dtype (None: the
    configuration's)."""
    act: Optional[Callable] = None
    kv: Optional[torch.dtype] = None


def control(conf: dict) -> Variant:
    """The precision control: activations in fp8 where the configuration
    serves them in bf16, and a bf16 KV cache in fp8 too."""
    kv = torch.float8_e4m3fn if conf["serve"]["kv_dtype"] == "bf16" else None
    return Variant(act=fp8_rows, kv=kv)


class Reference:
    """Full-sequence logits of token sequences, layer by layer: each
    layer's weights are made and quantized once for all sequences, so only
    one layer's weights are ever held, for each of `variants`."""

    def __init__(self, conf: dict, seed: int, device,
                 variants: tuple[Variant, ...] = (Variant(),)):
        self.conf, self.seed, self.device = conf, seed, device
        self.s = weights.sizes(conf)
        self.variants = variants
        self.kv_dtype = KV_DTYPES[conf["serve"]["kv_dtype"]]
        self.eps = conf["rms_norm_eps"]
        self.theta = float(conf["rope_theta"])

    def _mm(self, x, w, var):
        return (x if var.act is None else var.act(x)) @ w

    def _attention(self, h, lw, var):
        s = self.s
        L = h.shape[0]
        nq, nkv, d = s["nq"], s["nkv"], s["d"]
        q = _rope(self._mm(h, lw["wq"], var).reshape(L, nq, d), self.theta)
        k = _rope(self._mm(h, lw["wk"], var).reshape(L, nkv, d), self.theta)
        v = self._mm(h, lw["wv"], var).reshape(L, nkv, d)
        kv = var.kv or self.kv_dtype
        k = k.to(kv).float()
        v = v.to(kv).float()
        rep = nq // nkv
        k = k.repeat_interleave(rep, dim=1).transpose(0, 1)   # (nq, L, d)
        v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
        scores = q.transpose(0, 1) @ k.transpose(1, 2) / math.sqrt(d)
        causal = torch.ones(L, L, dtype=torch.bool, device=h.device).tril()
        p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        o = (p @ v).transpose(0, 1).reshape(L, nq * d)
        return self._mm(o, lw["wo"], var)

    def _swiglu(self, h, wg, wu, wd, var):
        g = self._mm(h, wg, var)
        u = self._mm(h, wu, var)
        return self._mm(torch.nn.functional.silu(g) * u, wd, var)

    @torch.no_grad()
    def logits(self, seqs: list, starts: list) -> list:
        """For each token sequence (1-D int tensor) the logits (f32) at
        positions starts[i] .. len - 1, for each variant:
        [variant][sequence] -> (len - start, V)."""
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return self._logits(seqs, starts)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev

    def _logits(self, seqs, starts):
        dev = self.device
        hw = weights.head(self.conf, self.seed, dev)
        embed = hw["embed"]
        toks = [torch.as_tensor(t, dtype=torch.long, device=dev)
                for t in seqs]
        xs = [[embed[t].float() for t in toks] for _ in self.variants]
        del embed
        for i in range(self.s["layers"]):
            lw = _layer_weights(self.conf, self.seed, i, dev)
            for var, xv in zip(self.variants, xs):
                for j, x in enumerate(xv):
                    h = _rms_norm(x, lw["attn_norm"], self.eps)
                    x = x + self._attention(h, lw, var)
                    h = _rms_norm(x, lw["mlp_norm"], self.eps)
                    x = x + self._swiglu(h, lw["w_gate"], lw["w_up"],
                                         lw["w_down"], var)
                    xv[j] = x
            del lw
        head_w = hw["lm_head"].float()
        norm = hw["final_norm"].float()
        out = []
        for var, xv in zip(self.variants, xs):
            out.append([self._mm(_rms_norm(x[s0:], norm, self.eps), head_w,
                                 var) for x, s0 in zip(xv, starts)])
        return out


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """The control's rounding: each row scaled by its amax / 448 into
    E4M3, rounded (half to even) and scaled back: activations in fp8, the
    next precision below the bf16 activations the configuration serves."""
    s = (x.abs().amax(dim=-1, keepdim=True) / 448.0).clamp_min(2.0 ** -126)
    return (x / s).to(torch.float8_e4m3fn).float() * s
