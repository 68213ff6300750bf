"""Operations and bytes of the work a served model does, from its shapes and
the tokens served: the yardstick of every roofline and mfu metric.

Work is counted from real rows: the tokens of the requests in a decode
step or a prefill chunk, never the padded bucket or the batch rows that
ride along, so a change that stops computing padding is credited for it.
Weights are counted at their format's own size (nvfp4: a 4-bit value and
an E4M3 scale per 16, 0.5625 bytes a weight; bf16: 2 bytes), read once a
call, whatever layout the program keeps them in. Norms, RoPE and
sampling are not counted.

Each Op carries the rows the program launched it with (`rows`), which the
kernel families' files use to say which family runs it.

bound() and the attention and KV-write counts follow chip_smoke.py's
`bound`, `_decode_work`, `_prefill_work` and `_append_work`, rewritten
over counts instead of tensors.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

import numpy as np

from . import weights

BYTES_PER_WEIGHT = {"nvfp4": 0.5 + 1 / 16, "bf16": 2.0}
KV_BYTES = {"fp8": 1, "bf16": 2}
ACT = 2                       # bf16 activations


@dataclasses.dataclass
class Op:
    kind: str                 # "gemm", "dense", "attn_decode",
    rows: int                 # "attn_prefill", "kv_append"
    nbytes: float
    flops: float
    what: str = ""            # the projection or step it stands for


def peaks(device_name: str) -> Optional[dict]:
    """The card's peaks from peaks.json, or None for a card not listed."""
    table = json.loads((Path(__file__).parent / "peaks.json").read_text())
    return table.get(device_name)


def bound_s(nbytes: float, flops: float, pk: dict) -> float:
    """The least time a call that moves nbytes and does flops can take:
    the larger of the two over the card's bandwidth and bf16 peak."""
    return max(nbytes / pk["hbm_bytes_per_s"], flops / pk["bf16_flop_per_s"])


def gemm(m: int, k: int, n: int, fmt: str, rows: int, what: str) -> Op:
    """y (m, n) = x (m, k) @ W (k, n): W, x read and y written once."""
    return Op("gemm", rows, k * n * BYTES_PER_WEIGHT[fmt] + m * (k + n) * ACT,
              2.0 * m * k * n, what)


def decode_attn(pos: np.ndarray, nq: int, nkv: int, d: int, kv: int,
                page_size: Optional[int], rows: int) -> Op:
    """One decode-attention call: each row's q in and out, and the K and V
    rows of positions <= pos[b] (with their block-table entries when
    paged); QK and PV at 2 operations a multiply-add."""
    pos = np.asarray(pos, np.int64)
    n = int((pos + 1).sum())
    nbytes = 2 * len(pos) * nq * d * ACT + 2 * n * nkv * d * kv + 4 * len(pos)
    if page_size:
        nbytes += 4 * int(((pos + page_size) // page_size).sum())
    return Op("attn_decode", rows, nbytes, 4.0 * nq * d * n, "attention")


def prefill_attn(chunks, nq: int, nkv: int, d: int, kv: int,
                 page_size: Optional[int], rows: int) -> Op:
    """Causal chunks [(offset, n)]: query t of a chunk at offset o reads
    the positions <= o + t."""
    nbytes, pairs = 0.0, 0
    for o, n in chunks:
        pairs += n * o + n * (n + 1) // 2
        nbytes += 2 * n * nq * d * ACT + 2 * (o + n) * nkv * d * kv + 4
        if page_size:
            nbytes += 4 * -(-(o + n) // page_size)
    return Op("attn_prefill", rows, nbytes, 4.0 * nq * d * pairs,
              "attention")


def kv_append(tokens: int, nkv: int, d: int, kv: int, rows: int) -> Op:
    """Their bf16 K and V read once and their cache rows written once."""
    return Op("kv_append", rows, 2 * tokens * nkv * d * (ACT + kv) + 8 * tokens,
              0.0, "kv_append")


def _times(op: Op, k: int) -> Op:
    return dataclasses.replace(op, nbytes=op.nbytes * k, flops=op.flops * k)


class Model:
    """The work of one configuration's forwards."""

    def __init__(self, conf: dict):
        self.s = weights.sizes(conf)
        serve = conf["serve"]
        self.fmt = serve["weights"]
        self.kv = KV_BYTES[serve["kv_dtype"]]
        self.page = serve.get("page_size") if serve["engine"] == "paged" \
            else None

    def _layer(self, m: int, launched: int) -> list[Op]:
        """One layer's projections for m real rows of a launch of
        `launched` rows."""
        s = self.s
        h, f, d = s["h"], s["f"], s["d"]
        att, mlp = self.fmt["attention"], self.fmt["mlp"]
        return [gemm(m, h, (s["nq"] + 2 * s["nkv"]) * d, att, launched,
                     "attn_in"),
                gemm(m, s["nq"] * d, h, att, launched, "attn_out"),
                gemm(m, h, 2 * f, mlp, launched, "mlp_in"),
                gemm(m, f, h, mlp, launched, "mlp_out")]

    def _head(self, rows: int, launched: int) -> list[Op]:
        s = self.s
        if not rows:
            return []
        return [Op("dense", launched, s["h"] * s["vocab"] * ACT
                   + rows * (s["h"] + s["vocab"]) * ACT,
                   2.0 * rows * s["h"] * s["vocab"], "head")]

    def decode_step(self, pos: np.ndarray, launched: int) -> list[Op]:
        """One decode step: the active rows write position pos[b] and
        attend positions <= pos[b]."""
        s = self.s
        m = len(pos)
        L = s["layers"]
        per = self._layer(m, launched) + [
            decode_attn(pos, s["nq"], s["nkv"], s["d"], self.kv, self.page,
                        launched),
            kv_append(m, s["nkv"], s["d"], self.kv, launched)]
        return [_times(op, L) for op in per] + self._head(m, launched)

    def chunks(self, chunks, launched: int, heads: int) -> list[Op]:
        """One prefill forward over chunks [(offset, real tokens)],
        launched as `launched` rows; `heads` of them end their prompt (the
        logits of their last token are the ones used)."""
        s = self.s
        m = sum(n for _, n in chunks)
        L = s["layers"]
        per = self._layer(m, launched) + [
            prefill_attn(chunks, s["nq"], s["nkv"], s["d"], self.kv,
                         self.page, launched),
            kv_append(m, s["nkv"], s["d"], self.kv, launched)]
        return [_times(op, L) for op in per] + self._head(heads, launched)
