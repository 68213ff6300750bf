"""work.py's operations and bytes against hand counts for a tiny
configuration, counted from real rows."""

from __future__ import annotations

import json

import numpy as np
import pytest

from benchmark import work
from conftest import HERE


def _conf(name):
    return json.loads((HERE / "data" / f"{name}.json").read_text())


def _sum(ops, kind=None):
    ops = [o for o in ops if kind is None or o.kind == kind]
    return sum(o.nbytes for o in ops), sum(o.flops for o in ops)


def test_decode_step_hand_count():
    # tiny-llama: h 256, f 512, 2 layers, 4 heads, 2 kv heads, d 64,
    # vocab 512, nvfp4 at 0.5625 bytes a weight, fp8 pages of 16
    m = work.Model(_conf("tiny-llama"))
    pos = np.array([5, 20])
    ops = m.decode_step(pos, launched=4)
    # projections: (256 x 512) qkv, (256 x 256) wo, (256 x 1024) gate|up,
    # (512 x 256) down, per layer; x read and y written in bf16
    kn = [(256, 512), (256, 256), (256, 1024), (512, 256)]
    w_bytes = sum(k * n for k, n in kn) * 0.5625
    act = sum(2 * (k + n) * 2 for k, n in kn)
    flops = sum(2 * 2 * k * n for k, n in kn)
    assert _sum(ops, "gemm") == pytest.approx((2 * (w_bytes + act),
                                               2 * flops))
    # attention: 6 + 21 positions of K and V (2 kv heads x 64, fp8), q in
    # and out for 2 rows x 4 heads x 64 in bf16, 2 positions, and the
    # pages of each row (1 and 2) at 4 bytes
    attn_b = 2 * 27 * 2 * 64 * 1 + 2 * 2 * 4 * 64 * 2 + 4 * 2 + 4 * 3
    assert _sum(ops, "attn_decode") == pytest.approx(
        (2 * attn_b, 2 * 4 * 4 * 64 * 27))
    assert _sum(ops, "kv_append")[0] == pytest.approx(
        2 * (2 * 2 * 2 * 64 * 3 + 8 * 2))
    # the head: bf16 (256 x 512) once, 2 rows in and out
    assert _sum(ops, "dense") == pytest.approx(
        (256 * 512 * 2 + 2 * (256 + 512) * 2, 2 * 2 * 256 * 512))


def test_rows_launched_do_not_change_the_work():
    m = work.Model(_conf("tiny-llama"))
    pos = np.array([7, 9, 30])
    a = m.decode_step(pos, launched=3)
    b = m.decode_step(pos, launched=32)
    assert _sum(a) == _sum(b)
    assert {o.rows for o in b} == {32}
    # a chunk of 40 real tokens counts 40, whatever its bucket
    c1 = m.chunks([(0, 40)], launched=64, heads=1)
    c2 = m.chunks([(0, 40)], launched=4 * 64, heads=1)
    assert _sum(c1) == _sum(c2)
    assert _sum(c1, "gemm")[1] == pytest.approx(
        2 * 2 * 40 * (256 * 512 + 256 * 256 + 256 * 1024 + 512 * 256))


def test_prefill_attention_pairs():
    m = work.Model(_conf("tiny-llama"))
    # a chunk of 10 after 32 cached positions: 10 * 32 + 55 pairs
    _, flops = _sum(m.chunks([(32, 10)], launched=16, heads=0),
                    "attn_prefill")
    assert flops == pytest.approx(2 * 4 * 4 * 64 * (10 * 32 + 55))
    # only prompts that end in the chunk read the head
    assert _sum(m.chunks([(0, 10)], launched=16, heads=0), "dense") == (0, 0)


def test_bound_takes_the_larger_side():
    pk = {"hbm_bytes_per_s": 1e12, "bf16_flop_per_s": 1e15}
    assert work.bound_s(1e9, 1e9, pk) == pytest.approx(1e-3)
    assert work.bound_s(1e3, 1e13, pk) == pytest.approx(1e-2)
