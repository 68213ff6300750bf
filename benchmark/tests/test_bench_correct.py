"""The tiny cells run whole on the CPU and their served tokens agree with
the plain reference; with the timed path broken underneath, the same run
says `correct` is false. The reference's quantization gives the program's
weights bit for bit."""

from __future__ import annotations

import json

import time

import pytest
import torch

from benchmark import run, weights
from benchmark.reference import mistral as ref
from conftest import HERE


def _run(tiny, name, traced=False, seed=2**31 + 5):
    # an open loop's requests wait for their arrivals: a longer window
    # finishes some on a busy CPU
    seconds = 8.0 if name.endswith(".open") else 4.0
    return run.run_cell(tiny, name, seed, seconds, traced,
                        torch.device("cpu"), t_start=time.perf_counter())


@pytest.mark.parametrize("name,traced", [("tiny-llama.closed", False),
                                         ("tiny-llama.open", True)])
def test_tiny_cell_is_correct(tiny, name, traced):
    out = _run(tiny, name, traced)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    want = {m["name"] for m in tiny.metrics(name, traced)}
    got = set(out["metrics"])
    # on the CPU there is no device trace and no card's peaks
    cpu_absent = {"kernels.decode_gemm_roofline",
                  "kernels.decode_attn_roofline", "device.idle_share.decode",
                  "model.decode_step_mfu", "kernels.prefill_gemm_roofline",
                  "kernels.prefill_attn_roofline", "device.idle_share.chat",
                  "model.prefill_mfu"}
    assert got == want - cpu_absent
    assert all(v["value"] > 0 for v in out["metrics"].values()), \
        out["metrics"]


def _no_kv_write(*a, **kw):
    """A step that returns its state unchanged: no KV row is written."""


def _altered(inner):
    def sample(logits, generator, temps, top_k=0):
        tok = inner(logits, generator, temps, top_k)
        return (tok + 1) % logits.shape[-1]
    return sample


@pytest.mark.parametrize("fault", ["state_unchanged", "token_altered"])
@pytest.mark.parametrize("name", ["tiny-llama.closed"])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, fault, name):
    from petit_kernel_tpu_torch.models import llama, paged, serving
    if fault == "state_unchanged":
        monkeypatch.setattr(llama, "_write_kv", _no_kv_write)
        monkeypatch.setattr(paged, "_write_kv", _no_kv_write)
    else:
        monkeypatch.setattr(serving, "sample_next",
                            _altered(serving.sample_next))
    out = _run(tiny, name)
    assert not out["correct"]
    assert out["checks"]["mean_logit_gap"]["value"] > \
        out["checks"]["mean_logit_gap"]["limit"]


def test_reference_quantizes_as_the_program():
    """The reference's dequantized weights equal the program's, decoded
    from its own layout: the same recipe gives the same values."""
    from benchmark.families import llama as program
    from petit_kernel_tpu_torch.ops import layout
    conf = json.loads((HERE / "data" / "tiny-llama.json").read_text())
    dev = torch.device("cpu")
    params = program.params(conf, 11, dev)
    mine = ref._layer_weights(conf, 11, 1, dev)
    lp = params["layers"][1]

    def decoded(q):
        k = q["words"].shape[0] * 8
        n = q["words"].shape[1]
        w = layout.dequant_from_tpu_layout(q["words"], q["scales"], n, k)
        return w.float() * q["gs"].float()

    qkv = torch.cat([mine["wq"], mine["wk"], mine["wv"]], dim=1)
    assert torch.equal(decoded(lp["wqkv"])[:qkv.shape[0]], qkv)
    gu = torch.cat([mine["w_gate"], mine["w_up"]], dim=1)
    assert torch.equal(decoded(lp["w_gateup"])[:gu.shape[0]], gu)
    assert torch.equal(decoded(lp["w_down"])[:mine["w_down"].shape[0]],
                       mine["w_down"])


def test_weights_are_made_from_the_seed():
    conf = json.loads((HERE / "data" / "tiny-llama.json").read_text())
    a = weights.layer(conf, 2**31 + 3, 1, "cpu")
    b = weights.layer(conf, 2**31 + 3, 1, "cpu")
    c = weights.layer(conf, 2**31 + 3, 0, "cpu")
    assert torch.equal(a["w_up"], b["w_up"])
    assert not torch.equal(a["wq"], c["wq"])
    assert weights.sub_seed(-5, 1) != weights.sub_seed(5, 1)


def test_e2m1_rounding_is_half_to_even():
    x = torch.tensor([0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0, 7.0, -0.25,
                      -2.5, 0.26, 4.9])
    assert ref.round_e2m1(x).tolist() == [0.0, 1.0, 1.0, 2.0, 2.0, 4.0, 4.0,
                                          6.0, -0.0, -2.0, 0.5, 4.0]
