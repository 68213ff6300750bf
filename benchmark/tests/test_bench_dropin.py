"""A configuration, a traffic mix, a cell and a per-layer metric are added
as new files and entries, and the harness finds them without an edit of
any file that was there."""

from __future__ import annotations

import hashlib
import json
import time

import torch

from benchmark import run, spec
from conftest import BENCH, HERE, make_copy


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    checkout, _ = make_copy(tmp_path)
    root = checkout / "benchmark"
    before = _digests(root)
    # a configuration: tiny-llama with a bf16 flat cache, as a new file
    conf = json.loads((HERE / "data" / "tiny-llama.json").read_text())
    conf["serve"].update(engine="flat", kv_dtype="bf16")
    (root / "configs" / "tiny-flat.json").write_text(json.dumps(conf))
    # a mix: the tiny closed loop with shorter outputs
    mix = json.loads((HERE / "data" / "tiny-closed.json").read_text())
    mix["output"] = {"dist": "uniform", "min": 6, "max": 12}
    (root / "traffic" / "tiny-short.json").write_text(json.dumps(mix))
    # a cell, and a per-layer metric with its reader
    (root / "cells" / "tiny-flat.short.json").write_text(
        json.dumps({"limits": {"mean_logit_gap": 0.01}}))
    (root / "metrics" / "engine.requests_admitted.py").write_text(
        "def read(run):\n"
        "    n = sum(s.attrs['done'] for s in run.window('engine.prefill'))\n"
        "    return n or None\n")
    b = json.loads((checkout / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny-flat", "source": "test",
                         "file": "benchmark/configs/tiny-flat.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "tiny-flat.short", "config": "tiny-flat",
                           "traffic": "tiny-short", "chips": 1,
                           "why": "test"})
    b["per_layer"].append({"name": "engine.requests_admitted",
                           "unit": "requests", "better": "higher",
                           "source": "program_span", "layer": "engine",
                           "moves": "tpot_p90_ms",
                           "workloads": ["tiny-flat.short"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(b))
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())   # nothing edited

    bench = spec.Bench.at(checkout, root=root)
    assert bench.mix("tiny-short")["output"]["max"] == 12
    assert bench.config("tiny-flat")["serve"]["engine"] == "flat"
    out = run.run_cell(bench, "tiny-flat.short", 7, 3.0, True,
                       torch.device("cpu"), t_start=time.perf_counter())
    assert out["correct"]
    assert out["metrics"]["engine.requests_admitted"]["value"] >= 1
    assert list(out)[-1] == "checks"


def test_the_real_benchmark_names_every_file():
    bench = spec.Bench.at(BENCH.parent)
    names = [m["name"] for m in bench.spec["end_to_end"]
             + bench.spec["per_layer"]]
    for n in names:
        assert callable(bench.reader(n))
    for w in bench.spec["workloads"]:
        bench.mix(w["traffic"])
        conf = bench.config(w["config"])
        assert conf["serve"]["family"] == "llama"
        if bench.mix(w["traffic"])["loop"] == "open":
            assert bench.cell(w["name"])["rate"] > 0
        assert bench.cell(w["name"])["limits"]["mean_logit_gap"] > 0
    for fam in bench.families().values():
        assert fam["patterns"] and fam["op"]


def test_knee_sweep_runs_every_rate(tiny):
    from benchmark import sweep
    rows = list(sweep.sweep(tiny, "tiny-llama.open", 3, 2.0, [2.0, 6.0],
                            torch.device("cpu")))
    assert [r["rate"] for r in rows] == [2.0, 6.0]
    assert all(r["due"] > 0 and r["ttft_p90_ms"] > 0 for r in rows)
