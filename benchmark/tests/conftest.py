"""Tiny cells on the CPU: a temporary copy of the benchmark folder with the
tiny configurations and mixes of data/ added as files of their own, and a
BENCHMARK.json that names them, as a later change would add a cell."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
CHECKOUT = BENCH.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

# tiny cells: name -> (config, mix, cell file). The closed cell's limit
# lies between the program's mean gap on the CPU (at most 0.0012 over
# nine seeds) and its control's (at least 0.0051), as a real cell's does;
# the open cell's samples on a busy CPU can be a few requests.
TINY = {
    "tiny-llama.closed": ("tiny-llama", "tiny-closed",
                          {"limits": {"mean_logit_gap": 0.003}}),
    "tiny-llama.open": ("tiny-llama", "tiny-open",
                        {"rate": 8.0, "limits": {"mean_logit_gap": 0.01}}),
}


def tiny_spec(real: dict) -> dict:
    """BENCHMARK.json for the tiny cells: the real metrics, each listed for
    the tiny cells of its loop kind."""
    closed = [n for n in TINY if n.endswith(".closed")]
    opened = [n for n in TINY if n.endswith(".open")]
    spec = {k: v for k, v in real.items()
            if k not in ("configs", "workloads")}
    spec["configs"] = [{"name": c, "source": "test", "reduced": [],
                        "file": f"benchmark/configs/{c}.json", "why": "test"}
                       for c in sorted({c for c, _, _ in TINY.values()})]
    spec["workloads"] = [{"name": n, "config": c, "traffic": m, "chips": 1,
                          "why": "test"} for n, (c, m, _) in TINY.items()]
    for group in ("end_to_end", "per_layer"):
        spec[group] = []
        for m in real[group]:
            m = dict(m)
            if "workloads" in m:
                decode = any(w.endswith("decode-long")
                             for w in m["workloads"])
                m["workloads"] = closed if decode else opened
            spec[group].append(m)
    return spec


def make_copy(tmp: Path):
    """A checkout holding BENCHMARK.json and a copy of benchmark/ with the
    tiny files added; returns (checkout, Bench)."""
    from benchmark import spec as spec_mod
    root = tmp / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    for c, m, cell in TINY.values():
        shutil.copy(HERE / "data" / f"{c}.json", root / "configs")
        shutil.copy(HERE / "data" / f"{m}.json", root / "traffic")
    for name, (_, _, cell) in TINY.items():
        (root / "cells" / f"{name}.json").write_text(json.dumps(cell))
    real = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    spec = tiny_spec(real)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return tmp, spec_mod.Bench(spec, root=root, checkout=tmp)


@pytest.fixture
def tiny(tmp_path):
    return make_copy(tmp_path)[1]
