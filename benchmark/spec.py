"""Finding a cell's pieces by name: BENCHMARK.json at the checkout's root
names the cells, their configurations (by file) and traffic mixes, and the
metrics each cell reports; the rest are files of their own under this
folder, so that a later change adds a piece by adding a file:

  configs/<config>.json    a configuration (BENCHMARK.json's `file`)
  traffic/<mix>.json       a traffic mix, read by traffic.py
  cells/<cell>.json        what belongs to one cell: its `rate` (open
                           loops) and the `limits` of its correctness
                           checks
  metrics/<metric>.py      a metric's reader: read(run) -> number or None
  kernels/<family>.json    a kernel family: name patterns, the work it
                           runs (`op`) and the launched rows it takes
  families/<family>.py     how the program builds a configuration's
                           engine (the configuration's serve.family),
                           imported from this package
  reference/<name>.py      a configuration's plain reference
                           (serve.reference), imported from this package
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


class Bench:
    """BENCHMARK.json (`spec`) and the folder of named files (`root`)."""

    def __init__(self, spec: dict, root: Path = HERE,
                 checkout: Path = HERE.parent):
        self.spec, self.root, self.checkout = spec, Path(root), Path(checkout)

    @classmethod
    def at(cls, checkout: Path, root: Path = HERE) -> "Bench":
        spec = json.loads((Path(checkout) / "BENCHMARK.json").read_text())
        return cls(spec, root, checkout)

    def _json(self, *parts) -> dict:
        return json.loads(self.root.joinpath(*parts).read_text())

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.checkout / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def mix(self, name: str) -> dict:
        return self._json("traffic", f"{name}.json")

    def cell(self, name: str) -> dict:
        path = self.root / "cells" / f"{name}.json"
        return json.loads(path.read_text()) if path.exists() else {}

    def metrics(self, cell: str, traced: bool) -> list[dict]:
        """The metrics a cell reports: its end-to-end metrics untraced,
        its per-layer metrics traced."""
        group = self.spec["per_layer" if traced else "end_to_end"]
        return [m for m in group
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        path = self.root / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"benchmark_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def families(self) -> dict:
        return {p.stem: json.loads(p.read_text())
                for p in sorted((self.root / "kernels").glob("*.json"))}

    def program(self, conf: dict):
        return self._module("families", conf["serve"]["family"])

    def reference(self, conf: dict):
        return self._module("reference", conf["serve"]["reference"])

    @staticmethod
    def _module(folder: str, name: str):
        return importlib.import_module(f"benchmark.{folder}.{name}")
