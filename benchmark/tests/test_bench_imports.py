"""Nothing the harness or the reference loads is JAX, the JAX package or
the script that imports them, compared by whole top-level names; the
reference loads nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys

from conftest import CHECKOUT

FORBIDDEN = ["jax", "jaxlib", "flax", "petit_kernel_tpu", "chip_smoke"]


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=CHECKOUT, capture_output=True, text=True, check=True,
        timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    tops = _loaded(
        "import sys; sys.path.insert(0, '.')\n"
        "from benchmark import (run, serve, check, trace, traffic, work,\n"
        "    reading, spec, weights, repeat)\n"
        "from benchmark.families import llama\n"
        "from benchmark.reference import mistral\n"
        "from benchmark.spec import Bench\n"
        "b = Bench.at('.')\n"
        "for m in b.spec['end_to_end'] + b.spec['per_layer']:\n"
        "    b.reader(m['name'])\n"
        "import petit_kernel_tpu_torch.models.serving\n")
    assert "petit_kernel_tpu_torch" in tops      # the program is loaded
    assert not tops & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    tops = _loaded("import sys; sys.path.insert(0, '.')\n"
                   "from benchmark.reference import mistral\n"
                   "from benchmark import check\n")
    assert "petit_kernel_tpu_torch" not in tops
    assert not tops & set(FORBIDDEN)


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, str(CHECKOUT))
    from benchmark import run
    assert run.FORBIDDEN == frozenset(FORBIDDEN)
    assert "petit_kernel_tpu_torch".split(".")[0] not in run.FORBIDDEN


def test_run_refuses_a_checkout_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and benchmark/, the
    command exits with another code than 0 and prints no result."""
    import shutil
    shutil.copytree(CHECKOUT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "mistral-7b.decode-long", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0
    assert not p.stdout.strip()
