"""The precision control at a size a test run holds: the tiny cell served
by the program comes out correct, and the same run with the control in
the program's place (run.py --control 1: the reference with fp8
activations) comes out not correct, through the same checks. The
full-size readings of each cell come from `run.py --control 1` on the card
(PERF.md)."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import run

DEVICES = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("seed", [1, 2, 2**31 + 3])
def test_control_fails_where_the_program_passes(tiny, device, seed):
    def cell(control):
        return run.run_cell(tiny, "tiny-llama.closed", seed, 5.0, False,
                            torch.device(device), control=control,
                            t_start=time.perf_counter())

    program, ctl = cell(False), cell(True)
    assert program["correct"], program["checks"]
    assert not ctl["correct"], ctl["checks"]
    gap = ctl["checks"]["mean_logit_gap"]
    assert gap["value"] > gap["limit"]
    assert gap["value"] == ctl["readings"]["control_mean_logit_gap"]
