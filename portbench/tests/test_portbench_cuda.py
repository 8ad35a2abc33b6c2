"""The controls on the card, at each cell's own size: the reference put in
the program's place in fp8 (the nearest precision below the configuration's
bf16) has to come out as not correct, while the program's readings of the
same run stay within their limits. Each run is a
short window of the cell's own load. Run on the card with

    python -m pytest --noconftest -m cuda portbench/tests/test_portbench_cuda.py

These tests decide inside themselves whether there is a card."""

import time

import pytest
import torch

from portbench import registry, run


def _cells(driver):
    bench = registry.load_benchmark()
    return [w["name"] for w in bench["workloads"]
            if registry.traffic(w["traffic"])["driver"] == driver]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", _cells("serve_backlog"))
def test_serve_control_fails_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = run.run_cell(cell, 2 ** 31 + 101, 5.0, False,
                       control=True, t0=time.perf_counter())
    ck, st = out["checks"], out["_stats"]
    # the control, in the program's place, comes out as not correct
    assert not out["correct"]
    compared = [k[len("control_"):] for k in ck if k.startswith("control_")]
    assert compared
    # the program's own readings of the same run are within every limit
    for k in compared:
        assert st[k] <= ck[f"control_{k}"]["limit"], (k, st[k])

