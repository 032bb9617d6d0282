"""The control of each cell: the plain reference put in the program's
place one precision below the configuration's bfloat16 (fp8 products)
must fail at least one of the cell's limits, at a size a test run holds;
the program's own readings at that size pass them. On the card the same
readings come from ``portbench/tools/control.py`` at the cells' sizes
(``PERF.md`` keeps them)."""

import importlib
import tempfile
import time

import pytest
import torch

from portbench.harness.cell import Context
from portbench.tests.small import small


@pytest.mark.parametrize("cell", ["car_fused.train", "car_fused.serve"])
def test_control_fails_program_passes(cell):
    config, traffic = small(cell)
    kind = importlib.import_module(f"portbench.kinds.{traffic['kind']}")
    with tempfile.TemporaryDirectory() as work:
        ctx = Context(cell, config, traffic, 31337, 0.0, False,
                      torch.device("cpu"), time.perf_counter(), work)
        out = kind.control(ctx, ["program", "fp8"])
    limits = traffic["correct"]
    assert all(out["program"][k] <= v for k, v in limits.items()
               if k in out["program"]), out["program"]
    assert any(out["fp8"][k] > v for k, v in limits.items()
               if k in out["fp8"]), out["fp8"]
