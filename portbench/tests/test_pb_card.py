"""Every cell once on a CUDA device, as the benchmark's command runs it,
at a short window: exit 0, ``correct`` true, the metrics the manifest
names for the cell. Skips without a CUDA device (decided in the
fixture)."""

import json
import os
import subprocess
import sys

import pytest

from portbench.harness import manifest


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card")


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  manifest.load()["workloads"]])
def test_cell_runs_on_the_card(card, cell):
    man = manifest.load()
    out = subprocess.run(
        [sys.executable, os.path.join(manifest.BENCH, "run.py"),
         "--workload", cell, "--seed", "2147483659", "--seconds", "5",
         "--trace", "0"], capture_output=True, text=True, timeout=900,
        cwd=manifest.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {m["name"] for m in
                                   manifest.metrics_of(man, cell, False)}
