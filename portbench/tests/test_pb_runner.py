"""A run of each cell of the manifest through the harness at a small size
on the CPU, its chip look skipped: the result line's keys, the metrics the
manifest names for the cell (the traced run's device readers read nothing
without a device trace), and the numbers compared, last."""

import time

import pytest
import torch

from portbench.harness import manifest, runner
from portbench.tests.small import small


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  manifest.load()["workloads"]])
def test_result_line(cell, trace):
    man = manifest.load()
    config, tf = small(cell)
    res, out = runner.run_cell(man, cell, 2 ** 31 + 7, 0.5, trace,
                               torch.device("cpu"), time.perf_counter(),
                               config, tf)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks" and res["correct"]
    assert res["attempted"] > 0 and res["failed"] == 0
    names = {m["name"] for m in manifest.metrics_of(man, cell, trace)}
    assert set(res["metrics"]) <= names
    if not trace:
        assert set(res["metrics"]) == names
    else:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
