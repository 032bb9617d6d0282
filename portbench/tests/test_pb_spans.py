"""The program's spans and counters as ``harness/spans.py`` reads them:
the four readings (None on a run that gave them nothing, their value on
hand-made readings), the idle gaps charged to the innermost program span
of the issuing thread on a synthetic trace, and a small traced CPU run of
each cell through ``tools/spans.py``, which reads that cell's two counter
readings (counters need no device)."""

import time

import pytest
import torch

from portbench.harness import manifest, spans
from portbench.tests.small import small
from portbench.tools.spans import measure

TRAIN = {"kind": "train", "step_s": 0.02, "window_steps": 50,
         "data_wait_s": 0.01, "step_host_s": 0.4}
SERVE = {"kind": "serve", "queue_ms": 210.5, "handler_ms": 14.25}


@pytest.mark.parametrize("name", list(spans.READINGS))
def test_readings_none_on_nothing(name):
    read = spans.READINGS[name]
    for r in ({}, {"kind": "train", "step_s": 0.02},
              {"kind": "serve", "render_ms": 31.9},
              {"kind": "train", "step_s": 0.02, "window_steps": 0,
               "data_wait_s": 0.0, "step_host_s": 0.0}):
        assert read(r) is None


def test_readings_values():
    assert spans.data_wait_share(TRAIN) == pytest.approx(1.0)
    assert spans.step_host_ms(TRAIN) == pytest.approx(8.0)
    assert spans.queue_ms(SERVE) == 210.5
    assert spans.handler_ms(SERVE) == 14.25
    assert spans.queue_ms(TRAIN) is None and spans.step_host_ms(SERVE) is None


def test_counters_of_a_program_without_them():
    class Old:
        pipeline = object()

        def _train_step(self):
            pass

    assert spans.train_counters(Old()) is None
    assert spans.train_readings(None, None) == {}
    assert spans.serve_readings(object()) == {}


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def test_gaps_go_to_the_issuing_threads_innermost_span():
    events = [
        # main thread: two steps and their phases; the benchmark's span
        # counts for nothing here
        _x("user_annotation", "pb.train_step", 0, 1000),
        _x("user_annotation", "train.step", 0, 1000),
        _x("user_annotation", "step.rays", 0, 300),
        _x("user_annotation", "step.update", 600, 400),
        _x("user_annotation", "train.step", 1000, 800),
        _x("user_annotation", "step.forward", 1000, 500),
        # the prefetch worker stages a batch inside the fourth gap
        _x("user_annotation", "data.stage", 1000, 100, tid=2),
        # a thread with a span around the last gap that issued nothing
        _x("user_annotation", "serve.encode", 1700, 400, tid=3),
        # launches: who issued each device operation
        _x("cuda_runtime", "cudaLaunchKernel", 5, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 250, 1, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 650, 1, correlation=3),
        _x("cuda_runtime", "cudaMemcpyAsync", 1050, 1, tid=2,
           correlation=4),
        _x("cuda_runtime", "cudaLaunchKernel", 1500, 1, correlation=5),
        _x("cuda_runtime", "cudaLaunchKernel", 2000, 1, tid=4,
           correlation=6),
        # device: busy 10-100, 300-500 (two overlapping), 800-900,
        # 1200-1300 (the worker's copy), 1600-1700, 2100-2200
        _x("kernel", "k1", 10, 90, correlation=1),
        _x("kernel", "k2", 300, 150, correlation=2),
        _x("kernel", "k2b", 350, 150, correlation=2),
        _x("kernel", "k3", 800, 100, correlation=3),
        _x("gpu_memcpy", "Memcpy HtoD", 1200, 100, correlation=4),
        _x("kernel", "k5", 1600, 100, correlation=5),
        _x("kernel", "k6", 2100, 100, correlation=6),
    ]
    gaps = spans.program_gaps(events)
    # 100-300 (mid 200): step.rays; 500-800 (mid 650): step.update;
    # 900-1200 (mid 1050) ends in the worker's copy, passed over for the
    # main thread's next kernel: step.forward, not data.stage; 1300-1600
    # (mid 1450): step.forward; 1700-2100 (mid 1900), issued by a thread
    # with no span: serve.encode, the one span any thread was in
    assert gaps == pytest.approx({"step.forward": 600e-6,
                                  "serve.encode": 400e-6,
                                  "step.update": 300e-6,
                                  "step.rays": 200e-6})
    assert list(gaps) == ["step.forward", "serve.encode", "step.update",
                          "step.rays"]                   # largest first
    notes = spans.gap_notes(gaps, 2000e-6)
    assert notes[0].startswith("idle in program span step.forward") \
        and "30.000%" in notes[0]
    alone = [e for e in events if e["name"] != "serve.encode"]
    assert spans.program_gaps(alone)[spans.OUTSIDE] == pytest.approx(400e-6)


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  manifest.load()["workloads"]])
def test_small_traced_run_reads_the_counters(cell):
    man = manifest.load()
    config, tf = small(cell)
    res, program, notes = measure(man, cell, 2 ** 31 + 11, 0.5,
                                  torch.device("cpu"), time.perf_counter(),
                                  config, tf)
    assert res["attempted"] > 0 and res["failed"] == 0
    want = {"train": {"data.wait_share.train", "step.host_ms.train"},
            "serve": {"serving.queue_ms", "serving.handler_ms"}}[tf["kind"]]
    assert set(program["readings"]) == want
    assert all(v >= 0 for v in program["readings"].values())
    assert program["window_s"] > 0 and program["traced_items"] > 0
    assert program["program_gaps"] == []               # no device trace
    assert set(program["build"]) == {"built", "build_s", "loaded", "load_s"}
    assert notes[-1].startswith("kernel builds:")
