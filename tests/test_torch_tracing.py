"""The port's spans and counters (``utils/tracing.py``) on the CPU:

- with no profiler ``span`` is one shared no-op;
- under a CPU ``torch.profiler`` a short ``Trainer.training`` exports
  ``data.wait``, ``train.step`` and the step's phases, each phase inside
  its step, and the prefetch worker's ``data.draw`` on another thread;
- a served request exports ``serve.request`` over its queue, prepare,
  render and encode spans;
- the counters count: batches and steps, the server's refusals, and its
  ``/timings`` quantiles in order;
- a training under the profiler leaves the same parameters, bit for bit,
  as one without it.

Sizes are ``test_torch_trainer.py``'s (W=256, 2+1 blocks, latent 32, 24
samples, 64 rays a step on a 16×16 synthetic scene).
"""

import json
import os
import subprocess
import sys
import tempfile
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from codenerf_tpu_torch.config import hparams_from_dict
from codenerf_tpu_torch.data.synthetic import synthetic_scene
from codenerf_tpu_torch.models.codenerf import CodeNeRF
from codenerf_tpu_torch.serving import RenderServer
from codenerf_tpu_torch.training.trainer import Trainer
from codenerf_tpu_torch.utils.tracing import span

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 64
NET = {"shape_blocks": 2, "texture_blocks": 1, "W": 256, "num_xyz_freq": 6,
       "num_dir_freq": 2, "latent_dim": 32}
PHASES = ("step.rays", "step.codes", "step.forward", "step.backward",
          "step.update")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    return synthetic_scene(n_objects=3, n_views=4, H=16, W=16, seed=0,
                           device="cpu")


def _hp(scene):
    return hparams_from_dict({
        "net_hyperparams": NET, "N_samples": 24,
        "near": float(scene["near"]), "far": float(scene["far"]),
        "use_fused_train": True})


def _trainer(scene, tmp_path, name):
    return Trainer(name, _hp(scene), batch_size=B, dataset=scene,
                   exps_root=str(tmp_path), check_iter=0, device="cpu")


def _profiled(fn):
    """``fn()`` under a CPU profiler that records every thread; the
    exported Chrome-trace events of the port's spans."""
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            experimental_config=config) as prof:
        fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]


def _named(events, name):
    return [e for e in events if e["name"] == name]


def _inside(inner, outer) -> bool:
    return inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"] \
        and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_span_is_a_shared_noop_without_a_profiler():
    a, b = span("train.step"), span("serve.request", "7")
    assert a is b
    with a:
        pass


def test_tracing_imports_with_jax_blocked():
    code = ("import sys\nsys.modules['jax'] = None\n"
            "from codenerf_tpu_torch.utils import tracing\n"
            "assert not [m for m in sys.modules if m == 'codenerf_tpu' "
            "or m.startswith(('codenerf_tpu.', 'jax.'))]\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_training_spans_and_counters(scene, tmp_path):
    tr = _trainer(scene, tmp_path, "spans")
    events = _profiled(lambda: tr.training(iters_crop=0, iters_all=2,
                                           log_every=2))
    steps = _named(events, "train.step")
    assert len(steps) == 2
    assert len(_named(events, "data.wait")) >= 2
    for name in PHASES:
        found = _named(events, name)
        assert len(found) == 2, name
        assert all(any(_inside(e, s) for s in steps) for e in found), name
    assert not _named(events, "step.reduce")       # no mesh, no collective
    assert len(_named(events, "train.log")) == 1
    draws = _named(events, "data.draw")
    assert draws and {e["tid"] for e in draws}.isdisjoint(
        {e["tid"] for e in steps})
    assert not any(e["name"].startswith("pb.") for e in events)
    assert tr.pipeline.counters["batches"] == 2
    assert tr._step_counters["steps"] == 2
    c = tr.pipeline.counters
    assert c["wait_s"] >= 0 and c["draw_s"] > 0 and c["stage_s"] > 0
    assert tr._step_counters["host_s"] > 0
    with open(os.path.join(tr.save_dir, "metrics.jsonl")) as f:
        row = json.loads(f.readline())
    assert 0 <= row["time/data_wait"] and \
        0 < row["time/step_host"] <= row["time/train"]


def test_profiling_leaves_training_bit_for_bit(scene, tmp_path):
    plain = _trainer(scene, tmp_path, "plain")
    plain.training(iters_crop=1, iters_all=3, log_every=3)
    traced = _trainer(scene, tmp_path, "traced")
    _profiled(lambda: traced.training(iters_crop=1, iters_all=3,
                                      log_every=3))
    a = dict(plain.state.model.named_parameters())
    for n, p in traced.state.model.named_parameters():
        assert torch.equal(p, a[n]), n
    assert torch.equal(plain.state.shape_codes, traced.state.shape_codes)
    assert torch.equal(plain.state.texture_codes,
                       traced.state.texture_codes)


@pytest.fixture(scope="module")
def server(scene):
    hp = _hp(scene)
    torch.manual_seed(0)
    model = CodeNeRF(hp.net).requires_grad_(False)
    codes = torch.randn(6, NET["latent_dim"]) * 0.1
    srv = RenderServer({"model": model, "fine_model": None,
                        "shape_codes": codes[:3],
                        "texture_codes": codes[3:]}, hp)
    srv.start_background()
    yield srv
    srv.shutdown()


def _post(srv, body):
    req = urllib.request.Request(
        f"http://{srv.host}:{srv.port}/render", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def _post_handled(srv, body):
    """:func:`_post`, then wait for the server's handler thread to end:
    the client can hold the whole reply before that thread has left
    ``serve.reply`` and ``serve.request``."""
    known = set(threading.enumerate())
    status = _post(srv, body)
    for t in set(threading.enumerate()) - known:
        if "process_request_thread" in t.name:
            t.join(timeout=60)
    return status


def test_request_spans(server):
    events = _profiled(lambda: _post_handled(server, {"obj": 1, "H": 8,
                                                      "W": 8}))
    (req,) = _named(events, "serve.request")
    for name in ("serve.parse", "serve.queue", "serve.prepare",
                 "serve.render", "serve.encode", "serve.reply", "render.rays",
                 "render.chunk", "render.readback"):
        found = _named(events, name)
        assert found and all(_inside(e, req) for e in found), name
    (render,) = _named(events, "serve.render")
    assert all(_inside(e, render) for e in _named(events, "render.chunk"))


def test_server_counters_and_timings(server):
    before = server.timings()
    assert _post(server, {"obj": 0, "H": 8, "W": 8}) == 200
    assert _post(server, {"obj": 99, "H": 8, "W": 8}) == 400
    assert _post(server, {"obj": 2, "H": 8, "W": 6}) == 200
    with urllib.request.urlopen(
            f"http://{server.host}:{server.port}/timings", timeout=60) as r:
        t = json.loads(r.read())
    assert t["requests"] == before["requests"] + 2
    assert t["failed"] == before["failed"] + 1
    assert 0 <= t["overlapped"] <= t["requests"]
    for k in ("queue_ms", "prepare_ms", "render_ms", "handler_ms",
              "request_ms"):
        q = t[k]
        assert set(q) == {"p50", "p95", "max"}
        assert 0 <= q["p50"] <= q["p95"] <= q["max"], k
    assert t["request_ms"]["max"] >= t["render_ms"]["max"] > 0
    assert t["render_ms"] == server.stats()["latency_ms"]


def test_server_keeps_the_last_thousand(server):
    """The times are bounded deques of 1,000; ``/stats`` reads the same
    numbers as over a list's last 1,000."""
    srv = RenderServer({"model": server.model, "fine_model": None,
                        "shape_codes": server.shape_codes,
                        "texture_codes": server.texture_codes}, server.hp)
    try:
        times = np.random.default_rng(0).uniform(0.01, 0.05, 1500)
        for x in times:
            srv._times["render_ms"].append(float(x))
        assert len(srv._times["render_ms"]) == 1000
        last = times[-1000:]
        lat = srv.stats()["latency_ms"]
        assert lat == {"p50": float(np.quantile(last, 0.5) * 1e3),
                       "p95": float(np.quantile(last, 0.95) * 1e3),
                       "max": float(last.max() * 1e3)}
    finally:
        srv.shutdown()
