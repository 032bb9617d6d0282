"""Served renders: the port's ``RenderServer`` over localhost HTTP.

Set-up builds the model and code tables from the seed on the card, starts
the server, sends a few warm-up renders (well under 2% of the 1,000
latencies ``/stats`` keeps) and starts the load generator in a child
process (``harness/loadgen.py``). The window is a closed loop: a fixed
number of clients, each sending its next ``POST /render`` as soon as its
last reply has come, so the rate completed over all the time is what the
server sustains, with no offered rate to cap it. The requests are a list
drawn from the seed, the same length for every seed: orbit views of
objects drawn Zipf over the training objects, each render the same work.

With ``--trace 1`` a profiled stretch of renders one at a time follows
the window; the benchmark's spans mark the server's lock wait, the render
under the lock and the rest of each HTTP request (parsing, PNG encoding,
the reply). After it the server is shut down and the reference renders a
sample, drawn from the seed, of the requests the window completed, from
the same weights and codes; each is compared with the PNG the server
returned.
"""

from __future__ import annotations

import gc
import json
import math
import os
import pickle
import subprocess
import sys
import time
import urllib.request

import numpy as np
import torch

from codenerf_tpu_torch.config import hparams_from_dict
from codenerf_tpu_torch.models.codenerf import CodeNeRF
from codenerf_tpu_torch.serving import RenderServer
from portbench.harness import arith, manifest, trace
from portbench.harness.cell import Context, Outcome, Parts, checks_from
from portbench.harness.weights import make_weights, networks
from portbench.reference import render as ref_render


def requests_of(tf: dict, n_objects: int, seed: int) -> list:
    """The traffic file's ``requests`` request dicts of one run, drawn
    from ``seed``: objects Zipf(``zipf_s``) over the seed's ranking of the
    objects, cameras uniform in azimuth and elevation."""
    n = tf["requests"]
    rng = np.random.default_rng(seed)
    p = np.arange(1, n_objects + 1, dtype=np.float64) ** -tf["zipf_s"]
    objs = rng.permutation(n_objects)[rng.choice(n_objects, n, p=p / p.sum())]
    az = rng.uniform(*tf["azimuth"], n)
    el = rng.uniform(*tf["elevation"], n)
    return [{"obj": int(objs[i]), "azimuth": float(az[i]),
             "elevation": float(el[i]), "radius": tf["radius"],
             "H": tf["H"], "W": tf["W"], "deterministic": True}
            for i in range(n)]


class SpannedLock:
    """The server's lock with the benchmark's spans around the wait for
    it and the render under it, while traced; ``held_s`` sums the time
    it was held."""

    def __init__(self, lock):
        self.lock, self.traced, self.held_s = lock, False, 0.0
        self._spans = []

    def __enter__(self):
        span = trace.span(self.traced)
        with span("pb.lock_wait"):
            self.lock.acquire()
        self._t = time.perf_counter()
        self._spans.append(span("pb.render"))
        self._spans[-1].__enter__()
        return self

    def __exit__(self, *exc):
        self._spans.pop().__exit__(*exc)
        self.held_s += time.perf_counter() - self._t
        self.lock.release()
        return False


def instrument(server: RenderServer) -> SpannedLock:
    """Wrap the server's lock and request handler in the benchmark's
    spans (no-ops until traced)."""
    lock = SpannedLock(server._lock)
    server._lock = lock
    base = server._httpd.RequestHandlerClass

    class Handler(base):
        def do_POST(self):
            with trace.span(lock.traced)("pb.http_request"):
                super().do_POST()

    server._httpd.RequestHandlerClass = Handler
    return lock


def post(server, req: dict) -> bytes:
    body = json.dumps(req).encode()
    r = urllib.request.Request(f"http://{server.host}:{server.port}/render",
                               data=body,
                               headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=120) as resp:
        return resp.read()


def stats(server) -> dict:
    with urllib.request.urlopen(
            f"http://{server.host}:{server.port}/stats", timeout=60) as r:
        return json.loads(r.read())


def decode(png: bytes) -> np.ndarray:
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))


def start_server(ctx: Context, init: dict):
    hp = hparams_from_dict({**ctx.config["hparams"], "seed": ctx.seed})
    model = CodeNeRF(hp.net).to(ctx.device)
    model.load_state_dict(networks(init))
    server = RenderServer({"model": model, "fine_model": None,
                           "shape_codes": init["shape_codes"],
                           "texture_codes": init["texture_codes"]}, hp)
    lock = instrument(server)
    server.start_background()
    return server, lock


class LoadGen:
    """The load generator's child process (``harness/loadgen.py``),
    started and its imports paid in set-up. :meth:`run` runs its clients
    over ``reqs`` (for ``seconds``, or each request once with None) and
    returns the results; :meth:`bodies` then fetches the replies named."""

    def __init__(self, server, reqs, clients: int, seconds):
        env = dict(os.environ, PYTHONPATH=manifest.ROOT)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "portbench.harness.loadgen"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env,
            cwd=manifest.ROOT)
        pickle.dump((server.host, server.port,
                     [json.dumps(r).encode() for r in reqs], clients,
                     seconds), self.proc.stdin)
        self.proc.stdin.flush()
        if self.proc.stdout.readline().strip() != b"ready":
            self.close()
            raise RuntimeError("the load generator did not start")

    def run(self):
        """Results of every request sent, in order, and the window's
        length: from the start to the last reply."""
        self.proc.stdin.write(b"go\n")
        self.proc.stdin.flush()
        results = pickle.load(self.proc.stdout)
        return results, max((r["done_s"] for r in results), default=0.0)

    def bodies(self, indices) -> dict:
        """The replies' bodies of ``indices``, by index; closes the
        child."""
        try:
            pickle.dump([int(i) for i in indices], self.proc.stdin)
            self.proc.stdin.flush()
            return pickle.load(self.proc.stdout)
        finally:
            self.close()

    def close(self, timeout: float = 30.0) -> None:
        self.proc.stdin.close()
        try:
            self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.proc.stdout.close()


def quantile(values, q: float) -> float:
    """The nearest-rank ``q`` quantile."""
    v = sorted(values)
    return float(v[max(0, math.ceil(q * len(v)) - 1)])


def level_gaps(served: list, want: list) -> dict:
    """The served images against the reference's, in uint8 levels: the
    worst pixel, and the mean over every pixel."""
    d = np.stack([np.abs(a.astype(np.int16) - b.astype(np.int16))
                  for a, b in zip(served, want)])
    return {"level_gap_max": float(d.max()),
            "level_gap_mean": float(d.mean())}


def reference_images(ctx: Context, init: dict, reqs: list,
                     precision: str = "f32") -> list:
    hp = ctx.config["hparams"]
    return [ref_render.render(
        networks(init), hp, init["shape_codes"][r["obj"]],
        init["texture_codes"][r["obj"]],
        ref_render.orbit_c2w(r["azimuth"], r["elevation"], r["radius"]),
        r["H"], r["W"], 1.1 * r["W"], precision) for r in reqs]


def run(ctx: Context) -> Outcome:
    tf, hp = ctx.traffic, ctx.config["hparams"]
    parts = Parts(ctx.t_start)
    parts.mark("imports")
    n_obj = ctx.config["scene"]["n_objects"]
    init = make_weights(hp["net_hyperparams"], n_obj, ctx.sub_seed(1),
                        ctx.device, tf["weight_gain"], tf["weight_colour"])
    server, lock = start_server(ctx, init)
    parts.mark("weights and server")
    try:
        reqs = requests_of(tf, n_obj, ctx.sub_seed(2))
        for req in reqs[:tf["warmup_requests"]]:
            post(server, req)
        parts.mark("warm-up renders")
        gen = LoadGen(server, reqs, tf["clients"], ctx.seconds)
        parts.mark("load generator")
        setup_s = time.perf_counter() - ctx.t_start
        try:
            results, wall = gen.run()
            ok = [r["index"] for r in results if r["status"] == 200]
            rng = np.random.default_rng(ctx.sub_seed(3))
            keep = sorted(rng.choice(ok, min(tf["check_requests"], len(ok)),
                                     replace=False)) if ok else []
            bodies = gen.bodies(keep)
        finally:
            gen.close()
        st = stats(server)
        summary, held = None, 0.0
        if ctx.trace:
            lock.traced, held0 = True, lock.held_s
            traced = reqs[:tf["trace_requests"]]
            summary = trace.traced(lambda: [post(server, r) for r in traced],
                                   ctx.device)
            lock.traced, held = False, lock.held_s - held0
        peak = (torch.cuda.max_memory_allocated(ctx.device)
                if ctx.device.type == "cuda" else 0)
    finally:
        server.shutdown()
    del server
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    lat = [r["done_s"] - r["sent_s"] for r in results if r["status"] == 200]
    failed = len(results) - len(ok)
    served = [decode(bodies[i]) for i in keep]
    want = reference_images(ctx, init, [reqs[i % len(reqs)] for i in keep])
    readings = level_gaps(served, want) if served else {}
    notes = [str(parts),
             f"{tf['clients']} clients: {len(ok)} of {len(results)} "
             f"requests completed in {wall:.3f} s for a {ctx.seconds} s "
             f"window; latency p50 {quantile(lat or [math.inf], 0.5) * 1e3:.3f}"
             f" ms, p95 {quantile(lat or [math.inf], 0.95) * 1e3:.3f} ms",
             f"server /stats: {st}",
             f"{len(served)} renders compared with the reference"]
    rays = tf["H"] * tf["W"]
    return Outcome(
        setup_s=setup_s,
        e2e={"render_per_s": len(ok) / wall if wall > 0 else 0.0},
        attempted=len(results), failed=failed, memory_peak_bytes=peak,
        checks=checks_from(readings, tf["correct"]),
        readings={"kind": "serve", "net": hp["net_hyperparams"],
                  "render_ms": st["latency_ms"]["p50"],
                  "render_flops": arith.render_flops(
                      hp["net_hyperparams"], rays, hp["N_samples"]),
                  "renders_traced": tf["trace_requests"],
                  "held_s": held, "trace": summary},
        notes=notes)


def control(ctx: Context, variants) -> dict:
    """The readings that set the cell's limits: the first
    ``check_requests`` requests served by the cell's clients
    (``"program"``) and the fp8 reference put in their place (``"fp8"``),
    each against the float32 reference on the same requests."""
    tf, hp = ctx.traffic, ctx.config["hparams"]
    n_obj = ctx.config["scene"]["n_objects"]
    init = make_weights(hp["net_hyperparams"], n_obj, ctx.sub_seed(1),
                        ctx.device, tf["weight_gain"], tf["weight_colour"])
    reqs = requests_of(tf, n_obj, ctx.sub_seed(2))[:tf["check_requests"]]
    out = {}
    if "program" in variants:
        server, _ = start_server(ctx, init)
        try:
            for r in reqs[:tf["warmup_requests"]]:
                post(server, r)
            gen = LoadGen(server, reqs, tf["clients"], None)
            try:
                gen.run()
                bodies = gen.bodies(range(len(reqs)))
            finally:
                gen.close()
        finally:
            server.shutdown()
        served = [decode(bodies[i]) for i in range(len(reqs))]
    t0 = time.perf_counter()
    want = reference_images(ctx, init, reqs)
    out["reference_s"] = time.perf_counter() - t0
    for v in variants:
        got = served if v == "program" else \
            reference_images(ctx, init, reqs, precision=v)
        out[v] = level_gaps(got, want)
    return out
