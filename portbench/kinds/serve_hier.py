"""Served hierarchical renders: the port's ``RenderServer`` over localhost
HTTP with a separate fine network, NeRF's coarse-to-fine sampling.

The same closed loop as ``kinds/serve.py``, whose load generator,
request drawing, lock spans, decoding and level gaps this module uses
unchanged: a fixed number of clients, each sending its next ``POST
/render`` on its last reply, the rate completed over the window what the
server sustains. What differs is the model and its reference. Both
networks are drawn from the seed (the fine one from a sub-seed of its
own), with the served gain and colours of ``serve.py``, and their density
is shaped as an object's (:func:`object_density`): a box with a relief
and a sharp surface, empty around it, as a trained model's scene is. The
server gets the fine network as ``fine_model`` and renders ``N_samples``
coarse and ``N_importance`` fine depths a ray. The reference is
``reference/hierarchical.py``.

Besides ``serve.py``'s readings, the run reads the program's counters
where the program has them, and leaves a reading out where it has not:
the points its forward kernels evaluated per render over the untraced
window (``RenderServer.timings()["samples"]``), and the launches and
points of the sigma-only and four-plane forwards in the traced stretch
(``fused_mlp.sigma_fwd`` and ``planes_fwd``'s counters). A program that
renders the cell through its plain module counts no launch there.

On a CPU device (the benchmark's own tests; ``run.py`` refuses one) the
traffic's ``cpu_sizes`` replace its sizes and the configuration's
``N_samples``: the tests cut every cell to 8 coarse samples, too few
bins for the coarse weights to place the fine depths, so that the bf16
and float32 fine depths part and the comparison reads noise.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time

import numpy as np
import torch

from codenerf_tpu_torch.config import hparams_from_dict
from codenerf_tpu_torch.models.codenerf import CodeNeRF
from codenerf_tpu_torch.ops import fused_mlp
from codenerf_tpu_torch.serving import RenderServer
from portbench.harness import trace
from portbench.harness.cell import Context, Outcome, Parts, checks_from
from portbench.harness.weights import make_weights, networks
from portbench.kinds.serve import (LoadGen, decode, instrument, level_gaps,
                                   post, quantile, requests_of, stats)
from portbench.reference import codenerf as ref
from portbench.reference import hierarchical
from portbench.reference.render import orbit_c2w

KERNELS = ("sigma", "planes")    # the forwards' launch counters


def sized(ctx: Context) -> Context:
    """``ctx``, on a CPU device with the traffic's ``cpu_sizes`` in place
    (``N_samples`` in the configuration's hyperparameters)."""
    cut = dict(ctx.traffic.get("cpu_sizes", {}))
    if ctx.device.type != "cpu" or not cut:
        return ctx
    hp = dict(ctx.config["hparams"], N_samples=cut.pop("N_samples"))
    return dataclasses.replace(ctx, traffic={**ctx.traffic, **cut},
                               config={**ctx.config, "hparams": hp})


def relief(p: dict, net: dict, codes: tuple, reach) -> tuple:
    """The mean and spread of the drawn density layer's input to the
    softplus, ``m(x)``, over points uniform in the box ``reach`` (3,)
    about the origin and the codes ``codes`` (shape, texture; (N, D)
    each), float32 (TF32 off), from a generator of its own."""
    dev = codes[0].device
    ref.set_exact_float32()
    gen = torch.Generator(device=dev).manual_seed(0)
    n = codes[0].shape[0]
    xyz = (torch.rand(n, 2048, 3, generator=gen, device=dev) * 2 - 1) * reach
    vd = torch.nn.functional.normalize(
        torch.randn(n, 3, generator=gen, device=dev), dim=-1)
    sigma = ref.forward(p, net, xyz, vd, *codes, ref.Precision())[0]
    sigma = sigma.clamp_min(1e-30)
    m = torch.where(sigma > 20, sigma, torch.log(torch.expm1(sigma)))
    return float(m.mean()), float(m.std())


def object_density(p: dict, net: dict, codes: tuple, obj: dict) -> dict:
    """``p``'s weights with the density confined to an object: a box of
    half-extents ``half_extents`` about the origin, widened by ``margin``
    and given a relief by the drawn density. Six units of ``enc_xyz``
    take ``relu(+-x_i)`` of the encoding's raw coordinates, the first
    shape block makes ``relu(|x_i| - a_i)`` of them and the later blocks
    carry it (code injection kept off those units), and ``enc_shape``'s
    first unit sums it into ``pen(x)``, zero inside the box. The density
    is then ``softplus(density_scale * (steepness * (margin - pen(x)) +
    relief * m'(x)))``, with ``m'`` the drawn density layer's input to
    the softplus, its mean and spread measured over the box on the drawn
    network before these edits (:func:`relief`, under ``codes``), put to
    about 0 and 1, so that no draw swells the object by much more than
    ``relief / steepness`` a spread: outside that nothing, inside some
    hundreds a unit, the surface within a few hundredths of a unit.
    Every other weight is the drawn one."""
    half = obj["half_extents"]
    reach = torch.tensor(half, device=codes[0].device) + obj["margin"]
    mean, spread = relief(p, net, codes, reach)
    p = {k: v.clone() for k, v in p.items()}
    enc = p["enc_xyz.weight"]
    enc[:6], p["enc_xyz.bias"][:6] = 0.0, 0.0
    for i in range(3):
        enc[2 * i, i], enc[2 * i + 1, i] = 1.0, -1.0
    for j in range(net["shape_blocks"]):
        p[f"shape_latent_{j}.weight"][:6] = 0.0
        p[f"shape_latent_{j}.bias"][:6] = 0.0
        w, b = p[f"shape_{j}.weight"], p[f"shape_{j}.bias"]
        w[:6], b[:6] = 0.0, 0.0
        for i in range(3):
            if j == 0:
                w[i, 2 * i] = w[i, 2 * i + 1] = 1.0
                b[i] = -half[i]
            else:
                w[i, i] = 1.0
    p["enc_shape.weight"][0], p["enc_shape.bias"][0] = 0.0, 0.0
    p["enc_shape.weight"][0, :3] = -1.0
    w = p["sigma.weight"] * (obj["relief"] / spread)
    b = (p["sigma.bias"] - mean) * (obj["relief"] / spread)
    w[0, 0] = obj["steepness"]
    b[0] = b[0] + obj["steepness"] * obj["margin"]
    p["sigma.weight"] = w * obj["density_scale"]
    p["sigma.bias"] = b * obj["density_scale"]
    return p


def make_networks(ctx: Context):
    """``(init, fine)``: ``serve.py``'s weights and code tables, and the
    fine network's weights from sub-seed 4, each with its density shaped
    by the traffic's ``object`` (:func:`object_density`, its relief
    measured under the first 16 objects' codes)."""
    tf, net = ctx.traffic, ctx.config["hparams"]["net_hyperparams"]
    n_obj = ctx.config["scene"]["n_objects"]
    init = make_weights(net, n_obj, ctx.sub_seed(1), ctx.device,
                        tf["weight_gain"], tf["weight_colour"])
    fine = networks(make_weights(net, 1, ctx.sub_seed(4), ctx.device,
                                 tf["weight_gain"], tf["weight_colour"]))
    codes = init["shape_codes"][:16], init["texture_codes"][:16]
    init.update(object_density(networks(init), net, codes, tf["object"]))
    return init, object_density(fine, net, codes, tf["object"])


def start_server(ctx: Context, init: dict, fine: dict):
    hp = hparams_from_dict({**ctx.config["hparams"], "seed": ctx.seed})
    model = CodeNeRF(hp.net).to(ctx.device)
    model.load_state_dict(networks(init))
    fine_model = CodeNeRF(hp.net).to(ctx.device)
    fine_model.load_state_dict(fine)
    server = RenderServer({"model": model, "fine_model": fine_model,
                           "shape_codes": init["shape_codes"],
                           "texture_codes": init["texture_codes"]}, hp)
    lock = instrument(server)
    server.start_background()
    return server, lock


def reference_images(ctx: Context, init: dict, fine: dict, reqs: list,
                     precision: str = "f32",
                     uniform_fine: bool = False) -> list:
    hp = ctx.config["hparams"]
    return [hierarchical.render(
        networks(init), fine, hp, init["shape_codes"][r["obj"]],
        init["texture_codes"][r["obj"]],
        orbit_c2w(r["azimuth"], r["elevation"], r["radius"]), r["H"],
        r["W"], 1.1 * r["W"], precision, uniform_fine) for r in reqs]


def samples_counted(server):
    """``(requests, samples)`` from the server's ``timings()``: the
    renders so far and the points the forward kernels evaluated
    (``coarse_sigma``, ``planes``); samples None where the program keeps
    no such counter."""
    timings = getattr(server, "timings", None)
    if timings is None:
        return 0, None
    t = timings()
    return t["requests"], t.get("samples")


def per_render(before, after):
    """The points a render of the window evaluated through each forward
    kernel, or None."""
    (n0, s0), (n1, s1) = before, after
    if s0 is None or s1 is None or n1 <= n0:
        return None
    return {k: (s1[k] - s0[k]) / (n1 - n0) for k in s1}


def launch_counts():
    """The sigma-only and four-plane forwards' launches and points so
    far."""
    counters = {"sigma": fused_mlp.sigma_fwd, "planes": fused_mlp.planes_fwd}
    return ({k: getattr(f, "launches", {}).get(k, 0)
             for k, f in counters.items()},
            {k: getattr(f, "points", {}).get(k, 0)
             for k, f in counters.items()})


def run(ctx: Context) -> Outcome:
    ctx = sized(ctx)
    tf, hp = ctx.traffic, ctx.config["hparams"]
    parts = Parts(ctx.t_start)
    parts.mark("imports")
    n_obj = ctx.config["scene"]["n_objects"]
    init, fine = make_networks(ctx)
    server, lock = start_server(ctx, init, fine)
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
            before = samples_counted(server)
            results, wall = gen.run()
            after = samples_counted(server)
            ok = [r["index"] for r in results if r["status"] == 200]
            rng = np.random.default_rng(ctx.sub_seed(3))
            keep = sorted(rng.choice(ok, min(tf["check_requests"], len(ok)),
                                     replace=False)) if ok else []
            bodies = gen.bodies(keep)
        finally:
            gen.close()
        st = stats(server)
        summary, held, launches, points = None, 0.0, {}, {}
        if ctx.trace:
            lock.traced, held0 = True, lock.held_s
            l0, p0 = launch_counts()
            traced = reqs[:tf["trace_requests"]]
            summary = trace.traced(lambda: [post(server, r) for r in traced],
                                   ctx.device)
            l1, p1 = launch_counts()
            launches = {k: l1[k] - l0[k] for k in KERNELS}
            points = {k: p1[k] - p0[k] for k in KERNELS}
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
    want = reference_images(ctx, init, fine,
                            [reqs[i % len(reqs)] for i in keep])
    readings = level_gaps(served, want) if served else {}
    samples = per_render(before, after)
    lat = lat or [math.inf]
    notes = [str(parts),
             f"{tf['clients']} clients: {len(ok)} of {len(results)} "
             f"requests completed in {wall:.3f} s for a {ctx.seconds} s "
             f"window; latency p50 {quantile(lat, 0.5) * 1e3:.3f} ms, "
             f"p95 {quantile(lat, 0.95) * 1e3:.3f} ms",
             f"server /stats: {st}",
             f"points a render through the forward kernels: {samples}",
             f"{len(served)} renders compared with the reference"]
    return Outcome(
        setup_s=setup_s,
        e2e={"render_per_s": len(ok) / wall if wall > 0 else 0.0},
        attempted=len(results), failed=failed, memory_peak_bytes=peak,
        checks=checks_from(readings, tf["correct"]),
        readings={"kind": "serve_hier", "net": hp["net_hyperparams"],
                  "hparams": hp,
                  "render_ms": st["latency_ms"]["p50"],
                  "samples_per_render": samples,
                  "launches": launches, "points": points,
                  "held_s": held, "trace": summary},
        notes=notes)


def control(ctx: Context, variants) -> dict:
    """The readings that set the cell's limits: the first
    ``check_requests`` requests served by the cell's clients
    (``"program"``), the fp8 reference (``"fp8"``) and the reference
    with its fine depths drawn as if the coarse weights were uniform
    (``"uniform_fine"``) put in their place, each against the float32
    reference on the same requests."""
    ctx = sized(ctx)
    tf = ctx.traffic
    n_obj = ctx.config["scene"]["n_objects"]
    init, fine = make_networks(ctx)
    reqs = requests_of(tf, n_obj, ctx.sub_seed(2))[:tf["check_requests"]]
    out = {}
    if "program" in variants:
        server, _ = start_server(ctx, init, fine)
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
    want = reference_images(ctx, init, fine, reqs)
    out["reference_s"] = time.perf_counter() - t0
    for v in variants:
        if v == "program":
            got = served
        elif v == "uniform_fine":
            got = reference_images(ctx, init, fine, reqs, uniform_fine=True)
        else:
            got = reference_images(ctx, init, fine, reqs, precision=v)
        out[v] = level_gaps(got, want)
    return out
