"""Training cells: the port's ``Trainer`` at category scale.

Set-up renders the cell's scene, builds one ``Trainer`` on it, loads the
benchmark's seeded weights and code tables into its state and drives that
state through its first ``check_steps`` steps by the window's own loop
and feed, recording what the reference will follow: each step's loss,
each leaf's first gradient (AdamW's first moment over 1 - beta1) and each
leaf's change over the steps. Those steps are also the warm-up: every
kernel the window runs is built and loaded by then. The window then runs
the same loop on the same object for ``--seconds`` and counts every ray
of every step over all the time, ending in a synchronise.

After the window (and the traced stretch, with ``--trace 1``) the peak
memory is read, the program's state is freed, and the reference follows
the checked steps from the same weights, rays, pixels and depth jitter
(``portbench/reference/train.py``).
"""

from __future__ import annotations

import gc
import math
import time

import torch

from codenerf_tpu_torch.config import hparams_from_dict
from codenerf_tpu_torch.ops import fused_train
from codenerf_tpu_torch.training.trainer import Trainer
from portbench.harness import arith, trace
from portbench.harness.cell import (Check, Context, Outcome, Parts,
                                    checks_from, leaf_gaps, moved_leaves,
                                    rel_gap, sync, worst_leaf)
from portbench.harness.scene import make_scene
from portbench.harness.weights import make_weights
from portbench.reference import train as ref_train

BETA1 = 0.9


class TrainLoop:
    """``Trainer.training``'s loop body, in its order: the phase's batch
    stream (the crop phase's, then the full images'), the step on the next
    batch, the occupancy refresh, and the metric read every ``log_every``
    steps. It leaves out the checkpoints and render logs."""

    def __init__(self, trainer: Trainer, iters_crop: int, log_every: int):
        self.tr = trainer
        self.iters_crop = iters_crop
        self.log_every = log_every
        start = trainer.state.step
        self.crop = start < iters_crop
        self.batches = trainer._batches(self.crop, start, iters_crop)
        self.last = {}

    def step(self, span=trace.span(False)):
        """One step; returns ``(metrics, batch)``."""
        tr = self.tr
        step = tr.state.step
        if self.crop and step >= self.iters_crop:
            self.crop = False
            self.batches.close()
            self.batches = tr._batches(False, step, self.iters_crop)
        with span("pb.pipeline_next"):
            batch = next(self.batches)
        with span("pb.train_step"):
            metrics = tr._train_step(tr.state, batch, *tr._step_extras())
        with span("pb.occupancy_update"):
            tr._maybe_update_occupancy(step + 1)
        if (step + 1) % self.log_every == 0:
            with span("pb.metric_read"):
                self.last = {k: float(v) for k, v in metrics.items()}
        return metrics, batch

    def close(self) -> None:
        self.batches.close()


def build_trainer(ctx: Context, scene: dict, init: dict) -> Trainer:
    """The cell's ``Trainer`` on ``scene``, its state holding ``init``."""
    hp = hparams_from_dict({**ctx.config["hparams"], "seed": ctx.seed})
    tr = Trainer("portbench", hp, batch_size=ctx.traffic["batch_rays"],
                 dataset={k: scene[k] for k in ("images", "poses", "focals")},
                 exps_root=ctx.workdir, check_iter=0, device=ctx.device)
    st = tr.state
    with torch.no_grad():
        for n, p in st.model.named_parameters():
            p.copy_(init[n])
        st.shape_codes.copy_(init["shape_codes"])
        st.texture_codes.copy_(init["texture_codes"])
    return tr


def _leaves(tr: Trainer) -> dict:
    st = tr.state
    out = dict(st.model.named_parameters())
    out.update(shape_codes=st.shape_codes, texture_codes=st.texture_codes)
    return out


def counters() -> dict:
    """The program's launch and point counters of the single-pass modes,
    which launch ``trunk_fwd_kernel``."""
    return {"points": dict(fused_train.train_fused.points),
            "launches": dict(fused_train.train_fused.launches)}


def checked_start(ctx: Context) -> dict:
    """Set-up and the checked steps: the scene, the weights, the
    ``Trainer`` and its loop, and what the reference will follow."""
    tf, hp = ctx.traffic, ctx.config["hparams"]
    parts = Parts(ctx.t_start)
    parts.mark("imports")
    scene = make_scene(ctx.config["scene"], ctx.sub_seed(0), ctx.device)
    parts.mark("scene")
    init = make_weights(hp["net_hyperparams"],
                        ctx.config["scene"]["n_objects"], ctx.sub_seed(1),
                        ctx.device)
    tr = build_trainer(ctx, scene, init)
    parts.mark("weights and Trainer")
    st = {"scene": scene, "init": init, "trainer": tr, "parts": parts,
          "loop": TrainLoop(tr, tf["iters_crop"], tf["log_every"]),
          "fed": [], "losses": []}
    for k in range(tf["check_steps"]):
        metrics, batch = st["loop"].step()
        st["fed"].append({n: batch[n].cpu() for n in ("obj", "view", "uv")})
        st["losses"].append(float(metrics["loss"]))
        if k == 0:
            # AdamW's first moment after one step is (1 - beta1) times
            # the gradient it was given; a leaf it never moved has none.
            moments = tr.state.optimizer.state
            st["grad1"] = {
                n: float(moments[p]["exp_avg"].norm()) / (1 - BETA1)
                if "exp_avg" in moments.get(p, {}) else 0.0
                for n, p in _leaves(tr).items()}
    st["change"] = {n: float((p.detach() - init[n]).norm())
                    for n, p in _leaves(tr).items()}
    sync(ctx.device)
    parts.mark("checked steps")
    return st


def free(ctx: Context, st: dict) -> None:
    """Stop the prefetch worker and free the program's state."""
    st.pop("loop").close()
    del st["trainer"]
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def follow(ctx: Context, st: dict, precision: str = "f32",
           fault=None) -> dict:
    """The reference over the checked steps: the same weights, rays and
    pixels, and the depth jitter drawn from the same seed as the step's
    generator draws it (one byte a sample, each step)."""
    hp = ctx.config["hparams"]
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    B, S = ctx.traffic["batch_rays"], hp["N_samples"]
    jitter = [torch.randint(0, 256, (B, S), generator=gen, dtype=torch.int32,
                            device=ctx.device).float() / 256.0
              for _ in st["fed"]]
    return ref_train.follow(st["init"], hp, st["fed"], jitter,
                            st["scene"]["images"], st["scene"]["poses_t"],
                            st["scene"]["focals_t"], precision=precision,
                            fault=fault)


def gaps(got: dict, ref: dict) -> dict:
    """The numbers compared: the worst step's relative loss gap, and the
    worst leaf's gap of first-gradient and change norms (leaves the
    reference does not move left out of the change)."""
    return {
        "loss_gap": max(rel_gap(a, b) for a, b in
                        zip(got["losses"], ref["losses"])),
        "grad_gap": worst_leaf(got["grad1"], ref["grad1"]),
        "change_gap": worst_leaf(got["change"], ref["change"],
                                 keep=moved_leaves(ref["grad1"])),
    }


def run(ctx: Context) -> Outcome:
    tf, hp = ctx.traffic, ctx.config["hparams"]
    B = tf["batch_rays"]
    st = checked_start(ctx)
    loop, tr = st["loop"], st["trainer"]
    setup_s = time.perf_counter() - ctx.t_start

    # The window: every ray of every step over all the time.
    t0 = time.perf_counter()
    steps = failed = 0
    while True:
        loop.step()
        steps += 1
        if tr.state.step % tf["log_every"] == 0 and \
                not all(math.isfinite(v) for v in loop.last.values()):
            failed += tf["log_every"]
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    sync(ctx.device)
    wall = time.perf_counter() - t0

    summary, points, launches = None, {}, {}
    if ctx.trace:
        before = counters()
        span = trace.span(True)
        summary = trace.traced(
            lambda: [loop.step(span) for _ in range(tf["trace_steps"])],
            ctx.device)
        after = counters()
        points = {k: after["points"][k] - before["points"][k]
                  for k in after["points"]}
        launches = {k: after["launches"][k] - before["launches"][k]
                    for k in after["launches"]}
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    del loop, tr
    free(ctx, st)

    ref = follow(ctx, st)
    fed = st["fed"]
    repeated = sum(torch.equal(a["obj"], b["obj"])
                   for i, a in enumerate(fed) for b in fed[i + 1:])
    moved = moved_leaves(ref["grad1"])
    worst = {k: max(g, key=g.get) for k, g in (
        ("grad", leaf_gaps(st["grad1"], ref["grad1"])),
        ("change", leaf_gaps(st["change"], ref["change"], moved)))}
    notes = [str(st["parts"]),
             f"losses program {st['losses']} reference {ref['losses']}",
             f"leaves left out of the change: "
             f"{sorted(set(ref['grad1']) - set(moved))}; worst leaf {worst}"]
    checks = checks_from(gaps(st, ref), tf["correct"]) + [
        Check("repeated_batches", float(repeated), 0.0)]
    return Outcome(
        setup_s=setup_s,
        e2e={"train_rays_per_s": steps * B / wall},
        attempted=steps, failed=failed, memory_peak_bytes=peak,
        checks=checks,
        readings={"kind": "train", "net": hp["net_hyperparams"],
                  "rays": B, "step_s": wall / steps,
                  "step_flops": arith.train_step_flops(
                      hp["net_hyperparams"], B, hp["N_samples"]),
                  "steps_traced": tf.get("trace_steps", 0), "points": points,
                  "launches": launches, "trace": summary},
        notes=notes)


def control(ctx: Context, variants) -> dict:
    """The readings that set the cell's limits, without a window: the
    program's (``"program"``), and those of the reference put in its place
    in fp8 (``"fp8"``) or with a fault planted (``"half"``,
    ``"shifted"``), each against the float32 reference."""
    st = checked_start(ctx)
    free(ctx, st)
    t0 = time.perf_counter()
    ref = follow(ctx, st)
    out = {"reference_s": time.perf_counter() - t0}
    for v in variants:
        if v == "program":
            out[v] = gaps(st, ref)
        else:
            alt = follow(ctx, st, precision="fp8" if v == "fp8" else "f32",
                         fault=None if v == "fp8" else v)
            out[v] = gaps(alt, ref)
    return out
