"""The reference's training steps: CodeNeRF's category loss and AdamW
(``src/trainer.py:75-131``), step by step from given weights, rays and
depth jitter.

Loss of a step: the MSE of the composited colour against the pixels, plus
``loss_reg_coef`` times the batch mean of ``‖z_shape‖ + ‖z_texture‖``.
AdamW (betas 0.9/0.999, eps 1e-8, decoupled weight decay) with the
networks on the first lr schedule and both code tables on the second, each
halved every ``interval`` steps.

``fault`` plants one of the faults the benchmark's comparison must catch,
in the reference put in the program's place: ``"half"`` leaves out half
of each batch and takes the mean over the rest, ``"shifted"`` raises every
composited colour by one uint8 level where it is produced.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from portbench.reference import codenerf as ref

BETAS = (0.9, 0.999)
EPS = 1e-8
FAULTS = (None, "half", "shifted")


def lr_at(schedule: dict, step: int) -> float:
    return schedule["lr"] * 2.0 ** (-(step // schedule["interval"]))


def _pixels(images, obj, view, uv) -> torch.Tensor:
    """The batch's target colours in [0, 1], gathered from the scene's
    uint8 images (a host array) by the reference itself."""
    o, v = obj.cpu().numpy(), view.cpu().numpy()
    u, w = uv[:, 0].cpu().numpy().astype(np.int64), \
        uv[:, 1].cpu().numpy().astype(np.int64)
    return torch.from_numpy(images[o, v, w, u].astype(np.float32) / 255.0)


def step_loss(p: dict, sc, tc, hp: dict, batch: dict, images, poses,
              focals, jitter, prec: ref.Precision, fault: Optional[str],
              chunk: int = 4096) -> torch.Tensor:
    """One step's loss, its gradient accumulated into the leaves' ``.grad``
    chunk by chunk (the loss is a mean over all of the batch's rays, so
    each chunk's share is scaled by its rows). ``jitter`` (R, S) is the
    step's depth jitter. Returns the loss."""
    dev = sc.device
    net = hp["net_hyperparams"]
    H, W = images.shape[2:4]
    obj = batch["obj"].long().to(dev)
    view = batch["view"].long().to(dev)
    uv = batch["uv"].to(dev)
    gt = _pixels(images, obj, view, uv).to(dev)
    ro, vd = ref.pixel_rays(uv, focals[obj], poses[obj, view], H, W)
    z = ref.stratified_z(hp["near"], hp["far"], jitter.to(dev))
    R = obj.shape[0] // 2 if fault == "half" else obj.shape[0]
    reg_coef = hp.get("loss_reg_coef", 1e-4)
    total = torch.zeros((), device=dev)
    for s in range(0, R, chunk):
        e = min(s + chunk, R)
        o, d, zz = ro[s:e], vd[s:e], z[s:e]
        s_code, t_code = sc[obj[s:e]], tc[obj[s:e]]
        sigma, rgb = ref.forward(
            p, net, o[:, None] + d[:, None] * zz[..., None], d, s_code,
            t_code, prec)
        out, _ = ref.composite(sigma, rgb, zz)
        if fault == "shifted":
            out = out + 1.0 / 255.0
        se = ((out - gt[s:e]) ** 2).sum() / (R * 3)
        reg = (torch.linalg.norm(s_code, dim=-1)
               + torch.linalg.norm(t_code, dim=-1)).sum() / R
        part = se + reg_coef * reg
        part.backward()
        total = total + part.detach()
    return total


def adamw_(leaves: Sequence[torch.Tensor], state: List[dict], lr: float,
           wd: float, t: int) -> None:
    """torch's AdamW, written out: decay, moments, bias-corrected step."""
    with torch.no_grad():
        for x, st in zip(leaves, state):
            g = x.grad
            x.mul_(1.0 - lr * wd)
            st["m"].mul_(BETAS[0]).add_(g, alpha=1.0 - BETAS[0])
            st["v"].mul_(BETAS[1]).addcmul_(g, g, value=1.0 - BETAS[1])
            denom = (st["v"].sqrt() / math.sqrt(1.0 - BETAS[1] ** t)).add_(EPS)
            x.addcdiv_(st["m"], denom, value=-lr / (1.0 - BETAS[0] ** t))
            x.grad = None


def follow(params0: Dict[str, torch.Tensor], hp: dict, batches: list,
           jitter: list, images, poses, focals, precision: str = "f32",
           fault: Optional[str] = None) -> dict:
    """The reference's first ``len(batches)`` steps from ``params0`` (the
    networks' weights by layer name plus ``shape_codes`` and
    ``texture_codes``), each with its depth ``jitter`` (:func:`step_loss`).
    Returns each step's ``losses``, ``grad1`` (each leaf's first gradient
    norm) and ``change`` (each leaf's norm of its change over the
    steps)."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    ref.set_exact_float32()
    prec = ref.Precision(precision)
    names = list(params0)
    leaves = [params0[n].detach().clone().float().requires_grad_()
              for n in names]
    by_name = dict(zip(names, leaves))
    nets = {n: x for n, x in by_name.items()
            if n not in ("shape_codes", "texture_codes")}
    sc, tc = by_name["shape_codes"], by_name["texture_codes"]
    state = {n: {"m": torch.zeros_like(x), "v": torch.zeros_like(x)}
             for n, x in by_name.items()}
    sched_net, sched_codes = hp["lr_schedule"][:2]
    wd = hp.get("weight_decay", 0.01)
    losses, grad1 = [], {}
    for k, (batch, jit) in enumerate(zip(batches, jitter)):
        loss = step_loss(nets, sc, tc, hp, batch, images, poses, focals,
                         jit, prec, fault)
        losses.append(float(loss))
        if k == 0:
            grad1 = {n: float(x.grad.norm()) for n, x in by_name.items()}
        for group, sched in ((list(nets), sched_net),
                             (["shape_codes", "texture_codes"], sched_codes)):
            adamw_([by_name[n] for n in group], [state[n] for n in group],
                   lr_at(sched, k), wd, k + 1)
    change = {n: float((x.detach() - params0[n].float()).norm())
              for n, x in by_name.items()}
    return {"losses": losses, "grad1": grad1, "change": change}
