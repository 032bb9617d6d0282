#!/usr/bin/env python3
"""Probes for the quality report's run-to-run spread on one NVIDIA GPU
(``docs/QUALITY_PORT.md``): are repeated kernel launches on the same
inputs the same, and what does a training of the standard protocol do
between the quality report's sparse logs?

    python3 quality_probe.py [--repeat 3000] [--seed 1] [--runs 3]

1. The single-pass kernel launched ``--repeat`` times on the same seeded
   full-width inputs (``chip_smoke.kernel_inputs``): the weight-gradient
   mode at the quality run's 8192 × 96 and the frozen mode at its
   4096 × 96 fitting chunk. Every sum of the kernels runs in a fixed
   order — dW/db, the SE and the code cotangents' ray sums, as
   ``chip_smoke.py::repeat_checks`` demands — so every output must be
   the same bits on every launch: a launch whose SE, code cotangents or
   dW/db differ in any bit from the first launch's is an outlier, and
   each output's largest difference is printed.
2. ``--runs`` trainings of ``--seed`` of the standard protocol
   (``codenerf_tpu_torch.quality_report``: ``--use_fused --samples
   96``), each logged every 50 steps instead of every 1,000, then the
   protocol's fitting and eval. Per run: the training steps whose PSNR
   fell more than 5 dB below the best of the 20 logs before it, the code
   tables' norms (each object's, and the mean code's, which starts every
   fit), each held-out object's fitting start -> end and held-out PSNR,
   and from ``--inspect``'s look at the checkpoint the training objects
   whose target view renders fully opaque (white from the last sample's
   color instead of the background) and the mean code's opacity. Each
   run's JSON line says whether its final checkpoint (every parameter,
   both code tables, every AdamW moment) is the same bits as the first
   run's: training repeats bit for bit on the card (the code tables'
   gradient is fixed-order, ``ops/code_rows.py``).

With ``--keep_collapsed DIR`` the checkpoint of every training whose
fits start below 5 dB (a collapsed mean code; healthy runs start at 7-17
dB) is copied to ``DIR/seed<s>_run<r>/``.

    python3 quality_probe.py --inspect DIR --seed 1 [--device cpu]

looks at such a checkpoint instead (on the CPU too): the code tables'
norms and spread, and each held-out object's target view rendered at the
mean code and each training object's at its own code (linspace depths):
PSNR against the ground truth, mean opacity and mean color; the count of
training objects that render fully opaque (mean opacity above 0.99) and
the checkpoint's ``state_digest``.

Prints the card line first and one JSON line per run of part 2 last;
exits non-zero without a card. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import chip_smoke


def _same_bits(a, b) -> bool:
    """The same bits (-0 is not 0, and a NaN equals its own bits)."""
    import torch

    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(ints[a.element_size()]),
        b.contiguous().view(ints[b.element_size()]))


def state_digest(ckpt_dir: str) -> str:
    """SHA-256 of the latest checkpoint's parameters, code tables and
    AdamW moments and steps, in a fixed order of keys."""
    import hashlib

    import torch

    from codenerf_tpu_torch.utils import checkpoint as ckpt

    ck = ckpt.read_checkpoint(ckpt_dir)
    tensors = [ck["model"][k] for k in sorted(ck["model"])]
    tensors += [ck["shape_codes"], ck["texture_codes"]]
    opt = ck["optimizer"]["state"]
    for i in sorted(opt):
        tensors += [torch.as_tensor(opt[i][k]) for k in sorted(opt[i])]
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def repeat_check(dev, R: int, S: int, weight_grads: bool, n: int) -> dict:
    import torch

    from codenerf_tpu_torch.ops import fused_train

    _, args = chip_smoke.kernel_inputs(dev, R, S)
    kw = (dict(weight_grads=True) if weight_grads
          else dict(weight_grads=False))
    first = [x.clone() for x in fused_train.train_fused(*args, **kw)]
    n_out = 4                       # se_sum and the three code cotangents
    tops = [float(x.float().abs().max()) for x in first[:n_out]]
    worst = [0.0] * n_out
    outliers, dw_differ = [], 0
    t0 = time.perf_counter()
    for i in range(n):
        got = fused_train.train_fused(*args, **kw)
        for j in range(n_out):
            d = float((got[j].float() - first[j].float()).abs().max())
            worst[j] = max(worst[j], d)
            if not _same_bits(got[j], first[j]):
                outliers.append((i, j, d))
        if weight_grads and not all(torch.equal(a, b) for a, b in
                                    zip(got[n_out:], first[n_out:])):
            dw_differ += 1
    torch.cuda.synchronize()
    out = {"mode": "train" if weight_grads else "codes", "R": R, "S": S,
           "launches": n, "seconds": time.perf_counter() - t0,
           "largest_difference": dict(zip(
               ["se_sum", "d_sproj", "d_tproj", "d_vcontrib"], worst)),
           "largest_magnitude": dict(zip(
               ["se_sum", "d_sproj", "d_tproj", "d_vcontrib"], tops)),
           "outlier_launches": outliers[:20],
           "n_outliers": len(outliers),
           "dw_db_not_bit_equal": dw_differ if weight_grads else None}
    chip_smoke.log(f"repeat: {json.dumps(out)}")
    return out


def training_probe(seed: int, run: int, work: str, every: int,
                   keep: str = None, device: str = "cuda") -> dict:
    from codenerf_tpu_torch import quality_report
    from codenerf_tpu_torch.training.trainer import Trainer

    tables = {}
    training = Trainer.training

    def logged_densely(self, iters_crop, iters_all, log_every=100):
        out = training(self, iters_crop, iters_all, log_every=every)
        st = self.state
        for name in ("shape_codes", "texture_codes"):
            table = st.shape_codes if name == "shape_codes" \
                else st.texture_codes
            rows = table.detach().float()
            norms = rows.norm(dim=1)
            tables[name] = {
                "norm_min": float(norms.min()),
                "norm_median": float(norms.median()),
                "norm_max": float(norms.max()),
                "mean_code_norm": float(rows.mean(0).norm()),
                "largest_component": float(rows.abs().max())}
        return out

    out_dir = os.path.join(work, f"seed{seed}_run{run}")
    args = quality_report.build_parser().parse_args([
        "--use_fused", "--samples", "96", "--seeds", str(seed),
        "--save_images", "0", "--out", out_dir, "--device", device])
    Trainer.training = logged_densely
    try:
        res = quality_report.run_once(args, seed, out_dir)
    finally:
        Trainer.training = training
    logs = [(r["step"], r["psnr/train"])
            for r in chip_smoke._metrics(res["run_dir"])
            if "psnr/train" in r]
    drops = []
    for i, (step, p) in enumerate(logs):
        best = max([q for _, q in logs[max(0, i - 20):i]], default=p)
        if p < best - 5.0:
            drops.append((step, round(p, 2), round(best, 2)))
    summary = {"seed": seed, "run": run, "held_out_psnr": res["psnr"],
               "held_out_ssim": res["ssim"],
               "rows": [[r[0]] + [round(v, 4) for v in r[1:]]
                        for r in res["rows"]],
               "train_psnr_last": logs[-1][1] if logs else None,
               "train_psnr_min_after_2000": min(
                   (p for s, p in logs if s > 2000), default=None),
               "drops_over_5db": drops, "codes": tables,
               "train_s": res["train_s"]}
    summary["state_sha256"] = state_digest(os.path.join(res["run_dir"],
                                                        "ckpt"))
    seen = inspect_run(os.path.join(res["run_dir"], "ckpt"), seed, device)
    summary["opaque_train_objects"] = sum(
        o["opacity"] > 0.99 for o in seen["train_at_own_code"])
    summary["mean_code_opacity"] = [
        round(o["opacity"], 4) for o in seen["held_out_at_mean_code"]]
    if keep and min(r[3] for r in res["rows"]) < 5.0:
        dst = os.path.join(keep, f"seed{seed}_run{run}")
        shutil.copytree(os.path.join(res["run_dir"], "ckpt"), dst)
        summary["kept"] = dst
    return summary


def inspect_run(ckpt_dir: str, seed: int, device: str) -> dict:
    import torch

    from codenerf_tpu_torch import quality_report
    from codenerf_tpu_torch.core.rays import camera_rays
    from codenerf_tpu_torch.models.codenerf import CodeNeRF
    from codenerf_tpu_torch.renderer import render_rays
    from codenerf_tpu_torch.utils import checkpoint as ckpt

    args = quality_report.build_parser().parse_args(
        ["--use_fused", "--samples", "96", "--seeds", str(seed)])
    scene, _, test_scene, base = quality_report.load_scenes(args, seed)
    hp = quality_report.flagship_hparams(args, seed, scene)
    dev = torch.device(device)
    step = ckpt.latest_step(ckpt_dir)
    state = torch.load(ckpt.step_path(ckpt_dir, step), map_location=dev,
                       weights_only=False)
    model = CodeNeRF(hp.net).to(dev).requires_grad_(False)
    model.load_state_dict(state["model"])
    tables = {k: state[k].float() for k in ("shape_codes", "texture_codes")}
    means = {k: v.mean(0) for k, v in tables.items()}
    H = W = args.size
    view = int(args.tgt_views.split(",")[0])

    def look(oi, sc, tc):
        ro, vd = camera_rays(H, W, float(test_scene["focals"][oi]),
                             test_scene["poses"][oi, view], device=dev)
        gt = torch.from_numpy(test_scene["images"][oi, view].astype(
            "float32").reshape(-1, 3) / 255.0).to(dev)
        with torch.no_grad():
            out = render_rays(model, hp.render, ro, vd, sc, tc, None).final
        mse = float(torch.mean((out.rgb - gt) ** 2))
        return {"psnr": -10.0 * torch.log10(torch.tensor(mse)).item(),
                "opacity": float(out.acc.mean()),
                "rgb": float(out.rgb.mean())}

    codes = {}
    for k, v in tables.items():
        norms = v.norm(dim=1)
        dist = torch.cdist(v, v)
        off = dist[~torch.eye(len(v), dtype=torch.bool, device=dev)]
        codes[k] = {"norms": [round(float(x), 4) for x in norms],
                    "mean_code_norm": float(means[k].norm()),
                    "mean_to_nearest_row": float(
                        (v - means[k]).norm(dim=1).min()),
                    "median_row_distance": float(off.median())}
    held_out = [look(base + i, means["shape_codes"], means["texture_codes"])
                for i in range(args.n_test_objects)]
    train = [look(i, tables["shape_codes"][i], tables["texture_codes"][i])
             for i in range(args.n_train_objects)]
    out = {"step": step, "state_sha256": state_digest(ckpt_dir),
           "opaque_train_objects": sum(o["opacity"] > 0.99 for o in train),
           "codes": codes, "held_out_at_mean_code": held_out,
           "train_at_own_code": train}
    print(json.dumps(out))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeat", type=int, default=3000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--log_every", type=int, default=50)
    ap.add_argument("--keep_collapsed", type=str, default=None)
    ap.add_argument("--inspect", type=str, default=None)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args()

    import torch

    if args.inspect:
        from codenerf_tpu_torch import resolve_device

        inspect_run(args.inspect, args.seed, resolve_device(args.device))
        return 0

    if not torch.cuda.is_available():
        print("quality_probe: torch.cuda.is_available() is False; this "
              "script needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    chip_smoke.log(f"card {chip_smoke.card_line()}")
    if args.repeat:
        repeat_check(dev, 8192, 96, True, args.repeat)
        torch.cuda.empty_cache()
        repeat_check(dev, 4096, 96, False, args.repeat)
        torch.cuda.empty_cache()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "quality")
    os.makedirs(root, exist_ok=True)
    work = tempfile.mkdtemp(prefix="quality_probe_", dir=root)
    runs = []
    for r in range(args.runs):
        runs.append(training_probe(args.seed, r, work, args.log_every,
                                   args.keep_collapsed))
        runs[-1]["same_bits_as_run0"] = (runs[-1]["state_sha256"]
                                         == runs[0]["state_sha256"])
        chip_smoke.log(f"run {r}: {json.dumps(runs[-1])}")
    for r in runs:
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
