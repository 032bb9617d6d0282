"""Category-level training loop (counterpart of
``codenerf_tpu/training/trainer.py``, without its mesh and its training
occupancy grid).

The reference ``Trainer``'s capabilities (``src/trainer.py:17-180``): the
two-stage cropped-then-full schedule, per-object latent code tables, MSE +
code-norm loss, AdamW with split model/code lrs and step-halving,
periodic checkpoints, scalar and image logging, and the run dir's
``hpam.json``. As in the JAX package, one step is one globally-sampled ray
batch (all objects mixed), the crop→full switch changes only the pixel
window of one pipeline, and checkpoints hold the whole state (moments and
RNG included), so a run resumes — exactly: the crop phase draws from the
pipeline's stream 0 and the full phase from stream 1, and a resumed run
skips the batches its phase has already used.

Batches are compact (15 B/ray: object, view, pixel, uint8 rgb), staged to
the card from pinned memory on the prefetch thread; the pose and focal
tables stay on the card. ``device="cuda"`` is the default; a CUDA request
without a card raises.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from codenerf_tpu_torch import resolve_device
from codenerf_tpu_torch.config import Hparams, resolve_dtype
from codenerf_tpu_torch.data.pipeline import RayBatchPipeline
from codenerf_tpu_torch.data.srn import SRNDataset
from codenerf_tpu_torch.evaluation.metrics import reference_psnr_mse
from codenerf_tpu_torch.renderer import render_image
from codenerf_tpu_torch.training.state import create_train_state
from codenerf_tpu_torch.training.train_step import build_train_step
from codenerf_tpu_torch.utils import checkpoint as ckpt
from codenerf_tpu_torch.utils.images import side_by_side
from codenerf_tpu_torch.utils.logging import MetricsLogger


class Trainer:
    def __init__(self, save_dir: str, hparams: Hparams,
                 batch_size: int = 16384, dataset: Optional[Any] = None,
                 exps_root: str = "exps", use_tensorboard: bool = False,
                 check_iter: int = 10000, max_objects: Optional[int] = None,
                 microbatch_rays: int = 0, device="cuda", mesh=None):
        """``dataset`` is anything with images/poses/focals (an
        :class:`SRNDataset` or a synthetic scene dict); when omitted it is
        loaded from ``hparams.data`` as the reference does."""
        self.device = resolve_device(device)
        self.hp = hparams
        self.B = int(batch_size)
        self.check_iter = check_iter
        if dataset is None:
            dataset = SRNDataset(cat=hparams.data.cat,
                                 splits=hparams.data.splits,
                                 data_dir=hparams.data.data_dir,
                                 max_objects=max_objects)
        if isinstance(dataset, dict):
            images, poses, focals = (dataset["images"], dataset["poses"],
                                     dataset["focals"])
        else:
            images, poses, focals = (dataset.images, dataset.poses,
                                     dataset.focals)
        self.dataset = dataset
        self.pipeline = RayBatchPipeline(images, poses, focals,
                                         seed=hparams.seed)
        self.H, self.W = self.pipeline.H, self.pipeline.W
        self.n_objects = self.pipeline.n_objects

        # Run directory: exps/<save_dir>/{hpam.json, metrics.jsonl, ckpt/}
        # (reference layout, src/trainer.py:158-166).
        self.save_dir = os.path.join(exps_root, save_dir)
        os.makedirs(self.save_dir, exist_ok=True)
        with open(os.path.join(self.save_dir, "hpam.json"), "w") as f:
            json.dump(self.hp.to_json_dict(), f, indent=2)
        self.logger = MetricsLogger(self.save_dir,
                                    use_tensorboard=use_tensorboard)
        self.ckpt_dir = os.path.join(self.save_dir, "ckpt")

        self._train_step = build_train_step(
            self.hp, self.H, self.W, microbatch_rays=microbatch_rays,
            batch_size=self.B, mesh=mesh)
        self.state = create_train_state(self.hp, self.n_objects, self.device)
        self._tables = {k: torch.from_numpy(v).to(self.device)
                        for k, v in self.pipeline.tables().items()}

    # ------------------------------------------------------------------ ckpt
    def save_checkpoint(self) -> str:
        return ckpt.save_checkpoint(self.ckpt_dir, self.state)

    def resume(self) -> bool:
        """Restore the latest checkpoint if one exists; True if restored."""
        if ckpt.latest_step(self.ckpt_dir) is None:
            return False
        ckpt.restore_checkpoint(self.ckpt_dir, self.state)
        return True

    # ------------------------------------------------------------- main loop
    def _batches(self, crop: bool, step: int, iters_crop: int):
        """The phase's batch stream from ``step`` on: stream 0 for the crop
        phase, stream 1 for the full phase, whatever step a run starts at,
        so a resumed run sees the batches an uninterrupted one would."""
        skip = step if crop else step - min(step, iters_crop)
        return self.pipeline.prefetch(self.B, crop=crop,
                                      transform=self._stage, compact=True,
                                      stream_id=0 if crop else 1, skip=skip)

    def training(self, iters_crop: int, iters_all: int,
                 log_every: int = 100) -> Dict[str, float]:
        """Run the two-stage schedule until ``iters_all`` total steps:
        rays from the center crop while the step is below ``iters_crop``,
        then from whole images (reference ``src/trainer.py:35-47``, minus
        the per-epoch optimizer rebuilds)."""
        if iters_crop > iters_all:
            raise ValueError(f"iters_crop={iters_crop} > iters_all={iters_all}")
        last_metrics: Dict[str, float] = {}
        t_phase = time.time()
        rays_since_log = 0
        start = self.state.step
        crop_phase = start < iters_crop
        batches = self._batches(crop_phase, start, iters_crop)
        try:
            for step in range(start, iters_all):
                if crop_phase and step >= iters_crop:
                    crop_phase = False
                    batches.close()          # stop the crop-phase worker
                    batches = self._batches(False, step, iters_crop)
                metrics = self._train_step(self.state, next(batches),
                                           self._tables)
                rays_since_log += self.B
                next_step = step + 1
                if next_step % log_every == 0 or next_step == iters_all:
                    last_metrics = {k: float(v) for k, v in metrics.items()}
                    dt = time.time() - t_phase
                    last_metrics["rays_per_sec"] = rays_since_log / max(dt,
                                                                        1e-9)
                    self.logger.scalars(next_step, {
                        "psnr/train": last_metrics["psnr"],
                        "reg/train": last_metrics["reg"],
                        "loss/train": last_metrics["loss"],
                        "time/train": dt,
                        "rays_per_sec": last_metrics["rays_per_sec"],
                    })
                    t_phase = time.time()
                    rays_since_log = 0
                if self.check_iter and next_step % self.check_iter == 0:
                    self._log_render(next_step)
                if self.hp.check_points and \
                        next_step % self.hp.check_points == 0:
                    self.save_checkpoint()
        except (KeyboardInterrupt, Exception):
            # Crash-safe checkpoint at the last completed step (the
            # reference has no resume path at all); a failure while saving
            # must not hide the original error.
            try:
                self.save_checkpoint()
            except Exception:
                pass
            raise
        finally:
            batches.close()                  # stop the prefetch worker
        self.save_checkpoint()
        return last_metrics

    def profile_steps(self, n_steps: int = 5,
                      trace_dir: Optional[str] = None) -> Dict[str, Any]:
        """``n_steps`` training steps on one staged batch untraced, then
        ``n_steps`` more under ``torch.profiler``, after a warm-up step.
        Writes a Chrome trace (``<trace_dir>/trace.json``, default
        ``<run>/profile``) and returns ``{"trace": path, "wall_ms": host ms
        per traced step, "untraced_ms": host ms per untraced step (each
        window ending in a synchronize), "profile": the profiler}``. The
        tracer adds its own host and device cost, so ``untraced_ms`` is
        the step's time and the trace says where it goes."""
        from torch.profiler import ProfilerActivity, profile

        trace_dir = trace_dir or os.path.join(self.save_dir, "profile")
        os.makedirs(trace_dir, exist_ok=True)
        batch = self._stage(self.pipeline.sample(self.B, compact=True))
        self._train_step(self.state, batch, self._tables)
        self._sync()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            self._train_step(self.state, batch, self._tables)
        self._sync()
        untraced_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n_steps):
                self._train_step(self.state, batch, self._tables)
            self._sync()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        path = os.path.join(trace_dir, "trace.json")
        prof.export_chrome_trace(path)
        return {"trace": path, "wall_ms": wall_ms,
                "untraced_ms": untraced_ms, "profile": prof}

    # ------------------------------------------------------------- utilities
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _stage(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host batch -> tensors on the device; on the card through pinned
        memory with a non-blocking copy (the prefetch worker runs this, so
        the copy overlaps the step in flight)."""
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def render_view(self, obj_idx: int, view_idx: int) -> np.ndarray:
        """Render one dataset view with the current model (linspace z);
        (H, W, 3) f32."""
        st = self.state
        img = render_image(
            st.model, self.hp.render, self.H, self.W,
            float(self.pipeline.focals[obj_idx]),
            self.pipeline.poses[obj_idx, view_idx],
            st.shape_codes[obj_idx].detach(),
            st.texture_codes[obj_idx].detach(),
            chunk=min(4096, self.H * self.W),
            compute_dtype=resolve_dtype(self.hp.compute_dtype))
        return img.cpu().numpy()

    def _log_render(self, step: int, obj_idx: int = 0,
                    view_idx: int = 0) -> None:
        img = self.render_view(obj_idx, view_idx)
        gt = self.pipeline.images[obj_idx, view_idx].astype(np.float32) / 255.0
        mse = float(reference_psnr_mse(torch.from_numpy(img),
                                       torch.from_numpy(gt)))
        self.logger.scalars(step, {"psnr/render": -10.0 * np.log10(mse)})
        self.logger.image(step, f"train_{step}_{obj_idx}",
                          side_by_side(img, gt))
