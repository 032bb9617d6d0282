"""Category-level training loop (counterpart of
``codenerf_tpu/training/trainer.py``).

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

With ``train_occupancy`` the trainer keeps a category-level occupancy
grid (``core/occupancy.py``) that bounds every step's coarse depths: the
full grid during warm-up; at the warm-up boundary a rebuild from every
object's codes (``category_density_scan``); then every ``update_every``
steps an EMA refresh from ``codes_per_update`` objects taken round-robin.
The density is a function of the model and codes and is not
checkpointed: a run resumed past warm-up rebuilds it. With separate fine
weights the grid is scanned from the coarse network, as in JAX.

With a ``mesh`` (``parallel/mesh.py``; one process per card) every rank
runs this loop on its rows of each step's batch (``train_step``'s data
parallelism). The ranks start from the same seeded weights, resume from
the same checkpoint and update alike; the occupancy grid is broadcast
from global rank 0 to every rank after each refresh, so no
nondeterministic op can set the ranks apart. Global rank 0 alone writes
``hpam.json``, ``metrics.jsonl``, TensorBoard, checkpoints and render
logs; every save ends at a barrier over every rank. With a ``model``
axis above 1 (the autodiff route) the state is split over it
(``training/state.py``), and whatever evaluates the model — the
occupancy refreshes, the render logs, the checkpoints — gathers it
whole first, on every rank alike. Its crash-safe save cannot gather (a
peer may be dead): each rank writes its own slices with no collective
(``utils/checkpoint.save_slices``), and a resume stitches the newest
complete set, or passes over an incomplete one to the newest complete
checkpoint and logs which it took. A ``mesh`` made with a ``timeout``
(``parallel/mesh.make_mesh``) lets a rank that waits on a dead peer
reach that save.
"""

from __future__ import annotations

import json
import logging
import os
import time
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from codenerf_tpu_torch import resolve_device
from codenerf_tpu_torch.config import Hparams, resolve_dtype
from codenerf_tpu_torch.core import occupancy as occ_mod
from codenerf_tpu_torch.data.pipeline import RayBatchPipeline
from codenerf_tpu_torch.data.srn import SRNDataset
from codenerf_tpu_torch.evaluation.metrics import reference_psnr_mse
from codenerf_tpu_torch.parallel.mesh import batch_shard, broadcast_, is_writer
from codenerf_tpu_torch.renderer import render_image
from codenerf_tpu_torch.training.state import (create_train_state,
                                               whole_trainables)
from codenerf_tpu_torch.training.train_step import build_train_step
from codenerf_tpu_torch.utils import checkpoint as ckpt
from codenerf_tpu_torch.utils.images import side_by_side
from codenerf_tpu_torch.utils.logging import MetricsLogger
from codenerf_tpu_torch.utils.tracing import span


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
        self._shard = None if mesh is None else batch_shard(mesh)
        self._meshed = mesh is not None
        self.writer = is_writer()

        # Run directory: exps/<save_dir>/{hpam.json, metrics.jsonl, ckpt/}
        # (reference layout, src/trainer.py:158-166).
        self.save_dir = os.path.join(exps_root, save_dir)
        self.ckpt_dir = os.path.join(self.save_dir, "ckpt")
        self.logger = None
        if self.writer:
            os.makedirs(self.save_dir, exist_ok=True)
            with open(os.path.join(self.save_dir, "hpam.json"), "w") as f:
                json.dump(self.hp.to_json_dict(), f, indent=2)
            self.logger = MetricsLogger(self.save_dir,
                                        use_tensorboard=use_tensorboard)

        self._train_step = build_train_step(
            self.hp, self.H, self.W, microbatch_rays=microbatch_rays,
            batch_size=self.B, mesh=mesh)
        self._step_counters = self._train_step.counters
        self.state = create_train_state(self.hp, self.n_objects, self.device,
                                        mesh=mesh)
        self._tables = {k: torch.from_numpy(v).to(self.device)
                        for k, v in self.pipeline.tables().items()}
        self._init_occupancy()

    # ------------------------------------------------------ train occupancy
    def _init_occupancy(self) -> None:
        """The training occupancy grid's state (``TrainOccupancyConfig``):
        the full grid until the warm-up ends, the density field, the
        round-robin cursor and the refresh width."""
        self._occ = None
        oc = self.hp.train_occupancy
        if oc is None:
            return
        radius = (oc.radius if oc.radius is not None
                  else self.hp.render.bound_sphere_radius)
        self._occ_radius = float(radius)
        self._density = torch.zeros((oc.grid_size,) * 3, dtype=torch.float32,
                                    device=self.device)
        self._occ = occ_mod.full_grid(oc.grid_size, self._occ_radius,
                                      self.device)
        self._occ_cursor = 0
        self._occ_seeded = False
        self._occ_k = k = occ_mod.resolve_codes_per_update(oc,
                                                           self.n_objects)
        rounds = -(-self.n_objects // k)
        if rounds > 1 and oc.decay ** rounds < 0.5:
            warnings.warn(
                f"train_occupancy: codes_per_update={k} covers "
                f"{self.n_objects} objects in {rounds} rounds, and "
                f"decay^rounds = {oc.decay ** rounds:.3f} < 0.5: cells kept "
                "alive only by rarely refreshed objects decay below the "
                "threshold between their refreshes. Raise codes_per_update "
                "or decay, or leave codes_per_update unset.", stacklevel=3)

    def _update_occupancy(self) -> None:
        """EMA refresh from the next ``codes_per_update`` objects."""
        oc = self.hp.train_occupancy
        idx = (torch.arange(self._occ_k) + self._occ_cursor) % self.n_objects
        self._occ_cursor = int((self._occ_cursor + self._occ_k)
                               % self.n_objects)
        idx = idx.to(self.device)
        model, _, sc, tc = self._whole()
        self._density = occ_mod.update_density_grid(
            self._density, model, sc[idx], tc[idx], self._occ_radius,
            decay=oc.decay, compute_dtype=resolve_dtype(self.hp.compute_dtype))
        self._occ = occ_mod.grid_from_density(
            self._density, self._occ_radius,
            sigma_threshold=oc.sigma_threshold, dilate=oc.dilate,
            mask_radius=self._occ_radius)
        self._share_occupancy()
        self._log_occupancy(rebuild=False)

    def _rebuild_occupancy(self) -> None:
        """The grid from every object's codes (``decay = 1``): at the
        warm-up boundary and on a resume past it, where one round-robin
        refresh would see only ``codes_per_update`` objects and empty the
        others' cells."""
        oc = self.hp.train_occupancy
        model, _, sc, tc = self._whole()
        self._density, self._occ = occ_mod.category_density_scan(
            model, sc, tc, oc.grid_size, self._occ_radius, self._occ_k,
            sigma_threshold=oc.sigma_threshold, dilate=oc.dilate,
            compute_dtype=resolve_dtype(self.hp.compute_dtype))
        self._occ_cursor = 0
        self._occ_seeded = True
        self._share_occupancy()
        self._log_occupancy(rebuild=True)

    def _share_occupancy(self) -> None:
        """Under a mesh, global rank 0's density and grid on every rank (a
        replicated step input, as in JAX)."""
        if self._meshed:
            broadcast_([self._density, self._occ.occ],
                       torch.distributed.group.WORLD)

    def _log_occupancy(self, rebuild: bool) -> None:
        """The grid's occupied share and whether it was a full rebuild, at
        the state's step, in ``metrics.jsonl``."""
        if self.writer:
            self.logger.scalars(self.state.step, {
                "occ/occupied": float(self._occ.occ.float().mean()),
                "occ/rebuild": float(rebuild)})

    def _maybe_update_occupancy(self, next_step: int) -> None:
        oc = self.hp.train_occupancy
        if oc is None:
            return
        if next_step >= oc.warmup and next_step % oc.update_every == 0:
            with span("train.occupancy"):
                if self._occ_seeded:
                    self._update_occupancy()
                else:
                    self._rebuild_occupancy()

    @property
    def occupancy_grid(self):
        """The live category occupancy grid (None without
        ``train_occupancy``). A max-union over the trained codes, it also
        bounds unseen objects of the category (``CodeOptimizer``'s
        ``occ_grid``)."""
        return self._occ

    # ------------------------------------------------------------------ ckpt
    def save_checkpoint(self) -> Optional[str]:
        """The writer saves the whole state (under a model axis every rank
        joins its gather); under a mesh every rank then waits at a barrier,
        so no rank reads a checkpoint still being written. Returns the
        path (None on the other ranks)."""
        path = self._save()
        if self._meshed:
            torch.distributed.barrier()
        return path

    def _save(self) -> Optional[str]:
        return ckpt.save_checkpoint(self.ckpt_dir, self.state,
                                    write=self.writer)

    def resume(self) -> bool:
        """Restore the latest checkpoint if one exists (whole, or a
        crashed run's complete set of slices; ``ckpt.checkpoint_note``
        is logged when newer incomplete sets were passed over); True if
        restored."""
        note = ckpt.checkpoint_note(self.ckpt_dir)
        if note is not None:
            logging.getLogger(__name__).warning(note)
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
                                      stream_id=0 if crop else 1, skip=skip,
                                      shard=self._shard)

    def training(self, iters_crop: int, iters_all: int,
                 log_every: int = 100) -> Dict[str, float]:
        """Run the two-stage schedule until ``iters_all`` total steps:
        rays from the center crop while the step is below ``iters_crop``,
        then from whole images (reference ``src/trainer.py:35-47``, minus
        the per-epoch optimizer rebuilds). Each log line adds to the
        reference's scalars the host seconds of its interval spent waiting
        for batches (``time/data_wait``) and inside the steps
        (``time/step_host``). While a profiler records, the loop's work
        is the spans ``data.wait``, ``train.step``, ``train.occupancy``,
        ``train.log``, ``train.checkpoint`` and ``train.render_log``."""
        if iters_crop > iters_all:
            raise ValueError(f"iters_crop={iters_crop} > iters_all={iters_all}")
        last_metrics: Dict[str, float] = {}
        t_phase = time.time()
        rays_since_log = 0
        waited = self._host_seconds()
        start = self.state.step
        crop_phase = start < iters_crop
        oc = self.hp.train_occupancy
        if oc is not None and start >= oc.warmup and not self._occ_seeded:
            # Resumed past the warm-up: the density is not checkpointed, so
            # it is rebuilt from the restored model over every object. A
            # grid already live in this process is current and kept.
            self._rebuild_occupancy()
        batches = self._batches(crop_phase, start, iters_crop)
        try:
            for step in range(start, iters_all):
                if crop_phase and step >= iters_crop:
                    crop_phase = False
                    batches.close()          # stop the crop-phase worker
                    batches = self._batches(False, step, iters_crop)
                metrics = self._train_step(self.state, next(batches),
                                           *self._step_extras())
                rays_since_log += self.B
                next_step = step + 1
                self._maybe_update_occupancy(next_step)
                if next_step % log_every == 0 or next_step == iters_all:
                    with span("train.log"):
                        last_metrics = {k: float(v)
                                        for k, v in metrics.items()}
                        dt = time.time() - t_phase
                        last_metrics["rays_per_sec"] = rays_since_log / max(
                            dt, 1e-9)
                        now = self._host_seconds()
                        if self.writer:
                            self.logger.scalars(next_step, {
                                "psnr/train": last_metrics["psnr"],
                                "reg/train": last_metrics["reg"],
                                "loss/train": last_metrics["loss"],
                                "time/train": dt,
                                "time/data_wait": now[0] - waited[0],
                                "time/step_host": now[1] - waited[1],
                                "rays_per_sec": last_metrics["rays_per_sec"],
                            })
                    t_phase = time.time()
                    rays_since_log = 0
                    waited = now
                if self.check_iter and next_step % self.check_iter == 0:
                    with span("train.render_log"):
                        self._log_render(next_step)
                if self.hp.check_points and \
                        next_step % self.hp.check_points == 0:
                    with span("train.checkpoint"):
                        self.save_checkpoint()
        except (KeyboardInterrupt, Exception):
            # Crash-safe checkpoint at the last completed step (the
            # reference has no resume path at all); a failure while saving
            # must not hide the original error. No collective: the other
            # ranks may not reach it. Under a model axis every rank writes
            # its own slices.
            try:
                if self.state.shards is None:
                    self._save()
                else:
                    ckpt.save_slices(self.ckpt_dir, self.state)
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
        batch = self._stage(self.pipeline.sample(self.B, compact=True,
                                                 shard=self._shard))
        self._train_step(self.state, batch, *self._step_extras())
        self._sync()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            self._train_step(self.state, batch, *self._step_extras())
        self._sync()
        untraced_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n_steps):
                self._train_step(self.state, batch, *self._step_extras())
            self._sync()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        path = os.path.join(trace_dir, "trace.json")
        prof.export_chrome_trace(path)
        return {"trace": path, "wall_ms": wall_ms,
                "untraced_ms": untraced_ms, "profile": prof}

    # ------------------------------------------------------------- utilities
    def _host_seconds(self) -> tuple:
        """The host seconds so far spent waiting on the prefetch queue and
        inside the train step (their counters)."""
        return (self.pipeline.counters["wait_s"],
                self._step_counters["host_s"])

    def _step_extras(self) -> tuple:
        """The train step's arguments after (state, batch): the pose and
        focal tables, then the occupancy grid when there is one."""
        return (self._tables,) + (() if self._occ is None else (self._occ,))

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

    @torch.no_grad()
    def _whole(self) -> list:
        """``whole_trainables`` of the state, detached: under a model axis
        a gather every rank must join."""
        return [x if x is None or callable(x) else x.detach()
                for x in whole_trainables(self.state)]

    def render_view(self, obj_idx: int, view_idx: int) -> np.ndarray:
        """Render one dataset view with the current model and fine network
        (linspace z); (H, W, 3) f32. Under a model axis every rank must
        call it."""
        return self._render(self._whole(), obj_idx, view_idx)

    def _render(self, whole, obj_idx: int, view_idx: int) -> np.ndarray:
        model, fine, sc, tc = whole
        img = render_image(
            model, self.hp.render, self.H, self.W,
            float(self.pipeline.focals[obj_idx]),
            self.pipeline.poses[obj_idx, view_idx], sc[obj_idx],
            tc[obj_idx], chunk=min(4096, self.H * self.W),
            compute_dtype=resolve_dtype(self.hp.compute_dtype),
            fine_model=fine)
        return img.cpu().numpy()

    def _log_render(self, step: int, obj_idx: int = 0,
                    view_idx: int = 0) -> None:
        """The writer renders and logs a view; every rank joins the
        gather under a model axis."""
        whole = self._whole()
        if not self.writer:
            return
        img = self._render(whole, obj_idx, view_idx)
        gt = self.pipeline.images[obj_idx, view_idx].astype(np.float32) / 255.0
        mse = float(reference_psnr_mse(torch.from_numpy(img),
                                       torch.from_numpy(gt)))
        self.logger.scalars(step, {"psnr/render": -10.0 * np.log10(mse)})
        self.logger.image(step, f"train_{step}_{obj_idx}",
                          side_by_side(img, gt))
