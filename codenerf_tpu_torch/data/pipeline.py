"""Host-side ray-batch pipeline; the port's own copy of
``codenerf_tpu/data/pipeline.py`` (numpy backend).

Every train step consumes ONE batch of rays sampled i.i.d. across all
objects, views and pixels; the host does only integer sampling and gathers
(the split is resident as uint8), and rays are built on the device from
(pixel, pose, focal) — ``core/rays.pixel_rays``. Crop mode is the
reference's first stage (center 64×64 of 128×128, ``src/data.py:76-78``)
as a restriction of the sampled pixel range. The same seed and stream give
the same batches as the JAX package, bit for bit.

:meth:`RayBatchPipeline.prefetch` keeps a small queue of ready batches on
a background thread, so sampling (and, through ``transform``, the copy to
the card) overlaps the step; a failure in the worker is raised on the
consumer's thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class _WorkerFailure:
    """Sentinel carrying a prefetch-worker exception to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class RayBatchPipeline:
    def __init__(self, images: np.ndarray, poses: np.ndarray,
                 focals: np.ndarray, seed: int = 0, backend: str = "numpy"):
        """``images`` (N, V, H, W, 3) uint8, ``poses`` (N, V, 4, 4),
        ``focals`` (N,). ``backend`` "numpy"; the JAX package's C++
        sampler ("native") is not ported."""
        if backend == "native":
            raise NotImplementedError(
                "the native (C++) pipeline backend is not ported yet "
                "(ROADMAP.md Queue 1, item 14)")
        if backend != "numpy":
            raise ValueError(f"unknown pipeline backend {backend!r}")
        assert images.dtype == np.uint8, "pipeline stores images as uint8"
        self.images = np.ascontiguousarray(images)
        self.poses = np.ascontiguousarray(poses.astype(np.float32))
        self.focals = np.ascontiguousarray(focals.astype(np.float32))
        self.n_objects, self.n_views, self.H, self.W = images.shape[:4]
        self._rng = np.random.default_rng(seed)
        self._seed = seed
        self._stream_count = 0

    def _pixel_bounds(self, crop: bool):
        if crop:
            # Center half of the image, the reference's [32:-32] of 128.
            return (self.H // 4, self.H - self.H // 4,
                    self.W // 4, self.W - self.W // 4)
        return 0, self.H, 0, self.W

    def _draw(self, rng: np.random.Generator, batch_size: int, crop: bool):
        v0, v1, u0, u1 = self._pixel_bounds(crop)
        obj = rng.integers(0, self.n_objects, batch_size, dtype=np.int64)
        view = rng.integers(0, self.n_views, batch_size, dtype=np.int64)
        pu = rng.integers(u0, u1, batch_size, dtype=np.int64)
        pv = rng.integers(v0, v1, batch_size, dtype=np.int64)
        return obj, view, pu, pv

    def sample(self, batch_size: int, crop: bool = False,
               rng: Optional[np.random.Generator] = None,
               compact: bool = False) -> Dict[str, np.ndarray]:
        """One training batch of host numpy arrays, from ``rng`` or the
        pipeline's own stream. Expanded layout: ``obj`` (B,) int32, ``uv``
        (B, 2) float32 full-image pixel coords (u = column, v = row),
        ``c2w`` (B, 3, 4) float32, ``focal`` (B,) float32, ``rgb`` (B, 3)
        float32 in [0, 1]. ``compact=True``: ``obj``, ``view`` (B,) int32,
        ``uv`` (B, 2) int16, ``rgb`` (B, 3) uint8 (15 B/ray; the step
        gathers pose and focal from :meth:`tables`). Both layouts draw the
        same (object, view, pixel) triples from a given stream state."""
        obj, view, pu, pv = self._draw(self._rng if rng is None else rng,
                                       batch_size, crop)
        if compact:
            return {
                "obj": obj.astype(np.int32),
                "view": view.astype(np.int32),
                "uv": np.stack([pu, pv], axis=-1).astype(np.int16),
                "rgb": self.images[obj, view, pv, pu],
            }
        rgb = self.images[obj, view, pv, pu].astype(np.float32) / 255.0
        return {
            "obj": obj.astype(np.int32),
            "uv": np.stack([pu, pv], axis=-1).astype(np.float32),
            "c2w": self.poses[obj, view, :3, :],
            "focal": self.focals[obj],
            "rgb": rgb,
        }

    def tables(self) -> Dict[str, np.ndarray]:
        """The full pose (N, V, 3, 4) and focal (N,) tables, put on the
        device once so each step gathers them for the compact layout."""
        return {
            "c2w": np.ascontiguousarray(self.poses[:, :, :3, :]),
            "focal": self.focals,
        }

    def prefetch(self, batch_size: int, crop: bool = False,
                 depth: int = 2, transform=None, compact: bool = False,
                 stream_id: Optional[int] = None,
                 skip: int = 0) -> Iterator:
        """Endless iterator of batches made on a background thread.

        Each call draws from its own deterministic stream,
        ``default_rng([seed, stream_id])`` — by default the next stream
        index, as in the JAX package — so the batches do not depend on
        thread timing. ``skip`` draws and drops that many batches first
        (a resumed run continues its stream). ``transform`` (the copy to
        the card) runs on the worker thread. Close the iterator
        (``.close()``) to stop its worker; closing waits for it to end, so
        no worker is left inside a native call when the process exits."""
        if stream_id is None:
            stream_id = self._stream_count
            self._stream_count += 1
        rng = np.random.default_rng([self._seed, stream_id])
        for _ in range(skip):
            self._draw(rng, batch_size, crop)
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def put(item) -> None:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def worker():
            # Any failure is forwarded through the queue and raised on the
            # consumer's thread: a silently dead worker would leave
            # training blocked on q.get() forever.
            try:
                while not stop.is_set():
                    batch = self.sample(batch_size, crop=crop, rng=rng,
                                        compact=compact)
                    if transform is not None:
                        batch = transform(batch)
                    put(batch)
            except BaseException as e:  # noqa: BLE001 — forwarded
                put(_WorkerFailure(e))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, _WorkerFailure):
                    raise RuntimeError("prefetch worker failed") from item.exc
                yield item
        finally:
            stop.set()
            t.join()
