"""Host-side ray-batch pipeline; the port's own copy of
``codenerf_tpu/data/pipeline.py``.

Every train step consumes ONE batch of rays sampled i.i.d. across all
objects, views and pixels; the host does only integer sampling and gathers
(the split is resident as uint8), and rays are built on the device from
(pixel, pose, focal) — ``core/rays.pixel_rays``. Crop mode is the
reference's first stage (center 64×64 of 128×128, ``src/data.py:76-78``)
as a restriction of the sampled pixel range. Two backends draw the
batches: ``numpy`` (the default) and ``native``, the C++ sampler of
``data/native.py``; they draw from different (each deterministic) streams.
The same backend, seed and stream give the same batches as the JAX
package, bit for bit.

:meth:`RayBatchPipeline.prefetch` keeps a small queue of ready batches on
a background thread, so sampling (and, through ``transform``, the copy to
the card) overlaps the step; a failure in the worker is raised on the
consumer's thread.

``counters`` counts, always: ``batches`` handed to the consumer and the
seconds it waited for them (``wait_s``), and on the worker the seconds
spent drawing (``draw_s``) and staging them through ``transform``
(``stage_s``). The same stretches are the spans ``data.wait``,
``data.draw`` and ``data.stage`` (``utils/tracing.py``) while a profiler
records.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from codenerf_tpu_torch.utils.tracing import span


class _WorkerFailure:
    """Sentinel carrying a prefetch-worker exception to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def shard_rows(batch_size: int, shard: Tuple[int, int]) -> slice:
    """Rows ``[i·B/n, (i+1)·B/n)`` of a batch of ``B`` for ``shard=(i,
    n)``; the JAX step's ``ValueError`` when ``n`` does not divide ``B``."""
    i, n = shard
    if batch_size % n:
        raise ValueError(f"batch {batch_size} not divisible by the {n}-way "
                         "batch sharding")
    b = batch_size // n
    return slice(i * b, (i + 1) * b)


class RayBatchPipeline:
    def __init__(self, images: np.ndarray, poses: np.ndarray,
                 focals: np.ndarray, seed: int = 0, backend: str = "numpy"):
        """``images`` (N, V, H, W, 3) uint8, ``poses`` (N, V, 4, 4),
        ``focals`` (N,). ``backend``: "numpy", "native" (the C++ sampler;
        raises if it cannot be built) or "auto" (native where it builds,
        else numpy); :attr:`backend` says which."""
        if backend not in ("numpy", "native", "auto"):
            raise ValueError(f"unknown pipeline backend {backend!r}")
        if backend != "numpy":
            from codenerf_tpu_torch.data import native

            if native.native_available():
                backend = "native"
            elif backend == "native":
                raise RuntimeError("native pipeline backend unavailable: "
                                   f"{native.build_error()}")
            else:
                backend = "numpy"
        self.backend = backend
        assert images.dtype == np.uint8, "pipeline stores images as uint8"
        self.images = np.ascontiguousarray(images)
        self.poses = np.ascontiguousarray(poses.astype(np.float32))
        self.focals = np.ascontiguousarray(focals.astype(np.float32))
        self.n_objects, self.n_views, self.H, self.W = images.shape[:4]
        self._rng = np.random.default_rng(seed)
        self._seed = seed
        self._step = 0
        self._stream_count = 0
        self.counters = {"batches": 0, "wait_s": 0.0, "draw_s": 0.0,
                         "stage_s": 0.0}

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
               compact: bool = False,
               native_step: Optional[int] = None,
               shard: Optional[Tuple[int, int]] = None
               ) -> Dict[str, np.ndarray]:
        """One training batch of host numpy arrays, from ``rng`` or the
        pipeline's own stream (numpy), or from the native stream's
        ``native_step`` (by default the pipeline's next step). Expanded
        layout: ``obj`` (B,) int32, ``uv`` (B, 2) float32 full-image pixel
        coords (u = column, v = row), ``c2w`` (B, 3, 4) float32, ``focal``
        (B,) float32, ``rgb`` (B, 3) float32 in [0, 1]. ``compact=True``:
        ``obj``, ``view`` (B,) int32, ``uv`` (B, 2) int16, ``rgb`` (B, 3)
        uint8 (15 B/ray; the step gathers pose and focal from
        :meth:`tables`). Both layouts draw the same (object, view, pixel)
        triples from a given stream state.

        ``shard=(i, n)``: the global batch's draws advance the stream as
        without it, and rows ``[i·B/n, (i+1)·B/n)`` of it come back (rank
        i of an n-way data-parallel step), the same rows bit for bit."""
        rows = slice(None) if shard is None else shard_rows(batch_size,
                                                            shard)
        if self.backend == "native":
            from codenerf_tpu_torch.data import native

            if native_step is None:
                self._step += 1
                native_step = self._step
            fn = native.sample_batch_compact if compact else \
                native.sample_batch
            # The sampler draws and gathers in one call: slice its output.
            out = fn(self.images, self.poses, self.focals, batch_size,
                     self._seed, native_step, *self._pixel_bounds(crop))
            return {k: v[rows] for k, v in out.items()}
        obj, view, pu, pv = (x[rows] for x in self._draw(
            self._rng if rng is None else rng, batch_size, crop))
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

    def rays_of_view(self, obj: int, view: int,
                     crop: bool = False) -> Dict[str, np.ndarray]:
        """Every pixel of one (object, view), row-major, in the expanded
        layout: the eval layout (``src/utils.py:18``)."""
        v0, v1, u0, u1 = self._pixel_bounds(crop)
        vv, uu = np.meshgrid(np.arange(v0, v1), np.arange(u0, u1),
                             indexing="ij")
        n = vv.size
        rgb = self.images[obj, view, vv.ravel(), uu.ravel()].astype(
            np.float32) / 255.0
        return {
            "obj": np.full((n,), obj, dtype=np.int32),
            "uv": np.stack([uu.ravel(), vv.ravel()], -1).astype(np.float32),
            "c2w": np.broadcast_to(self.poses[obj, view, :3, :],
                                   (n, 3, 4)).copy(),
            "focal": np.full((n,), self.focals[obj], dtype=np.float32),
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
                 skip: int = 0,
                 shard: Optional[Tuple[int, int]] = None) -> Iterator:
        """Endless iterator of batches made on a background thread.

        Each call draws from its own deterministic stream,
        ``default_rng([seed, stream_id])`` or, native, the steps
        ``(stream_id << 32) | i`` — by default the next stream index, as
        in the JAX package — so the batches do not depend on thread
        timing. ``skip`` passes over that many batches first (a resumed
        run continues its stream). ``shard`` as in :meth:`sample`.
        ``transform`` (the copy to
        the card) runs on the worker thread. Close the iterator
        (``.close()``) to stop its worker; closing waits for it to end, so
        no worker is left inside a native call when the process exits."""
        if stream_id is None:
            stream_id = self._stream_count
            self._stream_count += 1
        rng = np.random.default_rng([self._seed, stream_id])
        if self.backend == "numpy":
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
            c = self.counters
            try:
                i = skip
                while not stop.is_set():
                    t0 = time.perf_counter()
                    with span("data.draw"):
                        batch = self.sample(batch_size, crop=crop, rng=rng,
                                            compact=compact,
                                            native_step=(stream_id << 32) | i,
                                            shard=shard)
                    i += 1
                    t1 = time.perf_counter()
                    c["draw_s"] += t1 - t0
                    if transform is not None:
                        with span("data.stage"):
                            batch = transform(batch)
                        c["stage_s"] += time.perf_counter() - t1
                    put(batch)
            except BaseException as e:  # noqa: BLE001 — forwarded
                put(_WorkerFailure(e))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        c = self.counters
        try:
            while True:
                t0 = time.perf_counter()
                with span("data.wait"):
                    item = q.get()
                c["wait_s"] += time.perf_counter() - t0
                if isinstance(item, _WorkerFailure):
                    raise RuntimeError("prefetch worker failed") from item.exc
                c["batches"] += 1
                yield item
        finally:
            stop.set()
            t.join()
