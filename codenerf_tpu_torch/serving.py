"""Rendering service: an HTTP server over a trained model (counterpart of
``codenerf_tpu/serving.py``).

The networks and code tables stay on the device; each request renders one
image through the eval path (``renderer.render_image``: on the card the
forward kernels where they take the render, else the plain module(s))
and returns it as a PNG. Stdlib HTTP only:

  GET  /healthz  -> {"status": "ok", "device": "...", "n_objects": N}
  GET  /stats    -> request count, latency quantiles (p50, p95, max over
                    the last 1,000 requests), the (H, W, deterministic)
                    keys rendered so far
  GET  /timings  -> "requests", "failed" (400), "overlapped" (renders
                    prepared while another held the render lock); p50,
                    p95 and max ms over the last 1,000 requests of
                    "queue_ms" (the waits for both locks), "prepare_ms",
                    "render_ms" (under the render lock, /stats' latency),
                    "handler_ms" (parse, PNG encode, reply) and
                    "request_ms"; "chunks" and "samples" (the counters
                    renderer.render_image.chunks and .samples)
  POST /render   -> image/png (400 on a bad request, 404 on another path)
     JSON body:
       camera: either {"c2w": 4x4 nested list}
               or     {"azimuth": rad, "elevation": rad, "radius": float}
       codes:  either {"obj": int}  (a training object's codes)
               or     {"shape_code": [D], "texture_code": [D]}
       optional: "H", "W" (default 128), "focal" (default 1.1*W),
                 "deterministic" (default true), "seed" (default 0)

Renders run in two stages (``renderer.prepare_image``, then
``render_image`` finishing it). A request prepares under the prepare lock (with
``use_occupancy`` fetching or building its grid first), takes the render
lock, makes its launches, and only then lets go of the prepare lock, so
one render can wait prepared while another holds the render lock: on
the kernel route the next request's host work (the pose's upload, the
rays, the operands) runs while the device runs this render's kernels,
and not while this render's host enqueues them (both need the
interpreter lock). The render lock covers every forward launch of a
render and its read-back.
``deterministic: false`` draws the depths from a ``torch.Generator`` on
the device seeded with ``seed`` (the JAX package draws from its own
PRNG, so only deterministic renders agree across the packages). There
is nothing to compile: ``compiled_sizes`` lists the sizes rendered,
which keeps the JAX server's ``/stats`` fields.

While a profiler records, each request is the span ``serve.request``
(its sequence number in the span's args) over ``serve.parse``,
``serve.queue`` (the wait for the prepare lock, and again for the
render lock), ``serve.prepare`` (``render.rays``; on the kernel route
``render.operands``), ``serve.render`` (for a hierarchical render
``render.coarse`` and ``render.resample``, the ``render.chunk`` s,
``render.readback``), ``serve.encode`` and ``serve.reply``
(``utils/tracing.py``).
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import itertools
import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np
import torch

from codenerf_tpu_torch.utils.tracing import span

# Raw-code occupancy grids cached at most (object grids are bounded by the
# table size already).
_DIGEST_GRIDS = 32
# Requests whose times /stats and /timings read.
_KEPT = 1000


class _HTTPServer(ThreadingHTTPServer):
    """The threading HTTP server with a listen backlog for many clients:
    its accepting thread competes for the interpreter lock with the
    render and the handlers, and connections beyond a full backlog (the
    standard library's 5) can be refused."""
    request_queue_size = 128


def _read_back(img: torch.Tensor) -> np.ndarray:
    """``img`` on the host. From the card through a pinned buffer, then a
    wait on an event recorded after the copy: a copy into pageable
    memory holds up the other threads' CUDA calls until it ends, the
    next request's prepare among them."""
    if img.device.type != "cuda":
        return img.cpu().numpy()
    host = torch.empty(img.shape, dtype=img.dtype, pin_memory=True)
    host.copy_(img, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(img.device))
    done.synchronize()
    return host.numpy()


def _quantiles_ms(seconds) -> Dict[str, float]:
    """p50, p95 and max of ``seconds`` in ms (zeros when empty)."""
    a = np.asarray(seconds) if len(seconds) else np.zeros(1)
    return {"p50": float(np.quantile(a, 0.5) * 1e3),
            "p95": float(np.quantile(a, 0.95) * 1e3),
            "max": float(a.max() * 1e3)}


class RenderServer:
    def __init__(self, trainables: Dict[str, Any], hp,
                 host: str = "127.0.0.1", port: int = 0,
                 use_occupancy: bool = False, occ_grid_size: int = 64,
                 occ_radius: Optional[float] = None):
        """``trainables``: ``model`` (a ``CodeNeRF`` on the serving
        device), ``shape_codes`` and ``texture_codes`` (N, D), and
        ``fine_model`` (the separate fine network, or None), as
        ``utils/checkpoint.load_run`` returns them. ``use_occupancy=True``
        builds a per-object occupancy grid from the trained density
        (lazily, cached per object) and renders with empty-space skipping.
        Needs a grid extent: ``occ_radius`` or
        ``hp.render.bound_sphere_radius``."""
        self.model = trainables["model"]
        self.fine_model = trainables.get("fine_model")
        self.device = next(self.model.parameters()).device
        self.shape_codes = trainables["shape_codes"].to(self.device)
        self.texture_codes = trainables["texture_codes"].to(self.device)
        self.hp = hp
        self.n_objects = int(self.shape_codes.shape[0])
        self.use_occupancy = use_occupancy
        self._occ_grid_size = occ_grid_size
        self._occ_radius = (occ_radius if occ_radius is not None
                            else hp.render.bound_sphere_radius)
        if use_occupancy and self._occ_radius is None:
            raise ValueError(
                "use_occupancy needs a grid extent: pass occ_radius or set "
                "bound_sphere_radius in the config")
        if use_occupancy and hp.render.shared_jitter:
            # the shared-jitter quirk is one global z slab, so per-ray
            # bounds (and hence the grid) would be silently dropped by the
            # sampler
            raise ValueError(
                "use_occupancy requires per-ray sampling: shared_jitter "
                "cannot carry per-ray occupancy bounds")
        self._occ_grids: Dict[Any, Any] = {}
        self._sizes: Dict[tuple, None] = {}
        # The render lock, and the prepare lock a request holds until its
        # launches are enqueued under the render lock (hand over hand).
        # _rendering: a render holds the render lock (set under it);
        # _overlapped counts the renders prepared while one did.
        self._lock = threading.Lock()
        self._prepare_lock = threading.Lock()
        self._rendering = False
        self._overlapped = 0
        # Seconds of the last requests under the names timings() reports
        # them by; guarded by _times_lock, as is the count of refused
        # requests.
        self._times = {k: deque(maxlen=_KEPT) for k in (
            "queue_ms", "prepare_ms", "render_ms", "handler_ms",
            "request_ms")}
        self._times_lock = threading.Lock()
        self._count = 0
        self._failed = 0
        self._seq = itertools.count()
        self._device = str(self.device)
        self._httpd = _HTTPServer((host, port), self._handler_class())
        self.host, self.port = self._httpd.server_address[:2]

    @classmethod
    def from_checkpoint(cls, run_dir: str, hp, device="cuda",
                        **kw) -> "RenderServer":
        """A server over the run directory's networks and code tables
        (``utils/checkpoint.load_run``: the latest ``ckpt/step_*.pt``,
        else ``models.pth``), on ``device``."""
        from codenerf_tpu_torch import resolve_device
        from codenerf_tpu_torch.utils.checkpoint import load_run

        model, fine_model, sc, tc = load_run(run_dir, hp,
                                             resolve_device(device))
        return cls({"model": model, "fine_model": fine_model,
                    "shape_codes": sc, "texture_codes": tc}, hp, **kw)

    # ------------------------------------------------------------ rendering
    def _get_occ_grid(self, obj: int, shape_code, texture_code):
        """Per-object grid, built from the trained density on first use.
        Custom-code requests (obj == -1) are cached by a digest of the
        code bytes, so repeated renders of the same edit don't rebuild."""
        key = obj if obj >= 0 else hashlib.sha1(
            shape_code.cpu().numpy().astype(np.float32).tobytes()
            + texture_code.cpu().numpy().astype(np.float32).tobytes()
        ).hexdigest()
        if key in self._occ_grids:
            return self._occ_grids[key]
        from codenerf_tpu_torch.config import resolve_dtype
        from codenerf_tpu_torch.core.occupancy import build_occupancy_grid

        grid = build_occupancy_grid(
            self.model, shape_code, texture_code, G=self._occ_grid_size,
            radius=float(self._occ_radius),
            compute_dtype=resolve_dtype(self.hp.compute_dtype))
        if obj < 0:
            digests = [k for k in self._occ_grids if isinstance(k, str)]
            if len(digests) >= _DIGEST_GRIDS:
                del self._occ_grids[digests[0]]
        self._occ_grids[key] = grid
        return grid

    def _codes(self, req: Dict[str, Any]):
        """``(obj, shape_code, texture_code)`` of a request; obj -1 for raw
        codes."""
        if "obj" in req:
            obj = int(req["obj"])
            if not 0 <= obj < self.n_objects:
                raise ValueError(f"obj must be in [0, {self.n_objects})")
            return obj, self.shape_codes[obj], self.texture_codes[obj]
        if "shape_code" in req and "texture_code" in req:
            D = self.shape_codes.shape[1]
            codes = [torch.tensor(req[k], dtype=torch.float32)
                     for k in ("shape_code", "texture_code")]
            if any(tuple(c.shape) != (D,) for c in codes):
                raise ValueError(f"shape_code and texture_code must hold "
                                 f"{D} values each")
            return -1, codes[0].to(self.device), codes[1].to(self.device)
        raise ValueError("provide 'obj' or 'shape_code'+'texture_code'")

    def render(self, req: Dict[str, Any]) -> np.ndarray:
        """One request's image, (H, W, 3) uint8: the render clipped ×255.
        Prepared (``renderer.prepare_image``) under the prepare lock,
        finished (``renderer.render_image`` of the prepared record) and
        read back under the render lock; the prepare lock is let go once the render's
        launches are enqueued."""
        from codenerf_tpu_torch.config import resolve_dtype
        from codenerf_tpu_torch.render_orbit import orbit_pose
        from codenerf_tpu_torch.renderer import prepare_image, render_image

        H = int(req.get("H", 128))
        W = int(req.get("W", 128))
        focal = float(req.get("focal", 1.1 * W))
        deterministic = bool(req.get("deterministic", True))
        if "c2w" in req:
            c2w = np.asarray(req["c2w"], dtype=np.float32)
            if c2w.shape != (4, 4):
                raise ValueError("c2w must be 4x4")
        else:
            c2w = orbit_pose(float(req.get("azimuth", 0.0)),
                             float(req.get("elevation", 0.3)),
                             float(req.get("radius", 1.3)))
        obj, shape_code, texture_code = self._codes(req)
        seed = int(req.get("seed", 0))
        t_queue = time.perf_counter()
        with span("serve.queue"):
            self._prepare_lock.acquire()
        handed = False
        try:
            t_prep = time.perf_counter()
            with span("serve.prepare"):
                gen = (None if deterministic else torch.Generator(
                    device=self.device).manual_seed(seed))
                occ = (self._get_occ_grid(obj, shape_code, texture_code)
                       if self.use_occupancy else None)
                args = (self.model, self.hp.render, H, W, focal, c2w,
                        shape_code, texture_code, gen)
                kw = dict(chunk=4096, occ_grid=occ,
                          compute_dtype=resolve_dtype(self.hp.compute_dtype),
                          fine_model=self.fine_model)
                prep = prepare_image(*args, **kw)
            t_ready = time.perf_counter()
            behind = self._rendering
            self._record(prepare_ms=t_ready - t_prep)
            with contextlib.ExitStack() as queue:
                queue.enter_context(span("serve.queue"))
                with self._lock:
                    queue.close()
                    self._rendering = True
                    t0 = time.perf_counter()
                    try:
                        with span("serve.render"):
                            img = render_image(*args, prepared=prep, **kw)
                            # every launch is enqueued: the next request
                            # prepares while the device runs them
                            self._prepare_lock.release()
                            handed = True
                            with span("render.readback"):
                                img = _read_back(img)
                    finally:
                        self._rendering = False
                    self._sizes[(H, W, deterministic)] = None
                    self._record(render_ms=time.perf_counter() - t0,
                                 queue_ms=(t_prep - t_queue) + (t0 - t_ready))
                    self._count += 1
                    self._overlapped += behind
        finally:
            if not handed:
                self._prepare_lock.release()
        return np.clip(img * 255.0, 0, 255).astype(np.uint8)

    def _record(self, **seconds: float) -> None:
        """Append each of ``seconds`` to its table of times."""
        with self._times_lock:
            for k, v in seconds.items():
                self._times[k].append(v)

    def stats(self) -> Dict[str, Any]:
        return {"requests": self._count,
                "latency_ms": self.timings()["render_ms"],
                "compiled_sizes": [list(k) for k in self._sizes]}

    def timings(self) -> Dict[str, Any]:
        """What ``GET /timings`` returns (the module's docstring)."""
        from codenerf_tpu_torch.renderer import KERNEL_SAMPLES, ROUTE_CHUNKS

        with self._times_lock:
            times = {k: list(d) for k, d in self._times.items()}
            failed = self._failed
        return {"requests": self._count, "failed": failed,
                "overlapped": self._overlapped,
                **{k: _quantiles_ms(v) for k, v in times.items()},
                "chunks": dict(ROUTE_CHUNKS),
                "samples": dict(KERNEL_SAMPLES)}

    # ------------------------------------------------------------------ http
    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _json(self, code: int, payload: Dict[str, Any]):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, {"status": "ok", "device": server._device,
                                     "n_objects": server.n_objects})
                elif self.path == "/stats":
                    self._json(200, server.stats())
                elif self.path == "/timings":
                    self._json(200, server.timings())
                else:
                    self._json(404, {"error": "unknown path"})

            def do_POST(self):
                if self.path != "/render":
                    self._json(404, {"error": "unknown path"})
                    return
                with span("serve.request", str(next(server._seq))):
                    try:
                        self._render_png()
                    except (ValueError, KeyError, json.JSONDecodeError) as e:
                        with server._times_lock:
                            server._failed += 1
                        self._json(400, {"error": str(e)})

            def _render_png(self):
                from PIL import Image

                t0 = time.perf_counter()
                with span("serve.parse"):
                    n = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(n) or b"{}")
                t1 = time.perf_counter()
                img = server.render(req)
                t2 = time.perf_counter()
                with span("serve.encode"):
                    buf = io.BytesIO()
                    Image.fromarray(img).save(buf, format="PNG")
                    data = buf.getvalue()
                with span("serve.reply"):
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                t3 = time.perf_counter()
                server._record(handler_ms=(t1 - t0) + (t3 - t2),
                               request_ms=t3 - t0)

        return Handler

    # -------------------------------------------------------------- control
    def serve_forever(self):
        self._serving = True
        self._httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        # HTTPServer.shutdown() blocks forever unless serve_forever is
        # running — guard so shutting down a never-started server works.
        if getattr(self, "_serving", False):
            self._httpd.shutdown()
        self._httpd.server_close()
