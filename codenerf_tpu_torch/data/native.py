"""The native (C++) ray sampler: the port's ctypes binding of
``native/ray_sampler.cpp``, the counterpart of ``codenerf_tpu/data/native.py``.

The source in the repository is the only source. It is compiled with
``g++`` at first use, with ``native/Makefile``'s flags, into
``build/torch_kernels/`` at the root of the checkout; the library's name
carries a hash of the source, the flags and the host's name, since
``-march=native`` code runs on the host that built it. Nothing is built
when the module is imported. The counter-based streams are the JAX
package's: the same images, seed and step give the same batches, bit for
bit, whatever the thread count. :func:`native_available` is False where
the library cannot be built (no ``g++``); the wrappers then raise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "ray_sampler.cpp"
BUILD_DIR = _REPO / "build" / "torch_kernels"
# native/Makefile: CXXFLAGS, then -shared.
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread",
             "-Wall", "-Wextra", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None

_i64 = ctypes.c_int64
_u64 = ctypes.c_uint64
_MASK64 = 2 ** 64 - 1


def library_path() -> Path:
    key = (SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
           + platform.node().encode())
    return BUILD_DIR / f"libcn_native-{hashlib.sha256(key).hexdigest()[:16]}.so"


def _build(out: Path) -> Optional[str]:
    """Compile the source into ``out``; the compiler's message on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp),
                               str(SOURCE)], capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        return f"g++ did not run: {e}"
    if proc.returncode != 0:
        return f"g++ exited {proc.returncode}:\n{proc.stderr}"
    os.replace(tmp, out)
    return None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare every entry point's signature (``AttributeError`` if the
    library lacks one)."""
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    lib.cn_sample_batch.restype = ctypes.c_int
    lib.cn_sample_batch.argtypes = [
        u8p, f32p, f32p, _i64, _i64, _i64, _i64, _i64, _u64, _u64,
        _i64, _i64, _i64, _i64, i32p, f32p, f32p, f32p, f32p, ctypes.c_int]
    lib.cn_sample_batch_compact.restype = ctypes.c_int
    lib.cn_sample_batch_compact.argtypes = [
        u8p, _i64, _i64, _i64, _i64, _i64, _u64, _u64,
        _i64, _i64, _i64, _i64, i32p, i32p, i16p, u8p, ctypes.c_int]
    lib.cn_rays_of_view.restype = ctypes.c_int
    lib.cn_rays_of_view.argtypes = [
        u8p, f32p, f32p, _i64, _i64, _i64, _i64, _i64, _i64,
        _i64, _i64, _i64, _i64, i32p, f32p, f32p, f32p, f32p]
    return lib


def load_library() -> Optional[ctypes.CDLL]:
    """The loaded library, built if needed; None if it cannot be built
    (the reason is kept for :func:`build_error`)."""
    global _lib, _build_error
    with _lock:
        if _lib is None and _build_error is None:
            path = library_path()
            if not path.is_file():
                _build_error = _build(path)
            if _build_error is None:
                try:
                    _lib = _bind(ctypes.CDLL(str(path)))
                except (OSError, AttributeError) as e:
                    _build_error = f"{path} does not load: {e}"
        return _lib


def native_available() -> bool:
    return load_library() is not None


def build_error() -> Optional[str]:
    """Why the library could not be built, or None."""
    load_library()
    return _build_error


def _library() -> ctypes.CDLL:
    lib = load_library()
    if lib is None:
        raise RuntimeError(f"the native ray sampler could not be built "
                           f"({SOURCE}): {_build_error}")
    return lib


def _checked(images: np.ndarray, poses: Optional[np.ndarray],
             focals: Optional[np.ndarray]):
    """``images`` (N, V, H, W, 3) uint8, ``poses`` (N, V, 4, 4) and
    ``focals`` (N,) f32, all C-contiguous: the C side reads them by these
    shapes and checks nothing of them."""
    if images.ndim != 5 or images.shape[4] != 3 or images.dtype != np.uint8:
        raise ValueError(f"images must be (N, V, H, W, 3) uint8, got "
                         f"{images.shape} {images.dtype}")
    N, V, H, W = images.shape[:4]
    if poses is not None and (poses.shape != (N, V, 4, 4)
                              or poses.dtype != np.float32):
        raise ValueError(f"poses must be {(N, V, 4, 4)} float32, got "
                         f"{poses.shape} {poses.dtype}")
    if focals is not None and (focals.shape != (N,)
                               or focals.dtype != np.float32):
        raise ValueError(f"focals must be ({N},) float32, got "
                         f"{focals.shape} {focals.dtype}")
    return N, V, H, W


def _threads(n_threads: int) -> int:
    return n_threads if n_threads > 0 else min(8, os.cpu_count() or 1)


def sample_batch(
    images: np.ndarray, poses: np.ndarray, focals: np.ndarray,
    batch: int, seed: int, step: int,
    v0: int, v1: int, u0: int, u1: int,
    n_threads: int = 0,
) -> Dict[str, np.ndarray]:
    """``RayBatchPipeline.sample``'s expanded layout from the native
    stream of ``(seed, step)``: ``obj`` (B,) int32, ``uv`` (B, 2), ``c2w``
    (B, 3, 4), ``focal`` (B,), ``rgb`` (B, 3) float32, pixels in
    [v0, v1) × [u0, u1). ``n_threads`` 0: the smaller of 8 and the CPU
    count. Raises ``RuntimeError`` with the library's error code."""
    lib = _library()
    images = np.ascontiguousarray(images)
    poses, focals = np.ascontiguousarray(poses), np.ascontiguousarray(focals)
    N, V, H, W = _checked(images, poses, focals)
    out = {
        "obj": np.empty(batch, np.int32),
        "uv": np.empty((batch, 2), np.float32),
        "c2w": np.empty((batch, 3, 4), np.float32),
        "focal": np.empty(batch, np.float32),
        "rgb": np.empty((batch, 3), np.float32),
    }
    rc = lib.cn_sample_batch(
        images, poses, focals, N, V, H, W, batch, seed & _MASK64,
        step & _MASK64, v0, v1, u0, u1, out["obj"], out["uv"], out["c2w"],
        out["focal"], out["rgb"], _threads(n_threads))
    if rc != 0:
        raise RuntimeError(f"cn_sample_batch failed with code {rc}")
    return out


def sample_batch_compact(
    images: np.ndarray, poses: np.ndarray, focals: np.ndarray,
    batch: int, seed: int, step: int,
    v0: int, v1: int, u0: int, u1: int,
    n_threads: int = 0,
) -> Dict[str, np.ndarray]:
    """The compact (index) layout of the same picks as
    :func:`sample_batch` for the same ``(seed, step)``: ``obj``, ``view``
    (B,) int32, ``uv`` (B, 2) int16, ``rgb`` (B, 3) uint8. ``poses`` and
    ``focals`` are unused (the step gathers them from device tables) and
    kept so both layouts share a call shape."""
    del poses, focals
    lib = _library()
    images = np.ascontiguousarray(images)
    N, V, H, W = _checked(images, None, None)
    out = {
        "obj": np.empty(batch, np.int32),
        "view": np.empty(batch, np.int32),
        "uv": np.empty((batch, 2), np.int16),
        "rgb": np.empty((batch, 3), np.uint8),
    }
    rc = lib.cn_sample_batch_compact(
        images, N, V, H, W, batch, seed & _MASK64, step & _MASK64,
        v0, v1, u0, u1, out["obj"], out["view"], out["uv"], out["rgb"],
        _threads(n_threads))
    if rc != 0:
        raise RuntimeError(f"cn_sample_batch_compact failed with code {rc}")
    return out


def rays_of_view(
    images: np.ndarray, poses: np.ndarray, focals: np.ndarray,
    obj: int, view: int, v0: int, v1: int, u0: int, u1: int,
) -> Dict[str, np.ndarray]:
    """Every pixel of (``obj``, ``view``) in [v0, v1) × [u0, u1),
    row-major, in the expanded layout (the eval layout)."""
    lib = _library()
    images = np.ascontiguousarray(images)
    poses, focals = np.ascontiguousarray(poses), np.ascontiguousarray(focals)
    N, V, H, W = _checked(images, poses, focals)
    n = max(0, v1 - v0) * max(0, u1 - u0)
    out = {
        "obj": np.empty(n, np.int32),
        "uv": np.empty((n, 2), np.float32),
        "c2w": np.empty((n, 3, 4), np.float32),
        "focal": np.empty(n, np.float32),
        "rgb": np.empty((n, 3), np.float32),
    }
    rc = lib.cn_rays_of_view(
        images, poses, focals, N, V, H, W, obj, view, v0, v1, u0, u1,
        out["obj"], out["uv"], out["c2w"], out["focal"], out["rgb"])
    if rc != 0:
        raise RuntimeError(f"cn_rays_of_view failed with code {rc}")
    return out
