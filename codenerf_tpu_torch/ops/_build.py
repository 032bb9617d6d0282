"""Build and load the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` has a plain C interface. It is compiled at
first use with ``nvcc`` (``sm_90a``) into a shared library under
``build/torch_kernels/`` at the root of the checkout — named by a hash of
the source and the flags, so an edited source is rebuilt — and loaded with
``ctypes``. Nothing is prebuilt and nothing is compiled at import time.

``counters`` says what a process paid for that: the sources ``built``
and the seconds their ``nvcc`` runs took (``build_s``), the libraries
``loaded`` and the seconds ``ctypes`` took (``load_s``). While a
profiler records, the two are the spans ``kernels.build`` and
``kernels.load``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

from codenerf_tpu_torch.utils.tracing import span

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
counters = {"built": 0, "build_s": 0.0, "loaded": 0, "load_s": 0.0}


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from ops/csrc at first use")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names: Iterable[str]) -> List[Path]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` per source, all started together. The compiler's resource
    report (``-Xptxas -v``) is kept beside each library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    names = list(names)
    stale = [n for n in names if not library_path(n).exists()]
    failed = []
    if stale:
        t0 = time.perf_counter()
        with span("kernels.build"):
            failed = _compile(stale)
        counters["built"] += len(stale)
        counters["build_s"] += time.perf_counter() - t0
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return [library_path(n) for n in names]


def _compile(names: List[str]) -> List[str]:
    """Run ``nvcc`` on each named source at once; the failures' logs."""
    jobs = []
    for name in names:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    return failed


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``ops/csrc/<name>.cu``, built if needed."""
    with _LOCK:
        if name not in _LIBS:
            (path,) = build_all([name])
            t0 = time.perf_counter()
            with span("kernels.load"):
                _LIBS[name] = ctypes.CDLL(str(path))
            counters["loaded"] += 1
            counters["load_s"] += time.perf_counter() - t0
        return _LIBS[name]


def all_sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))
