"""One run of one cell: the kind module its traffic names, then the result line
the benchmark prints, built from the manifest's metrics for the cell."""

from __future__ import annotations

import importlib
import shutil
import subprocess
import sys
import tempfile
from typing import Optional, Tuple

import torch

from portbench.harness import manifest
from portbench.harness.cell import Context, Outcome

FORBIDDEN = ("jax", "jaxlib", "flax", "codenerf_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def run_cell(man: dict, cell: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float,
             config: Optional[dict] = None,
             traffic: Optional[dict] = None) -> Tuple[dict, Outcome]:
    """Run ``cell`` and return ``(result, outcome)``. ``config`` and
    ``traffic`` replace the cell's files (the tests' small sizes)."""
    w, conf, tf = manifest.cell_files(man, cell)
    conf = config if config is not None else conf
    tf = traffic if traffic is not None else tf
    kind = importlib.import_module(f"portbench.kinds.{tf['kind']}")
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        ctx = Context(cell=cell, config=conf, traffic=tf, seed=seed,
                      seconds=seconds, trace=trace, device=device,
                      t_start=t_start, workdir=workdir)
        out = kind.run(ctx)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return result(man, cell, w, trace, device, out), out


def result(man: dict, cell: str, w: dict, trace: bool,
           device: torch.device, out: Outcome) -> dict:
    metrics = {}
    wanted = manifest.metrics_of(man, cell, trace)
    if trace:
        for m in wanted:
            v = manifest.load_reader(m["name"])(out.readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(out.e2e, setup_s=out.setup_s)
        for m in wanted:
            if m["name"] not in values:
                raise RuntimeError(f"the {cell} run measured no "
                                   f"{m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": w["chips"],
           "memory_peak_bytes": out.memory_peak_bytes}
    if cuda:
        dev["power_limit"] = _power_limit()
    res = {"correct": all(c.ok for c in out.checks) and out.failed == 0,
           "attempted": out.attempted, "failed": out.failed,
           "metrics": metrics, "device": dev}
    summary = out.readings.get("trace")
    if trace and summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        res["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    res["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in out.checks}
    return res
