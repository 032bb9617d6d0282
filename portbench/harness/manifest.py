"""``BENCHMARK.json``: loading, checking, and finding each cell's files.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by the name the manifest gives:

- a configuration: the ``file`` its entry names (``portbench/configs/``);
- a cell's traffic mix: ``portbench/traffic/<cell>.json``, whose ``kind``
  names the module ``portbench/kinds/<kind>.py`` that runs it;
- a per-layer metric: ``portbench/metrics/<metric>.py``, whose ``read``
  takes the run's readings and returns the number or None.

So a later change adds a cell or a metric by adding files and manifest
entries, and edits none of these modules. :func:`validate` refuses a
manifest that breaks the benchmark's contract before any run.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "portbench")

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTHS = re.compile(r"(_dim$|_rank$|^W$|hidden_size|intermediate_size|"
                    r"state_size|proj|head_size|latent|expan|"
                    r"experts_per_tok)", re.I)


class ManifestError(ValueError):
    pass


def load(path: Optional[str] = None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s, what: str, limit: int = 200) -> None:
    if not isinstance(s, str) or not 1 <= len(s) <= limit or "\n" in s \
            or "\t" in s:
        raise ManifestError(f"{what}: 1 to {limit} characters on one line")


def _name(s, what: str) -> None:
    if not isinstance(s, str) or not NAME.match(s):
        raise ManifestError(f"{what} {s!r}: not a valid name")


def _keys(entry: dict, want: set, what: str, optional=()) -> None:
    extra = set(entry) - want - set(optional)
    missing = want - set(entry)
    if extra or missing:
        raise ManifestError(f"{what}: keys {sorted(extra)} not allowed, "
                            f"{sorted(missing)} missing")


def _metric(m: dict, keys: set, what: str, cells: Dict[str, dict]) -> None:
    _keys(m, keys, what, optional=("workloads",))
    _name(m["name"], what)
    if not isinstance(m["unit"], str) or not UNIT.match(m["unit"]):
        raise ManifestError(f"{what}: unit {m['unit']!r} not 1-16 of "
                            "letters, digits, _ / % . -")
    if m["better"] not in ("lower", "higher"):
        raise ManifestError(f"{what}: better must be lower or higher")
    if m["source"] not in SOURCES:
        raise ManifestError(f"{what}: unknown source {m['source']!r}")
    for c in m.get("workloads", []):
        if c not in cells:
            raise ManifestError(f"{what}: unknown workload {c!r}")


def cells_of(metric: dict, cells: Dict[str, dict]) -> List[str]:
    """The cells that report ``metric``: its ``workloads``, else all."""
    return list(metric.get("workloads", cells))


def validate(man: dict, root: str = ROOT) -> None:
    """Raise :class:`ManifestError` where ``man`` breaks the contract or a
    file it names is missing under ``root``."""
    if set(man) != TOP_KEYS:
        raise ManifestError(f"top-level keys must be {sorted(TOP_KEYS)}")
    cmd = man["command"]
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32):
        raise ManifestError("command: a list of 1 to 32 strings")
    for w in cmd:
        _line(w, "command word")
        if w.startswith("/") or ".." in w.split("/"):
            raise ManifestError(f"command word {w!r} leaves the checkout")
    paths = man["paths"]
    if not (isinstance(paths, list) and 1 <= len(paths) <= 16):
        raise ManifestError("paths: 1 to 16 directories")
    for p in paths:
        if not PATH.match(p) or p.startswith("/") or ".." in p.split("/"):
            raise ManifestError(f"path {p!r} is not a plain relative path")
    rs = man["run_seconds"]
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        raise ManifestError("run_seconds: a whole number from 1 to 51")

    def under_paths(f: str) -> bool:
        return any(f == p or f.startswith(p.rstrip("/") + "/") for p in paths)

    configs = {}
    for c in man["configs"]:
        _keys(c, CONFIG_KEYS, "config")
        _name(c["name"], "config")
        _line(c["source"], f"config {c['name']} source")
        _line(c["why"], f"config {c['name']} why")
        if c["name"] in configs:
            raise ManifestError(f"config {c['name']} twice")
        if not under_paths(c["file"]) or \
                not os.path.isfile(os.path.join(root, c["file"])):
            raise ManifestError(f"config {c['name']}: file {c['file']!r} "
                                "missing or outside paths")
        if any(x["file"] == c["file"] for x in configs.values()):
            raise ManifestError(f"config {c['name']}: file shared")
        if not isinstance(c["reduced"], list) or len(c["reduced"]) > 16:
            raise ManifestError(f"config {c['name']}: reduced, 0-16 keys")
        for k in c["reduced"]:
            _name(k, f"config {c['name']} reduced key")
            if WIDTHS.search(k):
                raise ManifestError(f"config {c['name']}: {k} is a width")
        configs[c["name"]] = c
    if not 1 <= len(configs) <= 24:
        raise ManifestError("configs: 1 to 24")

    cells: Dict[str, dict] = {}
    pairs = set()
    for w in man["workloads"]:
        _keys(w, CELL_KEYS, "workload")
        _name(w["name"], "workload")
        _name(w["traffic"], f"workload {w['name']} traffic")
        _line(w["why"], f"workload {w['name']} why")
        if w["name"] in cells:
            raise ManifestError(f"workload {w['name']} twice")
        if w["config"] not in configs:
            raise ManifestError(f"workload {w['name']}: unknown config")
        if w["chips"] not in (1, 4):
            raise ManifestError(f"workload {w['name']}: chips 1 or 4")
        if (w["config"], w["traffic"]) in pairs:
            raise ManifestError(f"workload {w['name']}: pair repeated")
        pairs.add((w["config"], w["traffic"]))
        traffic = traffic_path(w["name"], root)
        if not os.path.isfile(traffic):
            raise ManifestError(f"workload {w['name']}: no {traffic}")
        with open(traffic) as f:
            kind = json.load(f).get("kind")
        if not isinstance(kind, str) or not NAME.match(kind) or \
                not os.path.isfile(os.path.join(root, "portbench", "kinds",
                                                f"{kind}.py")):
            raise ManifestError(f"workload {w['name']}: no kind module "
                                f"{kind!r}")
        cells[w["name"]] = w
    if not 1 <= len(cells) <= 24:
        raise ManifestError("workloads: 1 to 24")
    four = sum(w["chips"] == 4 for w in cells.values())
    if four > max(1, len(cells) // 4):
        raise ManifestError("too many four-chip cells")
    used = {w["config"] for w in cells.values()}
    if used != set(configs):
        raise ManifestError(f"configs used by no cell: "
                            f"{sorted(set(configs) - used)}")

    names = set()
    e2e = {}
    for m in man["end_to_end"]:
        _metric(m, E2E_KEYS, "end-to-end metric", cells)
        if m["source"] not in ("host_clock", "device_trace"):
            raise ManifestError(f"{m['name']}: an end-to-end metric comes "
                                "from host_clock or device_trace")
        b = m["bound"]
        if not isinstance(b, (int, float)) or not 0.01 <= b <= 0.25:
            raise ManifestError(f"{m['name']}: bound between 0.01 and 0.25")
        e2e[m["name"]] = m
    if "setup_s" not in e2e or "workloads" in e2e["setup_s"]:
        raise ManifestError("setup_s is an end-to-end metric of every cell")
    if not 1 <= len(e2e) <= 16:
        raise ManifestError("end_to_end: 1 to 16 metrics")
    layer = {}
    for m in man["per_layer"]:
        _metric(m, LAYER_KEYS, "per-layer metric", cells)
        _line(m["layer"], f"{m['name']} layer")
        if m["moves"] not in e2e:
            raise ManifestError(f"{m['name']}: moves unknown metric "
                                f"{m['moves']!r}")
        reporting = cells_of(e2e[m["moves"]], cells)
        for c in cells_of(m, cells):
            if c not in reporting:
                raise ManifestError(
                    f"{m['name']}: reported in {c}, which lacks "
                    f"{m['moves']}, the metric it moves")
        if not os.path.isfile(metric_path(m["name"], root)):
            raise ManifestError(f"{m['name']}: no reader "
                                f"{metric_path(m['name'], root)}")
        layer[m["name"]] = m
    if not 1 <= len(layer) <= 128:
        raise ManifestError("per_layer: 1 to 128 metrics")
    for n in list(e2e) + list(layer):
        if n in names:
            raise ManifestError(f"metric {n} twice")
        names.add(n)
    for c in cells:
        mine = [n for n, m in e2e.items() if c in cells_of(m, cells)]
        if len(mine) < 2:
            raise ManifestError(f"{c}: reports setup_s and no other "
                                "end-to-end metric")
        if not any(c in cells_of(m, cells) for m in layer.values()):
            raise ManifestError(f"{c}: reports no per-layer metric")
    if len(json.dumps(man, indent=2)) > 64 * 1024:
        raise ManifestError("manifest over 64 KiB")


def traffic_path(cell: str, root: str = ROOT) -> str:
    return os.path.join(root, "portbench", "traffic", f"{cell}.json")


def metric_path(metric: str, root: str = ROOT) -> str:
    return os.path.join(root, "portbench", "metrics", f"{metric}.py")


def cell_files(man: dict, cell: str, root: str = ROOT):
    """``(workload entry, config, traffic)`` of ``cell``, read from their
    files."""
    cells = {w["name"]: w for w in man["workloads"]}
    if cell not in cells:
        raise ManifestError(f"unknown workload {cell!r}; the manifest has "
                            f"{sorted(cells)}")
    w = cells[cell]
    conf = next(c for c in man["configs"] if c["name"] == w["config"])
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(traffic_path(cell, root)) as f:
        traffic = json.load(f)
    return w, config, traffic


def metrics_of(man: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: end-to-end without the
    trace, per-layer with it."""
    cells = {w["name"]: w for w in man["workloads"]}
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group if cell in cells_of(m, cells)]


def load_reader(metric: str, root: str = ROOT):
    """The ``read`` function of ``portbench/metrics/<metric>.py``."""
    path = metric_path(metric, root)
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
