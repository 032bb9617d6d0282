"""The harness is driven by data: a configuration, a traffic mix and a
per-layer metric added as new files and manifest entries are found by the
validator and the loader with no edit to an existing file; the validator
refuses what the benchmark's contract refuses."""

import copy
import json
import os
import shutil

import pytest

from portbench.harness import manifest


@pytest.fixture
def tree(tmp_path):
    """A copy of the benchmark: ``BENCHMARK.json`` and ``portbench/``."""
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(manifest.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def _digest(root) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_shipped_manifest_is_valid():
    manifest.validate(manifest.load())


def test_new_cell_as_files(tree):
    before = _digest(tree / "portbench")
    man = manifest.load(tree / "BENCHMARK.json")
    cfg = json.loads((tree / "portbench/configs/car_fused.json").read_text())
    cfg["hparams"]["N_samples"] = 64
    (tree / "portbench/configs/car_fused64.json").write_text(json.dumps(cfg))
    tf = json.loads((tree / "portbench/traffic/car_fused.train.json")
                    .read_text())
    tf["batch_rays"] = 8192
    (tree / "portbench/traffic/car_fused64.train.json").write_text(
        json.dumps(tf))
    (tree / "portbench/metrics/pipeline.wait_ms.train.py").write_text(
        "def read(r):\n    return 1.5\n")
    man["configs"].append({"name": "car_fused64", "source": "https://x.y/z",
                           "file": "portbench/configs/car_fused64.json",
                           "reduced": ["N_samples"], "why": "fewer samples"})
    man["workloads"].append({"name": "car_fused64.train",
                             "config": "car_fused64", "traffic": "train",
                             "chips": 1, "why": "a test cell"})
    for m in man["end_to_end"]:
        if m["name"] == "train_rays_per_s":
            m["workloads"].append("car_fused64.train")
    man["per_layer"].append({
        "name": "pipeline.wait_ms.train", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "host data", "moves":
        "train_rays_per_s", "workloads": ["car_fused64.train"]})
    manifest.validate(man, root=str(tree))
    w, config, traffic = manifest.cell_files(man, "car_fused64.train",
                                             root=str(tree))
    assert config["hparams"]["N_samples"] == 64
    assert traffic["batch_rays"] == 8192 and traffic["kind"] == "train"
    names = [m["name"] for m in manifest.metrics_of(man, "car_fused64.train",
                                                    trace=True)]
    assert names == ["pipeline.wait_ms.train"]
    assert manifest.load_reader("pipeline.wait_ms.train",
                                root=str(tree))({}) == 1.5
    after = _digest(tree / "portbench")
    assert all(after[k] == v for k, v in before.items()), \
        "an existing file changed"


def _refused(tree, edit, match):
    man = copy.deepcopy(manifest.load(tree / "BENCHMARK.json"))
    edit(man)
    with pytest.raises(manifest.ManifestError, match=match):
        manifest.validate(man, root=str(tree))


@pytest.mark.parametrize("edit, match", [
    (lambda m: m["workloads"][0].update(name="car fused"), "not a valid name"),
    (lambda m: m["workloads"][0].update(name="a/b"), "not a valid name"),
    (lambda m: m["end_to_end"][0].update(unit="rays per second"), "unit"),
    (lambda m: m["end_to_end"][0].update(unit="r" * 17), "unit"),
    (lambda m: m["per_layer"][0].update(why="x"), "not allowed"),
    (lambda m: m["end_to_end"][0].update(bound=0.3), "bound"),
    (lambda m: m["configs"][0].update(reduced=["latent_dim"]), "width"),
    (lambda m: m["per_layer"][0].update(workloads=["car_fused.serve"]),
     "lacks"),
    (lambda m: m["per_layer"][0].update(moves="render_per_s"), "lacks"),
    (lambda m: m["per_layer"][0].update(moves="render_p50_ms"), "unknown"),
    (lambda m: m.update(run_seconds=52), "run_seconds"),
    (lambda m: m["workloads"][0].update(chips=2), "chips"),
])
def test_refusals(tree, edit, match):
    _refused(tree, edit, match)
