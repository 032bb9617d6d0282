"""Small sizes of the benchmark's cells for the CPU tests: the published
layer kinds at W = 256 (the fused route's least width), one block each,
a few objects and rays."""

import json
import os

from portbench.harness import manifest

NET = {"shape_blocks": 1, "texture_blocks": 1, "W": 256, "num_xyz_freq": 10,
       "num_dir_freq": 4, "latent_dim": 32}
SCENE = {"n_objects": 6, "n_views": 3, "H": 16, "W": 16, "focal": 16.4,
         "cam_radius": 1.3}


def small(cell: str, **traffic):
    """``(config, traffic)`` of ``cell`` cut to the CPU tests' size."""
    with open(os.path.join(manifest.BENCH, "configs",
                           cell.split(".")[0] + ".json")) as f:
        config = json.load(f)
    with open(manifest.traffic_path(cell)) as f:
        tf = json.load(f)
    config["hparams"]["net_hyperparams"] = dict(NET)
    config["hparams"]["N_samples"] = min(config["hparams"]["N_samples"], 8)
    config["scene"] = dict(SCENE)
    if tf["kind"] == "train":
        tf.update(batch_rays=64, trace_steps=3, log_every=2)
    if tf["kind"] == "serve":
        tf.update(H=16, W=16, clients=2, requests=64, warmup_requests=2,
                  trace_requests=3, check_requests=4)
    tf.update(traffic)
    return config, tf
