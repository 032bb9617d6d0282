"""The kind modules call what the program's own entries call: N steps of the
training adapter leave the parameters, code tables and AdamW moments that
``Trainer.training`` leaves over the same steps, bit for bit. A change to
the Trainer's internals then fails here rather than measuring something
else."""

import tempfile
import time

import torch

from portbench.kinds import train
from portbench.harness.cell import Context
from portbench.harness.scene import make_scene
from portbench.harness.weights import make_weights
from portbench.tests.small import small


def _ctx(cell, config, traffic, work, seed=11):
    return Context(cell, config, traffic, seed, 0.0, False,
                   torch.device("cpu"), time.perf_counter(), work)


def _state(tr):
    st = tr.state
    out = {f"p.{n}": p.detach().clone()
           for n, p in st.model.named_parameters()}
    out.update(sc=st.shape_codes.detach().clone(),
               tc=st.texture_codes.detach().clone())
    for i, p in enumerate(st.optimizer.param_groups[0]["params"]
                          + st.optimizer.param_groups[1]["params"]):
        for k, v in st.optimizer.state[p].items():
            out[f"m{i}.{k}"] = v.clone()
    return out


def test_training_adapter_matches_trainer():
    config, traffic = small("car_fused.train", iters_crop=3, log_every=2)
    steps = 5   # across the crop -> full switch
    with tempfile.TemporaryDirectory() as work:
        ctx = _ctx("car_fused.train", config, traffic, work)
        scene = make_scene(config["scene"], ctx.sub_seed(0), ctx.device)
        init = make_weights(config["hparams"]["net_hyperparams"],
                            config["scene"]["n_objects"], ctx.sub_seed(1),
                            ctx.device)
        ours = train.build_trainer(ctx, scene, init)
        loop = train.TrainLoop(ours, traffic["iters_crop"],
                               traffic["log_every"])
        try:
            for _ in range(steps):
                loop.step()
        finally:
            loop.close()
        theirs = train.build_trainer(ctx, scene, init)
        theirs.training(traffic["iters_crop"], steps,
                        log_every=traffic["log_every"])
        a, b = _state(ours), _state(theirs)
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
        assert ours.state.step == theirs.state.step == steps
