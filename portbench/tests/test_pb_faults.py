"""A run of each cell, its chip look skipped, with the timed path broken
underneath: ``correct`` must come out false for each fault the cell can
have (a step that leaves its state unchanged; half the batch left out,
the mean taken over the rest; an answer altered where it is produced).
The cells have no exchange between chips. The sound run beside them
comes out true at the same small size."""

import importlib
import tempfile
import time

import pytest
import torch

from codenerf_tpu_torch.ops import fused_train
from codenerf_tpu_torch.training import train_step
from portbench.harness.cell import Context
from portbench.tests.small import small


def _run(cell, seed=123456789012, **traffic):
    """A short run of ``cell`` at the small size, through its kind
    module (the cells ready to add run as the manifest's do); returns
    ``{"correct", "checks"}`` as the result line has them."""
    config, tf = small(cell, **traffic)
    kind = importlib.import_module(f"portbench.kinds.{tf['kind']}")
    with tempfile.TemporaryDirectory() as work:
        out = kind.run(Context(cell, config, tf, seed, 0.5, False,
                               torch.device("cpu"), time.perf_counter(),
                               work))
    return {"correct": all(c.ok for c in out.checks) and out.failed == 0,
            "checks": {c.name: c.value for c in out.checks}}


def _frozen_state(monkeypatch):
    def apply_update(state, hp):
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
    monkeypatch.setattr(train_step, "apply_update", apply_update)


def _half_batch(monkeypatch):
    expand = train_step.expand_compact_batch

    def half(batch, tables):
        n = batch["obj"].shape[0] // 2
        return expand({k: v[:n] for k, v in batch.items()}, tables)
    monkeypatch.setattr(train_step, "expand_compact_batch", half)


def _loss_altered(monkeypatch):
    apply = fused_train.FusedTrainLoss.apply

    def altered(*args):
        loss, fine = apply(*args)
        return loss * 1.01, fine
    monkeypatch.setattr(fused_train.FusedTrainLoss, "apply", altered)


def test_training_sound():
    res = _run("car_fused.train")
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", [_frozen_state, _half_batch,
                                   _loss_altered])
def test_training_faults(monkeypatch, fault):
    fault(monkeypatch)
    res = _run("car_fused.train")
    assert not res["correct"], res["checks"]


def _render_half(monkeypatch):
    from codenerf_tpu_torch import renderer
    render = renderer.render_image

    def half(*args, **kw):
        img = render(*args, **kw).clone()
        img[img.shape[0] // 2:] = 1.0      # those rays never rendered
        return img
    monkeypatch.setattr(renderer, "render_image", half)


def _render_shifted(monkeypatch):
    from codenerf_tpu_torch import renderer
    render = renderer.render_image

    def shifted(*args, **kw):
        return torch.roll(render(*args, **kw), 1, dims=0)
    monkeypatch.setattr(renderer, "render_image", shifted)


def test_serving_sound():
    res = _run("car_fused.serve")
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", [_render_half, _render_shifted])
def test_serving_faults(monkeypatch, fault):
    fault(monkeypatch)
    res = _run("car_fused.serve")
    assert not res["correct"], res["checks"]
