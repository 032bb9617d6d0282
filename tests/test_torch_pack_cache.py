"""The trunk kernels' operand cache (``fused_train.trunk_operands``) on the
CPU, at small widths: a hit on unchanged parameters returns the same
record and rebuilds nothing; every way the port or a user changes the
weights — the port's ``apply_update``, ``AdamW`` in its default,
``foreach`` and ``fused`` forms (the last through the explicit drop: its
step leaves the parameters' versions as they were), ``load_state_dict``
and a checkpoint restore, ``p.data = ...`` and an in-place edit under
``torch.no_grad()`` — makes the next call rebuild, and an in-place write
through ``.data``, which the key cannot see, after the explicit drop; a
CUDA call refuses a weight list (it never packs for itself); the cached
operands are
``kernel_operands(flatten_params(...))`` bit for bit (on the CPU the
cache holds no packed buffer: the plain versions never read one; the CUDA
packer is held against ``pack_trunk_weights_plain`` on the card by
``chip_smoke.py``); and training, fitting and the plane op give the same
bits with the cache as with operands built fresh for every call.
Everything here is exact: the cache moves no arithmetic."""

import os

import numpy as np
import pytest
import torch

from codenerf_tpu_torch.config import NetConfig, hparams_from_dict
from codenerf_tpu_torch.models.codenerf import CodeNeRF
from codenerf_tpu_torch.ops import fused_mlp, fused_train
from codenerf_tpu_torch.training import train_step
from codenerf_tpu_torch.training.state import create_train_state
from codenerf_tpu_torch.utils import checkpoint

torch.set_num_threads(2)     # W=256 on the CPU: keep xdist workers apart

CFG = NetConfig(W=128, shape_blocks=2, texture_blocks=1, num_xyz_freq=4,
                num_dir_freq=2, latent_dim=16)


def _model(seed=0, cfg=CFG):
    return CodeNeRF(cfg, generator=torch.Generator().manual_seed(seed))


def _bits(x: torch.Tensor) -> np.ndarray:
    x = x.detach().contiguous()
    return x.view(torch.int16 if x.dtype == torch.bfloat16
                  else torch.int32).numpy()


def _assert_fresh(trunk, model, cfg=CFG):
    """The record holds ``kernel_operands(flatten_params(model))``, bit for
    bit, 16-byte aligned and outside autograd; no packed buffer on the
    CPU."""
    want = fused_train.kernel_operands(fused_train.flatten_params(model, cfg))
    assert len(trunk.wops) == len(want)
    for got, w in zip(trunk.wops, want):
        assert got.dtype == w.dtype and got.shape == w.shape
        assert not got.requires_grad and got.data_ptr() % 16 == 0
        np.testing.assert_array_equal(_bits(got), _bits(w))
    assert trunk.packed is None


def test_hit_returns_the_same_record():
    model = _model()
    first = fused_train.trunk_operands(model, CFG)
    builds = fused_train.trunk_operands.builds
    for _ in range(3):
        assert fused_train.trunk_operands(model, CFG) is first
    assert fused_train.trunk_operands.builds == builds
    _assert_fresh(first, model)
    # The plain packing of the cached operands is that of fresh ones.
    np.testing.assert_array_equal(
        _bits(fused_train.pack_trunk_weights_plain(CFG, first.wops)),
        _bits(fused_train.pack_trunk_weights_plain(
            CFG, fused_train.kernel_operands(
                fused_train.flatten_params(model, CFG)))))


def test_networks_and_configs_keep_their_own_entries():
    """Two networks (a separate fine network's) each have their entry; a
    second config for the same module misses, and dropping one network's
    entry leaves the other's."""
    coarse, fine = _model(0), _model(1)
    a = fused_train.trunk_operands(coarse, CFG)
    b = fused_train.trunk_operands(fine, CFG)
    assert a is not b
    _assert_fresh(b, fine)
    fused_train.drop_trunk_operands(fine)
    assert fused_train.trunk_operands(coarse, CFG) is a
    assert fused_train.trunk_operands(fine, CFG) is not b
    other = NetConfig(**{**CFG.__dict__, "num_xyz_freq": 3})
    assert fused_train.trunk_operands(coarse, other) is not a


def _hp(**extra):
    return hparams_from_dict({
        "net_hyperparams": {"W": 256, "shape_blocks": 1, "texture_blocks": 1,
                            "num_xyz_freq": 4, "num_dir_freq": 2,
                            "latent_dim": 16},
        "N_samples": 8, "near": 0.8, "far": 1.8, "use_fused_train": True,
        **extra})


def _adamw(**kw):
    def change(state, hp, tmp):
        params = list(state.model.parameters())
        opt = torch.optim.AdamW(params, lr=1e-2, **kw)
        for p in params:
            p.grad = torch.randn_like(p)
        opt.step()
        if kw.get("fused"):
            fused_train.drop_trunk_operands(state.model)
    return change


def _apply_update(state, hp, tmp):
    for p in state.model.parameters():
        p.grad = torch.randn_like(p)
    train_step.apply_update(state, hp)


def _load_state_dict(state, hp, tmp):
    state.model.load_state_dict(_model(7, hp.net).state_dict())


def _restore(state, hp, tmp):
    other = create_train_state(_hp(seed=1), 2, device="cpu")
    checkpoint.save_checkpoint(tmp, other)
    checkpoint.restore_checkpoint(tmp, state)


def _assign_data(state, hp, tmp):
    w = state.model.enc_shape.weight
    w.data = torch.randn_like(w)


def _in_place(state, hp, tmp):
    with torch.no_grad():
        state.model.shape_0.bias.add_(0.25)


CHANGES = {
    "apply_update": _apply_update,
    "adamw_default": _adamw(),
    "adamw_foreach": _adamw(foreach=True),
    "adamw_fused": _adamw(fused=True),
    "load_state_dict": _load_state_dict,
    "checkpoint_restore": _restore,
    "data_assign": _assign_data,
    "no_grad_in_place": _in_place,
}


@pytest.mark.parametrize("change", list(CHANGES))
def test_a_weight_change_rebuilds(change, tmp_path):
    """After the change the next call builds once, a new record equal to
    fresh operands of the changed weights, and then hits again."""
    hp = _hp()
    state = create_train_state(hp, 2, device="cpu")
    before = fused_train.trunk_operands(state.model, hp.net)
    old = [w.clone() for w in before.wops]
    CHANGES[change](state, hp, os.fspath(tmp_path))
    builds = fused_train.trunk_operands.builds
    after = fused_train.trunk_operands(state.model, hp.net)
    assert after is not before
    assert fused_train.trunk_operands.builds == builds + 1
    _assert_fresh(after, state.model, hp.net)
    assert any(not torch.equal(a, b) for a, b in zip(after.wops, old))
    assert fused_train.trunk_operands(state.model, hp.net) is after
    assert fused_train.trunk_operands.builds == builds + 1


def test_data_in_place_write_needs_the_drop():
    """``p.data.mul_(...)`` keeps the address and bumps no version the key
    reads (``.data`` has a counter of its own): the cache still returns
    the old record, whose operands are now stale, until
    ``drop_trunk_operands`` — then it rebuilds from the new weights."""
    model = _model(2)
    before = fused_train.trunk_operands(model, CFG)
    old = [w.clone() for w in before.wops]
    w = model.enc_shape.weight
    ptr, version = w.data_ptr(), w._version
    w.data.mul_(2.0)
    assert (w.data_ptr(), w._version) == (ptr, version)
    assert fused_train.trunk_operands(model, CFG) is before
    assert all(torch.equal(a, b) for a, b in zip(before.wops, old))
    fused_train.drop_trunk_operands(model)
    after = fused_train.trunk_operands(model, CFG)
    assert after is not before
    _assert_fresh(after, model)
    assert any(not torch.equal(a, b) for a, b in zip(after.wops, old))


def test_fresh_operands_and_the_cuda_weights_check():
    """``fresh_trunk_operands`` builds what the cache holds, bit for bit,
    and caches nothing; the CUDA calls' weight check refuses a weight list
    (the kernels read only a TrunkOperands' packed buffer) and the plain
    versions read a TrunkOperands' own operands."""
    model = _model(4)
    wflat = fused_train.flatten_params(model, CFG)
    builds = fused_train.trunk_operands.builds
    fresh = fused_train.fresh_trunk_operands(CFG, wflat)
    assert fused_train.trunk_operands.builds == builds
    _assert_fresh(fresh, model)
    assert fused_train.kernel_operands(fresh) is fresh.wops
    with pytest.raises(TypeError, match="TrunkOperands"):
        fused_train._cuda_trunk(CFG, wflat, torch.device("cpu"))


def _batch(R, n_objects, seed):
    rng = np.random.default_rng(seed)
    c2w = np.tile(np.eye(4, dtype=np.float32)[:3], (R, 1, 1))
    c2w[:, 2, 3] = 1.3
    c2w[:, :, :3] *= np.array([1.0, -1.0, -1.0], np.float32)
    return {"obj": torch.from_numpy(rng.integers(0, n_objects, R)),
            "uv": torch.from_numpy(rng.uniform(0, 16, (R, 2)).astype(
                np.float32)),
            "c2w": torch.from_numpy(c2w),
            "focal": torch.full((R,), 20.0),
            "rgb": torch.from_numpy(rng.uniform(size=(R, 3)).astype(
                np.float32))}


def _two_steps(hp, fresh: bool, monkeypatch):
    """Two training steps of the hierarchical single-pass route (whose
    sigma-only pass reads the cached operands) from a seeded state;
    ``fresh`` rebuilds the operands at every read. Returns the losses, the
    builds and the final weights."""
    if fresh:       # every read misses
        monkeypatch.setattr(fused_train, "_key_holds", lambda key, m: False)
    state = create_train_state(hp, 2, device="cpu")
    grad_fn = train_step.build_grad_fn(hp, 16, 16, batch_size=32)
    losses, builds = [], fused_train.trunk_operands.builds
    for step in range(2):
        state.optimizer.zero_grad(set_to_none=True)
        m = grad_fn(state, _batch(32, 2, step))
        train_step.apply_update(state, hp)
        losses.append(m["loss"].item())
    monkeypatch.undo()
    return (losses, fused_train.trunk_operands.builds - builds,
            [p.detach().clone() for p in state.model.parameters()])


def test_training_steps_match_fresh_operands(monkeypatch):
    hp = _hp(N_importance=8, bound_sphere_radius=1.4)
    assert train_step.uses_single_pass_loss(hp)
    losses, builds, params = _two_steps(hp, False, monkeypatch)
    losses_f, builds_f, params_f = _two_steps(hp, True, monkeypatch)
    assert builds == 2                   # one per step
    assert builds_f >= 2
    assert losses == losses_f and np.isfinite(losses).all()
    for a, b in zip(params, params_f):
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("factory", ["codes", "codes_composite"])
def test_frozen_plane_op_reads_the_cache(factory):
    """A frozen plane op through ``fused_apply_train`` /
    ``fused_render_train``: one build for several calls, and the outputs
    and code cotangents of the same op fed ``flatten_params`` (the
    uncached operands), bit for bit."""
    cfg = NetConfig(W=256, shape_blocks=1, texture_blocks=1, num_xyz_freq=4,
                    num_dir_freq=2, latent_dim=16)
    model = _model(3, cfg).requires_grad_(False)
    rng = np.random.default_rng(4)
    R, S = 32, 8
    ro = torch.from_numpy(rng.uniform(-0.3, 0.3, (R, 3)).astype(np.float32))
    ro[:, 2] += 1.3
    vd = torch.from_numpy(rng.normal(size=(R, 3)).astype(np.float32))
    vd = vd / vd.norm(dim=-1, keepdim=True)
    z = torch.from_numpy(np.sort(rng.uniform(0.8, 1.8, (R, S)), -1).astype(
        np.float32))
    code = torch.from_numpy(rng.normal(size=(2, 16)).astype(np.float32))
    if factory == "codes":
        op = fused_train.make_fused_codes_op(cfg)
    else:
        op = fused_train.make_fused_codes_composite_op(cfg, white_bg=True)
    assert not op.weight_grads

    def run(cached: bool):
        sc, tc = (c.clone().requires_grad_(True) for c in code)
        ops = fused_mlp.prep_ray_operands(model, cfg, ro, vd, z, sc, tc)
        if not cached:
            outs = op(*ops, *fused_train.flatten_params(model, cfg))
        elif factory == "codes":
            outs = fused_train.fused_apply_train(model, cfg, ro, vd, z, sc,
                                                 tc, op=op)
            outs = (outs[0], *outs[1])
        else:
            r = fused_train.fused_render_train(model, cfg, ro, vd, z, sc,
                                               tc, op=op)
            outs = (torch.cat([r.rgb, r.depth[:, None], r.acc[:, None]], 1),)
        if factory == "codes_composite" and not cached:
            outs = [outs[:, :5]]
        sum(o.square().sum() for o in outs).backward()
        return [o.detach() for o in outs] + [sc.grad, tc.grad]

    builds = fused_train.trunk_operands.builds
    got = run(True)
    again = run(True)
    assert fused_train.trunk_operands.builds == builds + 1
    want = run(False)
    for a, b, c in zip(got, again, want):
        np.testing.assert_array_equal(_bits(a), _bits(b))
        np.testing.assert_array_equal(_bits(a), _bits(c))
