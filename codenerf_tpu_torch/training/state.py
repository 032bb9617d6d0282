"""Training state (counterpart of ``codenerf_tpu/training/state.py``).

Everything that evolves during training in one object: the ``CodeNeRF``
model (and, for hierarchical sampling with separate fine weights, the fine
network), both latent-code tables as dense ``nn.Parameter`` s, the AdamW
optimizer, the ``torch.Generator`` that draws the z jitter, and the step
count. The tables are dense on purpose: optax's AdamW decays every row and
advances every row's moments each step, and ``torch.optim.AdamW`` does the
same only with dense gradients (a sparse ``nn.Embedding`` would touch only
the rows in the batch). The whole state round-trips through
``utils/checkpoint.py``, so a resumed run continues exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from codenerf_tpu_torch import resolve_device
from codenerf_tpu_torch.config import Hparams
from codenerf_tpu_torch.models.codenerf import CodeNeRF, params_from_jax
from codenerf_tpu_torch.models.codes import init_codes
from codenerf_tpu_torch.parallel.mesh import ModelShards, model_size, shard_dim


@dataclasses.dataclass
class TrainState:
    model: CodeNeRF
    shape_codes: nn.Parameter      # (n_objects, latent_dim) f32
    texture_codes: nn.Parameter
    optimizer: torch.optim.Optimizer
    generator: torch.Generator     # z jitter, on the model's device
    step: int = 0
    fine_model: Optional[CodeNeRF] = None   # separate fine weights
    shards: Optional[ModelShards] = None    # the model axis's split

    @property
    def device(self) -> torch.device:
        return self.shape_codes.device


def needs_fine_model(hp: Hparams) -> bool:
    """Hierarchical sampling with separate fine weights."""
    return hp.render.n_importance > 0 and not hp.render.share_fine_weights


def make_trainables(hp: Hparams, n_objects: int,
                    generator: Optional[torch.Generator] = None,
                    device="cpu"):
    """``(model, shape_codes, texture_codes, fine_model)``: the
    reference's init (torch ``nn.Linear`` defaults, codes N(0,
    2/latent_dim)), drawn on the CPU from ``generator`` so that a seed
    gives the same start on every device; ``fine_model`` (None unless
    :func:`needs_fine_model`) is drawn right after the coarse network, in
    the JAX package's order (model, fine, shape, texture)."""
    model = CodeNeRF(hp.net, generator=generator)
    fine = (CodeNeRF(hp.net, generator=generator).to(device)
            if needs_fine_model(hp) else None)
    sc = init_codes(n_objects, hp.net.latent_dim, generator)
    tc = init_codes(n_objects, hp.net.latent_dim, generator)
    return (model.to(device), nn.Parameter(sc.to(device)),
            nn.Parameter(tc.to(device)), fine)


def _named(model, fine, sc, tc) -> Dict[str, torch.Tensor]:
    """Every trainable by name, in AdamW's order (``build_optimizer``):
    ``model.<param>``, ``fine_model.<param>``, ``shape_codes``,
    ``texture_codes``."""
    out = {f"model.{n}": p for n, p in model.named_parameters()}
    if fine is not None:
        out.update((f"fine_model.{n}", p) for n, p in fine.named_parameters())
    out.update(shape_codes=sc, texture_codes=tc)
    return out


def named_trainables(state: TrainState) -> Dict[str, torch.Tensor]:
    """:func:`_named` of the state: its leaves (slices under a model
    axis), in ``trainable_params`` ' order."""
    return _named(state.model, state.fine_model, state.shape_codes,
                  state.texture_codes)


def state_shard_dims(state: TrainState, model: int
                     ) -> Dict[str, Optional[int]]:
    """For every leaf of a whole state, the dimension a ``model`` axis of
    size ``model`` shards (``parallel/mesh.shard_dim``, JAX's
    ``state_shardings``) or None: each trainable, its AdamW moments
    (``<name>/exp_avg``, ``<name>/exp_avg_sq``: the parameter's) and
    step (``<name>/step``), the step count and the generator."""
    out = {}
    opt = state.optimizer
    for name, p in named_trainables(state).items():
        out[name] = shard_dim(name, p.shape, model)
        for k, v in opt.state.get(p, {}).items():
            out[f"{name}/{k}"] = (out[name] if k.startswith("exp_avg")
                                  else shard_dim(name, v.shape, model))
    out["step"] = out["generator"] = None
    return out


def _split(model, fine, sc, tc, shards: ModelShards):
    """Keep this rank's slices: each sharded parameter of the networks is
    replaced by a parameter of its block, each sharded table by one of
    its columns."""
    for prefix, net in (("model", model), ("fine_model", fine)):
        if net is None:
            continue
        for layer, lin in net.named_children():
            for kind in ("weight", "bias"):
                dim = shards.dims[f"{prefix}.{layer}.{kind}"]
                if dim is not None:
                    setattr(lin, kind, nn.Parameter(
                        shards.slice(getattr(lin, kind).detach(), dim)))
    sc, tc = (t if shards.dims[n] is None else nn.Parameter(
        shards.slice(t.detach(), shards.dims[n]))
        for n, t in (("shape_codes", sc), ("texture_codes", tc)))
    return model, fine, sc, tc


def _state(hp: Hparams, model, sc, tc, device, fine=None,
           mesh=None) -> TrainState:
    from codenerf_tpu_torch.training.train_step import build_optimizer

    shards = None
    if model_size(mesh) > 1:
        shards = ModelShards.of(mesh, {n: p.shape for n, p in
                                       _named(model, fine, sc, tc).items()})
        model, fine, sc, tc = _split(model, fine, sc, tc, shards)
    gen = torch.Generator(device=device).manual_seed(hp.seed)
    return TrainState(model=model, shape_codes=sc, texture_codes=tc,
                      optimizer=build_optimizer(hp, model, sc, tc, fine),
                      generator=gen, fine_model=fine, shards=shards)


def create_train_state(hp: Hparams, n_objects: int, device="cuda",
                       mesh=None) -> TrainState:
    """A fresh state from ``hp.seed`` on ``device`` (CUDA unless the
    caller asks for the CPU; no fallback). On a ``mesh`` with a ``model``
    axis above 1 every rank draws the whole state and keeps its
    slices."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(hp.seed)
    model, sc, tc, fine = make_trainables(hp, n_objects, gen, device)
    return _state(hp, model, sc, tc, device, fine, mesh)


def trainables_from_jax(trainables: Dict[str, Any], hp: Hparams,
                        device="cpu", mesh=None) -> TrainState:
    """A fresh state (step 0, new moments) whose model, fine network
    (``fine_params``, when the JAX package has one) and code tables are
    the JAX package's ``trainables`` (numpy arrays) — both packages start
    from the same point; sliced as :func:`create_train_state` on a
    ``mesh``."""
    device = resolve_device(device)

    def net(params):
        m = CodeNeRF(hp.net)
        m.load_state_dict(params_from_jax(params))
        return m.to(device)

    def table(x):
        return nn.Parameter(torch.from_numpy(
            np.array(x, dtype=np.float32)).to(device))

    fine = (net(trainables["fine_params"]) if "fine_params" in trainables
            else None)
    return _state(hp, net(trainables["params"]),
                  table(trainables["shape_codes"]),
                  table(trainables["texture_codes"]), device, fine, mesh)


class WholeNet:
    """A network's forward on the whole parameters ``params`` (name ->
    tensor, gathered over the model axis): called as the ``CodeNeRF`` it
    wraps, through ``torch.func.functional_call``, so gradients reach the
    gathered tensors and, through the gather, the rank's slices."""

    def __init__(self, net: CodeNeRF, params: Dict[str, torch.Tensor]):
        self.net, self.params, self.cfg = net, params, net.cfg

    def __call__(self, *args, **kwargs):
        return torch.func.functional_call(self.net, self.params, args,
                                          kwargs)


def whole_trainables(state: TrainState) -> List[Any]:
    """``[model, fine_model, shape_codes, texture_codes]`` as a forward
    sees them: the state's own without a model axis; else one gather over
    it — :class:`WholeNet` s and whole tables, differentiable, so every
    rank of the ``model`` group must call it alike."""
    if state.shards is None:
        return [state.model, state.fine_model, state.shape_codes,
                state.texture_codes]
    whole = state.shards.whole(named_trainables(state))

    def net(prefix: str, module):
        if module is None:
            return None
        n = len(prefix) + 1
        return WholeNet(module, {k[n:]: v for k, v in whole.items()
                                 if k.startswith(prefix + ".")})

    return [net("model", state.model), net("fine_model", state.fine_model),
            whole["shape_codes"], whole["texture_codes"]]
