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
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from codenerf_tpu_torch import resolve_device
from codenerf_tpu_torch.config import Hparams
from codenerf_tpu_torch.models.codenerf import CodeNeRF, params_from_jax
from codenerf_tpu_torch.models.codes import init_codes


@dataclasses.dataclass
class TrainState:
    model: CodeNeRF
    shape_codes: nn.Parameter      # (n_objects, latent_dim) f32
    texture_codes: nn.Parameter
    optimizer: torch.optim.Optimizer
    generator: torch.Generator     # z jitter, on the model's device
    step: int = 0
    fine_model: Optional[CodeNeRF] = None   # separate fine weights

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


def _state(hp: Hparams, model, sc, tc, device, fine=None) -> TrainState:
    from codenerf_tpu_torch.training.train_step import build_optimizer

    gen = torch.Generator(device=device).manual_seed(hp.seed)
    return TrainState(model=model, shape_codes=sc, texture_codes=tc,
                      optimizer=build_optimizer(hp, model, sc, tc, fine),
                      generator=gen, fine_model=fine)


def create_train_state(hp: Hparams, n_objects: int,
                       device="cuda") -> TrainState:
    """A fresh state from ``hp.seed`` on ``device`` (CUDA unless the
    caller asks for the CPU; no fallback)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(hp.seed)
    model, sc, tc, fine = make_trainables(hp, n_objects, gen, device)
    return _state(hp, model, sc, tc, device, fine)


def trainables_from_jax(trainables: Dict[str, Any], hp: Hparams,
                        device="cpu") -> TrainState:
    """A fresh state (step 0, new moments) whose model, fine network
    (``fine_params``, when the JAX package has one) and code tables are
    the JAX package's ``trainables`` (numpy arrays) — both packages start
    from the same point."""
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
                  table(trainables["texture_codes"]), device, fine)
