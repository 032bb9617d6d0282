"""Training state (counterpart of ``codenerf_tpu/training/state.py``).

Everything that evolves during training in one object: the ``CodeNeRF``
model, both latent-code tables as dense ``nn.Parameter`` s, the AdamW
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

    @property
    def device(self) -> torch.device:
        return self.shape_codes.device


def make_trainables(hp: Hparams, n_objects: int,
                    generator: Optional[torch.Generator] = None,
                    device="cpu"):
    """``(model, shape_codes, texture_codes)``: the reference's init
    (torch ``nn.Linear`` defaults, codes N(0, 2/latent_dim)), drawn on the
    CPU from ``generator`` so that a seed gives the same start on every
    device."""
    if hp.render.n_importance > 0 and not hp.render.share_fine_weights:
        raise NotImplementedError(
            "hierarchical_share_weights=false (a separate fine network) is "
            "not ported yet (ROADMAP.md Queue 2, item 6)")
    model = CodeNeRF(hp.net, generator=generator)
    sc = init_codes(n_objects, hp.net.latent_dim, generator)
    tc = init_codes(n_objects, hp.net.latent_dim, generator)
    return (model.to(device), nn.Parameter(sc.to(device)),
            nn.Parameter(tc.to(device)))


def _state(hp: Hparams, model, sc, tc, device) -> TrainState:
    from codenerf_tpu_torch.training.train_step import build_optimizer

    gen = torch.Generator(device=device).manual_seed(hp.seed)
    return TrainState(model=model, shape_codes=sc, texture_codes=tc,
                      optimizer=build_optimizer(hp, model, sc, tc),
                      generator=gen)


def create_train_state(hp: Hparams, n_objects: int,
                       device="cuda") -> TrainState:
    """A fresh state from ``hp.seed`` on ``device`` (CUDA unless the
    caller asks for the CPU; no fallback)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(hp.seed)
    model, sc, tc = make_trainables(hp, n_objects, gen, device)
    return _state(hp, model, sc, tc, device)


def trainables_from_jax(trainables: Dict[str, Any], hp: Hparams,
                        device="cpu") -> TrainState:
    """A fresh state (step 0, new moments) whose model and code tables are
    the JAX package's ``trainables`` (``params``, ``shape_codes``,
    ``texture_codes`` as numpy arrays) — both packages start from the same
    point."""
    device = resolve_device(device)
    model = CodeNeRF(hp.net)
    model.load_state_dict(params_from_jax(trainables["params"]))

    def table(x):
        return nn.Parameter(torch.from_numpy(
            np.array(x, dtype=np.float32)).to(device))

    return _state(hp, model.to(device), table(trainables["shape_codes"]),
                  table(trainables["texture_codes"]), device)
