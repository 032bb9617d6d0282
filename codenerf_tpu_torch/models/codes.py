"""Per-object latent code tables (reference ``nn.Embedding`` rows,
``src/trainer.py:136-144``)."""

from __future__ import annotations

import math
from typing import Optional

import torch


def init_codes(n_objs: int, latent_dim: int,
               generator: Optional[torch.Generator] = None,
               device=None) -> torch.Tensor:
    """N(0, 2/latent_dim) rows, as the reference initializes them."""
    return torch.randn((n_objs, latent_dim), generator=generator,
                       device=device) / math.sqrt(latent_dim / 2.0)


def mean_code(table: torch.Tensor) -> torch.Tensor:
    """Mean over the trained rows — the test-time init
    (``src/optimizer.py:215-216``). Returns (latent_dim,)."""
    return table.float().mean(dim=0)
