"""Seeded weights and code tables, made on the device by the benchmark.

The published initialisation (torch ``nn.Linear``: weight and bias
U(-1/sqrt(fan_in), 1/sqrt(fan_in)); codes N(0, 2/latent_dim),
``src/trainer.py:136-144``), drawn in two calls of one generator on the
card: one uniform buffer for every layer, one normal buffer for both code
tables. Both sides of the comparison start from these tensors.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from portbench.reference.codenerf import layer_shapes


def make_weights(net: dict, n_objects: int, seed: int, device,
                 gain: float = 1.0, colour: Optional[dict] = None
                 ) -> Dict[str, torch.Tensor]:
    """``{"<layer>.weight": (out, in), "<layer>.bias": (out,), ...,
    "shape_codes": (N, D), "texture_codes": (N, D)}`` f32 on ``device``,
    the networks' leaves first. ``gain`` widens the layers' uniform range
    to ``gain/sqrt(fan_in)``: sqrt(6) keeps a ReLU stack's activations of
    order one, as a trained model's are, where the published 1 shrinks
    them layer by layer. ``colour`` (``mean``, ``std``) draws ``rgb_out``
    so that inputs of unit second moment give colours of that mean and
    spread, as a trained model's colours lie inside [0, 1]."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = layer_shapes(net)
    n = sum(o * (i + 1) for _, i, o in shapes)
    flat = torch.rand(n, generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, fan_in, fan_out in shapes:
        bound = gain / math.sqrt(fan_in)
        w = flat[at:at + fan_out * fan_in].view(fan_out, fan_in) * bound
        at += fan_out * fan_in
        b = flat[at:at + fan_out] * bound
        at += fan_out
        if colour is not None and name == "rgb_out":
            w = w / bound * colour["std"] * math.sqrt(3.0 / fan_in)
            b = colour["mean"] + b / bound * colour["std"] * 0.1
        out[f"{name}.weight"], out[f"{name}.bias"] = w, b
    D = net["latent_dim"]
    codes = torch.randn(2, n_objects, D, generator=gen, device=device) \
        / math.sqrt(D / 2.0)
    out["shape_codes"], out["texture_codes"] = codes[0], codes[1]
    return out


def networks(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The networks' leaves of :func:`make_weights`, without the code
    tables."""
    return {k: v for k, v in weights.items()
            if k not in ("shape_codes", "texture_codes")}
