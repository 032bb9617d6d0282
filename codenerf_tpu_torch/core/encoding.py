"""Sinusoidal positional encoding (reference ``PE``, ``src/model.py:4-7``).

Channel order ``[x | sin, frequency-major | cos]``, as
``codenerf_tpu/core/encoding.py``: converted checkpoints stay valid.
Always float32 — at 2^9·x the argument reaches ~1e3 rad, beyond bf16.
"""

from __future__ import annotations

import torch


def positional_encoding(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """``x[..., D] -> [..., D*(1+2*num_freqs)]``."""
    x = x.float()
    if num_freqs == 0:
        return x
    freqs = 2.0 ** torch.arange(num_freqs, dtype=torch.float32,
                                device=x.device)
    scaled = (x[..., None, :] * freqs[:, None]).reshape(
        *x.shape[:-1], num_freqs * x.shape[-1])
    return torch.cat([x, torch.sin(scaled), torch.cos(scaled)], dim=-1)
