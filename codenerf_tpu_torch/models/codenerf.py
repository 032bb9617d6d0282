"""The CodeNeRF MLP as an ``nn.Module`` (reference ``src/model.py:10-53``).

Layer names are those of ``codenerf_tpu/models/codenerf.py::init_codenerf``
(``enc_xyz``, ``shape_latent_{j}``, ``shape_{j}``, ``enc_shape``,
``sigma``, ``enc_viewdir``, ``texture_latent_{j}``, ``texture_{j}``,
``rgb_hidden``, ``rgb_out``), each an ``nn.Linear`` with torch's default
init — U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias, the same
distribution the JAX package draws.

:meth:`CodeNeRF.forward` mirrors ``apply_codenerf``: latent projections
once per ray, matmuls in the compute dtype (bf16 by default, f32
accumulation) with the output rounded to it before the bias add, sigma and
rgb heads in f32. It is the eval path; optimization steps go through the
fused kernel (``ops/fused_train.py``).

Weight interchange:

- :func:`params_from_jax` — the JAX package's param pytree (numpy arrays,
  ``w`` stored (in, out)) to this module's state dict;
- :func:`load_reference_state_dict` — the reference ``models.pth``
  ``model_params`` naming (``tools/export_reference_checkpoint.py``) to
  this module's state dict.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from codenerf_tpu_torch.config import NetConfig
from codenerf_tpu_torch.core.encoding import positional_encoding


def layer_names(cfg: NetConfig):
    names = ["enc_xyz"]
    for j in range(cfg.shape_blocks):
        names += [f"shape_latent_{j}", f"shape_{j}"]
    names += ["enc_shape", "sigma", "enc_viewdir"]
    for j in range(cfg.texture_blocks):
        names += [f"texture_latent_{j}", f"texture_{j}"]
    return names + ["rgb_hidden", "rgb_out"]


class CodeNeRF(nn.Module):
    def __init__(self, cfg: NetConfig, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        W, D = cfg.W, cfg.latent_dim
        dims = {"enc_xyz": (cfg.d_xyz, W), "enc_shape": (W, W),
                "sigma": (W, 1), "enc_viewdir": (W + cfg.d_viewdir, W),
                "rgb_hidden": (W, W // 2), "rgb_out": (W // 2, 3)}
        for j in range(cfg.shape_blocks):
            dims[f"shape_latent_{j}"] = (D, W)
            dims[f"shape_{j}"] = (W, W)
        for j in range(cfg.texture_blocks):
            dims[f"texture_latent_{j}"] = (D, W)
            dims[f"texture_{j}"] = (W, W)
        for name in layer_names(cfg):
            d_in, d_out = dims[name]
            lin = nn.Linear(d_in, d_out, device=device)
            if generator is not None:
                bound = 1.0 / math.sqrt(d_in)
                with torch.no_grad():
                    lin.weight.uniform_(-bound, bound, generator=generator)
                    lin.bias.uniform_(-bound, bound, generator=generator)
            setattr(self, name, lin)

    def forward(self, xyz: torch.Tensor, viewdir: torch.Tensor,
                shape_code: torch.Tensor, texture_code: torch.Tensor,
                compute_dtype: torch.dtype = torch.bfloat16
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """xyz (R, S, 3); viewdir (R, 3); codes (R, D) or (D,). Returns
        sigmas (R, S) f32 and rgbs (R, S, 3) f32 (no output sigmoid)."""
        cfg, cd = self.cfg, compute_dtype
        R, S = xyz.shape[0], xyz.shape[1]

        def dense(lin, x):
            return (torch.matmul(x.to(cd), lin.weight.to(cd).T)
                    + lin.bias.to(cd))

        def act(x):
            return torch.relu(x).to(cd)

        if shape_code.dim() == 1:
            shape_code = shape_code.expand(R, -1)
        if texture_code.dim() == 1:
            texture_code = texture_code.expand(R, -1)

        y = act(dense(self.enc_xyz, positional_encoding(xyz,
                                                        cfg.num_xyz_freq)))
        for j in range(cfg.shape_blocks):
            z = act(dense(getattr(self, f"shape_latent_{j}"), shape_code))
            y = act(dense(getattr(self, f"shape_{j}"), y + z[:, None, :]))
        y = dense(self.enc_shape, y)
        sigmas = nn.functional.softplus(
            torch.matmul(y.float(), self.sigma.weight.float().T)
            + self.sigma.bias.float())[..., 0]

        vd_pe = positional_encoding(viewdir, cfg.num_dir_freq)
        vd_pe = vd_pe[:, None, :].expand(R, S, vd_pe.shape[-1])
        y = act(dense(self.enc_viewdir,
                      torch.cat([y.to(cd), vd_pe.to(cd)], dim=-1)))
        for j in range(cfg.texture_blocks):
            z = act(dense(getattr(self, f"texture_latent_{j}"), texture_code))
            y = act(dense(getattr(self, f"texture_{j}"), y + z[:, None, :]))
        y = act(dense(self.rgb_hidden, y))
        rgbs = (torch.matmul(y.float(), self.rgb_out.weight.float().T)
                + self.rgb_out.bias.float())
        return sigmas, rgbs


def params_from_jax(params) -> Dict[str, torch.Tensor]:
    """JAX param pytree ``{name: {"w": (in, out), "b": (out,)}}`` of numpy
    arrays -> this module's state dict (weights transposed to (out, in))."""
    sd = {}
    for name, layer in params.items():
        w = np.asarray(layer["w"], dtype=np.float32)
        sd[f"{name}.weight"] = torch.from_numpy(np.array(w.T, copy=True))
        sd[f"{name}.bias"] = torch.from_numpy(
            np.array(layer["b"], dtype=np.float32))
    return sd


def _reference_names(shape_blocks: int, texture_blocks: int):
    """(reference prefix, port name) pairs, ``src/model.py:19-34``."""
    pairs = [("encoding_xyz.0", "enc_xyz")]
    for j in range(shape_blocks):
        pairs += [(f"shape_latent_layer_{j + 1}.0", f"shape_latent_{j}"),
                  (f"shape_layer_{j + 1}.0", f"shape_{j}")]
    pairs += [("encoding_shape", "enc_shape"), ("sigma.0", "sigma"),
              ("encoding_viewdir.0", "enc_viewdir")]
    for j in range(texture_blocks):
        pairs += [(f"texture_latent_layer_{j + 1}.0", f"texture_latent_{j}"),
                  (f"texture_layer_{j + 1}.0", f"texture_{j}")]
    return pairs + [("rgb.0", "rgb_hidden"), ("rgb.2", "rgb_out")]


def _count_blocks(keys, prefix: str) -> int:
    return len({k.split(".")[0] for k in keys if k.startswith(prefix)})


def load_reference_state_dict(sd) -> Dict[str, torch.Tensor]:
    """Reference ``model_params`` (torch ``nn.Linear`` layout, already
    (out, in)) -> this module's state dict. Block counts are inferred from
    the keys."""
    nb = _count_blocks(sd, "shape_layer_")
    nt = _count_blocks(sd, "texture_layer_")
    out = {}
    for ref, name in _reference_names(nb, nt):
        out[f"{name}.weight"] = sd[f"{ref}.weight"].detach().float().clone()
        out[f"{name}.bias"] = sd[f"{ref}.bias"].detach().float().clone()
    return out


def state_dict_config(sd) -> NetConfig:
    """The ``NetConfig`` of this module's state dict ``sd``, read from its
    keys and shapes."""
    def blocks(kind):   # "shape_{j}" and "shape_latent_{j}" both count
        return (_count_blocks(sd, f"{kind}_")
                - _count_blocks(sd, f"{kind}_latent_"))

    W = sd["enc_shape.weight"].shape[0]
    return NetConfig(
        shape_blocks=blocks("shape"), texture_blocks=blocks("texture"), W=W, num_xyz_freq=(sd["enc_xyz.weight"].shape[1] - 3) // 6,
        num_dir_freq=(sd["enc_viewdir.weight"].shape[1] - W - 3) // 6,
        latent_dim=sd["shape_latent_0.weight"].shape[1])


def to_reference_state_dict(model: CodeNeRF) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`load_reference_state_dict`."""
    sd = model.state_dict()
    out = {}
    for ref, name in _reference_names(model.cfg.shape_blocks,
                                      model.cfg.texture_blocks):
        out[f"{ref}.weight"] = sd[f"{name}.weight"].detach().cpu().clone()
        out[f"{ref}.bias"] = sd[f"{name}.bias"].detach().cpu().clone()
    return out
