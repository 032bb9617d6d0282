"""Configuration: the reference JSON hyperparameter schema as frozen
dataclasses.

Its own copy of ``codenerf_tpu/config.py`` (the port imports nothing of the
JAX package): same keys, same defaults, same strict rejection of unknown
keys, so every ``jsonfiles/*.json`` parses identically in both packages.
Only :func:`resolve_dtype` differs — it maps to torch dtypes.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import torch

_REFERENCE_KEYS = {
    "net_hyperparams", "data", "N_samples", "near", "far", "loss_reg_coef",
    "lr_schedule", "check_points",
}
_EXTENSION_KEYS = {
    "N_importance", "white_bg", "shared_jitter", "compute_dtype",
    "weight_decay", "hierarchical_share_weights", "seed", "use_fused_train",
    "fused_composite", "train_occupancy", "bound_sphere_radius",
    "occ_probes", "reference_quirks",
}


@dataclasses.dataclass(frozen=True)
class NetConfig:
    """MLP architecture (reference ``net_hyperparams``)."""

    shape_blocks: int = 3
    texture_blocks: int = 1
    W: int = 256
    num_xyz_freq: int = 10
    num_dir_freq: int = 4
    latent_dim: int = 256

    @property
    def d_xyz(self) -> int:
        return 3 + 6 * self.num_xyz_freq

    @property
    def d_viewdir(self) -> int:
        return 3 + 6 * self.num_dir_freq


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Sampling / compositing parameters (reference ``N_samples``,
    ``near``, ``far`` plus the JAX package's extensions)."""

    n_samples: int = 96
    near: float = 0.8
    far: float = 1.8
    n_importance: int = 0
    white_bg: bool = True
    shared_jitter: bool = False
    share_fine_weights: bool = True
    bound_sphere_radius: Optional[float] = None
    occ_probes: int = 32


@dataclasses.dataclass(frozen=True)
class TrainOccupancyConfig:
    """Training-time occupancy grid settings (parsed so configs load; the
    occupancy path is not ported yet — see ROADMAP.md)."""

    grid_size: int = 64
    update_every: int = 500
    warmup: int = 2000
    codes_per_update: Optional[int] = None
    sigma_threshold: float = 0.01
    dilate: int = 1
    decay: float = 0.99
    radius: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class LrSchedule:
    """Step-halving: ``lr * 2^-(step // interval)``."""

    lr: float
    interval: int
    type: str = "step"


@dataclasses.dataclass(frozen=True)
class ReferenceQuirks:
    optimizer_reset_every: int = 0
    reg_chunk_divisor: int = 1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    cat: str = "srn_cars"
    splits: str = "cars_train"
    data_dir: str = "data/ShapeNet_SRN"


@dataclasses.dataclass(frozen=True)
class Hparams:
    net: NetConfig = dataclasses.field(default_factory=NetConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    loss_reg_coef: float = 1e-4
    lr_model: LrSchedule = dataclasses.field(
        default_factory=lambda: LrSchedule(lr=1e-4, interval=250_000))
    lr_codes: LrSchedule = dataclasses.field(
        default_factory=lambda: LrSchedule(lr=1e-3, interval=250_000))
    check_points: int = 100_000
    weight_decay: float = 0.01
    compute_dtype: str = "bfloat16"
    seed: int = 0
    use_fused_train: bool = False
    fused_composite: bool = True
    train_occupancy: Optional[TrainOccupancyConfig] = None
    quirks: ReferenceQuirks = dataclasses.field(default_factory=ReferenceQuirks)
    raw: Optional[Dict[str, Any]] = None

    def to_json_dict(self) -> Dict[str, Any]:
        """The reference JSON schema plus extensions, for the run dir's
        ``hpam.json`` (``src/trainer.py:163-166``); reads back through
        :func:`hparams_from_dict` unchanged."""
        return {
            "net_hyperparams": dataclasses.asdict(self.net),
            "data": dataclasses.asdict(self.data),
            "N_samples": self.render.n_samples,
            "near": self.render.near,
            "far": self.render.far,
            "loss_reg_coef": self.loss_reg_coef,
            "lr_schedule": [
                {"type": s.type, "lr": s.lr, "interval": s.interval}
                for s in (self.lr_model, self.lr_codes)],
            "check_points": self.check_points,
            "N_importance": self.render.n_importance,
            "white_bg": self.render.white_bg,
            "shared_jitter": self.render.shared_jitter,
            "hierarchical_share_weights": self.render.share_fine_weights,
            "bound_sphere_radius": self.render.bound_sphere_radius,
            "occ_probes": self.render.occ_probes,
            "compute_dtype": self.compute_dtype,
            "weight_decay": self.weight_decay,
            "seed": self.seed,
            "use_fused_train": self.use_fused_train,
            "fused_composite": self.fused_composite,
            "train_occupancy": (dataclasses.asdict(self.train_occupancy)
                                if self.train_occupancy is not None
                                else None),
            "reference_quirks": dataclasses.asdict(self.quirks),
        }


def hparams_from_dict(cfg: Dict[str, Any]) -> Hparams:
    unknown = set(cfg) - _REFERENCE_KEYS - _EXTENSION_KEYS
    if unknown:
        raise ValueError(f"Unknown hyperparameter keys: {sorted(unknown)}")
    render = RenderConfig(
        n_samples=int(cfg.get("N_samples", 96)),
        near=float(cfg.get("near", 0.8)),
        far=float(cfg.get("far", 1.8)),
        n_importance=int(cfg.get("N_importance", 0)),
        white_bg=bool(cfg.get("white_bg", True)),
        shared_jitter=bool(cfg.get("shared_jitter", False)),
        share_fine_weights=bool(cfg.get("hierarchical_share_weights", True)),
        bound_sphere_radius=(
            float(cfg["bound_sphere_radius"])
            if cfg.get("bound_sphere_radius") is not None else None),
        occ_probes=int(cfg.get("occ_probes", 32)),
    )
    sched = cfg.get("lr_schedule", [
        {"type": "step", "lr": 1e-4, "interval": 250_000},
        {"type": "step", "lr": 1e-3, "interval": 250_000},
    ])
    lr_model, lr_codes = (
        LrSchedule(lr=float(s["lr"]), interval=int(s["interval"]),
                   type=str(s.get("type", "step")))
        for s in sched[:2])
    return Hparams(
        net=NetConfig(**cfg.get("net_hyperparams", {})),
        data=DataConfig(**cfg.get("data", {})),
        render=render,
        loss_reg_coef=float(cfg.get("loss_reg_coef", 1e-4)),
        lr_model=lr_model,
        lr_codes=lr_codes,
        check_points=int(cfg.get("check_points", 100_000)),
        weight_decay=float(cfg.get("weight_decay", 0.01)),
        compute_dtype=str(cfg.get("compute_dtype", "bfloat16")),
        seed=int(cfg.get("seed", 0)),
        use_fused_train=bool(cfg.get("use_fused_train", False)),
        fused_composite=bool(cfg.get("fused_composite", True)),
        train_occupancy=(
            TrainOccupancyConfig(**cfg["train_occupancy"])
            if cfg.get("train_occupancy") is not None else None),
        quirks=ReferenceQuirks(**cfg.get("reference_quirks", {})),
        raw=dict(cfg),
    )


def load_hparams(jsonfile: str, jsondir: str = "jsonfiles") -> Hparams:
    """A filename resolved against ``jsonfiles/``, or a path that exists
    as-is (the reference CLIs' lookup)."""
    path = jsonfile if os.path.isfile(jsonfile) else os.path.join(jsondir,
                                                                  jsonfile)
    with open(path, "r") as f:
        return hparams_from_dict(json.load(f))


def resolve_dtype(name: str) -> torch.dtype:
    table = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
             "float32": torch.float32, "f32": torch.float32}
    if name not in table:
        raise ValueError(f"Unsupported compute dtype {name!r}")
    return table[name]
