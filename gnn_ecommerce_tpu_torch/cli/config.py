"""Typed framework configuration.

Counterpart of ``gnn_ecommerce_tpu/cli/config.py``: one dataclass covers
paths, the edge weighting scheme, the training hyperparameters (the port's
``TrainConfig``, with its ``model``, ``lightgcn``, ``simgcl`` or
``dgcf``, SimGCL's ``cl_weight``, ``cl_eps`` and ``cl_temp``, and DGCF's
``dgcf_factors``, ``dgcf_iterations`` and ``cor_weight``),
eval K and the mesh spec. YAML files need PyYAML, which is imported only by
:meth:`FrameworkConfig.load` and :meth:`FrameworkConfig.dump`: without it
they raise, and everything else works.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..data.events import EVENT_TYPE_WEIGHTS_V1, EVENT_TYPE_WEIGHTS_V2
from ..train.driver import TrainConfig

WEIGHT_SCHEMES = {"v1": EVENT_TYPE_WEIGHTS_V1, "v2": EVENT_TYPE_WEIGHTS_V2}


def _yaml():
    try:
        import yaml
    except ImportError:
        raise RuntimeError(
            "YAML configs need PyYAML, which is not installed; "
            "pass the settings as command-line flags instead"
        ) from None
    return yaml


@dataclasses.dataclass
class FrameworkConfig:
    # Paths.
    raw_events_path: Optional[str] = None
    edges_path: Optional[str] = None           # weighted (user,item,weight) CSV
    data_dir: str = "data/prepared"            # prepared-artifact directory
    checkpoint_dir: str = "model-checkpoints"
    recommendations_dir: str = "model-recommendations"
    # Edge weighting.
    weight_scheme: str = "v1"
    event_type_weights: Optional[dict] = None  # explicit override
    # Train hyperparameters.
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    # Devices to mesh for training (1 = single device, 0 = all visible,
    # N > 1 = explicit count); mirrored into TrainConfig.mesh_devices by the
    # train CLI. Only 1 is ported.
    mesh_devices: int = 1

    def weights(self) -> dict:
        return self.event_type_weights or WEIGHT_SCHEMES[self.weight_scheme]

    @classmethod
    def load(cls, path: str) -> "FrameworkConfig":
        yaml = _yaml()
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        train_raw = raw.pop("train", {})
        known = {f.name for f in dataclasses.fields(cls)} - {"train"}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        tknown = {f.name for f in dataclasses.fields(TrainConfig)}
        tunknown = set(train_raw) - tknown
        if tunknown:
            raise ValueError(f"unknown train config keys: {sorted(tunknown)}")
        return cls(train=TrainConfig(**train_raw), **raw)

    def dump(self, path: str) -> None:
        yaml = _yaml()
        with open(path, "w") as f:
            yaml.safe_dump(dataclasses.asdict(self), f, sort_keys=False)
