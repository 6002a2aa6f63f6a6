"""Carry LightGCN weights between the JAX package and the port.

The JAX package's params are ``{"embedding": [N, D]}`` (its arrays, or the
numpy arrays a checkpoint holds); the port's are the same dict of tensors on
a device. Values and dtypes pass unchanged both ways.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def params_to_torch(params: dict, device: str | torch.device = "cuda") -> dict:
    """JAX-side params (anything ``np.asarray`` takes) -> port tensors."""
    dev = resolve_device(device)
    return {
        name: torch.from_numpy(np.array(value, copy=True)).to(dev)
        for name, value in params.items()
    }


def params_to_numpy(params: dict) -> dict:
    """Port tensors -> numpy arrays, as the JAX package loads them."""
    return {name: value.detach().cpu().numpy() for name, value in params.items()}
