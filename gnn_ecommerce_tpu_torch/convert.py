"""Carry LightGCN weights and Adam state between the JAX package and the
port.

The JAX package's params are ``{"embedding": [N, D]}`` (its arrays, or the
numpy arrays a checkpoint holds); the port's are the same dict of tensors on
a device. Its Adam state is optax's ``ScaleByAdamState`` (count, mu, nu);
the port's is :class:`~.train.step.AdamState` (step, exp_avg, exp_avg_sq).
Values and dtypes pass unchanged both ways.

The SVD baseline's params (``models/svd.py``) are ``{"mu", "b_u", "b_i",
"p", "q"}`` in both packages: :func:`svd_params_to_torch` carries JAX's
(numpy or JAX arrays) to the port's f32 tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .train.step import AdamState


def params_to_torch(params: dict, device: str | torch.device = "cuda") -> dict:
    """JAX-side params (anything ``np.asarray`` takes) -> port tensors."""
    dev = resolve_device(device)
    return {
        name: torch.from_numpy(np.array(value, copy=True)).to(dev)
        for name, value in params.items()
    }


SVD_PARAM_NAMES = ("mu", "b_u", "b_i", "p", "q")


def svd_params_to_torch(params: dict, device: str | torch.device = "cuda") -> dict:
    """JAX-side SVD params -> the port's: the five arrays as f32 tensors
    (``mu`` 0-d). A missing or extra name raises ``KeyError``."""
    if set(params) != set(SVD_PARAM_NAMES):
        raise KeyError(f"SVD params need exactly {SVD_PARAM_NAMES}, got {sorted(params)}")
    return params_to_torch(
        {name: np.asarray(params[name], dtype=np.float32) for name in SVD_PARAM_NAMES}, device
    )


def params_to_numpy(params: dict) -> dict:
    """Port tensors -> numpy arrays, as the JAX package loads them."""
    return {name: value.detach().cpu().numpy() for name, value in params.items()}


def adam_state_to_torch(opt_state, device: str | torch.device = "cuda") -> AdamState:
    """optax's Adam state -> the port's. Takes ``optax.adam(...).init(...)``
    output (``(ScaleByAdamState, EmptyState)``) or the ``ScaleByAdamState``
    itself, or any object with ``count``, ``mu`` and ``nu``."""
    s = opt_state if hasattr(opt_state, "mu") else opt_state[0]
    return AdamState(
        step=int(np.asarray(s.count)),
        exp_avg=params_to_torch(s.mu, device),
        exp_avg_sq=params_to_torch(s.nu, device),
    )


def adam_state_to_numpy(state: AdamState) -> dict:
    """The port's Adam state -> ``{"count", "mu", "nu"}`` as numpy, the
    fields of optax's ``ScaleByAdamState(**...)``."""
    return {
        "count": np.asarray(state.step, np.int32),
        "mu": params_to_numpy(state.exp_avg),
        "nu": params_to_numpy(state.exp_avg_sq),
    }
