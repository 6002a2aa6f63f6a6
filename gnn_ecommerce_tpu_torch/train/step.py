"""Training step: sample → propagate → BPR + L2 → Adam update.

Counterpart of ``gnn_ecommerce_tpu/train/step.py``. One step is the net math
of the reference mini-batch loop: BPR loss ``-mean(logsigmoid(pos - neg))``
plus ego-embedding L2, optimized with Adam.

Differences of form, not of math:
- the step runs eagerly; ``run_steps`` is a Python loop over steps (the JAX
  package scans them in one program). Its metrics stay on the device and
  reach the host once per call;
- parameters and the Adam moments are updated in place (the JAX step
  donates its buffers to the same end);
- Adam is a few lines of our own (:class:`Adam`) in optax's form, so its
  state is the optax state under torch names.

Each ``train_step`` call is the span ``train.step`` (``tracing.py``), parent
of ``train.sample``, ``train.forward``, ``train.loss``, ``train.backward``
and ``train.adam``; ``run_steps``' one read of its metrics is ``train.sync``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..device import divisor
from ..models.lightgcn import LightGCNConfig, get_embedding
from ..models.losses import bpr_loss, reg_loss
from ..ops.propagate import propagate_segment
from ..sampling.bpr import BprSamplerData, sample_batch
from ..tracing import span


@dataclasses.dataclass
class AdamState:
    """optax's ``ScaleByAdamState`` (count, mu, nu) under torch's names."""

    step: int
    exp_avg: dict
    exp_avg_sq: dict


def _bias_correction(decay: float, step: int) -> float:
    """optax's ``1 - decay**count`` in f32, as a Python float."""
    power = np.float32(float(np.float32(decay)) ** step)
    return float(np.float32(1.0) - power)


class Adam:
    """``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8, bias-corrected,

        m ← b1·m + (1-b1)·g;  v ← b2·v + (1-b2)·g²
        p ← p - lr · (m / (1-b1^t)) / (sqrt(v / (1-b2^t)) + eps)

    ``torch.optim.Adam`` computes the same update with another grouping of
    the bias corrections; this keeps optax's, updating in place. As in
    optax, each bias correction is ``1 - b**t`` in f32 from the f32 ``b``
    (the power rounded once, as XLA's ``pow`` gives it): from the exact
    0.999, ``1 - b2**3`` would differ from optax's by 2.7e-5 relative."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params: dict) -> AdamState:
        return AdamState(
            step=0,
            exp_avg={k: torch.zeros_like(v) for k, v in params.items()},
            exp_avg_sq={k: torch.zeros_like(v) for k, v in params.items()},
        )

    @torch.no_grad()
    def update(self, grads: dict, state: AdamState, params: dict) -> None:
        """Apply one step to ``params`` and ``state`` in place."""
        state.step += 1
        bc1 = _bias_correction(self.b1, state.step)
        bc2 = _bias_correction(self.b2, state.step)
        for name, g in grads.items():
            m, v = state.exp_avg[name], state.exp_avg_sq[name]
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            params[name].sub_(adam_direction(m, v, bc1, bc2, self.eps), alpha=self.lr)


def adam_direction(m: torch.Tensor, v: torch.Tensor, bc1: float, bc2: float, eps: float) -> torch.Tensor:
    """``(m / bc1) / (sqrt(v / bc2) + eps)`` with true divisions, as optax
    divides: the f32 bias corrections divide as tensors
    (``device.divisor``)."""
    return (m / divisor(bc1, m.device)).div_((v / divisor(bc2, v.device)).sqrt_().add_(eps))


def make_loss_fn(
    cfg: LightGCNConfig,
    decay: float,
    embed_fn: Callable | None = None,
    batch_embed_fn: Callable | None = None,
    propagate_fn: Callable = propagate_segment,
):
    """``loss_fn(params, graph, users, pos, neg) -> (loss, (bpr, reg,
    dropped))``: BPR on the final embeddings plus L2 on the ego embeddings.

    The final embeddings are the layered ``get_embedding`` with
    ``propagate_fn`` as each layer. ``embed_fn(params, graph) ->
    final_embedding`` replaces it (e.g. ``ops.bipartite.fast_get_embedding`` with a
    ``FastBipartite`` as ``graph``). ``batch_embed_fn(params, graph, users,
    pos, neg) -> (u, p, n, dropped)`` replaces both and gives the batch's
    final embeddings directly (``ops.bipartite.fast_batch_embeddings``).
    """
    if embed_fn is None:
        embed_fn = lambda params, graph: get_embedding(params, graph, cfg, propagate_fn)

    def loss_fn(params, graph, users, pos, neg):
        with span("train.forward"):
            if batch_embed_fn is not None:
                u, p, n, dropped = batch_embed_fn(params, graph, users, pos, neg)
            else:
                out = embed_fn(params, graph)
                u, p, n = out[users], out[pos], out[neg]
                dropped = torch.zeros((), dtype=torch.int64, device=users.device)
        with span("train.loss"):
            bpr = bpr_loss((u * p).sum(-1), (u * n).sum(-1))
            reg = reg_loss(params["embedding"], users, pos, neg, decay)
            loss = bpr + reg
        return loss, (bpr, reg, dropped)

    return loss_fn


def make_batch_step(loss_fn: Callable, optimizer: Adam):
    """``on_batch(params, opt_state, graph, users, pos, neg) -> (params,
    opt_state, metrics)``: the gradient of ``loss_fn`` (:func:`make_loss_fn`'s
    form) on one given batch and one ``optimizer`` update, in place.

    The metrics are 0-d device tensors: ``loss``, ``bpr_loss``, ``reg_loss``
    and ``dropped_arcs`` (batch arcs beyond the batched forward's
    capacity)."""

    def on_batch(params, opt_state, graph, users, pos, neg):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            loss, (bpr, reg, dropped) = loss_fn(leaves, graph, users, pos, neg)
            with span("train.backward"):
                grads = torch.autograd.grad(loss, list(leaves.values()))
        with span("train.adam"):
            optimizer.update(dict(zip(leaves, grads)), opt_state, params)
        metrics = {
            "loss": loss.detach(),
            "bpr_loss": bpr.detach(),
            "reg_loss": reg.detach(),
            "dropped_arcs": dropped.float(),
        }
        return params, opt_state, metrics

    return on_batch


def make_run_steps(train_step: Callable):
    """``run_steps(params, opt_state, graph, sampler_data, generator,
    num_steps) -> (params, opt_state, mean metrics)``: ``num_steps`` calls of
    ``train_step``, the metrics averaged on the device and read once."""

    def run_steps(params, opt_state, graph, sdata, generator, num_steps: int):
        total = None
        for _ in range(num_steps):
            params, opt_state, m = train_step(params, opt_state, graph, sdata, generator)
            total = m if total is None else {k: total[k] + m[k] for k in m}
        names = list(total)
        stacked = torch.stack([total[k] for k in names])
        with span("train.sync"):
            means = (stacked / divisor(num_steps, stacked.device)).tolist()
        return params, opt_state, dict(zip(names, means))

    return run_steps


def make_train_fns(
    cfg: LightGCNConfig,
    optimizer: Adam,
    batch_size: int,
    decay: float,
    propagate_fn: Callable = propagate_segment,
    sample_replace: bool = True,
    embed_fn: Callable | None = None,
    batch_embed_fn: Callable | None = None,
    loss_fn: Callable | None = None,
):
    """Build (train_step, run_steps) over :func:`make_loss_fn`'s loss (or
    ``loss_fn``, a loss of the same form, when given). ``propagate_fn`` is
    the layered loss's propagation (``ops.propagate``'s functions).

    train_step(params, opt_state, graph, sampler_data, generator)
        -> (params, opt_state, metrics)        # metrics: 0-d device tensors
    run_steps(params, opt_state, graph, sampler_data, generator, num_steps)
        -> (params, opt_state, mean metrics)   # floats; one host sync

    ``train_step.on_batch`` is :func:`make_batch_step`'s step on a given
    batch, and ``train_step.loss_fn`` the loss.
    """
    if loss_fn is None:
        loss_fn = make_loss_fn(cfg, decay, embed_fn, batch_embed_fn, propagate_fn)
    on_batch = make_batch_step(loss_fn, optimizer)

    def train_step(params, opt_state, graph, sdata: BprSamplerData, generator):
        with span("train.step"):
            with span("train.sample"):
                users, pos, neg = sample_batch(generator, sdata, batch_size, replace=sample_replace)
            return on_batch(params, opt_state, graph, users, pos, neg)

    train_step.on_batch, train_step.loss_fn = on_batch, loss_fn
    return train_step, make_run_steps(train_step)
