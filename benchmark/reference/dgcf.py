"""Plain DGCF in float32 PyTorch: the reference that decides ``correct`` in
the DGCF cell.

Wang, Jin, Zhang, Chua, He, "Disentangled Graph Collaborative Filtering",
SIGIR 2020 (arXiv:2007.01764), written from its equations as the authors'
``DGCF.py`` computes them in training mode (``_create_star_routing_embed_
with_P``, ``_convert_A_values_to_A_factors_with_P`` with ``pick`` off,
``create_cor_loss``). It imports nothing of the program; TF32 is off.

The arcs are both directions of each edge ``(u, i)``, ``(h, t)`` with h the
head (the row written) and t the tail (the row read), sorted by (h, t); A,
S and the scores are [E, K]; x_k is the k-th chunk of ``c = d / K``
columns.

- A forward starts from ``A = 1`` (carried across layers); each layer runs
  T iterations over its input x: ``S = softmax_k(A)``; ``deg_k(v) =
  Σ_{arcs with head v} S``; ``f_k[h] = deg_k(h)^-½ Σ_t S·deg_k(t)^-½·x_k[t]``;
  ``A += ⟨normalize(f_k[h]), tanh(normalize(x_k[t]))⟩``. The layer's
  output is the last ``f``, the final embedding the mean of layers 0..L.
- The loss: ``mean(softplus(−(s_pos − s_neg)))``, ``decay · ½(‖u₀‖² +
  ‖p₀‖² + ‖n₀‖²) / B`` and ``cor_weight · cor``: the authors' distance
  correlation of adjacent intent chunks of the final rows of
  ``torch.randperm(n_users)[:cor_batch]`` and ``torch.randperm(n_items)
  [:cor_batch]``, drawn in that order from a generator set to the state the
  program's had before the step, over ``(K + 1)·K / 2``. The gradient is
  autograd's, Adam ``lightgcn.py``'s.

It works in blocks of ``BLOCK`` arcs, each block's gathers recomputed in
the backward (``torch.utils.checkpoint``), so that no [E, d] tensor is
kept: at the cell's size it fits the card after the program's release.

Departures from the authors' code: the L2 is the port's (the authors'
``l2_loss`` of the batch's ego rows over B, with ``decay`` for their
``regs``); the edges' weights are not used (A starts at ones over the
observed arcs); a node without arcs gets degree 1 and keeps a zero row (the
authors' graphs have none); rows are normalized as ``x / max(‖x‖, 1e-12)``
(``tf.math.l2_normalize``: ``x / sqrt(max(‖x‖², 1e-12))``, the same but for
rows shorter than 1e-6); the last iteration's score update, which feeds
nothing, is not computed.

``quant`` (``precision.py``), the control: every table that the products
gather (x, and the score's two operands) rounded in its forward, its
gradient rounded in the backward. Planted faults: ``softmax_over="arcs"``
(S normalized over all arcs of an intent), ``tanh=False``,
``unrouted_degrees=True`` (every iteration's degrees those of ``S = 1/K``),
and T = 1 or ``cor_weight=0`` through the arguments.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .lightgcn import Adam, no_tf32

BLOCK = 1 << 20


class Arcs:
    """Both directions of the edges ``(u, i)`` (local item ids) as arcs
    ``(head, tail)`` in node space, sorted by (head, tail), on ``device``."""

    def __init__(self, u, i, n_users: int, n_items: int, device, quant=None):
        no_tf32()
        dev = torch.device(device)
        n = int(n_users) + int(n_items)
        u = torch.as_tensor(np.asarray(u, np.int64), device=dev)
        it = torch.as_tensor(np.asarray(i, np.int64), device=dev) + int(n_users)
        h, t = torch.cat([u, it]), torch.cat([it, u])
        order = torch.argsort(h * n + t)
        self.head, self.tail = h[order], t[order]
        self.n_users, self.n_items, self.n = int(n_users), int(n_items), n
        self.quant = quant

    def blocks(self):
        for lo in range(0, self.head.shape[0], BLOCK):
            yield lo, self.head[lo:lo + BLOCK], self.tail[lo:lo + BLOCK]


class _Round(torch.autograd.Function):
    """The control's rounding: the values in the forward, the gradient in
    the backward."""

    @staticmethod
    def forward(ctx, x, quant):
        ctx.quant = quant
        return quant.activations(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.quant.gradients(g), None


def gathered(x: torch.Tensor, arcs: Arcs) -> torch.Tensor:
    return x if arcs.quant is None else _Round.apply(x, arcs.quant)


def _route_block(s, x, h, t, n: int, k: int):
    msgs = (x[t].view(-1, k, x.shape[1] // k) * s[:, :, None]).view(-1, x.shape[1])
    return torch.zeros(n, x.shape[1], dtype=x.dtype, device=x.device).index_add(0, h, msgs)


def route(arcs: Arcs, s: torch.Tensor, x: torch.Tensor, k: int) -> torch.Tensor:
    """[N, d]: ``out[h, k-chunk] = Σ_{arcs of h} s[a, k] · x[t_a, k-chunk]``."""
    xr = gathered(x, arcs)
    out = None
    for lo, h, t in arcs.blocks():
        part = checkpoint(_route_block, s[lo:lo + len(h)], xr, h, t, arcs.n, k, use_reentrant=False)
        out = part if out is None else out + part
    return out


def _score_block(p, q, h, t, k: int):
    return (p[h] * q[t]).view(-1, k, p.shape[1] // k).sum(-1)


def score(arcs: Arcs, p: torch.Tensor, q: torch.Tensor, k: int) -> torch.Tensor:
    """[E, K]: ``⟨p[h_a, k-chunk], q[t_a, k-chunk]⟩``."""
    pr, qr = gathered(p, arcs), gathered(q, arcs)
    return torch.cat([checkpoint(_score_block, pr, qr, h, t, k, use_reentrant=False)
                      for _, h, t in arcs.blocks()])


def chunks(x: torch.Tensor, k: int) -> torch.Tensor:
    return x.view(x.shape[0], k, x.shape[1] // k)


def forward(arcs: Arcs, table: torch.Tensor, k: int, iterations: int, layers: int,
            softmax_over: str = "intents", tanh: bool = True, unrouted_degrees: bool = False):
    """``(final embedding [N, d], the last iteration's S [E, K])``."""
    x = table
    outs = [x]
    a = torch.ones(arcs.head.shape[0], k, dtype=x.dtype, device=x.device)
    s = None
    for layer in range(layers):
        for it in range(iterations):
            s = torch.softmax(a, dim=1 if softmax_over == "intents" else 0)
            weights = torch.full_like(s, 1.0 / k) if unrouted_degrees else s
            deg = torch.zeros(arcs.n, k, dtype=x.dtype, device=x.device).index_add(0, arcs.head, weights)
            dinv = torch.where(deg > 0, deg, torch.ones_like(deg)).rsqrt()
            xs = (chunks(x, k) * dinv[:, :, None]).view(x.shape)
            f = (chunks(route(arcs, s, xs, k), k) * dinv[:, :, None]).view(x.shape)
            if not (layer == layers - 1 and it == iterations - 1):
                hn = F.normalize(chunks(f, k), dim=-1).view(x.shape)
                tn = F.normalize(chunks(x, k), dim=-1).view(x.shape)
                a = a + score(arcs, hn, torch.tanh(tn) if tanh else tn, k)
        x = f
        outs.append(x)
    return torch.stack(outs, dim=1).mean(dim=1), s


def dcor(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """The authors' ``_create_distance_correlation``."""
    def centred(x):
        r = (x * x).sum(1, keepdim=True)
        d = torch.sqrt(torch.clamp(r - 2 * x @ x.T + r.T, min=0.0) + 1e-8)
        return d - d.mean(dim=0, keepdim=True) - d.mean(dim=1, keepdim=True) + d.mean()

    def cov(d1, d2):
        n = d1.shape[0]
        return torch.sqrt(torch.clamp((d1 * d2).sum() / (n * n), min=0.0) + 1e-8)

    d1, d2 = centred(x1), centred(x2)
    return cov(d1, d2) / (torch.sqrt(torch.clamp(cov(d1, d1) * cov(d2, d2), min=0.0)) + 1e-10)


def cor_term(final: torch.Tensor, arcs: Arcs, k: int, cor_batch: int, generator) -> torch.Tensor:
    dev = final.device
    users = torch.randperm(arcs.n_users, generator=generator, device=dev)[:cor_batch]
    items = torch.randperm(arcs.n_items, generator=generator, device=dev)[:cor_batch] + arcs.n_users
    parts = torch.tensor_split(final[torch.cat([users, items])], k, dim=1)
    return sum(dcor(parts[j], parts[j + 1]) for j in range(k - 1)) / ((k + 1) * k / 2)


def dgcf_loss(arcs, table, k, iterations, layers, users, pos, neg, decay, cor_weight, cor_batch, generator,
              **fault):
    """``(loss, cor term, last S)`` of one batch (node-space ids)."""
    final, s = forward(arcs, table, k, iterations, layers, **fault)
    u, p, n = final[users], final[pos], final[neg]
    bpr = F.softplus(-((u * p).sum(-1) - (u * n).sum(-1))).mean()
    sq = table[users].pow(2).sum() + table[pos].pow(2).sum() + table[neg].pow(2).sum()
    reg = decay * 0.5 * sq / users.shape[0]
    cor = cor_weight * cor_term(final, arcs, k, cor_batch, generator)
    return bpr + reg + cor, cor, s


def follow_steps(arcs: Arcs, table0: torch.Tensor, k: int, iterations: int, layers: int, batches, cor_states,
                 lr: float, decay: float, cor_weight: float, cor_batch: int, **fault) -> dict:
    """Train from ``table0`` on ``batches`` (``(users, pos, neg)`` node ids),
    step j's ``cor`` rows from a generator set to ``cor_states[j]``: each
    step's loss and ``cor`` term, the first step's gradient, its norm and its
    last S, and the norm of the table's change after the last step (f64
    norms). ``fault`` is :func:`forward`'s."""
    table = table0.clone()
    opt = Adam(lr)
    losses, cors, grad, routing = [], [], None, None
    for (users, pos, neg), state in zip(batches, cor_states):
        gen = torch.Generator(device=table.device)
        gen.set_state(state)
        leaf = table.detach().requires_grad_()
        loss, cor, s = dgcf_loss(arcs, leaf, k, iterations, layers, users, pos, neg, decay, cor_weight,
                                 cor_batch, gen, **fault)
        (g,) = torch.autograd.grad(loss, [leaf])
        if grad is None:
            grad, routing = g, s.detach()
        losses.append(float(loss.detach()))
        cors.append(float(cor.detach()))
        del loss, cor, s, leaf
        opt.step(table, g)
    return {"losses": losses, "cor": cors, "grad": grad, "grad_norm": float(grad.double().norm()),
            "change_norm": float((table - table0).double().norm()), "routing": routing}
