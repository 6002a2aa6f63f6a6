"""Plain DGCF in float32 PyTorch, the reference of ``tests/test_torch_dgcf.py``.

Wang et al., "Disentangled Graph Collaborative Filtering", SIGIR 2020
(arXiv:2007.01764), written from its equations as the authors' ``DGCF.py``
computes them in training mode (``_create_star_routing_embed_with_P``,
``_convert_A_values_to_A_factors_with_P`` with ``pick`` off,
``create_cor_loss``). It imports no JAX, nothing of ``gnn_ecommerce_tpu``
and nothing of the port; TF32 is off. Arcs are both directions of each
edge, ``(h, t)`` with h the head (the row written) and t the tail (the row
read), sorted by (h, t); A, S and the scores are [E, K].

- A forward starts from ``A = 1``; each layer runs T iterations over its
  input x: ``S = softmax_k(A)``, ``deg_k(v) = Σ_{arcs with head v} S``,
  ``f_k[h] = deg_k(h)^-½ Σ_t S·deg_k(t)^-½·x_k[t]``, ``A += ⟨normalize(f_k[h]),
  tanh(normalize(x_k[t]))⟩``; the layer's output is the last ``f``; the
  final embedding the mean of layers 0..L.
- The loss: ``mean(softplus(−(s_pos − s_neg)))``, ``decay · ½(‖u₀‖² + ‖p₀‖²
  + ‖n₀‖²) / B`` and ``cor_weight · cor``, ``cor`` the distance correlation
  of adjacent intent chunks of the final rows of the users and items drawn
  by ``torch.randperm(n_users)[:cor_batch]`` and ``torch.randperm(n_items)
  [:cor_batch]`` from the generator it is given, over ``(K + 1)·K / 2``.
  The gradient is autograd's; Adam is optax's form.

Departures from the authors' code: the L2 is the port's (on the batch's
layer-0 rows, as the authors' ``l2_loss`` of the ego rows over B, with
``decay`` in the place of their ``regs``); a node without arcs gets degree 1
and keeps a zero row (the authors' graphs have none); rows are normalized
as ``x / max(‖x‖, 1e-12)`` (``tf.math.l2_normalize``: ``x / sqrt(max(‖x‖²,
1e-12))``; the two differ only for rows shorter than 1e-6); the last
iteration's score update, which feeds nothing, is not computed.

Planted faults, for the tests: ``softmax_over="arcs"`` (S normalized over
all arcs of an intent), ``tanh=False``, ``unrouted_degrees=True`` (every
iteration's degrees those of ``S = 1/K``), and ``T=1`` or ``cor_weight=0``
through the arguments.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Arcs:
    """Both directions of the edges ``(u, i)`` (local item ids) as arcs
    ``(head, tail)`` in node space, sorted by (head, tail)."""

    def __init__(self, u, i, n_users: int, n_items: int, device="cpu"):
        no_tf32()
        u = np.asarray(u, np.int64)
        it = np.asarray(i, np.int64) + n_users
        h, t = np.concatenate([u, it]), np.concatenate([it, u])
        n = n_users + n_items
        order = np.argsort(h * n + t, kind="stable")
        self.head = torch.as_tensor(h[order], device=device)
        self.tail = torch.as_tensor(t[order], device=device)
        self.n_users, self.n_items, self.n = n_users, n_items, n


def chunks(x, k):
    return x.view(x.shape[0], k, x.shape[1] // k)


def forward(arcs: Arcs, table, K: int, T: int, L: int, softmax_over: str = "intents", tanh: bool = True,
            unrouted_degrees: bool = False):
    """``(final embedding [N, d], the last iteration's S [E, K])``."""
    e, n = arcs.head.shape[0], arcs.n
    x = table
    layers = [x]
    a = torch.ones(e, K, dtype=x.dtype, device=x.device)
    s = None
    for layer in range(L):
        for it in range(T):
            s = torch.softmax(a, dim=1 if softmax_over == "intents" else 0)
            weights = torch.full_like(s, 1.0 / K) if unrouted_degrees else s
            deg = torch.zeros(n, K, dtype=x.dtype, device=x.device).index_add(0, arcs.head, weights)
            dinv = torch.where(deg > 0, deg, torch.ones_like(deg)).rsqrt()
            msgs = chunks(x[arcs.tail], K) * (s * dinv[arcs.head] * dinv[arcs.tail])[:, :, None]
            f = torch.zeros(n, K, x.shape[1] // K, dtype=x.dtype, device=x.device).index_add(0, arcs.head, msgs)
            f = f.view(n, -1)
            if not (layer == L - 1 and it == T - 1):
                hn = F.normalize(chunks(f, K), dim=-1)
                tn = F.normalize(chunks(x, K), dim=-1)
                tn = torch.tanh(tn) if tanh else tn
                a = a + (hn[arcs.head] * tn[arcs.tail]).sum(-1)
        x = f
        layers.append(x)
    return torch.stack(layers, dim=1).mean(dim=1), s


def dcor(x1, x2):
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


def cor_term(final, arcs: Arcs, K: int, cor_batch: int, generator):
    dev = final.device
    users = torch.randperm(arcs.n_users, generator=generator, device=dev)[:cor_batch]
    items = torch.randperm(arcs.n_items, generator=generator, device=dev)[:cor_batch] + arcs.n_users
    parts = torch.tensor_split(final[torch.cat([users, items])], K, dim=1)
    return sum(dcor(parts[k], parts[k + 1]) for k in range(K - 1)) / ((K + 1) * K / 2)


def dgcf_loss(arcs: Arcs, table, K, T, L, users, pos, neg, decay, cor_weight, cor_batch, generator, **fault):
    """``(loss, bpr, reg, cor term, last S)`` of one batch (node ids)."""
    final, s = forward(arcs, table, K, T, L, **fault)
    u, p, n = final[users], final[pos], final[neg]
    bpr = F.softplus(-((u * p).sum(-1) - (u * n).sum(-1))).mean()
    sq = table[users].pow(2).sum() + table[pos].pow(2).sum() + table[neg].pow(2).sum()
    reg = decay * 0.5 * sq / users.shape[0]
    cor = cor_weight * cor_term(final, arcs, K, cor_batch, generator)
    return bpr + reg + cor, bpr, reg, cor, s


def adam_step(table, g, m, v, t, lr, b1=0.9, b2=0.999, eps=1e-8):
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    table = table - lr * (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt() + eps)
    return table, m, v


def follow_steps(arcs, table0, K, T, L, batches, states, lr, decay, cor_weight, cor_batch, **fault) -> dict:
    """Train from ``table0`` on ``batches``, step k's ``cor`` rows from a
    generator set to ``states[k]``: each step's loss and ``cor`` term, the
    first gradient, the first step's last S and the table after the last
    step."""
    table = table0.clone()
    m = v = torch.zeros_like(table)
    losses, cors, grad, routing = [], [], None, None
    for step, ((users, pos, neg), state) in enumerate(zip(batches, states), start=1):
        gen = torch.Generator(device=table.device)
        gen.set_state(state)
        leaf = table.detach().requires_grad_()
        loss, _, _, cor, s = dgcf_loss(arcs, leaf, K, T, L, users, pos, neg, decay, cor_weight, cor_batch,
                                       gen, **fault)
        (g,) = torch.autograd.grad(loss, [leaf])
        if grad is None:
            grad, routing = g, s.detach()
        losses.append(float(loss.detach()))
        cors.append(float(cor.detach()))
        table, m, v = adam_step(table, g, m, v, step, lr)
    return {"losses": losses, "cor": cors, "grad": grad, "routing": routing, "table": table}
