"""Plain SimGCL in float32 PyTorch: the reference that decides ``correct`` in
the SimGCL cells.

Yu et al., SIGIR 2022 (arXiv:2112.08679), as SELFRec's ``model/graph/
SimGCL.py`` and ``util/loss_torch.py`` write it. It imports nothing of the
program: the normalized adjacency (``Â``, with its ``quant`` for the control)
and Adam are ``lightgcn.py``'s, TF32 is off.

- The clean view: ``E^(l) = Â E^(l-1)``, the mean of layers 1..L.
- A perturbed view: ``E'^(l) = Â E'^(l-1) + sign(Â E'^(l-1)) ·
  normalize_rows(U) · ε`` with one ``torch.rand((N, d))`` f32 draw U a
  layer, the mean of layers 1..L. A step draws view 1's layers 1..L, then
  view 2's, from one generator set to the program's state before that step.
- InfoNCE over ``torch.unique`` of the batch's users and of its positives,
  ``−mean_i log softmax_j(â_i·b̂_j / τ)[i]`` on unit rows.
- The loss: BPR on the clean view, ``λ·(InfoNCE_users + InfoNCE_items)``
  and the L2, differentiated by autograd.

Departures from SELFRec, each the program's: the weighted adjacency
(``w / sqrt(deg_u · deg_i)``, weighted degrees); BPR as
``-mean(logsigmoid(s_pos - s_neg))``, without SELFRec's ``1e-5`` inside the
log; the L2 as ``decay · 0.5 · (‖E0[u]‖² + ‖E0[p]‖² + ‖E0[n]‖²) / B`` on the
batch's layer-0 rows (SELFRec: ``reg · Σ ‖row‖ / B`` on the propagated
rows).

Planted faults, for the controls: ``eps=0`` (no noise), ``unique=False``
(InfoNCE over all B rows, duplicates kept) and ``with_layer0=True`` (layer 0
in every mean, ``1/(L+1)`` each).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .lightgcn import Adam, Adjacency  # noqa: F401  (Adjacency: the callers' graph)


def layers(adj: Adjacency, table, num_layers: int, eps: float = 0.0, generator=None) -> list:
    """``[E^(0), …, E^(L)]``; with a ``generator``, layers 1..L noised, one
    draw from it each."""
    out = [table]
    x = table
    for _ in range(num_layers):
        x = adj.mm(x)
        if generator is not None:
            noise = torch.rand(x.shape, generator=generator, dtype=torch.float32, device=x.device)
            x = x + torch.sign(x) * F.normalize(noise, dim=-1) * eps
        out.append(x)
    return out


def mean_of(ls: list, with_layer0: bool = False) -> torch.Tensor:
    """The mean of layers 1..L, or with ``with_layer0`` of 0..L."""
    return torch.stack(ls if with_layer0 else ls[1:], dim=1).mean(dim=1)


def clean_embedding(adj, table, num_layers: int, with_layer0: bool = False) -> torch.Tensor:
    return mean_of(layers(adj, table.float(), num_layers), with_layer0)


def info_nce(view1: torch.Tensor, view2: torch.Tensor, temp: float) -> torch.Tensor:
    """SELFRec's ``InfoNCE(view1, view2, temp)`` with cosine scores."""
    view1, view2 = F.normalize(view1, dim=1), F.normalize(view2, dim=1)
    return -torch.diag(F.log_softmax(view1 @ view2.T / temp, dim=1)).mean()


def simgcl_loss(adj, table, num_layers, users, pos, neg, decay, cl_weight, eps, temp, generator,
                unique: bool = True, with_layer0: bool = False):
    """``(loss, cl)`` of one batch (node-space ids), ``cl`` the contrastive
    term ``λ·(InfoNCE_users + InfoNCE_items)``."""
    out = clean_embedding(adj, table, num_layers, with_layer0)
    u, p, n = out[users], out[pos], out[neg]
    bpr = -F.logsigmoid((u * p).sum(-1) - (u * n).sum(-1)).mean()
    sq = table[users].pow(2).sum() + table[pos].pow(2).sum() + table[neg].pow(2).sum()
    reg = decay * 0.5 * sq / users.shape[0]
    del out, u, p, n
    views = [mean_of(layers(adj, table, num_layers, eps, generator), with_layer0) for _ in range(2)]
    u_idx, i_idx = (torch.unique(users), torch.unique(pos)) if unique else (users, pos)
    cl = cl_weight * (info_nce(views[0][u_idx], views[1][u_idx], temp)
                      + info_nce(views[0][i_idx], views[1][i_idx], temp))
    return bpr + reg + cl, cl


def follow_steps(adj, table0, num_layers: int, batches, noise_states, lr: float, decay: float,
                 cl_weight: float, eps: float, temp: float, **fault) -> dict:
    """Train from ``table0`` on ``batches`` (``(users, pos, neg)`` node ids),
    step k's noise from a generator set to ``noise_states[k]``: each step's
    loss and contrastive term, the first step's gradient and its norm, and
    the norm of the table's change after the last step (f64 norms).
    ``fault`` is ``simgcl_loss``'s ``unique`` or ``with_layer0``."""
    table = table0.clone()
    opt = Adam(lr)
    losses, cls, grad = [], [], None
    for (users, pos, neg), state in zip(batches, noise_states):
        gen = torch.Generator(device=table.device)
        gen.set_state(state)
        leaf = table.detach().requires_grad_()
        loss, cl = simgcl_loss(adj, leaf, num_layers, users, pos, neg, decay, cl_weight, eps, temp, gen, **fault)
        (g,) = torch.autograd.grad(loss, [leaf])
        grad = g if grad is None else grad
        losses.append(float(loss.detach()))
        cls.append(float(cl.detach()))
        del loss, cl, leaf
        opt.step(table, g)
    return {"losses": losses, "cl": cls, "grad": grad, "grad_norm": float(grad.double().norm()),
            "change_norm": float((table - table0).double().norm())}
