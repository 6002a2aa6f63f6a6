"""Plain SimGCL in float32 PyTorch, the reference of ``tests/test_torch_simgcl.py``.

Yu et al., SIGIR 2022 (arXiv:2112.08679), as SELFRec's ``model/graph/
SimGCL.py`` and ``util/loss_torch.py`` write it, over a sparse normalized
adjacency built here from the raw edges. It imports no JAX, nothing of
``gnn_ecommerce_tpu`` and nothing of the port; TF32 is off.

- The clean view: ``E^(l) = Â E^(l-1)``, the mean of layers 1..L.
- A perturbed view: ``E'^(l) = Â E'^(l-1) + sign(Â E'^(l-1)) ·
  normalize_rows(U) · ε`` with one ``torch.rand((N, d))`` draw U a layer,
  the mean of layers 1..L. A step draws view 1's layers 1..L, then view 2's,
  from the one generator it is given.
- InfoNCE over ``torch.unique`` of the batch's users and of its positives.
- The loss: BPR on the clean view, ``λ·(InfoNCE_users + InfoNCE_items)``
  and the L2, differentiated by autograd; Adam in optax's form.

Departures from SELFRec, each the port's:
- Â is the weighted adjacency, ``w / sqrt(deg_u · deg_i)`` with weighted
  degrees (SELFRec's interactions are unweighted);
- BPR is ``-mean(logsigmoid(s_pos - s_neg))``, without SELFRec's ``1e-5``
  inside the log;
- the L2 is ``decay · 0.5 · (‖E0[u]‖² + ‖E0[p]‖² + ‖E0[n]‖²) / B`` on the
  batch's layer-0 rows (SELFRec: ``reg · Σ ‖row‖ / B`` over the propagated
  batch rows).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Adjacency:
    """Â [N, N] of the edges ``(u, i, w)`` (local item ids), N = users +
    items, symmetric, sparse; degrees summed in float64."""

    def __init__(self, u, i, w, n_users: int, n_items: int, device="cpu"):
        no_tf32()
        dev = torch.device(device)
        self.n_users, self.n_items = int(n_users), int(n_items)
        n = self.n_users + self.n_items
        u = torch.as_tensor(np.asarray(u, np.int64), device=dev)
        it = torch.as_tensor(np.asarray(i, np.int64), device=dev) + self.n_users
        w64 = torch.as_tensor(np.asarray(w, np.float64), device=dev)
        deg = torch.zeros(n, dtype=torch.float64, device=dev)
        deg.index_add_(0, u, w64).index_add_(0, it, w64)
        inv = torch.where(deg > 0, deg.rsqrt(), torch.zeros_like(deg))
        vals = (w64 * inv[u] * inv[it]).float()
        self.A = torch.sparse_coo_tensor(
            torch.stack([torch.cat([u, it]), torch.cat([it, u])]), torch.cat([vals, vals]), (n, n),
            check_invariants=False,
        ).coalesce()

    def mm(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sparse.mm(self.A, x)


def layers(adj: Adjacency, table: torch.Tensor, num_layers: int, eps: float = 0.0, generator=None) -> list:
    """``[E^(0), …, E^(L)]``; with a ``generator``, each layer 1..L noised
    with one draw from it."""
    out = [table]
    x = table
    for _ in range(num_layers):
        x = adj.mm(x)
        if generator is not None:
            noise = torch.rand(x.shape, generator=generator, dtype=torch.float32, device=x.device)
            x = x + torch.sign(x) * F.normalize(noise, dim=-1) * eps
        out.append(x)
    return out


def clean_embedding(adj: Adjacency, table: torch.Tensor, num_layers: int) -> torch.Tensor:
    """The clean view [N, D]: the mean of layers 1..L."""
    return torch.stack(layers(adj, table, num_layers)[1:], dim=1).mean(dim=1)


def perturbed_embedding(adj, table, num_layers: int, eps: float, generator) -> torch.Tensor:
    """One perturbed view [N, D]: the mean of its noised layers 1..L."""
    return torch.stack(layers(adj, table, num_layers, eps, generator)[1:], dim=1).mean(dim=1)


def info_nce(view1: torch.Tensor, view2: torch.Tensor, temp: float) -> torch.Tensor:
    """SELFRec's ``InfoNCE(view1, view2, temp)`` with cosine scores."""
    view1, view2 = F.normalize(view1, dim=1), F.normalize(view2, dim=1)
    score = torch.diag(F.log_softmax(view1 @ view2.T / temp, dim=1))
    return -score.mean()


def simgcl_loss(adj, table, num_layers, users, pos, neg, decay, cl_weight, eps, temp, generator):
    """``(loss, bpr, reg, cl)`` of one batch (node-space ids); ``cl`` is the
    contrastive term ``λ·(InfoNCE_users + InfoNCE_items)``."""
    out = clean_embedding(adj, table, num_layers)
    u, p, n = out[users], out[pos], out[neg]
    bpr = -F.logsigmoid((u * p).sum(-1) - (u * n).sum(-1)).mean()
    sq = table[users].pow(2).sum() + table[pos].pow(2).sum() + table[neg].pow(2).sum()
    reg = decay * 0.5 * sq / users.shape[0]
    v1 = perturbed_embedding(adj, table, num_layers, eps, generator)
    v2 = perturbed_embedding(adj, table, num_layers, eps, generator)
    u_idx, i_idx = torch.unique(users), torch.unique(pos)
    cl = cl_weight * (info_nce(v1[u_idx], v2[u_idx], temp) + info_nce(v1[i_idx], v2[i_idx], temp))
    return bpr + reg + cl, bpr, reg, cl


class Adam:
    """optax's ``adam(lr)``: b1 0.9, b2 0.999, eps 1e-8, bias-corrected."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.t = 0
        self.m = self.v = None

    @torch.no_grad()
    def step(self, p: torch.Tensor, g: torch.Tensor) -> None:
        if self.m is None:
            self.m, self.v = torch.zeros_like(p), torch.zeros_like(p)
        self.t += 1
        self.m = self.b1 * self.m + (1 - self.b1) * g
        self.v = self.b2 * self.v + (1 - self.b2) * g * g
        m_hat = self.m / (1 - self.b1 ** self.t)
        v_hat = self.v / (1 - self.b2 ** self.t)
        p -= self.lr * m_hat / (v_hat.sqrt() + self.eps)


def follow_steps(adj, table0, num_layers, batches, noise_states, lr, decay, cl_weight, eps, temp) -> dict:
    """Train from ``table0`` on ``batches`` (``(users, pos, neg)`` node ids),
    step k's noise drawn from a generator set to ``noise_states[k]``: each
    step's loss and contrastive term, the first step's gradient, and the
    table after the last step."""
    table = table0.clone()
    opt = Adam(lr)
    losses, cls, grad = [], [], None
    for (users, pos, neg), state in zip(batches, noise_states):
        gen = torch.Generator(device=table.device)
        gen.set_state(state)
        leaf = table.detach().requires_grad_()
        loss, _, _, cl = simgcl_loss(adj, leaf, num_layers, users, pos, neg, decay, cl_weight, eps, temp, gen)
        (g,) = torch.autograd.grad(loss, [leaf])
        grad = g if grad is None else grad
        losses.append(float(loss.detach()))
        cls.append(float(cl.detach()))
        opt.step(table, g)
    return {"losses": losses, "cl": cls, "grad": grad, "table": table}
