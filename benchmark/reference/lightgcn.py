"""Plain LightGCN in float32 PyTorch: the reference that decides ``correct``.

It imports nothing of the program. From the raw edges ``(u, i, w)`` that the
harness made it builds its own symmetrically normalized adjacency (degrees
summed in float64, ``w / sqrt(deg_u · deg_i)``, no self-loops), propagates
layer by layer, ``x_{l+1} = Â x_l``, and averages the layers with the weights
``1 / (L + 1)`` (He et al. 2020, eq. 8 and 9). On top of that: the BPR loss
with the ego embeddings' L2 term as the reference repository trains it,
gradients by autograd, Adam in optax's form, and scoring with the train
purchases masked and the top-K taken.

TF32 is off for every product here. ``quant``, where given, rounds every
operand of a product (the adjacency's values once, each layer's input, and
in the backward each layer's incoming gradient) to a lower precision
(``precision.py``): that is the control, the reference computed in the
precision below the configuration's.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F

warnings.filterwarnings("ignore", message="Sparse CSR tensor support is in beta state")


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Adjacency:
    """The normalized bipartite adjacency Â [N, N], N = users + items,
    symmetric, as a sparse CSR tensor on ``device``."""

    def __init__(self, u, i, w, n_users: int, n_items: int, device, quant=None):
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
        if quant is not None:
            vals = quant.weights(vals)
        rows, cols = torch.cat([u, it]), torch.cat([it, u])
        self.A = torch.sparse_coo_tensor(
            torch.stack([rows, cols]), torch.cat([vals, vals]), (n, n), check_invariants=False
        ).coalesce().to_sparse_csr()
        self.quant = quant

    def mm(self, x: torch.Tensor) -> torch.Tensor:
        return _Propagate.apply(x, self)


class _Propagate(torch.autograd.Function):
    """``Â x``; its gradient is ``Â g`` (Â is symmetric). With a ``quant``,
    ``x`` and ``g`` are rounded before their product."""

    @staticmethod
    def forward(ctx, x, adj):
        ctx.adj = adj
        if adj.quant is not None:
            x = adj.quant.activations(x)
        return torch.sparse.mm(adj.A, x)

    @staticmethod
    def backward(ctx, g):
        adj = ctx.adj
        if adj.quant is not None:
            g = adj.quant.gradients(g)
        return torch.sparse.mm(adj.A, g.contiguous()), None


def final_embedding(adj: Adjacency, table: torch.Tensor, layers: int) -> torch.Tensor:
    """The layer-averaged embedding [N, D] f32 of ``table``."""
    x = table.float()
    out = x / (layers + 1)
    for _ in range(layers):
        x = adj.mm(x)
        out = out + x / (layers + 1)
    return out


def bpr_loss(adj: Adjacency, table, layers: int, users, pos, neg, decay: float, keep: int | None = None):
    """BPR ``-mean(logsigmoid(s_pos - s_neg))`` on the final embeddings plus
    ``decay · 0.5 · (‖E[u]‖² + ‖E[p]‖² + ‖E[n]‖²) / B`` on the ego
    embeddings; node-space ids. ``keep`` takes only the first ``keep``
    triples (a planted fault: part of the batch left out)."""
    if keep is not None:
        users, pos, neg = users[:keep], pos[:keep], neg[:keep]
    out = final_embedding(adj, table, layers)
    u, p, n = out[users], out[pos], out[neg]
    bpr = -F.logsigmoid((u * p).sum(-1) - (u * n).sum(-1)).mean()
    sq = table[users].pow(2).sum() + table[pos].pow(2).sum() + table[neg].pow(2).sum()
    return bpr + decay * 0.5 * sq / users.shape[0]


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


def follow_steps(adj: Adjacency, table0: torch.Tensor, layers: int, batches, lr: float, decay: float,
                 keep: int | None = None) -> dict:
    """Train from ``table0`` on ``batches`` (``(users, pos, neg)`` node ids,
    one a step): each step's loss, the first step's gradient and its norm,
    and the norm of the table's change after the last step (f64 norms)."""
    table = table0.clone()
    opt = Adam(lr)
    losses, grad = [], None
    for users, pos, neg in batches:
        leaf = table.detach().requires_grad_()
        loss = bpr_loss(adj, leaf, layers, users, pos, neg, decay, keep)
        (g,) = torch.autograd.grad(loss, [leaf])
        if grad is None:
            grad = g
        losses.append(float(loss.detach()))
        opt.step(table, g)
    return {"losses": losses, "grad": grad, "grad_norm": float(grad.double().norm()),
            "change_norm": float((table - table0).double().norm())}


def purchase_rows(u, i, w, n_users: int):
    """Each user's purchases (weight 1.0), local item ids: ``(indptr,
    items)`` over all ``n_users`` users, items ascending in a row."""
    buy = np.asarray(w) == 1.0
    pu, pi = np.asarray(u)[buy].astype(np.int64), np.asarray(i)[buy].astype(np.int64)
    order = np.lexsort((pi, pu))
    indptr = np.zeros(n_users + 1, np.int64)
    np.add.at(indptr, pu + 1, 1)
    return np.cumsum(indptr), pi[order]


def top_k(final: torch.Tensor, n_users: int, users: np.ndarray, purchases, k: int, quant=None):
    """Scores of ``users`` against every item with each user's purchases at
    -inf: ``(scores [B, I] f32, the k best [B, k], their local item ids
    [B, k])``. With a ``quant``, both operands of the product are rounded
    first."""
    indptr, items = purchases
    dev = final.device
    ids = torch.as_tensor(users, dtype=torch.int64, device=dev)
    a, b = final[ids], final[n_users:]
    if quant is not None:
        a, b = quant.activations(a), quant.activations(b)
    scores = a @ b.T
    lens = indptr[users + 1] - indptr[users]
    rows = np.repeat(np.arange(len(users)), lens)
    starts = np.repeat(indptr[users], lens)
    cols = items[starts + (np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens, lens))]
    scores[torch.as_tensor(rows, device=dev), torch.as_tensor(cols, device=dev)] = float("-inf")
    vals, idx = scores.topk(k, dim=1)
    return scores, vals, idx
