"""DGCF: intent-aware routing over the whole graph, trained with BPR and a
distance-correlation term between adjacent intents.

Wang, Jin, Zhang, Chua, He, "Disentangled Graph Collaborative Filtering",
SIGIR 2020 (arXiv:2007.01764), as its authors' ``DGCF.py`` writes it
(``_create_star_routing_embed_with_P`` and
``_convert_A_values_to_A_factors_with_P`` in training mode, ``create_cor_loss``).
Each embedding is split into K intent chunks of ``c = d / K`` columns. Over
the graph's arcs of both directions, h the head (the row written) and t the
tail (the row read), x the layer's input and x_k its k-th chunk:

- a forward starts from ``A[a, k] = 1`` on every arc and intent (rebuilt
  every forward, not learned state), carried across layers;
- each layer runs T routing iterations over the same input x:
  ``S = softmax_k(A)`` per arc; ``deg_k(v) = Σ_{arcs with head v} S[a, k]``;
  ``f_k[h] = deg_k(h)^-½ · Σ_t S[(h, t), k] · deg_k(t)^-½ · x_k[t]``;
  ``A[(h, t), k] += ⟨normalize(f_k[h]), tanh(normalize(x_k[t]))⟩``;
- the layer's output is ``concat_k f_k`` of its last iteration; the final
  embedding is the mean of layers 0..L, the score an inner product;
- the loss is ``mean(softplus(−(s_pos − s_neg)))``, the L2
  ``decay · ½(‖u₀‖² + ‖p₀‖² + ‖n₀‖²) / B`` on the batch's layer-0 rows, and
  ``cor_weight · cor``: the distance correlation between intent chunks k and
  k + 1 (k = 0..K−2) of the final rows of ``cor_batch`` users and
  ``cor_batch`` items drawn uniformly without replacement, summed and
  divided by ``(K + 1)·K / 2``, in the authors' centred-distance form.

How the port computes it (``ops/routing.py``): A, S and the scores are
[E, K] f32 (arc-major); the degrees' two factors scale x's rows before the
routed product and its output rows after it, so the product's weights are S
itself; the product is the CUDA intent gather-sum, the score update the
blocked per-arc dot product, and autograd runs back through every
iteration, the softmax, the degrees and the tanh. The last iteration's
score update of the last layer feeds nothing (A is rebuilt by the next
forward), so it is skipped. A node without arcs keeps a zero row (its
degree is taken as 1; the authors' graphs have none). DGCF routes over the
observed arcs alone: the edges' weights are not used.

Draws: each step's ``cor`` rows are ``torch.randperm(n_users)[:cor_batch]``
then ``torch.randperm(n_items)[:cor_batch]`` from the generator the loss is
given; nothing else draws from it, so a reference replays a step's rows
from the generator's state before the step.

Spans (``tracing.py``): ``train.dgcf`` (the whole routing forward), its
children ``train.dgcf.iter`` (each iteration), each with
``train.dgcf.softmax``, ``train.dgcf.degree``, ``train.dgcf.spmm`` and, but
for the last, ``train.dgcf.score``; and ``train.dgcf.cor``. Counter:
``train.dgcf.routed_arcs``, arcs × intents routed, each iteration.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import divisor, mm_f32
from ..ops.routing import RoutingGraph, intent_degree, intent_sddmm, intent_softmax, intent_spmm
from ..tracing import count, span
from .losses import bpr_loss, reg_loss


def _chunks(x: torch.Tensor, k: int) -> torch.Tensor:
    """[N, d] as [N, K, d / K]."""
    return x.view(x.shape[0], k, x.shape[1] // k)


def routing_iteration(x: torch.Tensor, a: torch.Tensor, rg: RoutingGraph, k: int,
                      gather_dtype: torch.dtype | None, score: bool) -> tuple:
    """One routing iteration over the layer input ``x`` [N, d] and the
    scores ``a`` [E, K]: ``(f [N, d] f32, S [E, K], the updated scores)``;
    with ``score`` False the scores are returned as they came."""
    with span("train.dgcf.iter"):
        count("train.dgcf.routed_arcs", rg.n_arcs * k)
        with span("train.dgcf.softmax"):
            s = intent_softmax(a)
        with span("train.dgcf.degree"):
            deg = intent_degree(s, rg)
            dinv = deg.masked_fill(deg == 0, 1.0).rsqrt()[:, :, None]
        with span("train.dgcf.spmm"):
            xs = (_chunks(x, k) * dinv).view(x.shape)
            f = (_chunks(intent_spmm(s, xs, rg, gather_dtype), k) * dinv).view(x.shape)
        if score:
            with span("train.dgcf.score"):
                head = F.normalize(_chunks(f, k), dim=-1).view(x.shape)
                tail = torch.tanh(F.normalize(_chunks(x, k), dim=-1)).view(x.shape)
                a = a + intent_sddmm(head, tail, rg, k, gather_dtype)
    return f, s, a


def dgcf_forward(table: torch.Tensor, rg: RoutingGraph, n_factors: int, n_iterations: int,
                 num_layers: int, gather_dtype: torch.dtype | None = None) -> tuple:
    """``(final embedding [N, d] f32, the last iteration's S [E, K])`` of the
    [N, d] ``table`` (layers 0..L averaged), its rows gathered in
    ``gather_dtype`` (f32 when None)."""
    k = n_factors
    with span("train.dgcf"):
        a = torch.ones(rg.n_arcs, k, dtype=torch.float32, device=table.device)
        x = table.float()
        total, s = x, None
        for layer in range(num_layers):
            for it in range(n_iterations):
                last = layer == num_layers - 1 and it == n_iterations - 1
                f, s, a = routing_iteration(x, a, rg, k, gather_dtype, score=not last)
            x = f
            total = total + x
        return total / divisor(num_layers + 1, table.device), s


def centred_distance(x: torch.Tensor) -> torch.Tensor:
    """The authors' doubly centred distance matrix of the rows of ``x``,
    ``sqrt(max(‖x_i‖² − 2 x_i·x_j + ‖x_j‖², 0) + 1e-8)``."""
    r = x.pow(2).sum(1, keepdim=True)
    d = torch.sqrt(torch.clamp(r - 2 * mm_f32(x, x.T) + r.T, min=0.0) + 1e-8)
    return d - d.mean(0, keepdim=True) - d.mean(1, keepdim=True) + d.mean()


def distance_correlation(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """``dcov₁₂ / (sqrt(dcov₁₁·dcov₂₂) + 1e-10)``, each ``dcov`` the authors'
    ``sqrt(max(Σ D₁·D₂ / n², 0) + 1e-8)``."""
    d1, d2 = centred_distance(x1), centred_distance(x2)
    n2 = float(x1.shape[0]) ** 2
    dcov = lambda a, b: torch.sqrt(torch.clamp((a * b).sum() / n2, min=0.0) + 1e-8)
    return dcov(d1, d2) / (torch.sqrt(torch.clamp(dcov(d1, d1) * dcov(d2, d2), min=0.0)) + 1e-10)


def cor_loss(rows: torch.Tensor, n_factors: int) -> torch.Tensor:
    """Σ_k dcor(chunk k, chunk k+1) of ``rows`` [2·cor_batch, d], over
    ``(K + 1)·K / 2``."""
    parts = rows.split(rows.shape[1] // n_factors, dim=1)
    total = sum(distance_correlation(parts[k], parts[k + 1]) for k in range(n_factors - 1))
    return total / ((n_factors + 1) * n_factors / 2)


def cor_rows(n_users: int, n_items: int, cor_batch: int, generator: torch.Generator) -> torch.Tensor:
    """[2·cor_batch] node ids: ``cor_batch`` users, then ``cor_batch`` items,
    each drawn uniformly without replacement (one ``randperm`` each)."""
    dev = generator.device
    users = torch.randperm(n_users, generator=generator, device=dev)[:cor_batch]
    items = torch.randperm(n_items, generator=generator, device=dev)[:cor_batch] + n_users
    return torch.cat([users, items])


def make_dgcf_loss_fn(
    n_factors: int,
    n_iterations: int,
    num_layers: int,
    decay: float,
    cor_weight: float,
    cor_batch: int,
    generator: torch.Generator,
    gather_dtype: torch.dtype | None = None,
):
    """``loss_fn(params, rg, users, pos, neg) -> (loss, (bpr, reg,
    dropped))`` in ``train.step.make_loss_fn``'s form, for
    ``make_train_fns(loss_fn=...)``, ``rg`` a :class:`RoutingGraph`: BPR and
    the L2 on the batch's rows of the full routed forward plus
    ``cor_weight · cor`` over rows that ``generator`` draws. ``loss - bpr -
    reg`` is the ``cor`` term."""

    def loss_fn(params, rg, users, pos, neg):
        table = params["embedding"]
        with span("train.forward"):
            final, _ = dgcf_forward(table, rg, n_factors, n_iterations, num_layers, gather_dtype)
        with span("train.loss"):
            u, p, n = final[users], final[pos], final[neg]
            bpr = bpr_loss((u * p).sum(-1), (u * n).sum(-1))
            reg = reg_loss(table, users, pos, neg, decay)
        with span("train.dgcf.cor"):
            ids = cor_rows(rg.n_users, rg.n_items, cor_batch, generator)
            cor = cor_loss(final[ids], n_factors)
        dropped = torch.zeros((), dtype=torch.int64, device=users.device)
        return bpr + reg + cor_weight * cor, (bpr, reg, dropped)

    return loss_fn


def authors_cor_batch(n_users: int, n_items: int, n_train: int, batch_size: int) -> int:
    """The authors' ``cor_batch_size``: ``int(max(n_users, n_items) /
    n_batch)`` with ``n_batch = n_train // batch_size + 1``."""
    return int(max(n_users, n_items) / (n_train // batch_size + 1))
