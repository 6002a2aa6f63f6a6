"""SimGCL: LightGCN's BPR step with two noised full-graph views and InfoNCE.

Yu et al., "Are Graph Augmentations Necessary? Simple Graph Contrastive
Learning for Recommendation", SIGIR 2022 (arXiv:2112.08679), as its authors'
SELFRec implements it (``model/graph/SimGCL.py``, ``util/loss_torch.py``).
Over the normalized bipartite adjacency Â:

- the clean view, which scores and trains BPR, is LightGCN with the layer
  weights ``[0, 1/L, …, 1/L]`` (:func:`simgcl_alphas`): the mean of layers
  1..L, layer 0 left out;
- a perturbed view runs ``E'^(l) = Â E'^(l-1) + ε·sign(Â E'^(l-1)) ⊙
  normalize_rows(U)`` for l = 1..L, U ~ Uniform(0, 1) of the whole table's
  shape, and takes the mean of its layers 1..L; the noise carries no
  gradient;
- the loss is ``BPR(clean) + L2 + λ·[InfoNCE_τ(users) + InfoNCE_τ(items)]``,
  the user term over the batch's unique users and the item term over its
  unique positive items, between two views of independent draws:
  ``InfoNCE_τ(a, b) = −mean_i log softmax_j(â_i·b̂_j / τ)[i]`` with â, b̂
  the rows scaled to unit length.

The clean term is the LightGCN step's own (``train.step.make_loss_fn`` over
``ops.bipartite.fast_batch_embeddings``: BPR and the L2 on the batch's
layer-0 rows, where SELFRec puts its norm on the propagated batch rows).
The views cannot take B_ii's fold, since the noise depends on each layer's
values: each layer is ``fast_to_users`` and ``fast_to_items`` of the
previous one over every node, and autograd runs back through all of them.

Noise draws: each layer of each view draws one ``torch.rand((N, d))`` f32
from the generator the loss is given, in this order: view 1 layers 1..L,
then view 2 layers 1..L. Nothing else draws from it, so a reference replays
a step's noise from the generator's state before the step.

InfoNCE over unique ids without a host sync: the batch's B ids are sorted
on the device and the first of each run of equal ids is marked. The mark
takes duplicates out of the softmax's columns and out of the mean over
rows, at fixed shapes ([B, B] logits).

Spans (``tracing.py``): ``train.cl`` (the whole contrastive term), its
children ``train.cl.view`` (each view's forward, 2 a step) with
``train.cl.noise`` (each layer's draw and add), and ``train.cl.infonce``
(both InfoNCE terms). Counters: ``train.cl.noised_rows`` (rows noised) and
``train.cl.view_arcs`` (arcs the views' sparse products traverse, both
directions), both from the host's arc lists.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.bipartite import FastBipartite, fast_batch_embeddings, fast_to_items, fast_to_users
from ..tracing import count, span
from .lightgcn import LightGCNConfig


def simgcl_alphas(num_layers: int) -> tuple:
    """SimGCL's layer weights ``(0, 1/L, …, 1/L)``: the mean of layers 1..L."""
    return (0.0,) + (1.0 / num_layers,) * num_layers


def noise_draw(n: int, dim: int, generator: torch.Generator, eps: float, device) -> torch.Tensor:
    """One [n, dim] f32 ``torch.rand`` draw from ``generator``, each row
    scaled to length ``eps``: ``ε·normalize_rows(U)``."""
    r = torch.rand((n, dim), generator=generator, dtype=torch.float32, device=device)
    return F.normalize(r, dim=1).mul_(eps)


def noise_add(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """``x + sign(x)·noise``; the noise carries no gradient."""
    return torch.addcmul(x, x.detach().sign(), noise)


def perturbed_view(
    table: torch.Tensor,
    fb: FastBipartite,
    num_layers: int,
    eps: float,
    generator: torch.Generator,
    user_ids: torch.Tensor,
    item_ids: torch.Tensor,
) -> tuple:
    """One perturbed view's final rows at ``user_ids`` (user ids) and
    ``item_ids`` (local item ids): ``(users [n, D], items [m, D])``, each the
    mean of the view's layers 1..L, f32. Each layer propagates the unified
    [N, D] table through ``fast_to_users`` / ``fast_to_items`` and adds the
    noise of one [N, D] draw (its user rows first, as in the table)."""
    if fb.fops is None:
        raise ValueError("the perturbed views need the fast plans (build_fast_bipartite(fast_ops=True))")
    n_users = fb.n_users
    arcs = len(fb.split.ui_src_user) + len(fb.split.iu_src_item)
    x_u, x_i = table[:n_users], table[n_users:]
    rows_u = rows_i = 0.0
    with span("train.cl.view"):
        for _ in range(num_layers):
            x_u, x_i = fast_to_users(x_i, fb.fops), fast_to_items(x_u, fb.fops)
            with span("train.cl.noise"):
                with torch.no_grad():
                    noise = noise_draw(table.shape[0], table.shape[1], generator, eps, table.device)
                x_u, x_i = noise_add(x_u, noise[:n_users]), noise_add(x_i, noise[n_users:])
            count("train.cl.noised_rows", table.shape[0])
            count("train.cl.view_arcs", arcs)
            rows_u = rows_u + x_u[user_ids]
            rows_i = rows_i + x_i[item_ids]
    return rows_u / num_layers, rows_i / num_layers


def first_of_runs(ids: torch.Tensor) -> tuple:
    """``(sorted ids, mask)``: ``mask[k]`` marks the first of each run of
    equal sorted ids, so the marked ids are the unique ones, once each."""
    s = torch.sort(ids).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    return s, first


def info_nce_unique(a: torch.Tensor, b: torch.Tensor, first: torch.Tensor, temp: float) -> torch.Tensor:
    """InfoNCE between the rows of ``a`` and ``b`` [B, D] (row k of each the
    same id) over the rows that ``first`` marks: each marked row's positive
    is its own row of ``b``, its negatives the other marked rows of ``b``;
    unmarked rows and columns are left out. Fixed shapes, no host sync."""
    a, b = F.normalize(a, dim=1), F.normalize(b, dim=1)
    logits = (a @ b.T / temp).masked_fill(~first[None, :], float("-inf"))
    diag = torch.log_softmax(logits, dim=1).diagonal()
    return -torch.where(first, diag, 0.0).sum() / first.sum().float()


def make_simgcl_loss_fn(
    cfg: LightGCNConfig,
    decay: float,
    cl_weight: float,
    eps: float,
    temp: float,
    edge_cap: int,
    generator: torch.Generator,
):
    """``loss_fn(params, fb, users, pos, neg) -> (loss, (bpr, reg,
    dropped))`` in ``train.step.make_loss_fn``'s form, for
    ``make_train_fns(loss_fn=...)``: ``make_loss_fn``'s clean LightGCN term
    over ``fast_batch_embeddings`` (``cfg``'s layer weights, made once on
    ``generator``'s device, the table's; :func:`simgcl_alphas` for SimGCL)
    plus ``cl_weight`` times both InfoNCE terms between two perturbed views,
    whose noise ``generator`` draws. ``loss - bpr - reg`` is the contrastive
    term."""
    from ..train.step import make_loss_fn  # the train package imports this module

    L = cfg.num_layers
    alpha = cfg.alphas(generator.device)
    batch_embed = lambda p, fb_, u, po, ne: fast_batch_embeddings(
        p, fb_, L, u, po, ne, edge_cap=edge_cap, alpha=alpha
    )
    clean_fn = make_loss_fn(cfg, decay, batch_embed_fn=batch_embed)

    def loss_fn(params, fb, users, pos, neg):
        loss, aux = clean_fn(params, fb, users, pos, neg)
        with span("train.cl"):
            su, first_u = first_of_runs(users)
            sp, first_p = first_of_runs(pos)
            sp = sp - fb.n_users
            views = [perturbed_view(params["embedding"], fb, L, eps, generator, su, sp) for _ in range(2)]
            with span("train.cl.infonce"):
                cl = info_nce_unique(views[0][0], views[1][0], first_u, temp)
                cl = cl + info_nce_unique(views[0][1], views[1][1], first_p, temp)
        return loss + cl_weight * cl, aux

    return loss_fn
