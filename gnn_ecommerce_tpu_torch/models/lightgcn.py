"""LightGCN as plain functions over a params dict ``{"embedding": [N, D]}``.

Counterpart of ``gnn_ecommerce_tpu/models/lightgcn.py``: the config, the
Xavier-uniform init, the layered alpha-weighted embedding (differentiable
through ``ops/propagate.py``), pair scores, the full forward and link
prediction.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from ..graph.build import BipartiteGraph
from ..ops.propagate import propagate_segment


def uniform_alphas(num_layers: int, device: str | torch.device) -> torch.Tensor:
    """The default layer weights, 1/(num_layers+1) each, as an f32 vector
    filled on ``device`` (a copy from the host would wait for the stream)."""
    return torch.full((num_layers + 1,), 1.0 / (num_layers + 1), dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class LightGCNConfig:
    """Model hyperparameters."""

    num_nodes: int
    embedding_dim: int = 64
    num_layers: int = 3
    # None -> uniform 1/(num_layers+1); else a length num_layers+1 vector.
    alpha: Optional[Sequence[float]] = None

    def alphas(self, device: str | torch.device = "cpu") -> torch.Tensor:
        """The layer weights as an f32 vector on ``device``: make them once,
        on the table's device, for a step, refresh or embedding path."""
        if self.alpha is None:
            return uniform_alphas(self.num_layers, device)
        a = torch.as_tensor(self.alpha, dtype=torch.float32, device=device)
        if a.shape != (self.num_layers + 1,):
            raise ValueError(f"alpha needs {self.num_layers + 1} entries")
        return a


def init_params(
    generator: torch.Generator,
    cfg: LightGCNConfig,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
) -> dict:
    """Xavier-uniform embedding init, bound sqrt(6 / (num_nodes + dim)) as
    ``torch.nn.init.xavier_uniform_`` gives for the [num_nodes, dim] table.
    Drawn on the generator's device, then moved to ``device``."""
    bound = (6.0 / (cfg.num_nodes + cfg.embedding_dim)) ** 0.5
    emb = torch.empty(
        cfg.num_nodes, cfg.embedding_dim, dtype=dtype, device=generator.device
    ).uniform_(-bound, bound, generator=generator)
    return {"embedding": emb.to(device)}


def get_embedding(
    params: dict,
    graph: BipartiteGraph,
    cfg: LightGCNConfig,
    propagate_fn: Callable = propagate_segment,
) -> torch.Tensor:
    """Alpha-weighted sum of the L+1 layer embeddings, in the table's dtype."""
    x = params["embedding"]
    alpha = cfg.alphas(x.device).to(x.dtype)
    out = x * alpha[0]
    for layer in range(cfg.num_layers):
        x = propagate_fn(graph, x)
        out = out + x * alpha[layer + 1]
    return out


def pair_scores(
    final_embedding: torch.Tensor, src_idx: torch.Tensor, dst_idx: torch.Tensor
) -> torch.Tensor:
    """Dot-product rankings for (src, dst) node pairs:
    ``(out[src] * out[dst]).sum(-1)``."""
    return (final_embedding[src_idx] * final_embedding[dst_idx]).sum(-1)


def forward(
    params: dict,
    graph: BipartiteGraph,
    edge_label_index: torch.Tensor,
    cfg: LightGCNConfig,
    propagate_fn: Callable = propagate_segment,
) -> torch.Tensor:
    """Full forward: propagate, then score the labelled pairs
    ``edge_label_index`` [2, P] (all graph arcs: ``torch.stack([graph.src,
    graph.dst])``)."""
    out = get_embedding(params, graph, cfg, propagate_fn)
    return pair_scores(out, edge_label_index[0], edge_label_index[1])


def predict_link(
    params: dict,
    graph: BipartiteGraph,
    edge_label_index: torch.Tensor,
    cfg: LightGCNConfig,
    prob: bool = False,
) -> torch.Tensor:
    """Link probabilities, or hard 0/1 predictions unless ``prob``."""
    p = torch.sigmoid(forward(params, graph, edge_label_index, cfg))
    return p if prob else torch.round(p)
