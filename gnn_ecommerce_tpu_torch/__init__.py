"""PyTorch + CUDA port of ``gnn_ecommerce_tpu`` for an NVIDIA H100.

The JAX package stays the reference; this package mirrors its module names
and imports nothing of it. Ported so far: the serving slice (prepared data,
graph build, LightGCN forward through the fast bipartite path and its CUDA
segment-reduce kernel, top-K, checkpoint loading, service, batcher, REST
server and CLI), one-device training, the gather and segment-reduce probes
(``probes/``) with their CUDA kernels, and the way in from raw events: the
numpy ETL (``data/events.py``, ``data/synthetic.py``, ``data/prepare.py``,
``data/movielens.py``, the native groupby and CSV reader), the popularity
baseline, ``cli/preprocess`` and ``cli/train`` with ``cli/config``, and the
rest of the layered model API (``pair_scores``, ``forward``,
``predict_link``, the chunked propagation and its registry).
"""
