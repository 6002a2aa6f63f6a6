"""PyTorch + CUDA port of ``gnn_ecommerce_tpu`` for an NVIDIA H100.

The JAX package stays the reference; this package mirrors its module names
and imports nothing of it. Ported so far: the serving slice (prepared data,
graph build, LightGCN forward through the fast bipartite path and its CUDA
segment-reduce kernel, top-K, checkpoint loading, service, batcher, REST
server and CLI), one-device training, and the gather and segment-reduce
probes (``probes/``) with their CUDA kernels.
"""
