"""Ports of the JAX package's gather and segment-reduce probe scripts.

Each module mirrors one script of ``scripts/`` with its Pallas kernel as a
hand-written CUDA kernel (``probes/kernels.py``):

- ``proto_segreduce``: the tiled segment reduce (K2);
- ``pallas_gather_probe``: the per-row gather (K4);
- ``microbench_gather`` and ``microbench_gather2``: the primitive rates, with
  the lane gather (K5, K6).

Run one on the card with ``python -m gnn_ecommerce_tpu_torch.probes.<name>``
(``--device cpu`` for the tiny CPU shapes, ``--out`` to write the JSON).
"""
