"""The benchmark of gnn_ecommerce_tpu_torch: BENCHMARK.json's harness (see README.md)."""
