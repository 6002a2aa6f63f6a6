"""Multi-device paths over torch.distributed: one process per shard.

Counterpart of ``gnn_ecommerce_tpu/parallel``, with its names: meshes
(``mesh.py``), the bootstrap and collectives (``distributed.py``), the
GSPMD steps (``sharded_train.py``), the explicit edge partition
(``edge_partition.py``), the fast edge partition (``edge_partition_fast.py``,
with ``ops/spmm_sharded.py``) and the sharded evaluation
(``sharded_eval.py``).

Names resolve at first use, so that ``ops/spmm_sharded.py`` can import this
package's collectives while this package exports what builds on it.
"""
import importlib

_EXPORTS = {
    "make_mesh": "mesh",
    "mesh_factorization": "mesh",
    "make_sharded_train_step": "sharded_train",
    "make_sharded_fast_train_step": "sharded_train",
    "shard_fast_bipartite": "sharded_train",
    "shard_graph": "sharded_train",
    "shard_params": "sharded_train",
    "EdgePartition": "edge_partition",
    "build_edge_partition": "edge_partition",
    "make_explicit_fns": "edge_partition",
    "pad_params": "edge_partition",
    "make_sharded_eval_fn": "sharded_eval",
    "sharded_evaluate": "sharded_eval",
    "FastEdgePartition": "edge_partition_fast",
    "build_fast_edge_partition": "edge_partition_fast",
    "ep_to_items": "edge_partition_fast",
    "ep_to_users": "edge_partition_fast",
    "make_fast_edge_fns": "edge_partition_fast",
    "merge_ep_view": "edge_partition_fast",
    "place_item_op": "edge_partition_fast",
    "split_ep_tree": "edge_partition_fast",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
