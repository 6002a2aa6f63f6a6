"""Prepared-dataset containers (numpy only).

Counterpart of ``gnn_ecommerce_tpu/data/prepare.py``'s containers. The ETL
that fills them from an event log (``prepare_splits``) is not ported yet;
the port reads what ``data/artifacts.py`` persisted. The JAX container's
pandas split frames are dropped: nothing in the port reads them.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CsrList:
    """Per-row sorted id lists in CSR form."""

    indptr: np.ndarray  # [R+1]
    values: np.ndarray  # [nnz]

    def lengths(self) -> np.ndarray:
        return np.diff(self.indptr)


@dataclasses.dataclass(frozen=True)
class EvalSplit:
    """Evaluation structures for one split (val or test), local item space."""

    user_ids: np.ndarray   # [Nu] sorted relabelled user ids with >=1 positive
    truth: CsrList         # per eval user: positive local item ids
    train_mask: CsrList    # per eval user: train-purchased local item ids


@dataclasses.dataclass(frozen=True)
class SamplerArrays:
    """BPR sampler inputs, unified node space (items offset by +n_users)."""

    users: np.ndarray      # [U] train users with >= 1 purchase
    pos_indptr: np.ndarray
    pos_flat: np.ndarray   # train positive item node ids per user
    ign_indptr: np.ndarray
    ign_flat: np.ndarray   # sorted ignore item node ids per user


@dataclasses.dataclass(frozen=True)
class PreparedData:
    n_users: int
    n_items: int
    # Train edges for graph construction (ALL train rows, weighted).
    edge_user: np.ndarray       # [E] relabelled user ids
    edge_item_node: np.ndarray  # [E] item ids offset by +n_users
    edge_weight: np.ndarray     # [E] float32
    sampler: SamplerArrays
    val: EvalSplit
    test: EvalSplit
    # Original-id vocabularies (LabelEncoder classes_) for round-tripping.
    user_classes: np.ndarray
    item_classes: np.ndarray
