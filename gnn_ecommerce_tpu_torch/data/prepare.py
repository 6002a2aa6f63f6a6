"""Dataset preparation: split / sync / relabel / positive & ignore lists
(numpy only).

Counterpart of ``gnn_ecommerce_tpu/data/prepare.py``: the same containers
and the same ETL (``split_edges``, ``prepare_splits``) over
:class:`~.events.Edges` in place of pandas frames, giving the JAX package's
arrays exactly, in its row order. The JAX container's pandas split frames
are dropped: nothing in the port reads them, and the persisted artifact
(``data/artifacts.py``) holds none.

Reference semantics preserved:
- random 95 / 2.5 / 2.5 edge split;
- ``sync_nodes``: val/test rows keep only users AND items seen in train,
  then only users with at least one purchase row (weight == 1.0) in that
  split;
- ``relabelling``: LabelEncoder ≡ rank in the sorted unique train values;
- item node ids offset by ``+n_users`` into the unified node space for the
  graph and sampler, while eval positives and interaction masks stay in
  local item space;
- per-user ignore list for negative sampling = train positives ∪ val ∪
  test positives, node space;
- "positive" means weight == 1.0 exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .events import Edges


def split_edges(
    edges: Edges, seed: int = 42, test_size: float = 0.05
) -> tuple[Edges, Edges, Edges]:
    """Random (1-test_size) / test_size/2 / test_size/2 split of edge rows,
    with the seed consumed. Returns (train, val, test)."""
    rng = np.random.default_rng(seed)
    n = len(edges)
    perm = rng.permutation(n)
    n_holdout = int(round(n * test_size))
    n_test = n_holdout // 2
    return edges.take(perm[n_holdout:]), edges.take(perm[n_test:n_holdout]), edges.take(perm[:n_test])


def _purchase_users(edges: Edges) -> Edges:
    """Keep the rows of users who have >= 1 purchase row (weight == 1.0)."""
    buyers = np.unique(edges.user_id[edges.weight == 1.0])
    return edges.take(np.isin(edges.user_id, buyers))


def _csr(keys: np.ndarray, vals: np.ndarray, n_rows: int) -> tuple[np.ndarray, np.ndarray]:
    """Build CSR (indptr, sorted-per-row values) from (row, value) pairs."""
    order = np.lexsort((vals, keys))
    keys, vals = keys[order], vals[order]
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    indptr[1:] = np.bincount(keys, minlength=n_rows)
    return np.cumsum(indptr), vals


@dataclasses.dataclass(frozen=True)
class CsrList:
    """Per-row sorted id lists in CSR form."""

    indptr: np.ndarray  # [R+1]
    values: np.ndarray  # [nnz]

    def row(self, r: int) -> np.ndarray:
        return self.values[self.indptr[r] : self.indptr[r + 1]]

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


def _build_eval_split(
    users_idx: np.ndarray, items_idx: np.ndarray, tp_users: np.ndarray, tp_items: np.ndarray
) -> EvalSplit:
    """One split's eval structures from its positive (user, local item)
    rows and the train purchases (user, local item) rows."""
    users = np.unique(users_idx)
    slot = np.searchsorted(users, users_idx)
    truth = CsrList(*_csr(slot, items_idx.astype(np.int64), len(users)))
    keep = np.isin(tp_users, users)
    tslot = np.searchsorted(users, tp_users[keep])
    mask = CsrList(*_csr(tslot, tp_items[keep].astype(np.int64), len(users)))
    return EvalSplit(user_ids=users.astype(np.int64), truth=truth, train_mask=mask)


def prepare_splits(train: Edges, val: Edges, test: Edges) -> PreparedData:
    """Full ``prepare_val_test`` pipeline over (train, val, test) edges in
    original id space. Output structures are documented on
    :class:`PreparedData`."""
    # --- sync_nodes ---
    train_users = np.unique(train.user_id)
    train_items = np.unique(train.item_id)

    def sync(df: Edges) -> Edges:
        seen = np.isin(df.user_id, train_users) & np.isin(df.item_id, train_items)
        return _purchase_users(df.take(seen))

    val, test = sync(val), sync(test)

    # --- relabelling: LabelEncoder == sorted-unique rank ---
    user_classes, item_classes = train_users, train_items
    n_users, n_items = len(user_classes), len(item_classes)

    def relabel(df: Edges) -> tuple[np.ndarray, np.ndarray]:
        return (
            np.searchsorted(user_classes, df.user_id),
            np.searchsorted(item_classes, df.item_id),
        )

    (tr_u, tr_i), (va_u, va_i), (te_u, te_i) = relabel(train), relabel(val), relabel(test)

    # Train purchases in LOCAL item space (the interaction matrix), and the
    # train items offset into the unified node space.
    tbuy = train.weight == 1.0
    tp_u, tp_i = tr_u[tbuy], tr_i[tbuy]
    tr_node = tr_i + n_users

    # --- sampler structures ---
    pos_users = np.unique(tp_u)
    pslot = np.searchsorted(pos_users, tp_u)
    tpos_node = tr_node[tbuy].astype(np.int64)
    pos_indptr, pos_flat = _csr(pslot, tpos_node, len(pos_users))

    # Ignore lists: train ∪ val ∪ test positives (node space) per train-pos
    # user; val/test users without train purchases are dropped, as the
    # reference's left-merge onto train_pos drops them.
    ign_rows = [pslot]
    ign_vals = [tpos_node]
    for df, (u, i) in ((val, (va_u, va_i)), (test, (te_u, te_i))):
        buy = df.weight == 1.0
        pu, pi = u[buy], i[buy]
        keep = np.isin(pu, pos_users)
        ign_rows.append(np.searchsorted(pos_users, pu[keep]))
        ign_vals.append(pi[keep].astype(np.int64) + n_users)
    rows = np.concatenate(ign_rows)
    vals = np.concatenate(ign_vals)
    pairs = np.unique(np.stack([rows, vals], axis=1), axis=0)
    ign_indptr, ign_flat = _csr(pairs[:, 0], pairs[:, 1], len(pos_users))

    sampler = SamplerArrays(
        users=pos_users.astype(np.int64),
        pos_indptr=pos_indptr,
        pos_flat=pos_flat,
        ign_indptr=ign_indptr,
        ign_flat=ign_flat,
    )

    # --- eval splits (local item space) ---
    vbuy, tebuy = val.weight == 1.0, test.weight == 1.0
    val_split = _build_eval_split(va_u[vbuy], va_i[vbuy], tp_u, tp_i)
    test_split = _build_eval_split(te_u[tebuy], te_i[tebuy], tp_u, tp_i)

    return PreparedData(
        n_users=n_users,
        n_items=n_items,
        edge_user=tr_u.astype(np.int64),
        edge_item_node=tr_node.astype(np.int64),
        edge_weight=train.weight.astype(np.float32),
        sampler=sampler,
        val=val_split,
        test=test_split,
        user_classes=user_classes,
        item_classes=item_classes,
    )
