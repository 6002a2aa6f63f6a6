"""Port of ``scripts/full_corpus_r3.py``: the full-scale clustered corpus and
its prepared splits, the one source of the parameters that the full-scale
runs share (``svd_full_r5``, ``bprmf_full_r5``, ``skyline_full_r3``,
``train_full_r5b``).

The corpus is the JAX package's bit for bit: ``synthetic_events`` (768
co-clusters, affinity 0.85, item skew 0.9, seed 42) →
``events_to_edges(EVENT_TYPE_WEIGHTS_V1)`` → ``split_edges(seed=42)`` →
``prepare_splits``. :func:`build_prepared` reads the constants below when
it is called, as the script's does.

The JAX ``PreparedData`` carries the held-out splits as frames
(``val_df``, ``test_df``); the port's carries none, so :func:`heldout_edges`
gives their rows, in their order, from the split edges.

    python -m gnn_ecommerce_tpu_torch.runs.full_corpus_r3 -o DATA_DIR [--device cuda]

builds the corpus, saves the prepared artifact into ``DATA_DIR`` (with this
line as ``DATA_DIR/corpus.json`` and the held-out edges as
``DATA_DIR/heldout.npz``) and prints one JSON line: the graph, the edge and
user counts, the ETL's seconds and the artifact's hash
(:func:`artifact_sha256`). The other runs reuse it with ``-d DATA_DIR``.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import numpy as np

from ..data.artifacts import _FIELDS, ARRAYS, MANIFEST, load_prepared, save_prepared
from ..data.events import EVENT_TYPE_WEIGHTS_V1, Edges, events_to_edges
from ..data.prepare import PreparedData, _purchase_users, prepare_splits, split_edges
from ..data.synthetic import synthetic_events
from ..device import resolve_device
from . import _load
from ._cli import emit, quality_parser

N_USERS = 1_639_358
N_ITEMS = 54_571
N_EVENTS = 20_692_840
N_PAIRS = 10_157_407
GEN_KWARGS = dict(seed=42, n_clusters=768, affinity=0.85, item_skew=0.9)
CORPUS_FILE = "corpus.json"
HELDOUT_FILE = "heldout.npz"
# The script wrote no file: every key of the line is the port's own.
EXTRA_KEYS = {
    "graph", "unique_edges", "train_edges", "val_users", "test_users", "etl_s",
    "artifact_sha256", "device",
}


def build_splits() -> tuple[Edges, Edges, Edges, int]:
    """(train, val, test, n_unique_edges): the corpus's edges, split."""
    events = synthetic_events(
        n_users=N_USERS, n_items=N_ITEMS, n_events=N_EVENTS, n_pairs=N_PAIRS, **GEN_KWARGS,
    )
    edges = events_to_edges(events, EVENT_TYPE_WEIGHTS_V1)
    del events
    tr, va, te = split_edges(edges, seed=42)
    return tr, va, te, len(edges)


def build_prepared() -> tuple[PreparedData, int]:
    """Returns (prepared, n_unique_edges), as the script's. Deterministic."""
    tr, va, te, n_edges = build_splits()
    return prepare_splits(tr, va, te), n_edges


def heldout_edges(train: Edges, val: Edges, test: Edges) -> dict[str, Edges]:
    """The rows of the JAX package's ``val_df`` and ``test_df``, in their
    order: each held-out split kept where both its user and its item are
    in train, then the rows of users with a purchase in it, relabelled
    (``user_id`` the relabelled user, ``item_id`` the LOCAL item: only
    train items are offset by ``n_users``). Keyed ``val`` and ``test``."""
    users, items = np.unique(train.user_id), np.unique(train.item_id)
    out = {}
    for name, df in (("val", val), ("test", test)):
        df = _purchase_users(df.take(np.isin(df.user_id, users) & np.isin(df.item_id, items)))
        out[name] = Edges(
            np.searchsorted(users, df.user_id), np.searchsorted(items, df.item_id), df.weight,
        )
    return out


def _arrays_sha256(arrays) -> dict:
    """A sha256 over each (name, array) and one over those digests:
    ``{"sha256": total, "arrays": {name: [dtype, shape, digest[:16]]}}``."""
    total, per = hashlib.sha256(), {}
    for name, a in arrays:
        a = np.ascontiguousarray(a)
        digest = hashlib.sha256(a.tobytes()).hexdigest()
        per[name] = [str(a.dtype), list(a.shape), digest[:16]]
        total.update(digest.encode())
    return {"sha256": total.hexdigest(), "arrays": per}


def artifact_sha256(directory: str) -> dict:
    """The hash of ``directory``'s saved artifact (either package's), its
    arrays in its manifest's order."""
    with open(os.path.join(directory, MANIFEST)) as f:
        names = list(json.load(f)["arrays"])
    with np.load(os.path.join(directory, ARRAYS)) as z:
        return _arrays_sha256((name, z[name]) for name in names)


def prepared_sha256(prepared: PreparedData) -> str:
    """The total of :func:`artifact_sha256` for ``prepared`` once saved."""
    return _arrays_sha256((name, get(prepared)) for name, get in _FIELDS.items())["sha256"]


def save_corpus(prepared: PreparedData, n_edges: int, etl_s: float, directory: str,
                heldout: dict[str, Edges] | None = None) -> dict:
    """Save ``prepared`` into ``directory`` with its ``corpus.json`` (the
    line of :func:`main` but the device) and, where given, the held-out
    edges (:func:`heldout_edges`) as ``heldout.npz``; returns that line."""
    save_prepared(prepared, directory)
    if heldout is not None:
        np.savez(os.path.join(directory, HELDOUT_FILE), **{
            f"{name}_{col}": getattr(e, col)
            for name, e in heldout.items() for col in ("user_id", "item_id", "weight")
        })
    line = {
        "graph": f"{prepared.n_users}x{prepared.n_items}",
        "unique_edges": int(n_edges),
        "train_edges": int(len(prepared.edge_user)),
        "val_users": int(len(prepared.val.user_ids)),
        "test_users": int(len(prepared.test.user_ids)),
        "etl_s": round(etl_s, 1),
        "artifact_sha256": prepared_sha256(prepared),
    }
    with open(os.path.join(directory, CORPUS_FILE), "w") as f:
        json.dump(line, f)
    return line


def load_corpus(directory: str) -> tuple[PreparedData, int | None]:
    """(prepared, n_unique_edges) from a saved artifact; the edge count
    from its ``corpus.json`` where :func:`save_corpus` wrote one."""
    prepared = load_prepared(directory)
    path = os.path.join(directory, CORPUS_FILE)
    if not os.path.exists(path):
        return prepared, None
    with open(path) as f:
        return prepared, json.load(f)["unique_edges"]


def load_heldout(directory: str) -> dict[str, Edges]:
    """The held-out edges that :func:`save_corpus` saved into ``directory``."""
    path = os.path.join(directory, HELDOUT_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path}: no held-out edges (save the corpus with full_corpus_r3 -o)")
    with np.load(path) as z:
        return {name: Edges(z[f"{name}_user_id"], z[f"{name}_item_id"], z[f"{name}_weight"])
                for name in ("val", "test")}


def prepared_of(data_dir: str | None) -> tuple[PreparedData, int | None, float]:
    """(prepared, n_unique_edges, seconds): the artifact in ``data_dir``,
    or the corpus built anew without one."""
    t0 = time.perf_counter()
    if data_dir:
        prepared, n_edges = load_corpus(data_dir)
    else:
        prepared, n_edges = build_prepared()
    etl_s = time.perf_counter() - t0
    _load.log(
        f"corpus: {prepared.n_users}x{prepared.n_items}, {len(prepared.edge_user)} train edges "
        f"({'loaded from ' + data_dir if data_dir else 'built'} in {etl_s:.1f} s)"
    )
    return prepared, n_edges, etl_s


def main(argv=None) -> int:
    ap = quality_parser(__doc__)
    ap.add_argument("-o", "--data-dir", required=True, help="where to save the prepared artifact")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    tr, va, te, n_edges = build_splits()
    heldout = heldout_edges(tr, va, te)
    prepared = prepare_splits(tr, va, te)
    del tr, va, te
    line = save_corpus(prepared, n_edges, time.perf_counter() - t0, args.data_dir, heldout)
    return emit({**line, "device": _load.card(dev)}, args.out)


if __name__ == "__main__":
    sys.exit(main())
