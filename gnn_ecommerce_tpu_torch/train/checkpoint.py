"""Checkpoint loading (numpy only).

Reads the layout of ``gnn_ecommerce_tpu/train/checkpoint.py``:

    <dir>/<name>/checkpoint.npz   leaf_0..leaf_N of (params, opt_state)
    <dir>/<name>/meta.json        epoch, metrics, hyperparams, npz_sha256,
                                  leaf_paths

Saving and resuming come with the training slice.
"""
from __future__ import annotations

import hashlib
import io
import json
import os

import numpy as np

BEST_NAME = "LightGCN_best"


def load_checkpoint(directory: str, name: str = BEST_NAME) -> tuple[list, dict]:
    """Load raw leaves + metadata.

    Checks meta's npz sha256 (when present) over the exact bytes then
    loaded. A mismatch is retried, because a concurrent save may replace
    the npz while this reader holds the old meta; a persistent mismatch (a
    torn pair on disk) raises."""
    path = os.path.join(directory, name)
    npz_path = os.path.join(path, "checkpoint.npz")
    have = want = blob = None
    for _ in range(3):
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        want = meta.get("npz_sha256")
        with open(npz_path, "rb") as f:
            blob = f.read()
        if want is None:
            break
        have = hashlib.sha256(blob).hexdigest()
        if have == want:
            break
    else:
        raise RuntimeError(
            f"checkpoint {path}: npz sha256 {have[:12]}… does not match "
            f"meta.json ({want[:12]}…) after retries — the save was "
            "interrupted between the weights and metadata writes"
        )
    with np.load(io.BytesIO(blob)) as data:
        leaves = [data[f"leaf_{i}"] for i in range(meta["num_leaves"])]
    return leaves, meta


def find_leaf(leaves: list, meta: dict, needle: str, prefix: str = "[0]"):
    """Locate a leaf by key-path substring via ``meta['leaf_paths']``;
    ``prefix`` narrows to params (``"[0]"``) or opt_state (``"[1]"``). Falls
    back to ``leaves[0]`` for checkpoints without the manifest."""
    paths = meta.get("leaf_paths")
    if paths:
        for p, leaf in zip(paths, leaves):
            if p.startswith(prefix) and needle in p:
                return leaf
        raise KeyError(f"no checkpoint leaf matching {prefix}*{needle}: {paths}")
    return leaves[0]
