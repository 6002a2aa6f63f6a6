"""Prepared-dataset persistence: one directory, one manifest.

The same on-disk layout as ``gnn_ecommerce_tpu/data/artifacts.py``: the
arrays of a :class:`PreparedData` in ``prepared.npz`` plus a
``manifest.json`` with shapes, byte sizes and the npz's sha256, which
:func:`load_prepared` checks. Either package reads what the other wrote.
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from .prepare import CsrList, EvalSplit, PreparedData, SamplerArrays

MANIFEST = "manifest.json"
ARRAYS = "prepared.npz"

_FIELDS = {
    "edge_user": lambda p: p.edge_user,
    "edge_item_node": lambda p: p.edge_item_node,
    "edge_weight": lambda p: p.edge_weight,
    "sampler_users": lambda p: p.sampler.users,
    "sampler_pos_indptr": lambda p: p.sampler.pos_indptr,
    "sampler_pos_flat": lambda p: p.sampler.pos_flat,
    "sampler_ign_indptr": lambda p: p.sampler.ign_indptr,
    "sampler_ign_flat": lambda p: p.sampler.ign_flat,
    "val_user_ids": lambda p: p.val.user_ids,
    "val_truth_indptr": lambda p: p.val.truth.indptr,
    "val_truth_values": lambda p: p.val.truth.values,
    "val_mask_indptr": lambda p: p.val.train_mask.indptr,
    "val_mask_values": lambda p: p.val.train_mask.values,
    "test_user_ids": lambda p: p.test.user_ids,
    "test_truth_indptr": lambda p: p.test.truth.indptr,
    "test_truth_values": lambda p: p.test.truth.values,
    "test_mask_indptr": lambda p: p.test.train_mask.indptr,
    "test_mask_values": lambda p: p.test.train_mask.values,
    "user_classes": lambda p: p.user_classes,
    "item_classes": lambda p: p.item_classes,
}


def _sha256(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def save_prepared(prepared: PreparedData, directory: str) -> str:
    """Persist everything serving needs; returns the manifest path."""
    os.makedirs(directory, exist_ok=True)
    arrays = {name: np.asarray(get(prepared)) for name, get in _FIELDS.items()}
    path = os.path.join(directory, ARRAYS)
    np.savez_compressed(path, **arrays)
    manifest = {
        "format": 1,
        "n_users": int(prepared.n_users),
        "n_items": int(prepared.n_items),
        "files": {ARRAYS: {"bytes": os.path.getsize(path), "sha256": _sha256(path)}},
        "arrays": {
            name: {"shape": list(a.shape), "dtype": str(a.dtype)}
            for name, a in arrays.items()
        },
    }
    mpath = os.path.join(directory, MANIFEST)
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=2)
    return mpath


def load_prepared(directory: str, verify: bool = True) -> PreparedData:
    """Load a prepared dir. With ``verify``, refuse an npz whose sha256
    differs from the manifest's; without it, skip the hash."""
    with open(os.path.join(directory, MANIFEST)) as f:
        manifest = json.load(f)
    path = os.path.join(directory, ARRAYS)
    if verify:
        have = _sha256(path)
        want = manifest["files"][ARRAYS]["sha256"]
        if have != want:
            raise ValueError(
                f"{path}: sha256 mismatch (manifest {want[:12]}…, file {have[:12]}…)"
            )
    with np.load(path) as data:
        a = {name: data[name] for name in _FIELDS}
    return PreparedData(
        n_users=int(manifest["n_users"]),
        n_items=int(manifest["n_items"]),
        edge_user=a["edge_user"],
        edge_item_node=a["edge_item_node"],
        edge_weight=a["edge_weight"],
        sampler=SamplerArrays(
            users=a["sampler_users"],
            pos_indptr=a["sampler_pos_indptr"],
            pos_flat=a["sampler_pos_flat"],
            ign_indptr=a["sampler_ign_indptr"],
            ign_flat=a["sampler_ign_flat"],
        ),
        val=EvalSplit(
            user_ids=a["val_user_ids"],
            truth=CsrList(a["val_truth_indptr"], a["val_truth_values"]),
            train_mask=CsrList(a["val_mask_indptr"], a["val_mask_values"]),
        ),
        test=EvalSplit(
            user_ids=a["test_user_ids"],
            truth=CsrList(a["test_truth_indptr"], a["test_truth_values"]),
            train_mask=CsrList(a["test_mask_indptr"], a["test_mask_values"]),
        ),
        user_classes=a["user_classes"],
        item_classes=a["item_classes"],
    )
