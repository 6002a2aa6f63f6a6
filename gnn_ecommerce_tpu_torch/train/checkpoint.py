"""Checkpoint save/load with mid-training resume (numpy on disk).

The layout of ``gnn_ecommerce_tpu/train/checkpoint.py``, so a checkpoint of
either package loads and resumes in the other:

    <dir>/<name>/checkpoint.npz   leaf_0..leaf_N of (params, opt_state)
    <dir>/<name>/meta.json        epoch, metrics, hyperparams, timestamp,
                                  npz_sha256, num_leaves, leaf_paths

A SimGCL run's ``hyperparams`` also hold ``model`` and ``layer_weights``
(``[0, 1/L, …, 1/L]``), which :func:`model_config` hands to whatever
scores the checkpoint; the JAX package's keys are the same for both models.
A DGCF run's hold ``model``, ``n_factors`` and ``n_iterations``: its
embedding is the routed forward, which nothing that scores a checkpoint
runs, so :func:`model_config` refuses it.

The leaves are in the JAX package's tree order, with its key paths: the
params by sorted name (``[0]['embedding']``), then the Adam state as optax
lays it out (``[1][0].count``, ``[1][0].mu['embedding']``,
``[1][0].nu['embedding']``). The port's :class:`~.step.AdamState` ``step``,
``exp_avg`` and ``exp_avg_sq`` are optax's count, mu and nu.

In a ``torch.distributed`` world of several ranks only rank 0 writes (every
rank holds the same gathered leaves; several writers would tear the
npz/meta pair), as the JAX package lets only process 0 write.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
from datetime import datetime

import numpy as np
import torch

from ..models.lightgcn import LightGCNConfig
from ..parallel.distributed import world_rank
from .step import AdamState

BEST_NAME = "LightGCN_best"
LAST_NAME = "LightGCN_last"


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def checkpoint_leaves(params: dict, opt_state: AdamState) -> tuple[list, list]:
    """(key paths, leaves) of (params, opt_state) in the JAX tree order."""
    names = sorted(params)
    paths = [f"[0][{n!r}]" for n in names] + ["[1][0].count"]
    leaves = [params[n] for n in names] + [np.asarray(opt_state.step, np.int32)]
    for field, moments in (("mu", opt_state.exp_avg), ("nu", opt_state.exp_avg_sq)):
        paths += [f"[1][0].{field}[{n!r}]" for n in names]
        leaves += [moments[n] for n in names]
    return paths, leaves


def save_checkpoint(
    directory: str,
    params: dict,
    opt_state: AdamState,
    *,
    epoch: int,
    precision: float,
    recall: float,
    hyperparams: dict | None = None,
    name: str = BEST_NAME,
) -> str:
    """Write one checkpoint: the npz under a tmp name, its rename, then
    ``meta.json`` (also renamed into place) holding the npz's sha256, so a
    crash between the two renames is caught by :func:`load_checkpoint`.
    Leaves may be tensors (any device) or numpy arrays. A rank other than 0
    writes nothing and returns the path."""
    path = os.path.join(directory, name)
    if world_rank()[1] != 0:
        return path
    os.makedirs(path, exist_ok=True)
    paths, leaves = checkpoint_leaves(params, opt_state)
    npz_path = os.path.join(path, "checkpoint.npz")
    tmp = npz_path + ".tmp.npz"
    np.savez(tmp, **{f"leaf_{i}": _numpy(leaf) for i, leaf in enumerate(leaves)})
    npz_sha = _file_sha256(tmp)
    os.replace(tmp, npz_path)
    meta = {
        "npz_sha256": npz_sha,
        "timestamp": datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
        "epoch": int(epoch),
        "precision": float(precision),
        "recall": float(recall),
        "hyperparams": hyperparams or {},
        "num_leaves": len(leaves),
        "leaf_paths": paths,
    }
    meta_path = os.path.join(path, "meta.json")
    with open(meta_path + ".tmp", "w") as f:
        json.dump(meta, f, indent=2)
    os.replace(meta_path + ".tmp", meta_path)
    return path


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 22), b""):
            h.update(block)
    return h.hexdigest()


def load_checkpoint(directory: str, name: str = BEST_NAME) -> tuple[list, dict]:
    """Load raw leaves + metadata; combine with :func:`restore_into`.

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


def model_config(meta: dict, num_nodes: int, default: LightGCNConfig | None = None) -> LightGCNConfig:
    """The configuration a checkpoint scores with: its width and depth
    (``default``'s, else 64 and 3, where the meta lacks them) and its layer
    weights (``layer_weights``; uniform where absent, as LightGCN's). A
    DGCF checkpoint raises: serving and ``cli.infer`` propagate with fixed
    arc weights, and DGCF's are routed anew by every forward."""
    hp = meta.get("hyperparams", {})
    if hp.get("model") == "dgcf":
        raise ValueError(
            "a DGCF checkpoint cannot be served or scored here: its embedding is the routed forward "
            "(models/dgcf.py:dgcf_forward), which the service and cli.infer do not run"
        )
    default = default or LightGCNConfig(num_nodes)
    weights = hp.get("layer_weights")
    return LightGCNConfig(
        num_nodes=num_nodes,
        embedding_dim=int(hp.get("latent_dim", default.embedding_dim)),
        num_layers=int(hp.get("n_layers", default.num_layers)),
        alpha=None if weights is None else tuple(float(a) for a in weights),
    )


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


def restore_into(params_like: dict, opt_state_like: AdamState, leaves: list):
    """Rebuild (params, opt_state) from loaded leaves, in the templates'
    dtypes and on their devices (the templates define the order, as the
    JAX package's treedef does)."""
    names = sorted(params_like)
    n = len(names)
    if len(leaves) != 3 * n + 1:
        raise ValueError(f"checkpoint has {len(leaves)} leaves, template has {3 * n + 1}")

    def like(leaf, t: torch.Tensor) -> torch.Tensor:
        if tuple(leaf.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint leaf {leaf.shape} != template {tuple(t.shape)}")
        return torch.from_numpy(np.array(leaf, copy=True)).to(device=t.device, dtype=t.dtype)

    params = {k: like(leaves[i], params_like[k]) for i, k in enumerate(names)}
    opt_state = AdamState(
        step=int(leaves[n]),
        exp_avg={k: like(leaves[n + 1 + i], opt_state_like.exp_avg[k]) for i, k in enumerate(names)},
        exp_avg_sq={
            k: like(leaves[2 * n + 1 + i], opt_state_like.exp_avg_sq[k]) for i, k in enumerate(names)
        },
    )
    return params, opt_state
