"""Training CLI (same flags as ``gnn_ecommerce_tpu/cli/train.py``, plus ``--device``).

    python -m gnn_ecommerce_tpu_torch.cli.train --synthetic -e 5
    python -m gnn_ecommerce_tpu_torch.cli.train --edges u_i_weight.csv -e 20
    python -m gnn_ecommerce_tpu_torch.cli.train --config framework.yaml
    python -m gnn_ecommerce_tpu_torch.cli.train --edges u_i_weight.csv --fast bf16 --model simgcl
    python -m gnn_ecommerce_tpu_torch.cli.train --edges u_i_weight.csv --fast bf16 --model dgcf

``--model simgcl`` and ``--model dgcf`` are the port's own, on one device
with ``--fast f32`` or ``bf16``. SimGCL's ``cl_weight``, ``cl_eps`` and
``cl_temp`` keep the paper's values unless a ``--config`` file's ``train``
section sets them; DGCF's intents, routing iterations and ``cor`` weight are
``--dgcf-factors``, ``--dgcf-iterations`` and ``--cor-weight`` (the authors'
4, 2 and 0.01 by default), its ``cor`` rows a step the authors' rule.

Runs on ``cuda`` unless ``--device cpu`` is given. After the ETL, the
prepared dataset artifact is saved to ``data_dir`` so that serving can
start without redoing it; the ETL's seconds are logged in front of the
training's records.

Multi-device training runs one process per device, every one of them this
CLI with the same flags:

    torchrun --nproc-per-node 2 -m gnn_ecommerce_tpu_torch.cli.train \
        --edges u_i_weight.csv --mesh 2 --partition edge --fast bf16

or with the flags ``--coordinator host:port --num-processes N --process-id
i`` on each. Any multi-host signal (those flags, ``--distributed``, or
torch's ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``) reaches
``parallel.distributed.init_distributed``, which raises on a partial world;
so does JAX's ``JAX_COORDINATOR_ADDRESS`` here, which torch does not read.
Each rank takes ``cuda:LOCAL_RANK`` (``cuda:0`` without it), or the CPU
with ``--device cpu``; rank 0 alone writes the prepared artifact. The
backend is NCCL on cards and gloo on the CPU. ``--backend gloo`` is a
testing switch: with ``--device cuda:0`` on each, it lets several ranks
share one card (which NCCL refuses), so that a mesh run can be tried where
there is only one card; such a run says nothing of a mesh's speed.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch.distributed as dist

from ..data.artifacts import save_prepared
from ..data.events import Edges, events_to_edges, read_csv
from ..data.prepare import prepare_splits, split_edges
from ..data.synthetic import synthetic_events
from ..parallel.distributed import world_rank
from ..train.driver import train
from .config import FrameworkConfig, WEIGHT_SCHEMES
from .preprocess import load_events


def load_edges(args, cfg: FrameworkConfig) -> Edges:
    if args.synthetic:
        events = synthetic_events(
            n_users=args.synthetic_users,
            n_items=args.synthetic_items,
            n_events=args.synthetic_events,
            seed=cfg.train.seed,
            n_clusters=args.synthetic_clusters,
            affinity=args.synthetic_affinity,
            user_skew=args.synthetic_user_skew,
            item_skew=args.synthetic_item_skew,
            n_pairs=args.synthetic_pairs or None,
        )
        return events_to_edges(events, cfg.weights())
    if args.movielens:
        from ..data.movielens import load_movielens

        return load_movielens(args.movielens)
    path = args.edges or cfg.edges_path
    if path:
        cols = read_csv(path)
        missing = {"user_id", "item_id", "weight"} - set(cols)
        if missing:
            raise SystemExit(f"edges CSV missing columns: {sorted(missing)}")
        return Edges(cols["user_id"], cols["item_id"], cols["weight"])
    events_path = args.events or cfg.raw_events_path
    if events_path:
        return events_to_edges(load_events(events_path), cfg.weights())
    raise SystemExit("provide --edges, --events, --synthetic, or config paths")


_TORCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def multi_host_requested(args) -> bool:
    """Any multi-host signal: the bootstrap flags or torch's launcher
    variables (JAX's coordinator address raises in :func:`main`)."""
    return bool(
        args.distributed
        or args.coordinator
        or args.num_processes is not None
        or args.process_id is not None
        or any(k in os.environ for k in _TORCH_ENV)
    )


def rank_device(device: str) -> str:
    """``cuda`` becomes this rank's card, ``cuda:LOCAL_RANK``; any other
    device (``cpu``, ``cuda:1``) is taken as it is."""
    if device == "cuda":
        return f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    return device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", help="framework YAML config (needs PyYAML)")
    ap.add_argument("--edges", help="weighted-edge CSV (user_id,item_id,weight)")
    ap.add_argument("--events", help="raw event CSV (runs the weight pipeline)")
    ap.add_argument("--movielens", help="MovieLens ratings file (u.data / ratings.dat)")
    ap.add_argument("--synthetic", action="store_true", help="synthetic dataset")
    ap.add_argument("--synthetic-users", type=int, default=2000)
    ap.add_argument("--synthetic-items", type=int, default=300)
    ap.add_argument("--synthetic-events", type=int, default=30000)
    ap.add_argument(
        "--synthetic-clusters", type=int, default=0,
        help="latent co-clusters (learnable structure; 0 = popularity only)",
    )
    ap.add_argument(
        "--synthetic-pairs", type=int, default=0,
        help="pin the unique (user,item) pair count (0 = independent draws)",
    )
    ap.add_argument(
        "--synthetic-affinity", type=float, default=0.7,
        help="P(event stays in the user's cluster) when clusters > 0 "
        "(0.85 in the full-scale corpus)",
    )
    ap.add_argument(
        "--synthetic-user-skew", type=float, default=0.8,
        help="zipf exponent for user activity",
    )
    ap.add_argument(
        "--synthetic-item-skew", type=float, default=1.0,
        help="zipf exponent for item popularity (lower = flatter; 0.9 in "
        "the full-scale corpus)",
    )
    ap.add_argument("-e", "--epochs", type=int, help="override config epochs")
    ap.add_argument("--dim", type=int, help="override latent_dim")
    ap.add_argument("--layers", type=int, help="override n_layers")
    ap.add_argument("--scheme", choices=sorted(WEIGHT_SCHEMES), help="weight scheme")
    ap.add_argument("--resume", action="store_true", help="resume from last checkpoint")
    ap.add_argument(
        "--mesh", type=int,
        help="devices to mesh: 1 = one device, N = the N ranks of the world, 0 = all of them",
    )
    ap.add_argument(
        "--partition", choices=["gspmd", "edge"], help="multi-device strategy"
    )
    ap.add_argument(
        "--fast", choices=["off", "f32", "bf16"],
        help="bipartite-factorized propagation (single device)",
    )
    ap.add_argument(
        "--heavy-users", type=int,
        help="dense-heavy-user head size K for the fast path (0=off)",
    )
    ap.add_argument(
        "--model", choices=["lightgcn", "simgcl", "dgcf"],
        help="simgcl: two noised full-graph views and InfoNCE beside BPR; dgcf: intent routing over "
             "the whole graph (both need --fast)",
    )
    ap.add_argument("--dgcf-factors", type=int, help="DGCF's intents K (latent_dim a multiple of K)")
    ap.add_argument("--dgcf-iterations", type=int, help="DGCF's routing iterations a layer")
    ap.add_argument("--cor-weight", type=float, help="the weight of DGCF's distance correlation")
    ap.add_argument(
        "--checkpoint-every", type=int,
        help="save LAST every N epochs (0 = only at the end)",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument(
        "--distributed", action="store_true",
        help="join a torch.distributed world (from the flags below or torch's variables)",
    )
    ap.add_argument("--coordinator", help="the world's rendezvous host:port (or an init URL)")
    ap.add_argument("--num-processes", type=int, help="ranks in the world")
    ap.add_argument("--process-id", type=int, help="this process's rank")
    ap.add_argument(
        "--backend", choices=["nccl", "gloo"],
        help="torch.distributed backend (default: nccl on cuda, gloo on cpu); a testing "
        "switch: gloo with --device cuda:0 lets several ranks share one card",
    )
    args = ap.parse_args(argv)

    device = args.device
    if os.environ.get("JAX_COORDINATOR_ADDRESS"):
        raise SystemExit(
            "JAX_COORDINATOR_ADDRESS is set: this CLI joins a torch.distributed world "
            "(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, or --coordinator, "
            "--num-processes, --process-id)"
        )
    if multi_host_requested(args):
        from ..parallel.distributed import init_distributed

        device = rank_device(args.device)
        info = init_distributed(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
            force=args.distributed,
            backend=args.backend,
            device=device,
        )
        print(f"distributed: {info}", flush=True)

    cfg = FrameworkConfig.load(args.config) if args.config else FrameworkConfig()
    if args.epochs is not None:
        cfg.train.epochs = args.epochs
    if args.dim is not None:
        cfg.train.latent_dim = args.dim
    if args.layers is not None:
        cfg.train.n_layers = args.layers
    if args.scheme:
        cfg.weight_scheme = args.scheme
    if args.resume:
        cfg.train.resume = True
    if args.mesh is not None:
        cfg.mesh_devices = args.mesh
    if args.partition:
        cfg.train.partition = args.partition
    if args.fast:
        cfg.train.fast_bipartite = args.fast
    if args.heavy_users is not None:
        cfg.train.heavy_users = args.heavy_users
    if args.model:
        cfg.train.model = args.model
    if args.dgcf_factors is not None:
        cfg.train.dgcf_factors = args.dgcf_factors
    if args.dgcf_iterations is not None:
        cfg.train.dgcf_iterations = args.dgcf_iterations
    if args.cor_weight is not None:
        cfg.train.cor_weight = args.cor_weight
    if args.checkpoint_every is not None:
        cfg.train.checkpoint_every = args.checkpoint_every
    cfg.train.mesh_devices = cfg.mesh_devices
    cfg.train.checkpoint_dir = cfg.checkpoint_dir

    t0 = time.perf_counter()
    edges = load_edges(args, cfg)
    print(f"{len(edges)} weighted edges; splitting + preparing ...", flush=True)
    tr, va, te = split_edges(edges, seed=cfg.train.seed)
    del edges
    prepared = prepare_splits(tr, va, te)
    del tr, va, te
    etl_s = time.perf_counter() - t0
    if world_rank()[1] == 0:  # one writer of the shared artifacts
        os.makedirs(cfg.data_dir, exist_ok=True)
        save_prepared(prepared, cfg.data_dir)
        print(f"prepared artifact -> {cfg.data_dir}", flush=True)
        # The ETL's seconds (load, split, prepare) go to the training log, in
        # front of the records that train() appends there.
        os.makedirs(cfg.checkpoint_dir, exist_ok=True)
        log_path = cfg.train.log_path or os.path.join(cfg.checkpoint_dir, "train_log.jsonl")
        with open(log_path, "a") as f:
            f.write(json.dumps({"etl_s": etl_s, "data_dir": cfg.data_dir}) + "\n")

    try:
        result = train(prepared, cfg.train, device=device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(
        f"done: best epoch {result.best_epoch} "
        f"val R@{cfg.train.k} {result.best_val_recall:.6f} | "
        f"test P@{cfg.train.k} {result.test_precision:.6f} "
        f"R@{cfg.train.k} {result.test_recall:.6f}"
    )


if __name__ == "__main__":
    main()
