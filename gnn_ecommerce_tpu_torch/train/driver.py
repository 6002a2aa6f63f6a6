"""Training driver: epoch loop with per-epoch validation, best-model
checkpointing, structured logging and resume.

Counterpart of ``gnn_ecommerce_tpu/train/driver.py``: on one device the
layered branch (``fast_bipartite="off"``) and the fast branches (``"f32"``
exact, ``"bf16"`` the main configuration) with the batched train forward
``fast_batch_embeddings`` (for ``model="simgcl"``, ``models/simgcl.py``'s
loss, whose noise generator is reseeded every epoch as the sampler's is,
and the layer weights ``[0, 1/L, …]`` in eval and the checkpoints; for
``model="dgcf"``, ``models/dgcf.py``'s routed forward over the whole graph,
rows gathered in bf16 or f32 as ``fast_bipartite`` says, its ``cor`` rows'
generator reseeded every epoch, eval on the routed forward, and neither
B_ii nor plans nor a heavy head built); on a
mesh (one ``torch.distributed`` process per device, every process running
this driver) the JAX driver's three branches: ``partition="edge"`` with the
fast edge partition (``parallel/edge_partition_fast.py``) or, with
``fast_bipartite="off"``, the explicit one (``parallel/edge_partition.py``),
and ``partition="gspmd"`` (``parallel/sharded_train.py``), each evaluated
by ``parallel/sharded_eval.py``. On a mesh, rank 0 alone logs and writes
checkpoints, which hold the unpadded, unified table of the one-device run
(each rank's layout is gathered for them, so every rank holds what rank 0
writes); saves are synchronous, and every flush is a barrier. A process
that joined a world trains on its mesh even when the world has one rank
(``cli.train --distributed --mesh 1``); the JAX driver runs one device
whenever ``mesh_devices`` is 1. As there:
- the final test evaluation uses the best epoch's params;
- every epoch's losses and metrics go to a JSONL log;
- resume restores params, Adam state and the epoch counter from LAST, and
  the on-disk BEST stays the bar a resumed run must beat;
- the one-time operator build is retried once on an out-of-memory error.

Checkpoints are written behind the training by one writer thread with a
latest-wins mailbox (one slot per checkpoint name): a save copies the
leaves once into pinned host tensors, waits for that copy (so the next step
may update the params in place), and returns; a save that is superseded
before the writer takes it is dropped unwritten. As in the JAX driver, a
leaf larger than twice ``SNAPSHOT_BAND_BYTES`` is copied in row bands, and
the writer keeps to a duty cycle: after a write that took T seconds it
idles ``T·(1-d)/d`` (``d = TrainConfig.async_save_duty`` clamped to [0.05,
1]), an idle that a flush or a stop cuts short.

Deliberate difference: the JAX driver logs an epoch's record after its save
block, so a save that raises loses that epoch from the JSONL
(``driver.py:1003``). Here the record is logged whether or not the save
raises; the error still propagates.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import threading
import time
from typing import Optional

import torch

from ..data.prepare import PreparedData
from ..device import resolve_device
from ..eval.evaluate import build_eval_buckets, evaluate_bucketed
from ..graph.build import build_graph
from ..models.lightgcn import LightGCNConfig, get_embedding, init_params
from ..models.dgcf import authors_cor_batch, dgcf_forward, make_dgcf_loss_fn
from ..models.simgcl import make_simgcl_loss_fn, simgcl_alphas
from ..ops.bipartite import build_fast_bipartite, fast_batch_embeddings, fast_get_embedding, row_padded
from ..ops.routing import build_routing_graph
from ..parallel.distributed import barrier, joined_world, world_rank
from ..sampling.bpr import make_sampler_data
from .checkpoint import (
    BEST_NAME, LAST_NAME, load_checkpoint, restore_into, save_checkpoint,
)
from .step import Adam, AdamState, make_loss_fn, make_run_steps, make_train_fns

# Seconds to wait before the one retry of an operator build that ran out of
# device memory.
RETRY_WAIT_S = 10.0


@dataclasses.dataclass
class TrainConfig:
    """Hyperparameters; the JAX package's fields and defaults."""

    latent_dim: int = 64
    n_layers: int = 3
    lr: float = 0.005
    decay: float = 1e-4
    batch_size: int = 1024
    epochs: int = 20
    k: int = 20
    seed: int = 42
    # Reference epoch: train_size // (batch_size * 40); None -> that, min 1.
    batches_per_epoch: Optional[int] = None
    checkpoint_dir: str = "model-checkpoints"
    mask_mode: str = "neginf"
    resume: bool = False
    sample_replace: bool = True
    log_path: Optional[str] = None  # default: <checkpoint_dir>/train_log.jsonl
    # When set, epoch `profile_epoch` runs under torch.profiler and its
    # Chrome trace is written into this directory.
    profile_dir: Optional[str] = None
    profile_epoch: int = 1
    # Devices to train over: 1 = one device; N > 1 = a mesh of the N ranks of
    # the initialized torch.distributed world (one device each); 0 = every
    # rank of the world. Anything but the world's size (or 0) raises.
    mesh_devices: int = 1
    # Mesh strategy: "gspmd" (row bands of the table over a (data, model)
    # mesh) or "edge" (the fast or the explicit edge partition).
    partition: str = "gspmd"
    # "off" (layered), "f32" (exact fast) or "bf16" (bf16 B_ii and messages).
    fast_bipartite: str = "off"
    # Arc capacity of the batched train forward; 0 -> max(64*batch, 8192).
    batch_edge_cap: int = 0
    # Dense heavy-user head size K of the fast plans (0 = off).
    heavy_users: int = 0
    async_saves: bool = True
    # Save LAST every N epochs (always after the final epoch); 0 = only at
    # the end. BEST is tracked in a device copy either way.
    checkpoint_every: int = 1
    # Share of the time the async writer may be busy: after a write of T
    # seconds it idles T*(1-d)/d before taking the next snapshot (flush and
    # stop cut the idle short). 1.0 writes back to back.
    async_save_duty: float = 0.5
    # "lightgcn", "simgcl" (models/simgcl.py: two noised full-graph views
    # and InfoNCE beside the BPR step) or "dgcf" (models/dgcf.py: intent
    # routing over the whole graph); the last two on one device, with
    # fast_bipartite f32 or bf16 (DGCF: the type its routed products gather).
    model: str = "lightgcn"
    # SimGCL's λ (the InfoNCE terms' weight), ε (the noise rows' length)
    # and τ (InfoNCE's temperature).
    cl_weight: float = 0.5
    cl_eps: float = 0.1
    cl_temp: float = 0.2
    # DGCF's intents K, routing iterations T and the weight of its distance
    # correlation (its rows a step are the authors' max(users, items) /
    # (edges // batch + 1), which the checkpoint records as cor_batch).
    dgcf_factors: int = 4
    dgcf_iterations: int = 2
    cor_weight: float = 0.01

    def hyperparams(self) -> dict:
        """The checkpoint's meta: the JAX package's keys, and for SimGCL its
        model, its layer weights (what eval, ``cli.infer`` and the service
        score with) and its contrastive settings; for DGCF its model, K, T
        and ``cor`` weight (the training driver adds its ``cor_batch``)."""
        hp = {
            "latent_dim": self.latent_dim,
            "n_layers": self.n_layers,
            "LR": self.lr,
            "DECAY": self.decay,
            "BATCH_SIZE": self.batch_size,
        }
        if self.model == "simgcl":
            hp.update(model="simgcl", layer_weights=list(simgcl_alphas(self.n_layers)),
                      cl_weight=self.cl_weight, cl_eps=self.cl_eps, cl_temp=self.cl_temp)
        if self.model == "dgcf":
            hp.update(model="dgcf", n_factors=self.dgcf_factors, n_iterations=self.dgcf_iterations,
                      cor_weight=self.cor_weight)
        return hp


@dataclasses.dataclass
class TrainResult:
    params: dict
    history: list
    best_epoch: int
    best_val_precision: float
    best_val_recall: float
    test_precision: float
    test_recall: float


def _epoch_seed(seed: int, epoch: int) -> int:
    """The sampler's seed for one epoch: a resumed run draws the batches an
    uninterrupted run would have."""
    return seed * 1_000_003 + 1000 + epoch


def _noise_seed(seed: int, epoch: int) -> int:
    """SimGCL's noise generator's (DGCF's ``cor`` rows' generator's) seed
    for one epoch, apart from the sampler's."""
    return _epoch_seed(seed, epoch) + (1 << 32)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# Row-band size of a snapshot's copies: a leaf larger than twice this is
# copied band by band. Module-level so tests can shrink it.
SNAPSHOT_BAND_BYTES = 32 << 20


def _snapshot_bands(x: torch.Tensor) -> int:
    """The number of row-band copies that snapshot ``x`` (1: one copy)."""
    nbytes = x.numel() * x.element_size()
    if x.dim() == 0 or nbytes <= 2 * SNAPSHOT_BAND_BYTES:
        return 1
    nb = -(-nbytes // SNAPSHOT_BAND_BYTES)
    rows = -(-x.shape[0] // nb)
    return -(-x.shape[0] // rows)


def _snapshot(params: dict, opt_state: AdamState) -> tuple[tuple[dict, AdamState], int]:
    """One copy of every leaf into host memory (pinned for CUDA leaves),
    awaited before returning, so the caller may update the originals. A
    leaf larger than twice ``SNAPSHOT_BAND_BYTES`` is copied in row bands
    into its one buffer. Returns the snapshot and its number of copies."""
    copies = [0]

    def one(x: torch.Tensor) -> torch.Tensor:
        x = x.detach()
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=x.is_cuda)
        nb = _snapshot_bands(x)
        if nb == 1:
            buf.copy_(x, non_blocking=x.is_cuda)
        else:
            rows = -(-x.shape[0] // nb)
            for r0 in range(0, x.shape[0], rows):
                buf[r0 : r0 + rows].copy_(x[r0 : r0 + rows], non_blocking=x.is_cuda)
        copies[0] += nb
        return buf

    snap = (
        {k: one(v) for k, v in params.items()},
        AdamState(
            opt_state.step,
            {k: one(v) for k, v in opt_state.exp_avg.items()},
            {k: one(v) for k, v in opt_state.exp_avg_sq.items()},
        ),
    )
    for v in params.values():
        _sync(v.device)
    return snap, copies[0]


def _tree_bytes(params: dict, opt_state: AdamState) -> int:
    tensors = [*params.values(), *opt_state.exp_avg.values(), *opt_state.exp_avg_sq.values()]
    return sum(t.numel() * t.element_size() for t in tensors)


class CheckpointWriter:
    """Write-behind checkpoint saves with a latest-wins mailbox.

    ``save`` snapshots and returns at once; one daemon thread writes. A save
    still in the mailbox when another of the same name arrives is replaced
    (counted as coalesced); names saved by one call share one snapshot. An
    error on the writer thread is raised by the next ``save`` or ``flush``.

    ``duty`` (clamped to [0.05, 1]) is the share of the time the writer may
    be busy: after a write of T seconds it idles ``T·(1-duty)/duty`` (at
    most 600 s) before it takes the next snapshot; ``flush`` and ``stop``
    cut the idle short. ``stats`` counts the writer's busy and idle
    seconds, the bytes it wrote and the snapshot's band copies.
    """

    def __init__(self, directory: str, hyperparams: dict, duty: float = 1.0):
        self.directory, self.hyperparams = directory, hyperparams
        self.duty = min(max(float(duty), 0.05), 1.0)
        self.stats = {
            "requested": 0, "written": 0, "coalesced": 0,
            "writer_busy_s": 0.0, "writer_idle_s": 0.0, "writer_bytes": 0,
            "snapshot_copies": 0,
        }
        self._cv = threading.Condition()
        self._box: dict = {}  # name -> (snapshot id, (params, opt_state), meta kwargs)
        self._busy = self._stop = self._flushing = False
        self._seq = 0
        self._errors: list = []
        self._thread = threading.Thread(target=self._run, daemon=True, name="ckpt-writer")
        self._thread.start()

    def save(self, params: dict, opt_state: AdamState, targets: list) -> None:
        self.raise_errors()
        self.stats["requested"] += len(targets)
        snap, copies = _snapshot(params, opt_state)
        self.stats["snapshot_copies"] += copies
        with self._cv:
            self._seq += 1
            for name, kw in targets:
                if name in self._box:
                    self.stats["coalesced"] += 1
                self._box[name] = (self._seq, snap, kw)
            self._cv.notify_all()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._box and not self._stop:
                    self._cv.wait()
                if not self._box:
                    return
                items = dict(self._box)
                self._box.clear()
                self._busy = True
            t0 = time.perf_counter()
            try:
                groups: dict = {}
                for name, (sid, snap, kw) in items.items():
                    groups.setdefault(sid, (snap, []))[1].append((name, kw))
                for snap, names in groups.values():
                    self.stats["writer_bytes"] += _tree_bytes(*snap)
                    for name, kw in names:
                        save_checkpoint(
                            self.directory, *snap, hyperparams=self.hyperparams,
                            name=name, **kw,
                        )
                        self.stats["written"] += 1
            except Exception as e:  # raised on the training thread by raise_errors
                self._errors.append(e)
            finally:
                busy_s = time.perf_counter() - t0
                with self._cv:
                    self.stats["writer_busy_s"] += busy_s
                    self._busy = False
                    self._cv.notify_all()
            self._idle(busy_s * (1.0 - self.duty) / self.duty)

    def _idle(self, seconds: float) -> None:
        """Wait ``seconds`` (at most 600) unless a flush or a stop comes."""
        t0 = time.monotonic()
        deadline = t0 + min(seconds, 600.0)
        with self._cv:
            while not (self._stop or self._flushing) and time.monotonic() < deadline:
                self._cv.wait(timeout=deadline - time.monotonic())
            self.stats["writer_idle_s"] += time.monotonic() - t0

    def flush(self) -> None:
        """Wait until every queued save is written (cutting the writer's
        idle short); raise a writer error."""
        with self._cv:
            self._flushing = True
            self._cv.notify_all()
            while self._box or self._busy:
                self._cv.wait()
            self._flushing = False
        self.raise_errors()

    def stop(self, timeout: float | None = None) -> None:
        """Let the thread write what is queued, then end; join it."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout)

    def raise_errors(self) -> None:
        if self._errors:
            errs = [f"{type(e).__name__}: {e}" for e in self._errors]
            self._errors.clear()
            raise RuntimeError(f"async checkpoint write(s) failed: {errs}")


def train(
    prepared: PreparedData,
    config: TrainConfig,
    verbose: bool = True,
    device: str | torch.device = "cuda",
) -> TrainResult:
    """Train on ``device`` (``cuda`` unless the caller asks for the CPU;
    raises without a card)."""
    state: dict = {}
    try:
        return _train_impl(prepared, config, verbose, resolve_device(device), state)
    finally:
        writer = state.get("writer")
        if writer is not None:
            writer.stop(timeout=60.0)
        log_f = state.get("log_f")
        if log_f is not None:
            log_f.close()


def _train_impl(
    prepared: PreparedData, config: TrainConfig, verbose: bool, dev: torch.device, _state: dict
) -> TrainResult:
    world, rank = world_rank()
    n_mesh = config.mesh_devices or world
    if n_mesh != world:
        raise ValueError(
            f"mesh_devices={config.mesh_devices}, but the torch.distributed world has "
            f"{world} rank(s): mesh_devices must be the world's size (or 0), one rank "
            "per device"
        )
    if config.fast_bipartite not in ("off", "f32", "bf16"):
        raise ValueError(f"fast_bipartite must be off, f32 or bf16: {config.fast_bipartite!r}")
    # A process that joined a torch.distributed world trains on the world's
    # mesh, a world of 1 included; without a world, on one device.
    on_mesh = n_mesh > 1 or joined_world()
    if on_mesh and config.partition not in ("gspmd", "edge"):
        raise ValueError(f"partition must be gspmd or edge: {config.partition!r}")
    if config.model not in ("lightgcn", "simgcl", "dgcf"):
        raise ValueError(f"model must be lightgcn, simgcl or dgcf: {config.model!r}")
    simgcl, dgcf = config.model == "simgcl", config.model == "dgcf"
    if (simgcl or dgcf) and (on_mesh or config.fast_bipartite == "off"):
        raise ValueError(
            f"model {config.model} trains on one device with fast_bipartite f32 or bf16 (simgcl's "
            "views run the fast plans, dgcf's routed products gather in that type); the mesh "
            "branches and the layered branch train lightgcn only"
        )
    is_main = rank == 0
    t_setup0 = time.perf_counter()
    os.makedirs(config.checkpoint_dir, exist_ok=True)
    log_path = config.log_path or os.path.join(config.checkpoint_dir, "train_log.jsonl")
    log_f = open(log_path if is_main else os.devnull, "a")
    _state["log_f"] = log_f
    verbose = verbose and is_main

    def log(record: dict):
        log_f.write(json.dumps(record) + "\n")
        log_f.flush()
        if verbose:
            print(record.get("msg") or json.dumps(record), flush=True)

    fast = config.fast_bipartite != "off"
    n_users, n_items = prepared.n_users, prepared.n_items
    # The fast branches and the mesh branches build from the host graph;
    # the one-device layered branch propagates over the graph on the device.
    graph = build_graph(
        prepared.edge_user, prepared.edge_item_node, prepared.edge_weight,
        n_users, n_items, items_offset=True, device="cpu" if fast or on_mesh else dev,
    )
    num_edges, num_arcs = len(prepared.edge_user), int(graph.src.shape[0])
    sdata = make_sampler_data(prepared.sampler, n_users, n_items, dev)
    val_buckets = build_eval_buckets(prepared.val, width_floor=256, device=dev)
    test_buckets = build_eval_buckets(prepared.test, width_floor=256, device=dev)
    t_graph_s = time.perf_counter() - t_setup0

    cfg = LightGCNConfig(
        num_nodes=graph.num_nodes, embedding_dim=config.latent_dim, num_layers=config.n_layers,
        alpha=simgcl_alphas(config.n_layers) if simgcl else None,
    )
    params = init_params(torch.Generator().manual_seed(config.seed), cfg, device=dev)
    optimizer = Adam(config.lr)
    opt_state = optimizer.init(params)

    start_epoch = 0
    if config.resume and os.path.exists(
        os.path.join(config.checkpoint_dir, LAST_NAME, "meta.json")
    ):
        leaves, meta = load_checkpoint(config.checkpoint_dir, LAST_NAME)
        params, opt_state = restore_into(params, opt_state, leaves)
        start_epoch = meta["epoch"] + 1
        log({"msg": f"resumed from epoch {meta['epoch']} (next: {start_epoch})"})

    n_batch = config.batches_per_epoch or max(1, num_edges // (config.batch_size * 40))

    def build_with_retry(build, what: str):
        """A one-time operator build, retried once after an out-of-memory
        error with the allocator's cache emptied; a real shortage fails
        again."""
        try:
            return build()
        except torch.cuda.OutOfMemoryError as e:
            log({"msg": f"{what}: out of device memory ({e}); retrying once in {RETRY_WAIT_S:.0f} s"})
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            time.sleep(RETRY_WAIT_S)
            return build()

    # Identity on one device; a mesh branch maps its layout to the unified,
    # unpadded checkpoint layout and back.
    ckpt_view = lambda tree: tree
    post_restore = lambda p: p
    mesh = None
    noise_gen = None  # SimGCL's noise or DGCF's cor rows, reseeded every epoch
    hyperparams = config.hyperparams()  # the checkpoints' meta
    bf16 = config.fast_bipartite == "bf16"
    mode = "bfloat16" if bf16 else "float32"
    edge_cap = config.batch_edge_cap or max(64 * config.batch_size, 8192)
    if on_mesh:
        mesh, step_graph, step, compute_embedding, ckpt_view, post_restore, params, opt_state = (
            _mesh_branch(config, cfg, graph, params, opt_state, optimizer, start_epoch, n_mesh,
                         dev, edge_cap, log, build_with_retry)
        )
        run_steps = make_run_steps(step)
        graph = None  # superseded by the branch's layout
    elif dgcf:
        t0 = time.perf_counter()
        rg = build_with_retry(lambda: build_routing_graph(graph, device=dev), "routing-graph build")
        _sync(dev)
        log({"msg": f"routing graph built in {time.perf_counter() - t0:.1f}s ({rg.n_arcs} arcs)",
             "build_s": time.perf_counter() - t0})
        graph = None  # superseded by rg
        gather = torch.bfloat16 if bf16 else None
        K, T, L = config.dgcf_factors, config.dgcf_iterations, config.n_layers
        cor_batch = authors_cor_batch(n_users, n_items, num_edges, config.batch_size)
        hyperparams["cor_batch"] = cor_batch
        noise_gen = torch.Generator(device=dev)
        loss_fn = make_dgcf_loss_fn(K, T, L, config.decay, config.cor_weight, cor_batch, noise_gen, gather)
        _, run_steps = make_train_fns(
            cfg, optimizer, config.batch_size, config.decay,
            sample_replace=config.sample_replace, loss_fn=loss_fn,
        )
        compute_embedding = lambda p: dgcf_forward(p["embedding"], rg, K, T, L, gather)[0]
        step_graph = rg
    elif fast:
        t0 = time.perf_counter()
        fb = build_with_retry(
            lambda: build_fast_bipartite(
                graph,
                dtype=torch.bfloat16 if bf16 else torch.float32,
                fast_ops=True,
                msgs_dtype=mode,
                heavy_users=config.heavy_users,
                heavy_dtype=mode,
                device=dev,
            ),
            "fast-bipartite build",
        )
        _sync(dev)
        op_gb = fb.item_op.numel() * fb.item_op.element_size() / 1e9
        log({
            "msg": (
                f"fast bipartite operator built in {time.perf_counter() - t0:.1f}s "
                f"({op_gb:.2f} GB {config.fast_bipartite})"
            ),
            "build_s": time.perf_counter() - t0,
            "item_op_s": fb.build_seconds["item_op"],
            "plans_s": fb.build_seconds["plans"],
        })
        graph = None  # superseded by fb
        alpha = cfg.alphas(dev)
        if simgcl:
            noise_gen = torch.Generator(device=dev)
            loss_fn = make_simgcl_loss_fn(cfg, config.decay, config.cl_weight, config.cl_eps,
                                          config.cl_temp, edge_cap, noise_gen)
        else:
            batch_embed = lambda p, fb_, u, po, ne: fast_batch_embeddings(
                p, fb_, cfg.num_layers, u, po, ne, edge_cap=edge_cap, alpha=alpha
            )
            loss_fn = make_loss_fn(cfg, config.decay, batch_embed_fn=batch_embed)
        _, run_steps = make_train_fns(
            cfg, optimizer, config.batch_size, config.decay,
            sample_replace=config.sample_replace, loss_fn=loss_fn,
        )
        compute_embedding = lambda p: fast_get_embedding(p, fb, cfg.num_layers, alpha=alpha)
        step_graph = fb
    else:
        _, run_steps = make_train_fns(
            cfg, optimizer, config.batch_size, config.decay,
            sample_replace=config.sample_replace,
        )
        step_graph = graph
        compute_embedding = lambda p: get_embedding(p, graph, cfg)

    if mesh is not None:
        from ..parallel.sharded_eval import make_sharded_eval_fn

        # Eval users split over every rank; per-bucket sums all-reduced.
        eval_buckets = make_sharded_eval_fn(mesh, n_users, config.k, mask_mode=config.mask_mode)
    else:
        eval_buckets = lambda emb, buckets: evaluate_bucketed(
            emb, buckets, n_users, config.k, mask_mode=config.mask_mode
        )

    def evaluate_split(p: dict, buckets) -> tuple[float, float]:
        with torch.no_grad():
            return eval_buckets(compute_embedding(p), buckets)

    log({
        "msg": (
            f"training: {n_users} users x {n_items} items, {num_edges} edges, "
            f"{n_batch} batches/epoch, dim {config.latent_dim}, {config.n_layers} layers, "
            f"{dev}"
        )
    })

    writer = None
    if config.async_saves and world > 1:
        log({"msg": "async saves: off on a mesh of processes (rank 0 writes synchronously)"})
    elif config.async_saves:
        writer = CheckpointWriter(
            config.checkpoint_dir, hyperparams, duty=config.async_save_duty
        )
        _state["writer"] = writer
        log({
            "msg": (
                "async saves: host snapshots (pinned for CUDA leaves, row bands above "
                f"{2 * SNAPSHOT_BAND_BYTES >> 20} MB), one writer thread at duty {writer.duty}"
            )
        })

    def do_save(params_t: dict, opt_t: AdamState, targets: list) -> None:
        """Write (params_t, opt_t) to every (name, meta kwargs) of targets.
        On a mesh the caller has gathered them on every rank, and
        ``save_checkpoint`` writes on rank 0 only."""
        if writer is None:
            for name, kw in targets:
                save_checkpoint(
                    config.checkpoint_dir, params_t, opt_t,
                    hyperparams=hyperparams, name=name, **kw,
                )
        else:
            writer.save(params_t, opt_t, targets)

    def flush_saves() -> None:
        if writer is not None:
            writer.flush()
        if world > 1:
            # Readers (the best-restore, a resume) must not race rank 0's
            # writes: every rank flushes at the same points of the loop.
            barrier()

    history = []
    best_recall = best_precision = 0.0
    best_epoch = -1
    best_params = None  # device copy of the best epoch's params
    best_dirty = False  # best_params newer than the on-disk BEST
    best_meta_path = os.path.join(config.checkpoint_dir, BEST_NAME, "meta.json")
    if start_epoch > 0 and os.path.exists(best_meta_path):
        with open(best_meta_path) as f:
            bmeta = json.load(f)
        best_recall = float(bmeta.get("recall", 0.0))
        best_precision = float(bmeta.get("precision", 0.0))
        best_epoch = int(bmeta.get("epoch", -1))
        log({
            "msg": (
                f"resume: on-disk BEST (epoch {best_epoch}, R@{config.k} "
                f"{best_recall:.6f}) is the bar to beat"
            )
        })
    log({
        "msg": (
            f"setup: {time.perf_counter() - t_setup0:.1f}s total "
            f"(graph+sampler+eval buckets {t_graph_s:.1f}s)"
        ),
        "setup_s": time.perf_counter() - t_setup0,
        "graph_setup_s": t_graph_s,
    })

    for epoch in range(start_epoch, config.epochs):
        profiling = config.profile_dir and epoch == min(config.profile_epoch, config.epochs - 1)
        generator = torch.Generator(device=dev).manual_seed(_epoch_seed(config.seed, epoch))
        if noise_gen is not None:
            noise_gen.manual_seed(_noise_seed(config.seed, epoch))
        t0 = time.perf_counter()
        with _profiler(dev) if profiling else contextlib.nullcontext() as prof:
            params, opt_state, metrics = run_steps(
                params, opt_state, step_graph, sdata, generator, n_batch
            )
            _sync(dev)
        t_train = time.perf_counter() - t0
        if profiling:
            os.makedirs(config.profile_dir, exist_ok=True)
            # One trace per rank on a mesh (rank 0 logs the names of all).
            name = f"train_epoch{epoch}" + ("_rank{}" if world > 1 else "") + ".json"
            prof.export_chrome_trace(os.path.join(config.profile_dir, name.format(rank)))
            traces = [os.path.join(config.profile_dir, name.format(r)) for r in range(world)]
            log({"msg": f"profiler trace (epoch {epoch}) -> {', '.join(traces)}"})

        precision, recall = evaluate_split(params, val_buckets)
        t_total = time.perf_counter() - t0
        rec = {
            "epoch": epoch,
            "bpr_loss": metrics["bpr_loss"],
            "reg_loss": metrics["reg_loss"],
            "loss": metrics["loss"],
            "val_precision": precision,
            "val_recall": recall,
            "dropped_arcs": metrics["dropped_arcs"],
            **({"cl_loss": metrics["loss"] - metrics["bpr_loss"] - metrics["reg_loss"]} if simgcl else {}),
            **({"cor_loss": metrics["loss"] - metrics["bpr_loss"] - metrics["reg_loss"]} if dgcf else {}),
            "train_s": t_train,
            "eval_s": t_total - t_train,
            "epoch_s": t_total,
            # Arcs x layers x 3 that the reference's layered forward and
            # backward would process in the same time (not measured work).
            "ref_equiv_edges_per_s": num_arcs * cfg.num_layers * n_batch * 3 / max(t_train, 1e-9),
        }
        history.append(rec)

        t_save0 = time.perf_counter()
        try:
            cur_targets = []  # saves of the current state share one snapshot
            if recall > best_recall:
                best_recall, best_precision, best_epoch = recall, precision, epoch
                best_params = {k: v.clone() for k, v in params.items()}
                best_dirty = True
                if config.checkpoint_every == 1:
                    cur_targets.append(
                        (BEST_NAME, dict(epoch=epoch, precision=precision, recall=recall))
                    )
                    best_dirty = False
            last_due = config.checkpoint_every > 0 and (epoch + 1) % config.checkpoint_every == 0
            if last_due or epoch == config.epochs - 1:
                cur_targets.append(
                    (LAST_NAME, dict(epoch=epoch, precision=precision, recall=recall))
                )
            if cur_targets:
                do_save(ckpt_view(params), ckpt_view(opt_state), cur_targets)
                # Throttled mode: BEST improved in an earlier epoch of this
                # window is persisted on the same cadence.
                if best_dirty:
                    do_save(
                        ckpt_view(best_params), ckpt_view(opt_state),
                        [(BEST_NAME, dict(epoch=best_epoch, precision=best_precision,
                                          recall=best_recall))],
                    )
                    best_dirty = False
                rec["save_s"] = time.perf_counter() - t_save0
        finally:
            log({
                **rec,
                "msg": (
                    f"Epoch {epoch}: Val P@{config.k}: {precision:.6f}, "
                    f"R@{config.k}: {recall:.6f}, Loss: ({metrics['bpr_loss']:.6f}, "
                    f"{metrics['reg_loss']:.6f}, {metrics['loss']:.6f}) [{t_total:.2f}s]"
                ),
            })

    if best_params is not None:
        params = best_params
        if best_dirty:
            do_save(
                ckpt_view(params), ckpt_view(opt_state),
                [(BEST_NAME, dict(epoch=best_epoch, precision=best_precision, recall=best_recall))],
            )
    elif best_epoch >= 0:
        # The resumed window never beat the on-disk BEST: test that one,
        # restored in the checkpoint layout and laid out again for the run.
        flush_saves()
        leaves, _ = load_checkpoint(config.checkpoint_dir, BEST_NAME)
        params, opt_state = restore_into(ckpt_view(params), ckpt_view(opt_state), leaves)
        params = post_restore(params)
    t_final0 = time.perf_counter()
    test_precision, test_recall = evaluate_split(params, test_buckets)
    log({
        "msg": (
            f"Best epoch ({best_epoch}): Val P@{config.k}: {best_precision:.6f}, "
            f"R@{config.k}: {best_recall:.6f} | Test P@{config.k}: "
            f"{test_precision:.6f}, R@{config.k}: {test_recall:.6f}"
        ),
        "best_epoch": best_epoch,
        "test_precision": test_precision,
        "test_recall": test_recall,
        "test_eval_s": time.perf_counter() - t_final0,
    })
    t_flush0 = time.perf_counter()
    flush_saves()
    if writer is not None:
        writer.stop()
        s = writer.stats
        log({
            "msg": (
                f"async saves: {s['written']} written, {s['coalesced']} coalesced of "
                f"{s['requested']} requested; writer busy {s['writer_busy_s']:.1f}s, idle "
                f"{s['writer_idle_s']:.1f}s for {s['writer_bytes'] / 1e9:.2f} GB; final flush "
                f"{time.perf_counter() - t_flush0:.1f}s"
            ),
            "flush_s": time.perf_counter() - t_flush0,
            **s,
        })
    return TrainResult(
        params=params,
        history=history,
        best_epoch=best_epoch,
        best_val_precision=best_precision,
        best_val_recall=best_recall,
        test_precision=test_precision,
        test_recall=test_recall,
    )


def _own_band(layout):
    """``layout`` with its own copy of this rank's B_ii band (a view until
    then), so that the rest of B_ii can be freed. The copy keeps B_ii's row
    padding (``ops.bipartite.row_padded``), which ``.clone()`` would drop."""
    rows = layout.item_op.rows
    own = row_padded(*rows.shape, rows.dtype, rows.device).copy_(rows)
    return dataclasses.replace(layout, item_op=dataclasses.replace(layout.item_op, rows=own))


def _mesh_branch(config, cfg, graph, params, opt_state, optimizer, start_epoch: int, n_mesh: int,
                 dev, edge_cap: int, log, build_with_retry):
    """Lay the run out on a mesh of the world's ``n_mesh`` ranks (the JAX
    driver's mesh branches). ``params`` and ``opt_state`` come in the
    unified layout (a resumed ``opt_state`` too) and leave in the branch's.
    Returns (mesh, step_graph, train_step, compute_embedding, ckpt_view,
    post_restore, params, opt_state)."""
    from ..parallel.mesh import make_mesh

    bf16 = config.fast_bipartite == "bf16"
    mode = "bfloat16" if bf16 else "float32"
    op_dtype = torch.bfloat16 if bf16 else torch.float32
    num_nodes = graph.num_nodes
    t0 = time.perf_counter()

    def laid_out(to_layout):
        p = to_layout(params)
        return p, optimizer.init(p) if start_epoch == 0 else to_layout(opt_state)

    if config.partition == "edge" and config.fast_bipartite != "off":
        from ..ops.bipartite import build_item_operator, split_graph
        from ..parallel.edge_partition_fast import (
            build_fast_edge_partition, make_fast_edge_fns, merge_ep_view, split_ep_tree,
        )

        mesh = make_mesh(n_mesh, axis_sizes=(n_mesh,), axis_names=("model",), device=dev)
        split = split_graph(graph)
        item_op = build_with_retry(
            lambda: build_item_operator(split, dtype=op_dtype, device=dev), "item-operator build"
        )
        fep = _own_band(build_fast_edge_partition(
            split, mesh, item_op, msgs_dtype=mode, heavy_users=config.heavy_users, heavy_dtype=mode
        ))
        del item_op
        to_layout = lambda tree: split_ep_tree(tree, fep)
        params_l, opt_l = laid_out(to_layout)
        embed, step = make_fast_edge_fns(
            cfg, optimizer, mesh, fep, config.batch_size, config.decay, edge_cap
        )
        log({"msg": (
            f"fast edge partition built in {time.perf_counter() - t0:.1f}s: {n_mesh} shards x "
            f"{fep.rows_per_shard} user rows, B_ii band {fep.item_op.rows.shape[0]} rows, "
            f"heavy_users={config.heavy_users}"
        )})
        return (mesh, fep, step, lambda p: embed(p, fep), lambda tree: merge_ep_view(tree, fep),
                to_layout, params_l, opt_l)
    if config.partition == "edge":
        from ..parallel.edge_partition import (
            build_edge_partition, make_explicit_fns, pad_params, unpad_params,
        )

        mesh = make_mesh(n_mesh, axis_sizes=(n_mesh,), axis_names=("model",), device=dev)
        part = build_edge_partition(graph, mesh)
        to_layout = lambda tree: pad_params(tree, part)
        params_l, opt_l = laid_out(to_layout)
        embed, step = make_explicit_fns(cfg, optimizer, mesh, part, config.batch_size, config.decay)
        log({"msg": (
            f"edge partition: {n_mesh} shards x {part.rows_per_shard} rows, max boundary send "
            f"{part.max_send} rows/peer"
        )})
        return (mesh, part, step, lambda p: embed(p, part)[:num_nodes],
                lambda tree: unpad_params(tree, part), to_layout, params_l, opt_l)

    from ..parallel.sharded_train import (
        make_sharded_fast_train_step, make_sharded_train_step, propagate_arc_shards,
        shard_fast_bipartite, shard_graph, shard_params, sharded_fast_embedding, unshard_params,
    )

    mesh = make_mesh(n_mesh, device=dev)
    to_layout = lambda tree: shard_params(tree, mesh)
    params_l, opt_l = laid_out(to_layout)
    if config.fast_bipartite != "off":
        fb = build_with_retry(
            lambda: build_fast_bipartite(graph, dtype=op_dtype, device=dev),
            "fast-bipartite build",
        )
        step_graph = _own_band(shard_fast_bipartite(
            fb, mesh, fast_ops=True, msgs_dtype=mode, heavy_users=config.heavy_users,
            heavy_dtype=mode,
        ))
        del fb
        step = make_sharded_fast_train_step(
            cfg, optimizer, mesh, config.batch_size, config.decay, edge_cap
        )
        embed = lambda p: sharded_fast_embedding(p, step_graph, cfg.num_layers)
    else:
        step_graph = shard_graph(graph, mesh)
        step = make_sharded_train_step(cfg, optimizer, mesh, config.batch_size, config.decay)
        prop = functools.partial(propagate_arc_shards, mesh=mesh)
        embed = lambda p: get_embedding(
            unshard_params(p, mesh, num_nodes), step_graph, cfg, prop
        )
    log({"msg": (
        f"mesh training: {mesh.shape}, built in {time.perf_counter() - t0:.1f}s "
        f"(fast_bipartite={config.fast_bipartite}, heavy_users={config.heavy_users})"
    )})
    return (mesh, step_graph, step, embed, lambda tree: unshard_params(tree, mesh, num_nodes),
            to_layout, params_l, opt_l)


def _profiler(dev: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)
