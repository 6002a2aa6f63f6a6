"""Drive the PyTorch port's serving, training and probe paths on one H100
and hold its CUDA kernels against their plain versions.

    python3 chip_smoke.py [--seed 0]

Phases, one printed line each (plus detail lines):
  0 device    the card's name and power limit (nvidia-smi), TF32 off; one
              Adam direction and one recall/precision call bit for bit
              against the host's f32 divisions
  1 build     nvcc builds the five csrc/*.cu kernels for sm_90a, all at once
  2 data      a full-scale synthetic corpus made from --seed: 1,552,888 users
              x 54,571 items, 10,157,407 unique edges of which 5% are held
              out (half val, half test), leaving 9,649,537 train edges; Zipf
              (0.9) item popularity, power-law user degrees (the 16,384
              heaviest users hold about a fifth of the arcs); the splits
              follow the JAX package's data/prepare.py
  3 kernel    each kernel against its plain version: first the probes'
              (K2, K4, K5, K6: see phase 10), then on the main path's
              inputs the segment reduce (K1) in f32 over all user->item arcs
              (the service's run) and in bf16 over the tail left by the
              16,384-user head (the main configuration's run) on the table
              cast into 16-byte rows by K1's cast kernel, each launched twice
              for equal bytes, with per-pass device times; K1 on edge-case
              plans (empty rows, a 2,000-chunk hub) at D 1 to 256 on f32,
              bf16 and padded bf16 tables, and through gather_segreduce on
              expanded, transposed and misaligned f32 tables; the stream
              sum (K3) over K1's bf16 tail messages; kernel, plain and
              library times and the bound; K1's accumulate mode (out +=
              Â·x) against segreduce_plain(prev=) on the edge-case plans,
              a plan with no arc (on 0- and 1-row tables) and a one-row
              hub, rows with no arc unchanged; the src-bucketed to_items
              (gather_segreduce_bucketed, 8 and 16 source ranges of the
              bf16 tail plan: one K1 launch, then one accumulate launch
              per later bucket) against the unbucketed K1 and its plain
              version, timed beside the unbucketed K1 and its bound
  4 forward   the RecommenderService (dim 90, 5 layers, f32) propagates once
              through the fast forward; its cache is held against the layered
              get_embedding on the card; forward time and a profiler breakdown
  5 bf16      the main configuration's forward (bf16 B_ii, messages and a
              16,384-user head) against the f32 forward; time and breakdown
  6 serve     the REST server with the batcher answers :predict requests of
              1, 8, 64 and 512 users (300 timed per size, p50/p90/p99), each
              answer checked against a plain top-K
 13 quantized (runs after 6) phase 4's RecommenderService switched to
              quantized serving: its refresh propagates through K1 f32 and
              quantizes the [1,607,459, 90] cache to int8 rows; the rows and
              scales equal the host's quantize_rows; the int8 product
              (torch._int_mm, padded to its shape rules) exact at odd
              users x items shapes (1 to 5,094 x 5,457 to 54,571);
              topk_scores_int8 on 4,096 users against
              its plain version (the exact f32 product of the int8 values):
              scores bit for bit, ids equal but for ties; the overlap of its
              top-20 with the f32 top-20; the int8 product and top-20 timed
              against the f32 ones at 512 and 4,096 users; the REST server
              over it answers 300 timed requests per size, each held
              against the plain int8 top-20 (differences only at exact
              ties), p50/p90/p99 beside phase 6's
 14 mesh      (runs after 13) the multi-device forward and sharded eval on
              phase 4/5's operators: a world of 1 over NCCL in this process
              (the fast edge partition's f32 embed against phase 4's
              forward), then a gloo world of 2 spawned ranks sharing the
              card (B_ii and the tables reach them by CUDA IPC): the embed in
              f32 (phase 4's bound) and in bf16 (phase 5's bound against the
              f32 forward; its distance from phase 5's forward printed),
              sharded_to_items / sharded_to_users in f32 and bf16 against
              fast_to_items / fast_to_users, sharded_evaluate and
              make_sharded_eval_fn on the val split (P and R within 1e-6
              relative of evaluate / evaluate_bucketed, ids equal); then, one
              rank at a time, K1 at each rank's to_items and to_users shapes
              in f32 and bf16 against its plain version, with kernel, plain
              and torch.sparse.mm times, the bound and ell_apply's time on
              the same to_users arcs
  7 grad      on one fixed batch of 1024, the exact fast batched loss's
              gradient and the full fast forward's loss gradient (K1 runs in
              fast_to_users' backward) against the layered loss's gradient,
              taken in f64
  8 breakdown the train step's parts (the port of scripts/profile_step.py):
              fast_to_items, fast_to_users, the B_ii pair matmul, K1 bf16 and
              K3 on its messages, one train step, one step under the
              profiler; val R@20 of the untrained params and of popularity
  9 train     train() at dim 90 / 5 layers / batch 1024 / bf16 / 16,384
              head, 2 epochs of 235 batches with async checkpoints (writer
              duty 0.5), then a resume from LAST for a third epoch (duty
              1.0); save_s and the writer's busy and idle seconds and bytes
              of both; the banded snapshot's checkpoint bytes equal an
              unbanded save of the same tensors
 10 probes    the ports of the probe scripts (their kernels checked and
              timed in phase 3): K2 (csrc/tile_segreduce.cu) in
              f32 and bf16 over the to_items plan (10,157,407 arcs into
              54,571 items, OT 512, CH 2048, D 80) and in bf16 over the
              to_users plan (into 1,639,358 users), twice for equal bytes,
              and on odd layouts; K4 (csrc/row_gather.cu) on
              [1,639,358, 128] bf16 rows and [524,288, 8, 128] f32 tile
              rows, exact at every (k_inflight, chunk) the probe times, and
              at odd chunks that walk a bulk block through several index
              windows; K5 and K6 (csrc/lane_gather.cu: a transposed
              table in L2, windows of indices) exact on edge cases (d 1 to
              200, ragged and many windows, both layouts, indices 16 bytes
              into a buffer) and on an [80, 54,571] bf16 table with
              10,153,984 indices; each against
              its plain version (exact for the gathers) with kernel, plain
              and library times, per-pass device times, the bound and
              yardsticks (K2: torch.segment_reduce over the real arcs; K4: a
              contiguous copy of the same bytes); here, counted from 0, each
              probe module's main at its full shapes
 12 cli       (runs before 11) the entry points as a user runs them, in a
              temporary directory: the port's synthetic_events makes the
              clustered corpus at 1/10 of the full scale (163,936 users,
              5,457 items, 2,069,284 events over 1,015,741 pairs, 77
              clusters, affinity 0.85, item skew 0.9, seed 42) into an
              event CSV; cli.preprocess turns it into an edges CSV through
              the native reader (held equal to events_to_edges in memory);
              cli.train --edges trains 2 epochs at dim 90 / 5 layers / bf16 /
              16,384 head; the manifest, both checkpoints, two epoch records,
              a falling finite loss, no dropped arcs and a best val R@20 at
              least 3x the popularity baseline's on the same split are
              checked; ETL (from the training log), B_ii, epoch and eval
              seconds and the val R@20 curve on the detail line; two
              cli.train ranks (torch's four variables, --mesh 2 --partition
              edge --fast bf16 --backend gloo, both on cuda:0) train the
              same edges CSV for 2 epochs, rank 0 alone writing, their best
              val R@20 at least 3x popularity's and within 0.01 of the
              one-device run's, then --resume trains a third; cli.eda on
              the event CSV (its stats against the CSV's own counts, its
              projection equal to the CSV, every report section, its
              seconds); then, after
              the path's launches are read, K1 bf16 and its cast are held
              against their plain versions at the path's own shapes (the
              best checkpoint's user table over the tail plan that
              train/driver.py builds from the saved artifact); then
              cli.infer -k 20 on the best checkpoint explains every hit user
              (the metrics CSV's rows are the eval users and its recall is
              evaluate's on the same embedding; every path starts at its
              user, ends at its hit item and walks train edges; the int8
              top-20 keeps at least 0.9 of the f32 top-20); two SVD epochs
              fed fixed permutations on the card equal the CPU's (rtol
              1e-5), and cli.svd (2 folds, 5 epochs, P/R@10) on the edges
              CSV lands within 0.003 of JAX's cli.svd on the same CSV, while
              fits of 0 and 1 epochs land outside that limit
 15 mesh_train (runs after 14) the multi-device training steps at the
              main configuration's width on phase 4/5's operators, three
              fixed batches of 1024 from phase 4's params, each step held
              against the one-device main-path step (make_train_fns over
              fast_batch_embeddings) from the same params: its loss
              (rtol 1e-5), the table (2e-3 relative Frobenius) and Adam's
              first moment (the gradients: f32 1e-5, bf16 2e-3); in a
              world of 1 over NCCL in
              this process the fast edge partition's bf16 step (and one
              f32 step), then in a gloo world of 2 spawned ranks sharing
              the card the fast edge partition's and the GSPMD fast bf16
              steps, the replicated leaves bit-equal on every rank after
              every step; in both worlds the GSPMD segment-sum path
              (shard_fast_bipartite(fb16, mesh), fast_ops=False; in the
              gloo world on a (data 2, model 1) mesh, each rank summing
              half of the arcs and one all-reduce adding the halves): its
              forward against the one-device plan-less forward (phase 4's
              bound) and three steps against the one-device plan-less step
              (the bf16 tolerances: B_ii is bf16); each step's ms,
              labelled as ranks sharing one card; then, against their
              plain versions and outside the
              counts: K1 f32 and bf16 at the world of 1's plans (both
              directions: its users-side plan is the whole graph's, which
              the to_items backward runs), and, one rank at a time, K1
              bf16 at each gloo rank's GSPMD shapes (both directions) and
              its cast at the rank's edge-partition user rows
 16 bench     (runs after 12) python -m gnn_ecommerce_tpu_torch.bench in a
              process of its own at root bench.py's full shapes (1,639,358
              users x 54,571 items, 10,157,407 edges, dim 80, 4 layers,
              batch 1024, 25,000 eval users): its one JSON line has root
              bench.py's keys, finite numbers, the card, K1 bf16 and its
              cast launched (the process counts from 0) and no roofline
              share above 100%; forward_ms of the segment, plans and
              bucketed (8 source ranges) candidates, the fastest named by
              fast_path, and K1's accumulate launches a multiple of 7 (one
              launch and seven accumulate launches a bucketed to_items);
              its progress and line are printed; then K1 bf16, its cast
              and the 8-bucket K1 against their plain versions at its
              shapes (the [1,639,358, 80] initial user table over its
              graph's tail plan after the 16,384-user head)
 11 kernels   one JSON line of the port's kernels, with their launches on
              the paths of phases 4-6, 13, 14 and 15 (every rank's), 7, 8,
              9, 10, 12 (train, infer and svd apart) and 16 (each counted
              from 0 just before the path and read just after), K1's with
              its accumulate launches (also counted apart); K1's rows
              (and its cast's) also carry each mesh rank's shapes and times
              (mesh, mesh_train; K1's mesh_train_world1: the world of 1),
              and K1 bf16's and the cast's the cli and bench shapes
The last line is {"ok": true, "device": {...}}. Any failed check raises.
Without CUDA, or without the repository around this file, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import filecmp
import hashlib
import io
import json
import multiprocessing
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.request

import numpy as np
import torch

from gnn_ecommerce_tpu_torch import bench
from gnn_ecommerce_tpu_torch.cli import eda as eda_cli
from gnn_ecommerce_tpu_torch.cli import infer as infer_cli
from gnn_ecommerce_tpu_torch.cli import preprocess as preprocess_cli
from gnn_ecommerce_tpu_torch.cli import svd as svd_cli
from gnn_ecommerce_tpu_torch.cli import train as train_cli
from gnn_ecommerce_tpu_torch.data.artifacts import load_prepared
from gnn_ecommerce_tpu_torch.data.events import EVENT_TYPE_WEIGHTS_V1, events_to_edges, read_csv
from gnn_ecommerce_tpu_torch.data.prepare import CsrList, EvalSplit, PreparedData, SamplerArrays
from gnn_ecommerce_tpu_torch.data.synthetic import synthetic_events
from gnn_ecommerce_tpu_torch.device import mm_f32, resolve_device
from gnn_ecommerce_tpu_torch.eval.baselines import popularity_recall_at_k
from gnn_ecommerce_tpu_torch.eval.metrics import recall_precision_at_k
from gnn_ecommerce_tpu_torch.eval.evaluate import (
    build_eval_batch,
    build_eval_buckets,
    evaluate,
    evaluate_bucketed,
)
from gnn_ecommerce_tpu_torch.graph.build import build_graph
from gnn_ecommerce_tpu_torch.models.lightgcn import LightGCNConfig, get_embedding, init_params
from gnn_ecommerce_tpu_torch.models.losses import bpr_loss, reg_loss
from gnn_ecommerce_tpu_torch.models.svd import SVDConfig, pad_edges, svd_epoch
from gnn_ecommerce_tpu_torch.ops._kernels import (
    ALL_KERNELS,
    LANE_GATHER,
    ROW_GATHER,
    SEGREDUCE,
    STREAM_SUM,
    TILE_SEGREDUCE,
    stream_sum,
    stream_sum_plain,
)
from gnn_ecommerce_tpu_torch.ops.bipartite import (
    FastBipartite,
    build_fast_bipartite,
    build_fast_ops,
    fast_batch_embeddings,
    fast_get_embedding,
    fast_to_items,
    fast_to_users,
    split_graph,
    split_heavy_users,
)
from gnn_ecommerce_tpu_torch.ops.spmm_fast import (
    bf16_row_width,
    bf16_rows,
    bf16_rows_plain,
    build_bucketed_segreduce_plan,
    build_ell_plan,
    build_segreduce_plan,
    ell_apply,
    gather_segreduce,
    gather_segreduce_bucketed,
    segreduce_plain,
)
from gnn_ecommerce_tpu_torch.ops.spmm_sharded import (
    build_sharded_fast_ops,
    sharded_to_items,
    sharded_to_users,
    user_rows_per_shard,
)
from gnn_ecommerce_tpu_torch.parallel import (
    build_fast_edge_partition,
    make_fast_edge_fns,
    make_mesh,
    make_sharded_eval_fn,
    make_sharded_fast_train_step,
    merge_ep_view,
    shard_fast_bipartite,
    shard_params,
    sharded_evaluate,
    sharded_fast_embedding,
    split_ep_tree,
)
from gnn_ecommerce_tpu_torch.parallel.distributed import all_gather_rows, barrier, init_distributed
from gnn_ecommerce_tpu_torch.parallel.sharded_train import unshard_params
from gnn_ecommerce_tpu_torch.probes import (
    microbench_gather,
    microbench_gather2,
    pallas_gather_probe,
    proto_segreduce,
)
from gnn_ecommerce_tpu_torch.probes.kernels import (
    TILE_SEGREDUCE_RTOL,
    lane_gather_plain,
    row_gather_plain,
    tile_segreduce_abs_sum,
    tile_segreduce_plain,
)
from gnn_ecommerce_tpu_torch.ops.topk_score import _mask_scores, topk_scores
from gnn_ecommerce_tpu_torch.sampling.bpr import make_sampler_data
from gnn_ecommerce_tpu_torch.serve import BatchingRecommender, RecommenderService, make_server
from gnn_ecommerce_tpu_torch.serve.quantized import (
    QuantizedCache,
    int8_product_int_mm,
    int8_product_plain,
    quantize_rows,
    topk_scores_int8,
)
from gnn_ecommerce_tpu_torch.train import LAST_NAME, BEST_NAME, TrainConfig, load_checkpoint, train
from gnn_ecommerce_tpu_torch.train.checkpoint import save_checkpoint
from gnn_ecommerce_tpu_torch.train.driver import CheckpointWriter
from gnn_ecommerce_tpu_torch.train.step import (
    Adam,
    AdamState,
    _bias_correction,
    adam_direction,
    make_loss_fn,
    make_train_fns,
)

N_USERS, N_ITEMS, N_EDGES = 1_552_888, 54_571, 10_157_407
HOLDOUT = 0.05  # held out at random, half val, half test (data/prepare.py)
N_EDGES_TRAIN = N_EDGES - int(round(N_EDGES * HOLDOUT))  # 9,649,537
DIM, LAYERS, HEAVY_USERS = 90, 5, 16_384
BATCH, LR, DECAY = 1024, 0.005, 1e-4
EDGE_CAP = max(64 * BATCH, 8192)  # the driver's default batch arc capacity
# Timed requests per size, after a few untimed ones; each answer is checked
# after the timing, so the check does not sit between two requests.
REQUESTS_PER_SIZE, WARMUP_REQUESTS = 300, 5
ITEM_SKEW, USER_SKEW = 0.9, 0.75
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
# (kernel wrapper, mode) per row of the kernels line. K1's rows also count
# the launches of its accumulate mode (ACCUMULATE), which the line breaks
# out as each row's accumulate_launches.
KERNELS = {
    "segreduce_f32": (SEGREDUCE, "float32"),
    "segreduce_bf16": (SEGREDUCE, "bfloat16"),
    "segreduce_cast_bf16": (SEGREDUCE, "cast_bf16"),
    "stream_sum_bf16": (STREAM_SUM, "bfloat16"),
    "tile_segreduce_f32": (TILE_SEGREDUCE, "float32"),
    "tile_segreduce_bf16": (TILE_SEGREDUCE, "bfloat16"),
    "row_gather_bf16_rows": (ROW_GATHER, "bfloat16"),
    "row_gather_f32_tile_rows": (ROW_GATHER, "float32"),
    "lane_gather_1xn": (LANE_GATHER, "1xn"),
    "lane_gather_8x512": (LANE_GATHER, "8x512"),
}
ACCUMULATE = {"segreduce_f32": "float32_accumulate", "segreduce_bf16": "bfloat16_accumulate"}
# The src-bucketed to_items plan: phase 3 holds it at the main configuration's
# tail with each bucket count here; the benchmark's candidate has
# bench.SRC_BUCKETS (K1 launches a call: one, then one accumulate per later
# bucket).
BUCKET_COUNTS = (8, 16)
# The to_users row shares K2's bf16 counter with the row above: its launches
# are the ones made in these sections of probes/proto_segreduce.py's main,
# and the row above keeps the rest.
TO_USERS = "tile_segreduce_bf16_to_users"
TO_USERS_SECTIONS = ("to_users_pallas_bf16", "to_users_pallas_bf16_ch1024")
# Phase 12's corpus: the clustered corpus of the full-scale quality run
# (scripts/full_corpus_r3.py) at 1/10 scale, as scripts/corpus_minitrain_r3.py
# cut it; its best val R@20 must reach CLI_POPULARITY_FACTOR x popularity's.
CLI_CORPUS = dict(
    n_users=163_936, n_items=5_457, n_events=2_069_284, n_pairs=1_015_741,
    n_clusters=77, affinity=0.85, item_skew=0.9, seed=42,
)
CLI_TRAIN_ARGS = [
    "-e", "2", "--dim", str(DIM), "--layers", str(LAYERS), "--fast", "bf16",
    "--heavy-users", str(HEAVY_USERS),
]
CLI_POPULARITY_FACTOR = 3.0
# What the kernels line keeps of a kernel's check at phase 12's shapes.
CLI_ROW_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")
# Phase 13 (quantized): users of the int8 top-K check and of the product
# timings (the service's largest batch is 512).
QUANT_CHECK_USERS = 4096
# Phase 12's infer step: the int8 top-20 of the trained checkpoint keeps at
# least this share of the f32 top-20, the bound of
# tests/test_eval.py::test_int8_quantized_topk_overlap.
QUANT_OVERLAP_MIN = 0.9
# Phase 12's svd step: cli.svd on the phase's edges CSV (its sha256 below)
# with SVD_ARGS; its mean P@10 and R@10 must lie within SVD_TOL of JAX's
# cli.svd on the same CSV and flags (run on a CPU; the inits and the
# shuffles come from other generators, the folds are the same). Fits of
# SVD_BROKEN_EPOCHS epochs must lie outside it (the port's CPU run read
# P/R 0.00009/0.00005 at 0 epochs, 0.0059/0.0051 at 1), which shows that
# the limit fails an unfitted model.
SVD_ARGS = ["--folds", "2", "--epochs", "5", "-k", "10"]
CLI_EDGES_SHA256 = "23d06557f0385dc784053c96f93b64c71f269fc36be6d6dfc37d9e1df679472a"
SVD_JAX = {"precision_mean": 0.015851077331507236, "recall_mean": 0.018305578641572534}
SVD_TOL = 0.003
SVD_BROKEN_EPOCHS = (0, 1)
# The on-card SVD epochs against the CPU's: rtol and atol (for parameters
# near zero), as tests/test_torch_svd.py holds the CPU against optax.
SVD_EPOCH_RTOL, SVD_EPOCH_ATOL = 1e-5, 1e-7
# Widths of K1's edge cases: with f32, bf16 and padded bf16 tables they take
# every (vector width, loads per arc) instance of csrc/segreduce.cu.
K1_CASE_DIMS = (1, 33, 62, 64, 90, 127, 250, 255, 256)
# Phase 14 (mesh): two gloo ranks share the card; each must report within
# MESH_TIMEOUT_S. The bf16 embed is held to phase 5's bound against the f32
# forward; bf16 to_users to a relative Frobenius error of MESH_BF16_USERS_REL
# against the one-device one (K1 rounds each weight to bf16, the one-device
# ELL keeps it f32: 2^-9 relative a term).
MESH_WORLD, MESH_TIMEOUT_S = 2, 240
BF16_FORWARD_REL = 5e-2
MESH_BF16_USERS_REL = 1e-2
# Phase 15 (mesh train): MESH_TRAIN_STEPS fixed batches of BATCH, each
# step's loss within MESH_LOSS_RTOL of the one-device main-path step's from
# the same params, the table within MESH_TABLE_REL relative Frobenius and
# Adam's first moment (the gradients' running mean) within MESH_GRAD_REL
# (bf16: on the mesh K1 reduces the users-side plans, the backward of
# to_items, with each arc weight rounded to bf16, where the one-device
# backward's ELL keeps it f32). Phase 12's mesh cli.train keeps its best
# val R@20 within MESH_CLI_RECALL_TOL of the one-device run's.
MESH_TRAIN_STEPS = 3
MESH_LOSS_RTOL, MESH_TABLE_REL = 1e-5, 2e-3
MESH_GRAD_REL = {"float32": 1e-5, "bfloat16": 2e-3}
MESH_CLI_RECALL_TOL = 0.01
# Phase 12's EDA step: the report's sections.
EDA_SECTIONS = ("overview", "headline", "variables", "missing", "correlations", "sample")
# Phase 16 (bench): the benchmark's process must end within BENCH_TIMEOUT_S;
# its line carries root bench.py's keys under "detail".
BENCH_TIMEOUT_S = 600
BENCH_DETAIL_KEYS = (
    "b_ii_build_s", "fast_forward_ms", "layered_forward_ms", "train_step_ms", "eval_s",
    "heldout_recall_at_20", "projected_train_hours", "graph", "roofline",
)


def phase(n: int, name: str, t0: float, detail: str = "") -> None:
    print(f"phase {n} {name}: {time.perf_counter() - t0:.2f} s {detail}".rstrip(), flush=True)


def build_kernels() -> None:
    """nvcc builds every kernel's source at once (one thread each); the
    first failure is raised. Prints ptxas's register and spill lines."""
    errors = []

    def build(kernel):
        try:
            kernel.load()
        except subprocess.CalledProcessError as e:  # the compiler's own words, then re-raised
            print(f"  build of {kernel.STEM} failed:\n{e.stdout}{e.stderr}", flush=True)
            errors.append(e)
        except Exception as e:  # re-raised below, on the main thread
            errors.append(e)

    builders = [threading.Thread(target=build, args=(k,)) for k in ALL_KERNELS]
    for b in builders:
        b.start()
    for b in builders:
        b.join()
    if errors:
        raise errors[0]
    for kernel in ALL_KERNELS:
        for line in kernel.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {kernel.STEM}:", line.strip())


def reset_launches() -> None:
    for kernel in ALL_KERNELS:
        kernel.launches = {mode: 0 for mode in kernel.launches}


def read_launches(to_users: int = 0) -> dict:
    """Each row's launches since the last reset (K1's with its accumulate
    launches, which ``<row>_accumulate`` also counts apart); ``to_users``
    of K2's bf16 launches go to the to_users row."""
    counts = {name: kernel.launches[mode] for name, (kernel, mode) in KERNELS.items()}
    for name, mode in ACCUMULATE.items():
        counts[f"{name}_accumulate"] = SEGREDUCE.launches[mode]
        counts[name] += SEGREDUCE.launches[mode]
    counts["tile_segreduce_bf16"] -= to_users
    counts[TO_USERS] = to_users
    return counts


def zipf_ranks(rng: np.random.Generator, n: int, m: int, a: float) -> np.ndarray:
    """m draws of ranks in [0, n) with P(rank r) ∝ (r+1)^-a (inverse CDF of
    the continuous power law, a < 1)."""
    span = (n + 1.0) ** (1.0 - a) - 1.0
    r = (1.0 + rng.random(m) * span) ** (1.0 / (1.0 - a))
    return np.minimum(r.astype(np.int64) - 1, n - 1)


def csr_rows(keys: np.ndarray, rows: np.ndarray, n_items: int) -> CsrList:
    """CSR over ``rows`` (sorted user ids) of the items of the sorted unique
    ``keys`` (user * n_items + item): per-row sorted local item ids."""
    users = keys // n_items
    lo, hi = np.searchsorted(users, rows, "left"), np.searchsorted(users, rows, "right")
    lens = hi - lo
    take = np.repeat(lo, lens) + (np.arange(lens.sum()) - np.repeat(np.cumsum(lens) - lens, lens))
    return CsrList(np.append(0, np.cumsum(lens)).astype(np.int64), keys[take] % n_items)


def make_prepared(seed: int, n_users: int, n_items: int, n_edges: int) -> PreparedData:
    """Unique (user, item) edges: one per user, the rest drawn with power-law
    user activity and Zipf item popularity; about 15% purchases (weight
    1.0), the rest view/cart weights.

    5% of the edges are held out at random, half for val and half for test,
    as ``data/prepare.py`` splits. Each user's first edge stays in train, so
    every user and (checked) every item is in the train graph: no relabelling
    is needed, and the train graph keeps the full corpus's shape. Eval users
    are the users with a purchase in the split; their masks are their train
    purchases; ignore lists are train ∪ val ∪ test purchases (node space)."""
    rng = np.random.default_rng(seed)
    user_of_rank = rng.permutation(n_users)
    base = np.arange(n_users, dtype=np.int64) * n_items + zipf_ranks(rng, n_items, n_users, ITEM_SKEW)
    extra = np.empty(0, np.int64)
    while len(extra) < n_edges - n_users:
        m = int((n_edges - n_users - len(extra)) * 1.3) + 1000
        draw = user_of_rank[zipf_ranks(rng, n_users, m, USER_SKEW)] * n_items
        draw += zipf_ranks(rng, n_items, m, ITEM_SKEW)
        extra = np.setdiff1d(np.concatenate([extra, draw]), base)
    extra = rng.permutation(extra)[: n_edges - n_users]
    n_hold = int(round(n_edges * HOLDOUT))
    test_keys, val_keys = extra[: n_hold // 2], extra[n_hold // 2 : n_hold]
    train_keys = np.sort(np.concatenate([base, extra[n_hold:]]))
    weights = np.array([0.01, 0.1, 0.11, 1.0], np.float32)
    p = [0.7, 0.1, 0.05, 0.15]
    train_w = rng.choice(weights, size=len(train_keys), p=p)
    if len(np.unique(train_keys % n_items)) != n_items:
        raise RuntimeError("an item has no train edge; the corpus needs relabelling")

    def buys(keys):
        return np.unique(keys[rng.choice(weights, size=len(keys), p=p) == 1.0])

    train_buy = train_keys[train_w == 1.0]
    val_buy, test_buy = buys(val_keys), buys(test_keys)

    def eval_split(split_buy):
        users = np.unique(split_buy // n_items)
        return EvalSplit(
            user_ids=users,
            truth=csr_rows(split_buy, users, n_items),
            train_mask=csr_rows(train_buy, users, n_items),
        )

    pos_users = np.unique(train_buy // n_items)
    pos = csr_rows(train_buy, pos_users, n_items)
    ign = csr_rows(np.unique(np.concatenate([train_buy, val_buy, test_buy])), pos_users, n_items)
    return PreparedData(
        n_users=n_users,
        n_items=n_items,
        edge_user=train_keys // n_items,
        edge_item_node=train_keys % n_items + n_users,
        edge_weight=train_w,
        sampler=SamplerArrays(
            pos_users, pos.indptr, pos.values + n_users, ign.indptr, ign.values + n_users
        ),
        val=eval_split(val_buy),
        test=eval_split(test_buy),
        user_classes=np.arange(n_users),
        item_classes=np.arange(n_items),
    )


def time_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_profile(label: str, fn, top: int = 6) -> None:
    """One call of ``fn`` under torch.profiler: wall ms, summed kernel ms on
    the card, the idle share (1 - kernel/wall) and the heaviest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = sorted(
        (e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=lambda e: e.self_device_time_total, reverse=True,
    )
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(
        f"  profile {label}: wall_ms {wall_ms:.3f} kernel_ms {busy_ms:.3f} "
        f"idle_share {1 - busy_ms / wall_ms:.3f}",
        flush=True,
    )
    for e in kernels[:top]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<3d} {e.key[:90]}")


def pass_times(fn, names: dict, label: str = "", calls: int = 5, attempts: int = 3,
               per_call: int = 1) -> dict | None:
    """Device ms per call of each pass of ``fn``, over ``calls`` calls under
    torch.profiler. ``names`` maps a key of each pass's kernel symbol to the
    pass's short name; every pass launches ``per_call`` times a call. None
    unless, in one of ``attempts`` fresh profiles, the profiler recorded
    each pass exactly ``calls · per_call`` times and no other kernel: it has
    dropped kernels before, and a missing launch is not made up (a printed
    line says so, after ``label``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ms, counts = {}, {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or not e.count:
                continue
            short = next((s for key, s in names.items() if key in e.key), e.key[:60])
            ms[short] = ms.get(short, 0.0) + e.self_device_time_total / 1e3
            counts[short] = counts.get(short, 0) + e.count
        if counts == {short: calls * per_call for short in names.values()}:
            return {short: total / calls for short, total in ms.items()}
    print(f"  {label} passes not measured: launches recorded in {calls} calls {counts} (the last of "
          f"{attempts} profiles), expected each of {sorted(names.values())} {calls * per_call} times",
          flush=True)
    return None


def plan_stats(plan) -> dict:
    """The chunk layout's shape: chunks, the most chunks (and arcs) of one
    row, and the rows that have more than one chunk."""
    per_row = torch.diff(plan.row_chunk_ptr)
    arcs = torch.bincount(plan.dst, minlength=plan.n_out)
    return {
        "n_chunks": plan.n_chunks,
        "max_chunks_per_row": int(per_row.max()),
        "max_arcs_per_row": int(arcs.max()),
        "multi_chunk_rows": int((per_row > 1).sum()),
        "empty_rows": int((arcs == 0).sum()),
        "long_rows": plan.n_long,
    }


def check_kernel(name: str, table: torch.Tensor, plan) -> dict:
    """K1 against its plain version on the same inputs, the same bytes from
    a second launch, then times."""
    out = SEGREDUCE(table, plan)
    again = SEGREDUCE(table, plan)
    ref = segreduce_plain(table, plan)
    torch.cuda.synchronize()
    assert torch.equal(out, again), f"{name}: two launches gave different bytes"
    del again
    scale = ref.abs().max().item()
    err = (out - ref).abs().max().item()
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5 * scale)
    # Largest error as a share of what the check allows (< 1 passes).
    margin = ((out - ref).abs() / (1e-5 * scale + 1e-4 * ref.abs())).max().item()
    # Both against an f64 sum of the same products: only summation order and
    # f32 rounding differ (the plain version's index_add_ adds in no fixed order).
    w64 = (plan.w if table.dtype == torch.float32 else plan.w.to(torch.bfloat16)).double()
    ref64 = torch.zeros(plan.n_out, table.shape[1], dtype=torch.float64, device=table.device)
    ref64.index_add_(0, plan.dst, table.index_select(0, plan.src).double() * w64[:, None])
    f64_kernel = (out.double() - ref64).abs().max().item()
    f64_plain = (ref.double() - ref64).abs().max().item()
    del out, ref, ref64
    n_arcs = plan.src.numel()
    rows_read = torch.unique(plan.src).numel()
    bytes_once, bytes_gather, flops = k1_bytes(table, plan)
    bound_ms = max(bytes_once / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3
    kernel_ms = time_ms(lambda: SEGREDUCE(table, plan))
    # Five calls back to back: the launch gap of one call is hidden.
    back_to_back_ms = time_ms(lambda: [SEGREDUCE(table, plan) for _ in range(5)]) / 5
    plain_ms = time_ms(lambda: segreduce_plain(table, plan))
    dense = table.float()
    csr = sparse_csr(plan, dense)
    library_f32_ms = time_ms(lambda: torch.sparse.mm(csr, dense))
    library_ms, library_call = library_f32_ms, "torch.sparse.mm, f32 CSR and table"
    del dense
    if table.dtype != torch.float32:
        # The same bytes as the kernel reads: a bf16 CSR times the bf16 table.
        csr16 = sparse_csr(plan, table)
        dense16 = table.contiguous()
        library_ms = time_ms(lambda: torch.sparse.mm(csr16, dense16))
        library_call = f"torch.sparse.mm, {table.dtype} CSR and table"
        del csr16, dense16
    print(f"  {name} plan: {json.dumps(plan_stats(plan))} vector width {SEGREDUCE.vector_width(table)} "
          f"row stride {table.stride(0)}", flush=True)
    k1_names = {"chunks": "chunks", "combine": "combine"} if plan.comb_rows.numel() else {"chunks": "chunks"}
    passes = named_passes(name, lambda: SEGREDUCE(table, plan), k1_names)
    print(
        f"  {name}: arcs {n_arcs} chunks {plan.n_chunks} rows_read {rows_read} "
        f"max_abs_err {err:.3e} (max |ref| {scale:.3e}, check margin {margin:.3f}; "
        f"vs f64: kernel {f64_kernel:.3e} plain {f64_plain:.3e}) equal bytes on a second launch; "
        f"kernel_ms {kernel_ms:.4f} back_to_back_ms {back_to_back_ms:.4f} "
        f"plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} ({library_call}; f32 {library_f32_ms:.4f}) "
        f"bytes_once {bytes_once} bytes_gather {bytes_gather} bound_ms {bound_ms:.4f} "
        f"gather_bound_ms {bytes_gather / HBM_BYTES_PER_S * 1e3:.4f}",
        flush=True,
    )
    return {
        "name": name,
        "route": "cuda",
        "source": "gnn_ecommerce_tpu_torch/csrc/segreduce.cu",
        "replaces": "gnn_ecommerce_tpu/ops/spmm_fast.py:274",
        "launches": 0,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_once / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S else "operations",
        "library_ms": library_ms,
        "library_call": library_call,
        "library_f32_ms": library_f32_ms,
        "back_to_back_ms": back_to_back_ms,
        "pass_ms": passes,
        "gather_bound_ms": bytes_gather / HBM_BYTES_PER_S * 1e3,
        "arcs": n_arcs,
    }


def check_cast(table: torch.Tensor) -> dict:
    """K1's padded bf16 cast against its plain version (equal bytes, pad
    columns included), then times; library_ms is the contiguous cast
    ``table.to(torch.bfloat16)`` it takes the place of."""
    n, d = table.shape
    width = bf16_row_width(d)
    full = lambda t: t.as_strided((n, width), (width, 1))  # the view's buffer, pad included
    assert torch.equal(full(SEGREDUCE.cast_bf16(table, width)), full(bf16_rows_plain(table)))
    kernel_ms = time_ms(lambda: SEGREDUCE.cast_bf16(table, width))
    plain_ms = time_ms(lambda: bf16_rows_plain(table))
    library_ms = time_ms(lambda: table.to(torch.bfloat16))
    # The one-call times above include each call's host time before its
    # launch, which the wrapper's Python makes longer; five calls back to
    # back hide it behind the previous call's device time.
    back_to_back_ms = {
        "kernel": time_ms(lambda: [SEGREDUCE.cast_bf16(table, width) for _ in range(5)]) / 5,
        "library": time_ms(lambda: [table.to(torch.bfloat16) for _ in range(5)]) / 5,
    }
    row = kernel_row(
        "segreduce_cast_bf16", "gnn_ecommerce_tpu_torch/csrc/segreduce.cu",
        # Each f32 value read, its bf16 written: the pad columns are the
        # design's overhead, not the function's work (as in K1 bf16's bound).
        "gnn_ecommerce_tpu/ops/spmm_fast.py:425", 0.0, kernel_ms, plain_ms, library_ms,
        n * d * (4 + 2), n * d, rows=n, width=width, back_to_back_ms=back_to_back_ms,
    )
    print(
        f"  segreduce_cast_bf16: [{n}, {d}] f32 -> [{n}, {width}] bf16, exact; kernel_ms "
        f"{kernel_ms:.4f} plain_ms {plain_ms:.4f} library_ms (contiguous .to(bfloat16)) "
        f"{library_ms:.4f} bound_ms {row['bound_ms']:.4f}; back_to_back_ms: kernel "
        f"{back_to_back_ms['kernel']:.4f} library {back_to_back_ms['library']:.4f}",
        flush=True,
    )
    return row


def k1_case_plan(rng: np.random.Generator, ch: int, n_src: int, dev):
    """Rows the main path's plans may not have: empty ones (first, middle,
    last), one arc, exactly ch and ch + 1 arcs, a hub of more than 2,000
    chunks, and rows of random length up to 3·ch."""
    hub = 2000 * ch + 7
    sizes = [0, 1, ch, ch + 1, 0, hub, 2, 0] + list(rng.integers(0, 3 * ch, 300)) + [0]
    dst = np.repeat(np.arange(len(sizes)), sizes)
    src = rng.integers(0, n_src, len(dst)).astype(np.int32)
    w = rng.random(len(dst)).astype(np.float32) / 512
    return build_segreduce_plan(src, dst, w, len(sizes), ch=ch, device=dev)


def check_kernel_cases(dev: torch.device, seed: int) -> None:
    """K1 on plans and tables the main path does not give it, against its
    plain version with check_kernel's tolerance: the rows of k1_case_plan at
    CH 256, 300 (two index windows a chunk) and 32, D from 1 to 256 on f32
    tables and on bf16 ones both contiguous and padded to 16-byte rows
    (bf16_rows, its bytes held to the plain cast), which between them take
    every vector width and loads-per-arc instance of the kernel; each
    launched twice for equal bytes."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_src = 200_000
    for ch in (256, 300, 32):
        plan = k1_case_plan(rng, ch, n_src, dev)
        stats = plan_stats(plan)
        assert stats["max_chunks_per_row"] > 2000 and stats["empty_rows"] >= 4, stats
        for d in K1_CASE_DIMS:
            x = torch.randn(n_src, d, generator=gen, device=dev)
            width = bf16_row_width(d)
            # The cast, and from x[1:] (not 16-byte aligned for most d) the
            # cast of the wrapper's aligned copy; pad columns included.
            for y in (x, x[1:]):
                full = lambda t: t.as_strided((t.shape[0], width), (width, 1))
                assert torch.equal(full(bf16_rows(y)), full(bf16_rows_plain(y))), d
            for label, table in (("f32", x), ("bf16", x.to(torch.bfloat16)), ("bf16 padded", bf16_rows(x))):
                out = SEGREDUCE(table, plan)
                assert torch.equal(out, SEGREDUCE(table, plan)), (ch, d, label)
                ref = segreduce_plain(table, plan)
                scale = ref.abs().max().item()
                torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5 * scale)
                assert not out[plan.row_chunk_ptr[1:] == plan.row_chunk_ptr[:-1]].any(), "empty rows"
        print(f"  K1 cases CH {ch}: {json.dumps(stats)}; D {K1_CASE_DIMS}, f32, bf16, bf16 padded: held",
              flush=True)
    # f32 tables of other layouts through gather_segreduce in both modes
    # (an expanded one is what a .sum()'s gradient hands fast_to_users'
    # backward), each against the plain version on the dense table.
    x = torch.randn(n_src + 1, DIM, generator=gen, device=dev)
    shape = (n_src, DIM)
    layouts = {
        "expanded row": x[:1].expand(shape),
        "expanded scalar": x[:1, :1].expand(shape),
        "transposed": x[:n_src].T.contiguous().T,
        "offset rows": x.reshape(-1)[1 : 1 + n_src * DIM].view(shape),  # 4-byte aligned
    }
    for label, table in layouts.items():
        dense = table.clone(memory_format=torch.contiguous_format)
        for mode in (torch.float32, torch.bfloat16):
            out = gather_segreduce(table, plan, mode)
            ref = segreduce_plain(dense.to(mode), plan)
            torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5 * ref.abs().max().item())
    print(f"  K1 through gather_segreduce on {', '.join(layouts)} f32 tables, f32 and bf16: held",
          flush=True)
    torch.cuda.synchronize()


def check_accumulate_cases(dev: torch.device, seed: int) -> None:
    """K1's accumulate mode against ``segreduce_plain(prev=)`` and an f64
    sum of the same products with check_kernel's tolerance (``hold``), from
    a random ``prev``: k1_case_plan's rows
    (empty ones, a 2,000-chunk hub) at CH 256 and 32 on f32, bf16 and padded
    bf16 tables at every width of K1_CASE_DIMS; a plan with no arc (an empty
    bucket, on a table of 0 rows and of 1); a plan whose every arc lands in
    one hub row. Rows with no arc keep ``prev``'s bits; two launches give
    the same bytes."""
    rng = np.random.default_rng(seed + 7)
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    n_src, n_out = 200_000, 309

    def hold(table, plan, label):
        prev = torch.randn(plan.n_out, table.shape[1], generator=gen, device=dev)
        out = SEGREDUCE(table, plan, prev.clone())
        assert torch.equal(out, SEGREDUCE(table, plan, prev.clone())), label
        ref = segreduce_plain(table, plan, prev)
        # The same products summed in f64: the plain version's index_add_
        # adds a hub row's 512,007 f32 terms in no fixed order, and its own
        # rounding there reaches the tolerance (8.4e-5 against 5.0e-5 in a
        # D 250 bf16 hub row), so the kernel is held to the f64 sum at the
        # plain mode's tolerance, and to the plain version at that
        # tolerance plus the plain version's own distance from the f64 sum.
        w64 = (plan.w if table.dtype == torch.float32 else plan.w.to(torch.bfloat16)).double()
        ref64 = torch.zeros(plan.n_out, table.shape[1], dtype=torch.float64, device=dev)
        ref64.index_add_(0, plan.dst, table.index_select(0, plan.src).double() * w64[:, None])
        ref64 += prev.double()
        scale = ref.abs().max().item()
        torch.testing.assert_close(out.double(), ref64, rtol=1e-4, atol=1e-5 * scale,
                                   msg=lambda m: f"{label} vs f64: {m}")
        allowed = 1e-4 * ref.abs() + 1e-5 * scale + (ref.double() - ref64).abs()
        assert bool(((out - ref).abs() <= allowed).all()), f"{label}: kernel and plain version differ"
        empty = plan.row_chunk_ptr[1:] == plan.row_chunk_ptr[:-1]
        assert torch.equal(out[empty], prev[empty]), f"{label}: a row with no arc changed"

    hub_arcs = 2000 * 256 + 7
    plans = {
        "cases CH 256": k1_case_plan(rng, 256, n_src, dev),
        "cases CH 32": k1_case_plan(rng, 32, n_src, dev),
        "one hub row": build_segreduce_plan(
            rng.integers(0, n_src, hub_arcs).astype(np.int32), np.full(hub_arcs, 5),
            rng.random(hub_arcs).astype(np.float32) / 512, n_out, device=dev),
        "no arc": build_segreduce_plan(np.zeros(0, np.int32), np.zeros(0, np.int64),
                                       np.zeros(0, np.float32), n_out, device=dev),
    }
    for d in K1_CASE_DIMS:
        x = torch.randn(n_src, d, generator=gen, device=dev)
        for label, table in (("f32", x), ("bf16", x.to(torch.bfloat16)), ("bf16 padded", bf16_rows(x))):
            for name, plan in plans.items():
                hold(table, plan, f"accumulate {name} D {d} {label}")
            for rows in (0, 1):  # the slices an empty or one-user bucket reads
                hold(table[7 : 7 + rows], plans["no arc"], f"accumulate {rows}-row table D {d} {label}")
    torch.cuda.synchronize()
    print(f"  K1 accumulate mode: {', '.join(plans)} and 0- and 1-row tables; D {K1_CASE_DIMS}, f32, "
          "bf16, bf16 padded: held against segreduce_plain(prev=) and an f64 sum, rows with no arc "
          "unchanged", flush=True)


def check_bucketed(label: str, table16: torch.Tensor, plan, tail: tuple, n_src: int,
                   n_buckets: int) -> dict:
    """``gather_segreduce_bucketed`` on the bf16 table over ``tail``'s arcs
    (src, dst, w) cut into ``n_buckets`` source ranges, against the
    unbucketed K1 over ``plan`` (the same arcs) and against its plain
    version (check_kernel's tolerance); K1 launches a call (one, then one
    accumulate a later bucket); times of both beside the unbucketed input-
    once bound (k1_bytes), which reckons the same work."""
    t0 = time.perf_counter()
    bplan = build_bucketed_segreduce_plan(*tail, plan.n_out, n_src, n_buckets, device=table16.device)
    build_s = time.perf_counter() - t0
    before = dict(SEGREDUCE.launches)
    out = gather_segreduce_bucketed(table16, bplan, torch.bfloat16)
    launched = {m: SEGREDUCE.launches[m] - before[m] for m in ("bfloat16", "bfloat16_accumulate")}
    assert launched == {"bfloat16": 1, "bfloat16_accumulate": n_buckets - 1}, launched
    ref = SEGREDUCE(table16, plan)

    def plain_passes():
        acc = None
        for (lo, hi), p in zip(bplan.spans, bplan.buckets):
            acc = segreduce_plain(table16[lo:hi], p, acc)
        return acc

    plain = plain_passes()
    scale = ref.abs().max().item()
    err = (out - ref).abs().max().item()
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5 * scale)
    torch.testing.assert_close(out, plain, rtol=1e-4, atol=1e-5 * scale)
    err_plain = (out - plain).abs().max().item()
    del out, ref, plain
    bytes_once, bytes_gather, flops = k1_bytes(table16, plan)
    bound_ms = max(bytes_once / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3
    ms = time_ms(lambda: gather_segreduce_bucketed(table16, bplan, torch.bfloat16))
    unbucketed_ms = time_ms(lambda: SEGREDUCE(table16, plan))
    plain_ms = time_ms(plain_passes, reps=3)
    sub_mb = max(hi - lo for lo, hi in bplan.spans) * table16.stride(0) * table16.element_size() / 1e6
    passes = pass_times(lambda: gather_segreduce_bucketed(table16, bplan, torch.bfloat16),
                        {"chunks": "chunks", "combine": "combine"}, f"{label} {n_buckets} buckets",
                        per_call=n_buckets)
    row = {
        "n_buckets": n_buckets, "launches_per_call": n_buckets, "max_abs_err": err,
        "max_abs_err_vs_plain": err_plain, "ms": ms, "unbucketed_ms": unbucketed_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "gather_bound_ms": bytes_gather / HBM_BYTES_PER_S * 1e3,
        "chunks": sum(p.n_chunks for p in bplan.buckets), "unbucketed_chunks": plan.n_chunks,
        "sub_table_mb": sub_mb, "build_s": build_s, "pass_ms": passes,
    }
    print(
        f"  {label} bucketed K1 bf16, {n_buckets} buckets ({n_buckets} launches a call, largest "
        f"sub-table {sub_mb:.1f} MB, chunks {row['chunks']} vs {plan.n_chunks}, build {build_s:.2f} s): "
        f"max_abs_err {err:.3e} vs unbucketed K1 (max |ref| {scale:.3e}), {err_plain:.3e} vs plain; "
        f"ms {ms:.4f} unbucketed_ms {unbucketed_ms:.4f} plain_ms {plain_ms:.4f} bound_ms {bound_ms:.4f} "
        f"gather_bound_ms {row['gather_bound_ms']:.4f}; device ms a call by pass {passes}",
        flush=True,
    )
    return row


def tail_messages(table16: torch.Tensor, plan) -> torch.Tensor:
    """K1's bf16 messages: each arc's bf16 row times its bf16-rounded
    weight, rounded to bf16 (the stream the TPU probe sums)."""
    w16 = plan.w.to(torch.bfloat16).float()
    return (table16.index_select(0, plan.src).float() * w16[:, None]).to(torch.bfloat16)


def check_stream_sum(msgs: torch.Tensor) -> dict:
    """K3 against its plain version on K1's bf16 tail messages, then times.
    Tolerance: 1e-5 of the largest column's sum of magnitudes (both are f32
    sums of the same bf16 values in different orders)."""
    out = STREAM_SUM(msgs)
    ref = stream_sum_plain(msgs)
    ref64 = msgs.double().sum(0, keepdim=True)
    torch.cuda.synchronize()
    scale = msgs.float().abs().sum(0).max().item()
    err = (out - ref).abs().max().item()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5 * scale)
    f64_kernel = (out.double() - ref64).abs().max().item()
    f64_plain = (ref.double() - ref64).abs().max().item()
    n, d = msgs.shape
    bytes_once = n * d * msgs.element_size() + d * 4
    flops = n * d
    bound_ms = max(bytes_once / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3
    kernel_ms = time_ms(lambda: STREAM_SUM(msgs))
    plain_ms = time_ms(lambda: stream_sum_plain(msgs))
    library_ms = time_ms(lambda: torch.sum(msgs, dim=0, keepdim=True, dtype=torch.float32))
    print(
        f"  stream_sum_bf16: rows {n} max_abs_err {err:.3e} (max col Σ|x| {scale:.3e}; "
        f"vs f64: kernel {f64_kernel:.3e} plain {f64_plain:.3e}) kernel_ms {kernel_ms:.4f} "
        f"plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} bytes {bytes_once} "
        f"bound_ms {bound_ms:.4f}",
        flush=True,
    )
    return {
        "name": "stream_sum_bf16",
        "route": "cuda",
        "source": "gnn_ecommerce_tpu_torch/csrc/stream_sum.cu",
        "replaces": "scripts/profile_step.py:169",
        "launches": 0,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_once / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S else "operations",
        "library_ms": library_ms,
        "rows": n,
    }


def kernel_row(name, source, replaces, err, kernel_ms, plain_ms, library_ms, bytes_once, ops,
               **extra) -> dict:
    """One row of the kernels line; the bound is the larger of the bytes
    over the HBM rate and the f32 operations over the f32 peak."""
    bytes_ms = bytes_once / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOPS_PER_S * 1e3
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": 0, "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms, **extra,
    }


def named_passes(name: str, fn, names: dict) -> dict | None:
    """``pass_times`` of ``fn`` with one printed line (None: not measured)."""
    passes = pass_times(fn, names, name)
    if passes is not None:
        print(f"  {name} passes ms: " + " ".join(f"{k} {v:.4f}" for k, v in passes.items()), flush=True)
    return passes


def real_arcs(plan: dict, dst_sorted: np.ndarray, ot: int) -> np.ndarray:
    """Positions of a probe plan's real (unpadded) arcs, in dst order: each
    tile's arcs open its first chunk, the padding follows them."""
    ch = len(plan["seg"]) // plan["n_chunks"]
    chunks = np.bincount(plan["tile_map"], minlength=plan["n_tiles"])
    starts = np.concatenate([[0], np.cumsum(chunks)[:-1]]) * ch
    cnt = np.bincount(dst_sorted // ot, minlength=plan["n_tiles"])
    return np.repeat(starts - np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt) + np.arange(len(dst_sorted))


def check_tile_segreduce(name: str, plan: dict, t: dict, msgs: torch.Tensor, ot: int,
                         dst_sorted: np.ndarray) -> dict:
    """K2 against its plain version (the one-hot products) on a probe plan.
    Tolerance: TILE_SEGREDUCE_RTOL (1e-6) of the largest output element's
    Σ|msg| (both sum the same f32 values, or exact products of bf16 ones, in
    different orders). Yardsticks: ``index_add_`` of the padded messages
    (library_ms) and ``torch.segment_reduce`` over the real arcs' f32
    messages in dst order (segment_reduce_ms), the one-call equivalent on
    this plan."""
    n_tiles, n_chunks = plan["n_tiles"], plan["n_chunks"]
    args = (msgs, t["seg"], t["tile_map"], t["first"], n_tiles, ot)
    out = TILE_SEGREDUCE(*args)
    assert torch.equal(out, TILE_SEGREDUCE(*args)), f"{name}: two launches gave different bytes"
    ref = tile_segreduce_plain(*args)
    ch = msgs.shape[0] // n_chunks
    rows = t["tile_map"].long().repeat_interleave(ch) * ot + t["seg"].long()
    msgs_f = msgs.float()
    abs_sum = tile_segreduce_abs_sum(msgs, t["seg"], t["tile_map"], n_tiles, ot)
    scale = abs_sum.max().item()
    diff = (out - ref).abs()
    err = diff.max().item()
    assert err <= TILE_SEGREDUCE_RTOL * scale, (name, err, scale)
    # Largest error as a share of the tolerance at its own element's Σ|msg| (not checked).
    elem_margin = (diff / (TILE_SEGREDUCE_RTOL * abs_sum).clamp_min(1e-30)).max().item()
    del diff, abs_sum
    ref64 = torch.zeros(ref.shape, dtype=torch.float64, device=msgs.device)
    ref64.index_add_(0, rows, msgs_f.double())
    f64_kernel = (out.double() - ref64).abs().max().item()
    f64_plain = (ref.double() - ref64).abs().max().item()
    del out, ref, ref64
    kernel_ms = time_ms(lambda: TILE_SEGREDUCE(*args))
    plain_ms = time_ms(lambda: tile_segreduce_plain(*args), reps=3, warmup=1)
    library_ms = time_ms(
        lambda: torch.zeros(n_tiles * ot, msgs.shape[1], device=msgs.device).index_add_(0, rows, msgs_f)
    )
    del rows
    real = torch.from_numpy(real_arcs(plan, dst_sorted, ot)).to(msgs.device)
    real_msgs = msgs_f.index_select(0, real)
    del msgs_f, real
    lengths = torch.bincount(torch.from_numpy(dst_sorted).to(msgs.device).long(), minlength=n_tiles * ot)
    segment_reduce_ms = time_ms(lambda: torch.segment_reduce(real_msgs, "sum", lengths=lengths))
    del real_msgs, lengths
    k2_names = {"tiles": "tiles"}
    if TILE_SEGREDUCE.n_splits(n_tiles, n_chunks) > 1:
        k2_names["combine"] = "combine"
    passes = named_passes(name, lambda: TILE_SEGREDUCE(*args), k2_names)
    e_pad, d = msgs.shape
    bytes_once = e_pad * d * msgs.element_size() + e_pad * 4 + n_chunks * 8 + n_tiles * ot * d * 4
    row = kernel_row(
        name, "gnn_ecommerce_tpu_torch/csrc/tile_segreduce.cu", "scripts/proto_segreduce.py:90",
        err, kernel_ms, plain_ms, library_ms, bytes_once, e_pad * d,
        e_pad=e_pad, pad_ratio=plan["pad_ratio"], n_chunks=n_chunks, n_tiles=n_tiles,
        n_splits=TILE_SEGREDUCE.n_splits(n_tiles, n_chunks), pass_ms=passes,
        segment_reduce_ms=segment_reduce_ms,
    )
    print(
        f"  {name}: E_pad {e_pad} (pad {plan['pad_ratio']:.4f}) chunks {n_chunks} tiles {n_tiles} "
        f"splits {row['n_splits']} max_abs_err {err:.3e} (max Σ|msg| {scale:.3e}, allowed "
        f"{TILE_SEGREDUCE_RTOL * scale:.3e}; per-element margin {elem_margin:.3f}; vs f64: kernel "
        f"{f64_kernel:.3e} plain {f64_plain:.3e}) equal bytes on a second launch; kernel_ms "
        f"{kernel_ms:.4f} plain_ms {plain_ms:.4f} library_ms (index_add_) {library_ms:.4f} "
        f"segment_reduce_ms {segment_reduce_ms:.4f} bytes {bytes_once} bound_ms "
        f"{row['bound_ms']:.4f}",
        flush=True,
    )
    return row


def check_tile_segreduce_cases(dev: torch.device, seed: int) -> None:
    """K2 on layouts the probe plans never make, against its plain version:
    seg in any order and partly outside [0, OT), resets in the middle of a
    tile, tiles with no chunk, split tiles, odd D, and D that takes each
    vector width (8, 4, 2 and 1 bf16 columns; 4, 2 and 1 f32), one D not a
    multiple of 16 bytes (90 bf16), tiles summed in two row bands, split
    and not. Same tolerance; two launches give the same bytes."""
    rng = np.random.default_rng(seed)
    widths = []
    for n_tiles, ot, ch, d, dtype in (
        (3, 64, 96, 33, torch.bfloat16), (5, 128, 256, 80, torch.float32),
        (40, 16, 32, 128, torch.float32), (1100, 16, 32, 8, torch.bfloat16),  # the last unsplit
        (3, 32, 64, 90, torch.bfloat16), (4, 48, 80, 36, torch.bfloat16),
        (6, 32, 64, 50, torch.float32), (2, 16, 40, 33, torch.float32),
        (3, 600, 128, 64, torch.float32), (2, 512, 96, 80, torch.bfloat16),  # two row bands
        (1100, 600, 32, 64, torch.float32), (1100, 512, 32, 80, torch.bfloat16),  # unsplit, banded
    ):
        n_chunks = 7 * n_tiles
        tile_map = np.sort(rng.integers(0, n_tiles, n_chunks)).astype(np.int32)
        first = (rng.random(n_chunks) < 0.3).astype(np.int32)
        seg = rng.integers(-2, ot + 2, n_chunks * ch).astype(np.int32)
        msgs = torch.from_numpy(rng.standard_normal((n_chunks * ch, d)).astype(np.float32)).to(dev, dtype)
        args = [torch.from_numpy(a).to(dev) for a in (seg, tile_map, first)]
        out = TILE_SEGREDUCE(msgs, *args, n_tiles, ot)
        assert torch.equal(out, TILE_SEGREDUCE(msgs, *args, n_tiles, ot)), (n_tiles, ot, ch, d)
        ref = tile_segreduce_plain(msgs, *args, n_tiles, ot)
        scale = msgs.float().abs().sum(0).max().item()
        err = (out - ref).abs().max().item()
        assert err <= TILE_SEGREDUCE_RTOL * scale, (n_tiles, ot, ch, d, err, scale)
        vec = TILE_SEGREDUCE.vector_width(msgs)
        widths.append(f"{n_tiles}x{ot}x{d}{'bf16' if dtype == torch.bfloat16 else 'f32'}:{vec}/"
                      f"{TILE_SEGREDUCE.n_bands(ot, d, vec)}")
    torch.cuda.synchronize()
    print(f"  K2 cases (tiles x OT x D dtype: vector width/row bands) {' '.join(widths)}: held",
          flush=True)


def check_row_gather(name: str, table: torch.Tensor, idx: torch.Tensor, k: int, chunk: int) -> dict:
    """K4 against ``table[idx]``: equal bytes at every (k_inflight, chunk)
    the probe times. Yardsticks: ``index_select`` (library_ms) and a
    contiguous copy of the same n·row_bytes (copy_ms), the card's rate for
    these bytes with no random rows."""
    want = row_gather_plain(table, idx)
    for ck, cc in pallas_gather_probe.CONFIGS:
        assert torch.equal(ROW_GATHER(table, idx, k_inflight=ck, chunk=cc), want), (name, ck, cc)
    del want
    kernel_ms = time_ms(lambda: ROW_GATHER(table, idx, k_inflight=k, chunk=chunk))
    plain_ms = time_ms(lambda: row_gather_plain(table, idx))
    library_ms = time_ms(lambda: torch.index_select(table, 0, idx))
    n, row_bytes = idx.numel(), table[0].numel() * table.element_size()
    src = torch.empty(n * row_bytes, dtype=torch.uint8, device=table.device)
    dst = torch.empty_like(src)
    copy_ms = time_ms(lambda: dst.copy_(src))
    del src, dst
    back_to_back_ms = time_ms(lambda: [ROW_GATHER(table, idx, k_inflight=k, chunk=chunk) for _ in range(5)]) / 5
    passes = named_passes(name, lambda: ROW_GATHER(table, idx, k_inflight=k, chunk=chunk),
                          {"row_gather": "gather"})
    uniq = torch.unique(idx).numel()
    # Each referenced row read once, the indices, the output written once.
    bytes_once = uniq * row_bytes + n * 4 + n * row_bytes
    bytes_gather = 2 * n * row_bytes + n * 4  # each gathered row read again
    row = kernel_row(
        name, "gnn_ecommerce_tpu_torch/csrc/row_gather.cu", "scripts/pallas_gather_probe.py:48",
        0.0, kernel_ms, plain_ms, library_ms, bytes_once, 0,
        rows=n, row_bytes=row_bytes, k_inflight=k, chunk=chunk,
        gather_bound_ms=bytes_gather / HBM_BYTES_PER_S * 1e3, pass_ms=passes, copy_ms=copy_ms,
        back_to_back_ms=back_to_back_ms, path=ROW_GATHER.path(row_bytes),
    )
    print(
        f"  {name}: table {tuple(table.shape)} {table.dtype} rows {n} unique {uniq} exact at "
        f"(k_inflight, chunk) {pallas_gather_probe.CONFIGS}; kernel_ms {kernel_ms:.4f} plain_ms {plain_ms:.4f} "
        f"library_ms (index_select) {library_ms:.4f} copy_ms {copy_ms:.4f} back_to_back_ms "
        f"{back_to_back_ms:.4f} path {row['path']} bound_ms {row['bound_ms']:.4f} gather_bound_ms {row['gather_bound_ms']:.4f} "
        f"({n * row_bytes * 2 / kernel_ms / 1e9:.1f} TB/s moved)",
        flush=True,
    )
    return row


def check_row_gather_cases(dev: torch.device, seed: int) -> None:
    """K4 on index blocks the probe never makes, bit-exact against
    ``index_select``: chunks that are not a multiple of 4, with about three
    index blocks for each block of the bulk path's persistent grid, so that
    each block walks several windows through both halves of its index
    buffer; on 4 KB and 1 KB rows (the bulk path) and 256-byte rows (the
    lanes path), from an index array at a 16-byte boundary and 4 bytes
    past one."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    held = []
    for shape, dtype in (((20_000, 8, 128), torch.float32), ((20_000, 256), torch.float32),
                         ((20_000, 128), torch.bfloat16)):
        table = torch.randn(shape, generator=gen, device=dev).to(dtype)
        row_bytes = table[0].numel() * table.element_size()
        for chunk in (5, 7, 13):
            for k in ROW_GATHER.K_INFLIGHT:
                grid = ROW_GATHER.grid(1 << 30, sms, ROW_GATHER.bulk_shared_bytes(k, row_bytes, chunk))
                n = chunk * (3 * grid + 1)
                idx = torch.randint(0, shape[0], (n + 1,), generator=gen, device=dev, dtype=torch.int32)
                for offset in (0, 1):
                    sub = idx[offset : offset + n]
                    got = ROW_GATHER(table, sub, k_inflight=k, chunk=chunk)
                    assert torch.equal(got, torch.index_select(table, 0, sub)), (shape, chunk, k, offset)
        held.append(f"{row_bytes} B {ROW_GATHER.path(row_bytes)}")
    torch.cuda.synchronize()
    print(f"  K4 cases ({', '.join(held)}; chunk 5, 7, 13 x k {ROW_GATHER.K_INFLIGHT}, "
          f"3 index blocks + 1 a grid block, indices at offsets 0 and 4 B): held", flush=True)


def check_lane_gather(name: str, replaces: str, tab: torch.Tensor, idx: torch.Tensor, layout: str) -> dict:
    """K5 or K6 against ``tab[:, idx]``: equal bytes. Times: one call
    (kernel_ms, both passes and the wrapper), each pass's device time and
    their sum (device_ms), the plain version, ``index_select`` along dim 1 (library_ms) and
    ``zero_`` of an output-sized buffer (fill_ms), the card's rate for
    writing these bytes with nothing read."""
    assert torch.equal(LANE_GATHER(tab, idx, layout), lane_gather_plain(tab, idx))
    kernel_ms = time_ms(lambda: LANE_GATHER(tab, idx, layout))
    plain_ms = time_ms(lambda: lane_gather_plain(tab, idx))
    flat = idx.reshape(-1)
    library_ms = time_ms(lambda: torch.index_select(tab, 1, flat))
    d, n = tab.shape[0], flat.numel()
    sink = torch.empty(d, n, dtype=torch.bfloat16, device=tab.device)
    fill_ms = time_ms(sink.zero_)
    del sink
    passes = named_passes(name, lambda: LANE_GATHER(tab, idx, layout), LANE_GATHER.PASSES)
    device_ms = sum(passes.values()) if passes else None
    uniq = torch.unique(flat).numel()
    bytes_once = uniq * d * 2 + n * 4 + d * n * 2
    row = kernel_row(
        name, "gnn_ecommerce_tpu_torch/csrc/lane_gather.cu", replaces,
        0.0, kernel_ms, plain_ms, library_ms, bytes_once, 0, n=n, index_shape=list(idx.shape),
        device_ms=device_ms, pass_ms=passes, fill_ms=fill_ms,
    )
    print(
        f"  {name}: tab {tuple(tab.shape)} idx {tuple(idx.shape)} exact kernel_ms {kernel_ms:.4f} "
        f"device_ms {'not measured' if device_ms is None else f'{device_ms:.4f}'} "
        f"plain_ms {plain_ms:.4f} library_ms (index_select) "
        f"{library_ms:.4f} fill_ms {fill_ms:.4f} bound_ms {row['bound_ms']:.4f} "
        f"({d * n * 2 / kernel_ms / 1e9:.1f} TB/s written)",
        flush=True,
    )
    return row


def check_lane_gather_cases(dev: torch.device, seed: int) -> None:
    """K5/K6 byte-equal to ``lane_gather_plain`` at the shapes its CPU
    emulation covers: d 1, 7, 80 and 200 (one band, two bands), tables of
    1, 1,000 and 54,571 items, index counts that make one short window, one
    window less 8, one more 8, three more 8 (a ragged last window) and more
    windows than the grid has blocks (each block walks several windows
    through both buffers), in both layouts, with the indices at offsets 0
    and 16 bytes into a buffer."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    j = LANE_GATHER.WINDOW
    counts = {"1xn": (8, j - 8, j + 8, 3 * j + 8, 400 * j + 8), "8x512": (4096, 4096 * 30)}
    held = 0
    for d in (1, 7, 80, 200):
        for ni in (1, 1000, 54_571):
            tab = torch.randn(d, ni, generator=gen, device=dev).to(torch.bfloat16)
            for layout, ns in counts.items():
                for n in ns:
                    buf = torch.randint(0, ni, (n + 4,), generator=gen, device=dev, dtype=torch.int32)
                    buf[0], buf[n - 1], buf[4], buf[n + 3] = 0, ni - 1, 0, ni - 1
                    for offset in (0, 4):
                        flat = buf[offset : offset + n]
                        idx = flat.reshape(1, -1) if layout == "1xn" else flat.reshape(-1, 512)
                        got = LANE_GATHER(tab, idx, layout)
                        assert torch.equal(got, lane_gather_plain(tab, idx)), (d, ni, layout, n, offset)
                        held += 1
    torch.cuda.synchronize()
    print(f"  K5/K6 cases (d 1, 7, 80, 200 x ni 1, 1000, 54571 x n {counts}, indices at offsets 0 "
          f"and 16 B): {held} calls held", flush=True)


def probe_kernel_rows(dev: torch.device, seed: int) -> list:
    """K2, K4, K5 and K6 against their plain versions at the probes' full
    shapes, with times and bounds: one kernels-line row each."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    E, NU, NI, D = proto_segreduce.E, proto_segreduce.NU, proto_segreduce.NI, proto_segreduce.D
    check_tile_segreduce_cases(dev, seed)
    item_sorted, user_src, w, user_sorted, item_src = proto_segreduce.arcs(rng, E, NU, NI)
    rows = []
    plan = proto_segreduce.build_plan(user_src, item_sorted, w, NI, 512, 2048)
    t = proto_segreduce.plan_tensors(plan, dev)
    T = torch.randn(NU, D, generator=gen, device=dev)
    for dtype, name in ((torch.float32, "tile_segreduce_f32"), (torch.bfloat16, "tile_segreduce_bf16")):
        rows.append(check_tile_segreduce(
            name, plan, t, proto_segreduce.messages(T, t, dtype), 512, item_sorted))
    plan = proto_segreduce.build_plan(item_src, user_sorted, w, NU, 512, 2048)
    t = proto_segreduce.plan_tensors(plan, dev)
    T = torch.randn(NI, D, generator=gen, device=dev)
    msgs = proto_segreduce.messages(T, t, torch.bfloat16)
    rows.append(check_tile_segreduce(TO_USERS, plan, t, msgs, 512, user_sorted))
    del plan, t, T, msgs
    torch.cuda.empty_cache()

    check_row_gather_cases(dev, seed)
    s = pallas_gather_probe.shapes(dev)
    table = torch.randn(s["n_rows"], 128, generator=gen, device=dev, dtype=torch.bfloat16)
    idx = torch.randint(0, s["n_rows"], (s["n_gather"],), generator=gen, device=dev, dtype=torch.int32)
    rows.append(check_row_gather("row_gather_bf16_rows", table, idx, 8, 1024))
    table = torch.randn(s["n_rows_t"], 8, 128, generator=gen, device=dev)
    idx = torch.randint(0, s["n_rows_t"], (s["n_gather_t"],), generator=gen, device=dev, dtype=torch.int32)
    rows.append(check_row_gather("row_gather_f32_tile_rows", table, idx, 8, 1024))
    del table, idx
    torch.cuda.empty_cache()

    check_lane_gather_cases(dev, seed)
    tile = microbench_gather.TILE
    idx = torch.from_numpy(item_src[: E // tile * tile]).to(dev)
    tab = torch.randn(80, NI, generator=gen, device=dev, dtype=torch.bfloat16)
    rows.append(check_lane_gather(
        "lane_gather_1xn", "scripts/microbench_gather.py:208", tab, idx.reshape(1, -1), "1xn"))
    rows.append(check_lane_gather(
        "lane_gather_8x512", "scripts/microbench_gather2.py:134", tab, idx.reshape(-1, 512), "8x512"))
    torch.cuda.empty_cache()
    return rows


def run_probe_mains(dev: torch.device, reps: int = 2) -> dict:
    """Each probe module's main at its full shapes, failures raised; one
    summary line each (ms by key) and its JSON. Returns the results by
    module name. microbench_gather2 takes the sections it repeats from
    microbench_gather's results."""
    out = {}
    for module in (proto_segreduce, pallas_gather_probe, microbench_gather, microbench_gather2):
        t0 = time.perf_counter()
        extra = {"shared": out["microbench_gather"]} if module is microbench_gather2 else {}
        res = module.main(device=dev, reps=reps, **extra)
        times = {
            k: (v["ms"] if isinstance(v, dict) else v)
            for k, v in res.items()
            if (isinstance(v, dict) and "ms" in v) or k.endswith("_ms")
        }
        name = module.__name__.rsplit(".", 1)[1]
        print(
            f"  probe {name}: {time.perf_counter() - t0:.1f} s; ms "
            + " ".join(f"{k} {v:.4f}" for k, v in times.items()),
            flush=True,
        )
        print(f"  probe {name} json: {json.dumps(res)}", flush=True)
        out[name] = res
        torch.cuda.empty_cache()
    return out


def plain_topk(emb, ids, prepared, k):
    """Reference answer: full scores, purchased items masked, torch.topk."""
    n_users = prepared.n_users
    scores = mm_f32(emb[ids], emb[n_users:].T)
    s = prepared.sampler
    slots = np.minimum(np.searchsorted(s.users, ids), len(s.users) - 1)
    rows = np.flatnonzero(s.users[slots] == ids)
    lo, hi = s.pos_indptr[slots[rows]], s.pos_indptr[slots[rows] + 1]
    n = hi - lo
    flat = np.repeat(lo - np.cumsum(n) + n, n) + np.arange(n.sum())
    scores[
        torch.as_tensor(np.repeat(rows, n), device=scores.device),
        torch.as_tensor(s.pos_flat[flat] - n_users, device=scores.device),
    ] = -float("inf")
    vals, idx = torch.topk(scores, k, dim=1)
    return scores, vals.cpu(), idx.cpu()


def check_answer(items, scores, vals, idx, rtol: float = 1e-6) -> int:
    """Same top-K sets as the plain answer, except items tied with its k-th
    score (within ``rtol``; 0 asks for an exact tie). Returns the rows that
    differ by such ties."""
    differ = 0
    for row, got in enumerate(items):
        want = set(idx[row].tolist())
        if set(got) == want:
            continue
        differ += 1
        kth = vals[row, -1].item()
        for item in set(got) ^ want:
            assert abs(scores[row, item].item() - kth) <= rtol * abs(kth), (row, item)
    return differ


def plain_quantized_topk(qc: QuantizedCache, ids, mask, k):
    """Reference answer of the int8 path: the f32 product of the int8 rows
    (exact), rescaled and masked as topk_scores_int8 does, torch.topk."""
    dev = qc.user_q.device
    ids_t = torch.as_tensor(np.asarray(ids), dtype=torch.int64, device=dev)
    scores = int8_product_plain(qc.user_q[ids_t], qc.item_q) * qc.user_s[ids_t][:, None]
    scores = _mask_scores(scores * qc.item_s[None, :], torch.as_tensor(mask, device=dev), "neginf")
    vals, idx = torch.topk(scores, k, dim=1)
    return scores, vals.cpu(), idx.cpu()


def serve_requests(service, prepared: PreparedData, rng: np.random.Generator) -> tuple[dict, list]:
    """The REST server with the batcher over ``service``: per size (1, 8,
    64, 512 users, half of them buyers) WARMUP_REQUESTS untimed, then
    REQUESTS_PER_SIZE timed :predict requests. Returns (ms by size, the
    (ids, items) of every answer)."""
    batcher = BatchingRecommender(service)
    server = make_server(batcher, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/v1/models/lightgcn_recommender:predict"
    buyers = prepared.sampler.users
    lat, answers = {}, []
    try:
        for size in (1, 8, 64, 512):
            lat[size] = []
            for i in range(WARMUP_REQUESTS + REQUESTS_PER_SIZE):
                ids = np.concatenate([
                    rng.choice(buyers, (size + 1) // 2),
                    rng.integers(0, prepared.n_users, size // 2),
                ])
                t_req = time.perf_counter()
                items = post(url, ids.tolist())["items"]
                if i >= WARMUP_REQUESTS:
                    lat[size].append((time.perf_counter() - t_req) * 1e3)
                answers.append((ids, items))
    finally:
        server.shutdown()
        server.server_close()
    thread.join(timeout=30)
    return lat, answers


def percentiles(lat: dict) -> str:
    """p50/p90/p99 ms by request size."""
    return " ".join(
        f"{size}:" + "/".join(f"{p:.3f}" for p in np.percentile(v, [50, 90, 99]))
        for size, v in lat.items()
    )


def check_int8_shapes(dev: torch.device, seed: int) -> str:
    """The int8 product through torch._int_mm against the plain f32 product
    (exact) at users x items shapes that need each kind of padding: rows
    below 17 and not a multiple of 8, thousands of users against item
    counts 8 past a multiple of 16 (the 1/10 corpus's 5,457), and the full
    corpus's 54,571, at D 90."""
    g = torch.Generator().manual_seed(seed)
    shapes = [(b, n) for b in (1, 17, 2048, 5094) for n in (5457, 5464, 54571)]
    for b, n in shapes:
        uq = torch.randint(-127, 128, (b, DIM), generator=g, dtype=torch.int8).to(dev)
        iq = torch.randint(-127, 128, (n, DIM), generator=g, dtype=torch.int8).to(dev)
        assert torch.equal(int8_product_int_mm(uq, iq), int8_product_plain(uq, iq)), (b, n)
    return "exact at users x items " + " ".join(f"{b}x{n}" for b, n in shapes)


def quantized_path(prepared: PreparedData, params: dict, svc, seed: int, f32_pct: str) -> str:
    """Phase 13: phase 4's service switched to quantized serving (its
    refresh propagates through K1 f32 on the same operators, then
    quantizes), its quantize_rows held exactly against the host's,
    topk_scores_int8 on QUANT_CHECK_USERS users against its plain version
    (scores bit for bit, ids equal but for ties), the overlap of its top-20
    with the f32 top-20, the int8 product timed against the plain f32
    products, and the REST server answering from the int8 cache, each answer
    held against the plain int8 top-20. Returns the detail line."""
    dev = svc.device
    n_users = prepared.n_users
    svc.quantized = True
    with torch.no_grad():
        svc.refresh(params)
        entry = svc._versions[svc._active]
        svc._warm_version(entry["emb"], entry["qcache"])
    k1 = SEGREDUCE.launches["float32"]
    assert k1 >= 1, "the quantized refresh did not propagate through K1 f32"
    assert svc.stats()["quantized"] is True
    qc, qemb = entry["qcache"], entry["emb"]
    with torch.no_grad():
        q_host, s_host = quantize_rows(qemb.cpu())
        assert torch.equal(torch.cat([qc.user_q, qc.item_q]).cpu(), q_host), "int8 rows differ from the host's"
        assert torch.equal(torch.cat([qc.user_s, qc.item_s]).cpu(), s_host), "scales differ from the host's"
        # The padded item operand: the int8 rows, zeros elsewhere.
        assert torch.equal(qc.item_mm[: prepared.n_items, :DIM], qc.item_q)
        assert torch.count_nonzero(qc.item_mm) == torch.count_nonzero(qc.item_q)
        del q_host, s_host
        shapes = check_int8_shapes(dev, seed)
        rng = np.random.default_rng(seed + 3)
        ids = np.sort(rng.choice(n_users, QUANT_CHECK_USERS, replace=False))
        ids_t = torch.as_tensor(ids, device=dev)
        mask = torch.as_tensor(svc._request_mask(ids), device=dev)
        uq, us = qc.user_q[ids_t], qc.user_s[ids_t]
        n_items = prepared.n_items
        assert torch.equal(int8_product_int_mm(uq, qc.item_mm, n_items), int8_product_plain(uq, qc.item_q))
        vals, idx = topk_scores_int8(uq, us, qc.item_mm, qc.item_s, mask, 20)
        vals, idx = vals.cpu(), idx.cpu()
        _, pvals, pidx = plain_quantized_topk(qc, ids, mask, 20)
        assert torch.equal(vals, pvals), "int8 top-20 scores differ from the plain version's"
        moved = idx != pidx
        tied = torch.zeros_like(moved)
        tied[:, 1:] |= vals[:, 1:] == vals[:, :-1]
        tied[:, :-1] |= vals[:, :-1] == vals[:, 1:]
        tied[:, -1] = True  # may tie with the 21st
        assert not (moved & ~tied).any(), "int8 top-20 ids differ where no scores tie"
        n_moved = int(moved.sum())
        _, fidx = topk_scores(qemb[ids_t], qemb[n_users:], mask, 20)
        overlap = np.mean([
            len(set(a) & set(b)) / 20 for a, b in zip(idx.tolist(), fidx.cpu().tolist())
        ])
        items = qemb[n_users:]
        times = {}
        for b in (512, QUANT_CHECK_USERS):
            u8, uf = uq[:b], qemb[ids_t[:b]]
            times[f"int_mm_{b}"] = time_ms(lambda: int8_product_int_mm(u8, qc.item_mm, n_items))
            times[f"plain_int8_{b}"] = time_ms(lambda: int8_product_plain(u8, qc.item_q))
            times[f"f32_{b}"] = time_ms(lambda: mm_f32(uf, items.T))
            times[f"topk_int8_{b}"] = time_ms(
                lambda: topk_scores_int8(u8, us[:b], qc.item_mm, qc.item_s, mask[:b], 20)
            )
            times[f"topk_f32_{b}"] = time_ms(lambda: topk_scores(uf, items, mask[:b], 20))
        del vals, pvals, idx, pidx, fidx, moved, tied, items
    lat, answers = serve_requests(svc, prepared, np.random.default_rng(seed + 4))
    differ = 0
    with torch.no_grad():
        for ids, items in answers:
            assert len(items) == len(ids) and all(len(r) == 20 for r in items)
            differ += check_answer(items, *plain_quantized_topk(qc, ids, svc._request_mask(ids), 20), rtol=0.0)
    print("  int8 ms: " + " ".join(f"{k} {v:.4f}" for k, v in times.items()), flush=True)
    return (
        f"refresh {svc.last_refresh_s:.2f} s, K1 f32 launches {k1}; int8 rows and scales equal the "
        f"host's; the int8 product {shapes}; top-20 of {QUANT_CHECK_USERS} users: scores "
        f"equal the plain version's, "
        f"ids equal but for {n_moved} tied positions; overlap with f32 top-20 {overlap:.4f}; "
        f"{len(answers)} answers checked ({differ} differ by exact ties); p50/p90/p99 ms int8 "
        f"{percentiles(lat)} (f32, phase 6: {f32_pct})"
    )


def post(url: str, body) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.load(r)


def layered_grad_f64(params, graph, cfg, users, pos, neg) -> torch.Tensor:
    """The layered loss's gradient in f64: ``Σ_l α_l Â^l G`` plus the L2
    term's, where G scatters the BPR gradient of the batch's final rows (Â is
    symmetric, so its VJP is another pass of Â). At the corpus's hub item
    (about 250K arcs) the f32 layered gradient's own summation error,
    added by ``index_add_`` in no fixed order, is about as large as the
    check's tolerance; in f64 it is far below it."""
    src, dst, w = graph.src.long(), graph.dst.long(), graph.w_norm.double()
    alpha = cfg.alphas(src.device).double()

    def prop(x):  # Â x, 4M arcs at a time (the f64 messages are 2.9 GB)
        out = torch.zeros_like(x)
        for lo in range(0, src.numel(), 4_000_000):
            hi = lo + 4_000_000
            out.index_add_(0, dst[lo:hi], x.index_select(0, src[lo:hi]) * w[lo:hi, None])
        return out

    def alpha_sum(x):  # Σ_l α_l Â^l x
        acc = x * alpha[0]
        for layer in range(cfg.num_layers):
            x = prop(x)
            acc += x * alpha[layer + 1]
        return acc

    E = params["embedding"].detach().double()
    with torch.no_grad():
        out = alpha_sum(E)
    rows = [out[ids].requires_grad_() for ids in (users, pos, neg)]
    u, p, n = rows
    bpr = bpr_loss((u * p).sum(-1), (u * n).sum(-1))
    g_rows = torch.autograd.grad(bpr, rows)
    E_leaf = E.requires_grad_()
    g_reg = torch.autograd.grad(reg_loss(E_leaf, users, pos, neg, DECAY), E_leaf)[0]
    del out, E_leaf
    with torch.no_grad():
        G = torch.zeros_like(E)
        for ids, g in zip((users, pos, neg), g_rows):
            G.index_add_(0, ids, g)
        return alpha_sum(G) + g_reg


def fixed_batch(prepared: PreparedData, seed: int, dev) -> tuple:
    """One BPR batch drawn in numpy: buyers, one of their train purchases,
    and a uniform item."""
    rng = np.random.default_rng(seed)
    s = prepared.sampler
    slot = rng.integers(0, len(s.users), BATCH)
    lo, hi = s.pos_indptr[slot], s.pos_indptr[slot + 1]
    pos = s.pos_flat[lo + (rng.random(BATCH) * (hi - lo)).astype(np.int64)]
    neg = prepared.n_users + rng.integers(0, prepared.n_items, BATCH)
    return tuple(torch.from_numpy(np.asarray(a, np.int64)).to(dev) for a in (s.users[slot], pos, neg))


def in_dir(work: str, fn):
    """``fn()`` with ``work`` as the working directory (the CLIs' relative
    default paths land there)."""
    cwd = os.getcwd()
    try:
        os.chdir(work)
        return fn()
    finally:
        os.chdir(cwd)


def cli_path(work: str) -> str:
    """Phase 12: events CSV -> cli.preprocess -> cli.train in ``work`` (the
    CLI's relative default paths land there). Raises on a failed check;
    returns the detail line."""
    t0 = time.perf_counter()
    events = synthetic_events(**CLI_CORPUS)
    events_csv, edges_csv = os.path.join(work, "events.csv"), os.path.join(work, "edges.csv")
    events.to_csv(events_csv)
    t_gen = time.perf_counter() - t0

    t0 = time.perf_counter()
    preprocess_cli.main(["--events", events_csv, "-o", edges_csv])
    t_pre = time.perf_counter() - t0
    want = events_to_edges(events, EVENT_TYPE_WEIGHTS_V1)
    got = read_csv(edges_csv)
    for col in ("user_id", "item_id", "weight"):
        a, b = got[col], getattr(want, col)
        assert a.dtype == b.dtype and np.array_equal(a, b), f"edges CSV column {col} differs"
    del events, want, got

    t0 = time.perf_counter()
    in_dir(work, lambda: train_cli.main(["--edges", edges_csv, *CLI_TRAIN_ARGS]))
    t_train = time.perf_counter() - t0

    data_dir, ckpt = os.path.join(work, "data/prepared"), os.path.join(work, "model-checkpoints")
    prepared = load_prepared(data_dir)
    for name in (BEST_NAME, LAST_NAME):
        leaves, meta = load_checkpoint(ckpt, name)
        dim = meta["hyperparams"]["latent_dim"]
        assert meta["num_leaves"] == 4 and leaves[0].shape == (prepared.n_users + prepared.n_items, dim), meta
    with open(os.path.join(ckpt, "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    hist = [r for r in log if "epoch" in r]
    final = next(r for r in log if "test_recall" in r)
    etl_s = next(r["etl_s"] for r in log if "etl_s" in r)
    assert len(hist) == 2, hist
    assert all(np.isfinite(h["loss"]) for h in hist), hist
    assert hist[1]["loss"] < hist[0]["loss"], "loss did not fall between the epochs"
    assert all(h["dropped_arcs"] == 0.0 for h in hist), hist
    best = max(h["val_recall"] for h in hist)
    pop = popularity_recall_at_k(prepared, k=20)
    assert best >= CLI_POPULARITY_FACTOR * pop, (best, pop)
    b_ii = " ".join(f"{r['item_op_s']:.2f}" for r in log if "item_op_s" in r)

    def per_epoch(key: str, fmt: str) -> str:
        return " ".join(format(h[key], fmt) for h in hist)

    return (
        f"users {prepared.n_users} items {prepared.n_items} train edges {len(prepared.edge_user)} "
        f"val users {len(prepared.val.user_ids)}; events+CSV {t_gen:.2f} s preprocess "
        f"{t_pre:.2f} s train ETL {etl_s:.2f} s B_ii {b_ii} s epoch_s {per_epoch('epoch_s', '.3f')} "
        f"eval_s {per_epoch('eval_s', '.3f')} cli.train {t_train:.2f} s; val R@20 "
        f"{per_epoch('val_recall', '.6f')} (popularity {pop:.6f}, best/popularity "
        f"{best / pop:.2f}) test R@20 {final['test_recall']:.6f}"
    )


def check_cli_kernels(work: str, dev: torch.device) -> dict:
    """K1 bf16 and its cast against their plain versions at phase 12's own
    shapes: the trained user table of the best checkpoint over the tail
    plan that train/driver.py builds from the saved artifact. Returns each
    check's kernels-line row by name."""
    prepared = load_prepared(os.path.join(work, "data/prepared"))
    graph = build_graph(
        prepared.edge_user, prepared.edge_item_node, prepared.edge_weight,
        prepared.n_users, prepared.n_items, items_offset=True, device="cpu",
    )
    plan = build_fast_ops(split_graph(graph), "bfloat16", HEAVY_USERS, "bfloat16", device=dev).items_plan
    leaves, _ = load_checkpoint(os.path.join(work, "model-checkpoints"), BEST_NAME)
    E_u = torch.as_tensor(leaves[0][: prepared.n_users], dtype=torch.float32).to(dev)
    print(f"  cli shapes: [{prepared.n_users}, {E_u.shape[1]}] trained user table", flush=True)
    with torch.no_grad():
        cast = check_cast(E_u)
        k1 = check_kernel("segreduce_bf16", bf16_rows(E_u), plan)
    return {row["name"]: row for row in (cast, k1)}


def infer_path(work: str, dev: torch.device) -> str:
    """Phase 12's inference step: ``cli.infer -d data/prepared -c
    model-checkpoints -k 20 --out recs`` on the trained checkpoint, every
    hit user explained. Holds the CSV's rows to the eval users, its recall
    to evaluate's on the same embedding, every path to its user, its hit
    item and real edges, and the int8 top-20's overlap with the f32 top-20
    to QUANT_OVERLAP_MIN. Returns the detail line."""
    t0 = time.perf_counter()
    res = in_dir(work, lambda: infer_cli.main([
        "-d", "data/prepared", "-c", "model-checkpoints", "-k", "20", "--out", "recs",
        "--device", dev.type,
    ]))
    t_infer = time.perf_counter() - t0
    prepared = load_prepared(os.path.join(work, "data/prepared"))
    n_users = prepared.n_users
    split = infer_cli.combined_eval_split(prepared)
    metrics = read_csv(os.path.join(work, "recs/metrics_K20.csv"))
    assert np.array_equal(metrics["user_id_idx"], split.user_ids), "metrics rows are not the eval users"
    batch = build_eval_batch(split, dev)
    with torch.no_grad():
        _, recall, per_recall, per_precision, topk = evaluate(res.final_emb, batch, n_users, k=20)
        qidx = QuantizedCache(res.final_emb, n_users).recommend(split.user_ids, batch.mask, k=20)
    assert recall == res.recall, (recall, res.recall)
    assert np.array_equal(metrics["recall"].astype(np.float32), per_recall), "per-user recall differs"
    overlap = np.mean([len(set(a) & set(b)) / 20 for a, b in zip(qidx.tolist(), topk.tolist())])
    assert overlap >= QUANT_OVERLAP_MIN, overlap

    hits = read_csv(os.path.join(work, "recs/hit_df.csv"))
    lengths = hits["path_length"]
    n_paths = len(lengths)
    assert n_paths == res.hit_paths == int(round(float(per_precision.astype(np.float64).sum()) * 20))
    assert set(hits["user_id_idx"].tolist()) == set(split.user_ids[per_recall > 0].tolist())
    flagged = (lengths < 0) | (lengths > 3)
    assert np.array_equal(hits["longer_than_3"], np.where(flagged, "True", "False"))
    n_long = int(flagged.sum())
    assert n_long == res.longer_than_3
    found = hits["path"] != ""  # "" where unreachable within the cutoff
    assert np.array_equal(found, lengths >= 0)
    paths = [json.loads(path) for path in hits["path"][found]]
    for user, item, length, path in zip(
        hits["user_id_idx"][found], hits["item_id_idx"][found], lengths[found], paths
    ):
        assert len(path) == length + 1 and path[0] == user and path[-1] == item + n_users, path
    steps = np.concatenate([np.asarray(p, np.int64).reshape(-1)[:-1] for p in paths] + [[]])
    nxt = np.concatenate([np.asarray(p, np.int64).reshape(-1)[1:] for p in paths] + [[]])
    n_nodes = n_users + prepared.n_items
    keys = np.minimum(steps, nxt).astype(np.int64) * n_nodes + np.maximum(steps, nxt).astype(np.int64)
    edge_keys = prepared.edge_user.astype(np.int64) * n_nodes + prepared.edge_item_node
    assert np.isin(keys, edge_keys).all(), "a path step is not a train edge"
    return (
        f"cli.infer {t_infer:.2f} s ({' '.join(f'{k} {v:.3f}' for k, v in res.seconds.items())} s): "
        f"{res.n_users} eval users P@20 {res.precision:.6f} R@20 {res.recall:.6f} (evaluate's); "
        f"{n_paths} hit paths, every one a walk of real edges from its user to its hit item, "
        f"{n_long} longer than 3 hops or missing, count by length "
        f"{dict(zip(*(x.tolist() for x in np.unique(lengths, return_counts=True))))}; int8 top-20 "
        f"overlap {overlap:.4f}"
    )


def check_svd_epochs(dev: torch.device, seed: int) -> float:
    """Two SVD epochs (8 factors, batches of 512: the case of
    tests/test_torch_svd.py) on a planted two-group set, each fed the same
    fixed permutation, on the card and on the CPU from the same initial
    parameters: every parameter within SVD_EPOCH_RTOL / SVD_EPOCH_ATOL.
    (Adam's normalized steps carry summation-order differences forward; at
    the CLI's 100 factors they reach 10x this tolerance between two CPU
    implementations, at 8 factors a third of it.) Returns the largest
    error relative to the tolerance (at most 1)."""
    rng = np.random.default_rng(seed)
    n_users, n_items, n_obs = 120, 60, 3000
    u = rng.integers(0, n_users, n_obs)
    i = rng.integers(0, n_items, n_obs)
    r = np.clip(0.2 + 0.8 * ((u < 60) == (i < 30)) + rng.normal(0, 0.05, n_obs), 0, 1.2)
    cfg = SVDConfig(n_factors=8, batch_size=512)
    init = {
        "mu": torch.tensor(float(np.mean(r)), dtype=torch.float32),
        "b_u": torch.zeros(n_users),
        "b_i": torch.zeros(n_items),
        "p": torch.from_numpy(rng.normal(0, cfg.init_std, (n_users, cfg.n_factors)).astype(np.float32)),
        "q": torch.from_numpy(rng.normal(0, cfg.init_std, (n_items, cfg.n_factors)).astype(np.float32)),
    }
    fitted = {}
    for where in (dev, torch.device("cpu")):
        params = {k: v.clone().to(where) for k, v in init.items()}
        data, bsz = pad_edges(u, i, r.astype(np.float32), cfg.batch_size, where)
        opt = Adam(cfg.lr)
        state = opt.init(params)
        perm_rng = np.random.default_rng(seed + 1)
        for _ in range(2):
            perm = torch.from_numpy(perm_rng.permutation(len(data[0]))).to(where)
            svd_epoch(params, opt, state, perm, data, bsz, cfg.reg)
        fitted[where.type] = {k: v.cpu() for k, v in params.items()}
    worst = 0.0
    for name, want in fitted["cpu"].items():
        got = fitted[dev.type][name]
        torch.testing.assert_close(got, want, rtol=SVD_EPOCH_RTOL, atol=SVD_EPOCH_ATOL)
        limit = SVD_EPOCH_ATOL + SVD_EPOCH_RTOL * want.abs()
        worst = max(worst, ((got - want).abs() / limit).max().item())
    return worst


def svd_path(work: str, dev: torch.device, seed: int) -> str:
    """Phase 12's SVD step: two epochs on the card held against the CPU's
    (check_svd_epochs); ``cli.svd --edges edges.csv`` with SVD_ARGS on the
    phase's edges CSV, its mean P@10 and R@10 within SVD_TOL of JAX's; the
    same folds fitted for SVD_BROKEN_EPOCHS epochs outside it. Returns the
    detail line."""
    epoch_err = check_svd_epochs(dev, seed)
    edges_csv = os.path.join(work, "edges.csv")
    with open(edges_csv, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    assert digest == CLI_EDGES_SHA256, f"edges CSV {digest} is not the one JAX's figures are for"
    t0 = time.perf_counter()
    res = svd_cli.main(["--edges", edges_csv, *SVD_ARGS, "--device", dev.type])
    t_svd = time.perf_counter() - t0
    for key, want in SVD_JAX.items():
        assert abs(res[key] - want) <= SVD_TOL, (key, res[key], want)
    broken = []
    for epochs in SVD_BROKEN_EPOCHS:
        out = svd_cli.main(["--edges", edges_csv, *SVD_ARGS, "--epochs", str(epochs), "--device", dev.type])
        off = max(abs(out[key] - want) for key, want in SVD_JAX.items())
        assert off > SVD_TOL, f"a {epochs}-epoch fit lies within SVD_TOL of JAX's: {out}"
        broken.append(f"a {epochs}-epoch fit {out['precision_mean']:.6f} / {out['recall_mean']:.6f}")
    return (
        f"svd_epoch on the card: 2 epochs within {epoch_err:.3f} of the CPU's tolerance; "
        f"cli.svd {t_svd:.2f} s: P@10 {res['precision_mean']:.6f} R@10 {res['recall_mean']:.6f} "
        f"(JAX {SVD_JAX['precision_mean']:.6f} / {SVD_JAX['recall_mean']:.6f}, limit {SVD_TOL}; per fold P "
        f"{' '.join(f'{p:.6f}' for p in res['precision_per_fold'])}); outside the limit: "
        f"{'; '.join(broken)}"
    )


def check_scalar_division(dev: torch.device, seed: int) -> str:
    """One Adam update's direction and one metrics call on the card, bit for
    bit against the host's f32 true divisions (the port divides by 0-d
    tensors; the card turns a division by a Python scalar into a multiply
    by its reciprocal). The square root is the card's own, read back; the
    detail line also counts how often it differs from numpy's and how often
    the old scalar forms leave the host's division."""
    rng = np.random.default_rng(seed + 5)
    adam = Adam(LR)
    params = {"embedding": torch.from_numpy(rng.standard_normal((4096, DIM), dtype=np.float32)).to(dev)}
    state = adam.init(params)
    for _ in range(3):  # step 3: both bias corrections far from 1
        g = torch.from_numpy(rng.standard_normal((4096, DIM), dtype=np.float32)).to(dev)
        adam.update({"embedding": g}, state, params)
    m, v = state.exp_avg["embedding"], state.exp_avg_sq["embedding"]
    bc1, bc2 = _bias_correction(adam.b1, state.step), _bias_correction(adam.b2, state.step)
    got = adam_direction(m, v, bc1, bc2, adam.eps).cpu().numpy()
    m_h, v_h = m.cpu().numpy(), v.cpu().numpy()
    q_h = v_h / np.float32(bc2)
    root = torch.from_numpy(q_h).to(dev).sqrt().cpu().numpy()
    want = (m_h / np.float32(bc1)) / (root + np.float32(adam.eps))
    assert np.array_equal(got, want), "Adam's direction left the host's f32 division"
    sqrt_diff = int((root != np.sqrt(q_h)).sum())
    old_adam = int(((m / bc1).cpu().numpy() != m_h / np.float32(bc1)).sum())

    k = 20
    idx = torch.from_numpy(rng.integers(0, 500, (8192, k))).to(dev)
    # Distinct truth ids per user, as the splits give them, -1 padded.
    truth = np.argsort(rng.random((8192, 500)), axis=1)[:, :7]
    truth[np.arange(7)[None, :] >= rng.integers(1, 8, 8192)[:, None]] = -1
    truth = torch.from_numpy(truth).to(dev)
    recall, precision = recall_precision_at_k(idx, truth, k)
    hits = (idx[:, :, None] == truth[:, None, :]).any(2).sum(1).cpu().numpy().astype(np.float32)
    tlen = np.maximum((truth >= 0).sum(1).cpu().numpy(), 1).astype(np.float32)
    assert np.array_equal(precision.cpu().numpy(), hits / np.float32(k)), "precision left the host's division"
    assert np.array_equal(recall.cpu().numpy(), hits / tlen), "recall left the host's division"
    old_prec = int(((torch.from_numpy(hits).to(dev) / k).cpu().numpy() != hits / np.float32(k)).sum())
    return (
        f"scalar division: Adam direction ({m.numel()} values, step 3) and recall/precision "
        f"({len(hits)} users, K {k}) equal the host's f32 divisions; the card's sqrt differs "
        f"from numpy's in {sqrt_diff}; the old scalar forms m / bc1 and hits / K differ from "
        f"the host in {old_adam} and {old_prec} values"
    )


def k1_bytes(table: torch.Tensor, plan) -> tuple[int, int, int]:
    """K1's work on these inputs: (bytes with each input read once: the
    referenced table rows, index and weight per arc, the chunk pointers, and
    the output written once; the same with each arc reading its own row;
    f32 operations)."""
    n_arcs, d = plan.src.numel(), table.shape[1]
    elt = table.element_size()
    rows_read = torch.unique(plan.src).numel()
    bytes_once = (
        rows_read * d * elt + n_arcs * 8 + (plan.n_chunks + plan.n_out + 2) * 8
        + plan.n_out * d * 4
    )
    bytes_gather = n_arcs * d * elt + n_arcs * 8 + plan.n_out * d * 4
    return bytes_once, bytes_gather, 2 * n_arcs * d


def sparse_csr(plan, table: torch.Tensor):
    """The plan as a torch CSR matrix in the table's dtype (the library
    yardstick's operand)."""
    crow = torch.zeros(plan.n_out + 1, dtype=torch.int64, device=table.device)
    crow[1:] = torch.cumsum(torch.bincount(plan.dst, minlength=plan.n_out), 0)
    return torch.sparse_csr_tensor(
        crow, plan.src.long(), plan.w.to(table.dtype), size=(plan.n_out, table.shape[0])
    )


def ell_of_plan(plan, dev) -> object:
    """The degree-binned ELL of the same arcs as a segment-reduce plan."""
    dst = plan.dst.cpu().numpy()
    indptr = np.searchsorted(dst, np.arange(plan.n_out + 1))
    return build_ell_plan(indptr, plan.src.cpu().numpy(), plan.w.cpu().numpy(), plan.n_out, device=dev)


def check_rank_k1(name: str, table: torch.Tensor, plan, ell_table: torch.Tensor | None = None) -> dict:
    """K1 at one rank's shapes against its plain version (phase 3's bound),
    with kernel, plain and torch.sparse.mm times and the bound; for a
    to_users plan also ell_apply's time on the same arcs (``ell_table``)."""
    out = SEGREDUCE(table, plan)
    ref = segreduce_plain(table, plan)
    scale = ref.abs().max().item()
    err = (out - ref).abs().max().item()
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5 * scale)
    del ref
    bytes_once, bytes_gather, flops = k1_bytes(table, plan)
    csr, dense = sparse_csr(plan, table), table.contiguous()
    row = {
        "arcs": plan.src.numel(), "n_out": plan.n_out, "table_rows": table.shape[0],
        "n_chunks": plan.n_chunks, "max_abs_err": err,
        "ms": time_ms(lambda: SEGREDUCE(table, plan)),
        "plain_ms": time_ms(lambda: segreduce_plain(table, plan), reps=5),
        "library_ms": time_ms(lambda: torch.sparse.mm(csr, dense)),
        "bound_ms": max(bytes_once / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3,
        "gather_bound_ms": bytes_gather / HBM_BYTES_PER_S * 1e3,
    }
    del csr, dense
    if ell_table is not None:
        ell = ell_of_plan(plan, table.device)
        gather = torch.bfloat16 if table.dtype == torch.bfloat16 else None
        got = ell_apply(ell_table, ell, gather_dtype=gather)
        if gather is None:
            torch.testing.assert_close(got, out, rtol=1e-4, atol=1e-5 * scale)
        else:  # the ELL keeps each weight f32, K1 rounds it to bf16
            rel = ((got - out).norm() / out.norm()).item()
            assert rel <= MESH_BF16_USERS_REL, rel
        row["ell_apply_ms"] = time_ms(lambda: ell_apply(ell_table, ell, gather_dtype=gather))
        del ell, got
    del out
    print(
        f"  {name}: arcs {row['arcs']} into {row['n_out']} rows from {row['table_rows']}, chunks "
        f"{row['n_chunks']}; max_abs_err {err:.3e} (max |ref| {scale:.3e}); kernel_ms {row['ms']:.4f} "
        f"plain_ms {row['plain_ms']:.4f} library_ms {row['library_ms']:.4f} bound_ms "
        f"{row['bound_ms']:.4f} gather_bound_ms {row['gather_bound_ms']:.4f}"
        + (f" ell_apply_ms {row['ell_apply_ms']:.4f}" if "ell_apply_ms" in row else ""),
        flush=True,
    )
    return row


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def assert_forward(got: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    """Phase 4's bound (rtol 1e-4, atol 1e-5·max|ref|); returns max |err|."""
    scale = ref.abs().max().item()
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5 * scale, msg=lambda m: f"{what}: {m}")
    return (got - ref).abs().max().item()


def mesh_world1(split, cfg, item_op: torch.Tensor, params: dict, emb: torch.Tensor, dev) -> str:
    """A world of 1 over NCCL in this process: the fast edge partition's
    embed in f32 (one all-reduce, one band all-gather a B_ii pass, one
    all-gather of the user rows) against phase 4's forward."""
    init_distributed(f"localhost:{free_port()}", 1, 0, backend="nccl", device=dev)
    try:
        mesh = make_mesh(1, axis_sizes=(1,), axis_names=("model",), device=dev)
        fep = build_fast_edge_partition(split, mesh, item_op, "float32")
        sp = split_ep_tree(params, fep)
        embed, _ = make_fast_edge_fns(cfg, None, mesh, fep, BATCH, DECAY, EDGE_CAP)
        err = assert_forward(embed(sp, fep), emb, "NCCL world 1 embed")
        ms = time_ms(lambda: embed(sp, fep), reps=5, warmup=1)
    finally:
        torch.distributed.destroy_process_group()
    return f"NCCL world 1: embed f32 max_abs_err {err:.3e} vs phase 4, {ms:.3f} ms"


def mesh_rank(rank: int, world: int, store: str, payload: dict, queue) -> None:
    """One rank of phase 14's gloo world on cuda:0: drive the mesh path
    (counted), then K1 at this rank's shapes in turns with the other ranks
    (not counted). Puts its results, or its traceback, on ``queue``."""
    try:
        p = payload
        dev = resolve_device(p["device"])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        init_distributed(f"file://{store}", world, rank, backend="gloo", device=dev)
        split, cfg = p["split"], LightGCNConfig(p["num_nodes"], DIM, LAYERS)
        params = {"embedding": p["table"]}
        E_u, E_i = p["table"][: split.n_users], p["table"][split.n_users :]
        res = {"rank": rank}
        reset_launches()
        t0 = time.perf_counter()
        mesh = make_mesh(world, axis_sizes=(world,), axis_names=("model",), device=dev)
        mesh_eval = make_mesh(world, axis_sizes=(world, 1), device=dev)
        fep32 = build_fast_edge_partition(split, mesh, p["item_op32"], "float32")
        fep16 = build_fast_edge_partition(
            split, mesh, p["item_op16"], "bfloat16", HEAVY_USERS, "bfloat16"
        )
        sfo32 = build_sharded_fast_ops(split, mesh, "float32")
        sfo16 = build_sharded_fast_ops(split, mesh, "bfloat16", HEAVY_USERS, "bfloat16")
        res["build_s"] = time.perf_counter() - t0
        with torch.no_grad():
            sp32, sp16 = split_ep_tree(params, fep32), split_ep_tree(params, fep16)
            embed32, _ = make_fast_edge_fns(cfg, None, mesh, fep32, BATCH, DECAY, EDGE_CAP)
            embed16, _ = make_fast_edge_fns(cfg, None, mesh, fep16, BATCH, DECAY, EDGE_CAP)
            out32 = embed32(sp32, fep32)
            res["embed32_err"] = assert_forward(out32, p["emb"], f"rank {rank} embed f32")
            out16 = embed16(sp16, fep16)
            assert torch.isfinite(out16).all()
            res["embed16_rel"] = ((out16 - out32).norm() / out32.norm()).item()
            assert res["embed16_rel"] <= BF16_FORWARD_REL, res["embed16_rel"]
            res["embed16_rel_vs_phase5"] = ((out16 - p["emb16"]).norm() / p["emb16"].norm()).item()
            del out32, out16
            res["embed32_ms"] = time_ms(lambda: embed32(sp32, fep32), reps=3, warmup=1)
            res["embed16_ms"] = time_ms(lambda: embed16(sp16, fep16), reps=3, warmup=1)
            for mode, sfo in (("32", sfo32), ("16", sfo16)):
                ti, tu = sharded_to_items(E_u, sfo), sharded_to_users(E_i, sfo)
                res[f"to_items{mode}_err"] = assert_forward(ti, p[f"ti{mode}"], f"sharded_to_items {mode}")
                if mode == "32":
                    res["to_users32_err"] = assert_forward(tu, p["tu32"], "sharded_to_users f32")
                else:
                    res["to_users16_rel"] = ((tu - p["tu16"]).norm() / p["tu16"].norm()).item()
                    assert res["to_users16_rel"] <= MESH_BF16_USERS_REL, res["to_users16_rel"]
                del ti, tu
            batch = build_eval_batch(p["val"], device=dev)
            prec, rec, rec_u, prec_u, idx = sharded_evaluate(p["emb"], batch, split.n_users, mesh_eval, k=20)
            res["eval"] = (prec, rec, idx)
            buckets = build_eval_buckets(p["val"], width_floor=256, device=dev)
            res["eval_buckets"] = make_sharded_eval_fn(mesh, split.n_users, k=20)(p["emb"], buckets)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        res["path_s"] = time.perf_counter() - t0
        res["launches"] = read_launches()
        # K1 at this rank's shapes, one rank at a time (the card is shared).
        x_loc32, x_loc16 = sp32["emb_users"], bf16_rows(sp16["emb_users"])
        E_i16 = bf16_rows(E_i)
        for turn in range(world):
            barrier()
            if turn == rank:
                res["k1"] = {
                    "f32_to_items": check_rank_k1(f"rank {rank} K1 f32 to_items", x_loc32, fep32.items_stack.plan),
                    "f32_to_users": check_rank_k1(
                        f"rank {rank} K1 f32 to_users", E_i, fep32.users_stack.plan, ell_table=E_i
                    ),
                    "bf16_to_items": check_rank_k1(f"rank {rank} K1 bf16 to_items", x_loc16, fep16.items_stack.plan),
                    "bf16_to_users": check_rank_k1(
                        f"rank {rank} K1 bf16 to_users", E_i16, fep16.users_stack.plan, ell_table=E_i
                    ),
                }
        barrier()
        torch.distributed.destroy_process_group()
        queue.put(res)
    except BaseException:
        queue.put({"rank": rank, "error": traceback.format_exc()})
        raise


def mesh_world2(payload: dict, target=None, label: str = "phase 14") -> list:
    """A gloo world of MESH_WORLD spawned ranks sharing cuda:0, each running
    ``target`` (default: phase 14's ``mesh_rank``); the payload's CUDA
    tensors reach them by IPC, B_ii included. Returns each rank's results.
    A rank that fails or outlives MESH_TIMEOUT_S fails the phase; every rank
    is stopped before this returns."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        procs = [
            ctx.Process(target=target or mesh_rank,
                        args=(r, MESH_WORLD, os.path.join(tmp, "store"), payload, queue))
            for r in range(MESH_WORLD)
        ]
        for proc in procs:
            proc.start()
        results = []
        try:
            deadline = time.monotonic() + MESH_TIMEOUT_S
            for _ in procs:
                try:
                    results.append(queue.get(timeout=max(1.0, deadline - time.monotonic())))
                except Exception as e:  # queue.Empty: a rank died or hung
                    raise RuntimeError(
                        f"{label}: {len(results)} of {MESH_WORLD} ranks reported within "
                        f"{MESH_TIMEOUT_S} s; exit codes {[proc.exitcode for proc in procs]}"
                    ) from e
            for proc in procs:
                proc.join(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                    proc.join(10)
    errors = [r["error"] for r in results if "error" in r]
    if errors:
        raise RuntimeError(f"{label} rank failed:\n" + "\n".join(errors))
    assert all(proc.exitcode == 0 for proc in procs), [proc.exitcode for proc in procs]
    return sorted(results, key=lambda r: r["rank"])


def mesh_path(split, cfg, params: dict, fb, fb16, emb: torch.Tensor, emb16: torch.Tensor,
              prepared: PreparedData, dev) -> tuple[str, dict, list]:
    """Phase 14: the multi-device forward and sharded eval in a world of 1
    over NCCL (in this process), then in a gloo world of MESH_WORLD ranks on
    this card. Returns (detail, the path's launches over every process,
    each rank's K1 rows)."""
    n_users = split.n_users
    with torch.no_grad():  # references on one device: not the path
        E_u, E_i = params["embedding"][:n_users], params["embedding"][n_users:]
        refs = {
            "ti32": fast_to_items(E_u, fb.fops), "tu32": fast_to_users(E_i, fb.fops),
            "ti16": fast_to_items(E_u, fb16.fops), "tu16": fast_to_users(E_i, fb16.fops),
        }
        ev_p, ev_r, _, _, ev_idx = evaluate(emb, build_eval_batch(prepared.val, device=dev), n_users, 20)
        bk_p, bk_r = evaluate_bucketed(
            emb, build_eval_buckets(prepared.val, width_floor=256, device=dev), n_users, 20
        )
    reset_launches()
    with torch.no_grad():
        w1 = mesh_world1(split, cfg, fb.item_op, params, emb, dev)
    counts = read_launches()
    payload = {
        "device": dev, "split": split, "num_nodes": cfg.num_nodes, "table": params["embedding"],
        "item_op32": fb.item_op, "item_op16": fb16.item_op, "emb": emb, "emb16": emb16,
        "val": prepared.val, **refs,
    }
    ranks = mesh_world2(payload)
    del payload, refs
    for r in ranks:
        prec, rec, idx = r["eval"]
        assert within_rel(prec, ev_p) and within_rel(rec, ev_r), (r["eval"][:2], ev_p, ev_r)
        assert np.array_equal(idx, ev_idx), f"rank {r['rank']}: sharded_evaluate ids differ"
        bp, br = r["eval_buckets"]
        assert within_rel(bp, bk_p) and within_rel(br, bk_r), (r["eval_buckets"], bk_p, bk_r)
        for name, n in r["launches"].items():
            counts[name] += n
    for name in ("segreduce_f32", "segreduce_bf16", "segreduce_cast_bf16"):
        assert all(r["launches"][name] >= 1 for r in ranks), f"a rank did not launch {name}"
    detail = "; ".join(
        f"rank {r['rank']}: build {r['build_s']:.2f} s path {r['path_s']:.2f} s, embed f32 "
        f"{r['embed32_ms']:.3f} ms max_abs_err {r['embed32_err']:.3e}, bf16 {r['embed16_ms']:.3f} ms "
        f"rel vs f32 {r['embed16_rel']:.3e} (vs phase 5's bf16 forward {r['embed16_rel_vs_phase5']:.3e}); "
        f"sharded_to_items err f32 {r['to_items32_err']:.3e} bf16 {r['to_items16_err']:.3e}, "
        f"sharded_to_users err f32 {r['to_users32_err']:.3e} bf16 rel {r['to_users16_rel']:.3e}; "
        f"eval P/R@20 {r['eval'][0]:.6f}/{r['eval'][1]:.6f} ids equal, buckets "
        f"{r['eval_buckets'][0]:.6f}/{r['eval_buckets'][1]:.6f}"
        for r in ranks
    )
    return f"{w1}; gloo world {MESH_WORLD} on one card: {detail} (one device: P/R@20 {ev_p:.6f}/{ev_r:.6f})", counts, ranks


def within_rel(got: float, want: float, rel: float = 1e-6) -> bool:
    return abs(got - want) <= rel * abs(want)


def step_digest(tensors) -> torch.Tensor:
    """Two int64 checksums of each f32 tensor's bits (their sum, and a
    position-weighted sum): equal digests on two ranks mean equal bits."""
    parts = []
    for t in tensors:
        v = t.detach().contiguous().view(torch.int32).reshape(-1).long()
        w = torch.arange(v.numel(), dtype=torch.int64, device=v.device) % 1_000_003 + 1
        parts += [v.sum(), (v * w).sum()]
    return torch.stack(parts)


def assert_bit_equal(tensors, mesh, what: str) -> None:
    """Every rank of ``mesh`` holds the same bits in ``tensors``."""
    every = all_gather_rows(step_digest(tensors)[None], mesh)
    assert bool((every == every[0]).all()), f"{what}: the ranks' replicated leaves differ"


def one_device_steps(fb, params: dict, batches: list) -> list:
    """The one-device main-path step (``make_train_fns`` over
    ``fast_batch_embeddings``, as ``train()`` runs it) on each fixed batch
    from ``params``: per step (loss, table, Adam's first moment)."""
    adam = Adam(LR)
    step, _ = make_train_fns(
        LightGCNConfig(fb.n_users + fb.n_items, DIM, LAYERS), adam, BATCH, DECAY,
        batch_embed_fn=lambda p, fb_, u, po, ne: fast_batch_embeddings(
            p, fb_, LAYERS, u, po, ne, edge_cap=EDGE_CAP
        ),
    )
    p = {"embedding": params["embedding"].clone()}
    state = adam.init(p)
    refs = []
    for users, pos, neg in batches:
        _, _, m = step.on_batch(p, state, fb, users, pos, neg)
        assert int(m["dropped_arcs"]) == 0
        refs.append((float(m["loss"]), p["embedding"].clone(), state.exp_avg["embedding"].clone()))
    return refs


def compare_step(m: dict, table: torch.Tensor, mu: torch.Tensor, ref: tuple, mode: str) -> dict:
    """A mesh step against the one-device step from the same params: the
    loss within MESH_LOSS_RTOL, the table within MESH_TABLE_REL relative
    Frobenius, Adam's first moment within MESH_GRAD_REL; no dropped arcs."""
    loss, ref_table, ref_mu = ref
    out = {"loss": float(m["loss"]), "dropped": float(m["dropped_arcs"])}
    out["loss_rel"] = abs(out["loss"] / loss - 1.0)
    out["table_rel"] = ((table - ref_table).norm() / ref_table.norm()).item()
    out["grad_rel"] = ((mu - ref_mu).norm() / ref_mu.norm()).item()
    assert out["dropped"] == 0.0, out
    assert out["loss_rel"] <= MESH_LOSS_RTOL and out["table_rel"] <= MESH_TABLE_REL, out
    assert out["grad_rel"] <= MESH_GRAD_REL[mode], out
    return out


def run_mesh_steps(step, params: dict, state, graph, batches, refs, mode: str, view, dev,
                   replicated=None) -> list:
    """``step.on_batch`` on each fixed batch, each held against the
    one-device step (``refs``; ``view`` gives the unified table and Adam
    state) and, with ``replicated(params, state) -> (tensors, mesh)``, the
    replicated leaves against every rank's; per step its stats and ms."""
    out = []
    for batch, ref in zip(batches, refs):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        _, _, m = step.on_batch(params, state, graph, *batch)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        with torch.no_grad():
            row = compare_step(m, view(params)["embedding"], view(state).exp_avg["embedding"], ref, mode)
            if replicated is not None:
                assert_bit_equal(*replicated(params, state), f"{mode} step")
        out.append({**row, "ms": ms})
    return out


def edge_train_steps(split, cfg, mesh, item_op, mode: str, heavy: int, table, batches, refs,
                     dev) -> list:
    """The fast edge partition's train step on each fixed batch from
    ``table`` (``run_mesh_steps``; ``emb_items`` and its moments bit-equal
    on every rank); also returns the rank's partition."""
    fep = build_fast_edge_partition(split, mesh, item_op, mode, heavy, mode)
    _, step = make_fast_edge_fns(cfg, Adam(LR), mesh, fep, BATCH, DECAY, EDGE_CAP)
    params = split_ep_tree({"embedding": table}, fep)
    rows = run_mesh_steps(
        step, params, Adam(LR).init(params), fep, batches, refs, mode,
        lambda tree: merge_ep_view(tree, fep), dev,
        lambda p, o: ([p["emb_items"], o.exp_avg["emb_items"], o.exp_avg_sq["emb_items"]], mesh),
    )
    return rows, fep


def gspmd_train_steps(fb16, cfg, mesh, table, batches, refs, dev) -> tuple[list, object]:
    """The GSPMD fast bf16 step on each fixed batch (``run_mesh_steps``);
    also returns the rank's sharded operators."""
    sfb = shard_fast_bipartite(fb16, mesh, True, "bfloat16", HEAVY_USERS, "bfloat16")
    step = make_sharded_fast_train_step(cfg, Adam(LR), mesh, BATCH, DECAY, EDGE_CAP)
    params = shard_params({"embedding": table}, mesh)
    rows = run_mesh_steps(
        step, params, Adam(LR).init(params), sfb, batches, refs, "bfloat16",
        lambda tree: unshard_params(tree, mesh, cfg.num_nodes), dev,
    )
    return rows, sfb


def segment_train_steps(fb16, cfg, mesh, table, batches, seg: dict, dev) -> tuple[dict, list]:
    """The GSPMD segment-sum path, ``shard_fast_bipartite(fb16, mesh)`` with
    JAX's default ``fast_ops=False``: ``sharded_fast_embedding`` against the
    one-device plan-less forward (phase 4's bound), then the fast step on
    each fixed batch (``run_mesh_steps``) against the one-device plan-less
    step (``seg``: its forward and step references). Returns (the
    forward's max |err| and ms, the steps' rows)."""
    sfb = shard_fast_bipartite(fb16, mesh)
    assert sfb.fops is None
    params = shard_params({"embedding": table}, mesh)
    with torch.no_grad():
        fwd = {"err": assert_forward(sharded_fast_embedding(params, sfb, LAYERS), seg["emb"],
                                     "GSPMD segment forward")}
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        sharded_fast_embedding(params, sfb, LAYERS)
        torch.cuda.synchronize(dev)
        fwd["ms"] = (time.perf_counter() - t0) * 1e3
    step = make_sharded_fast_train_step(cfg, Adam(LR), mesh, BATCH, DECAY, EDGE_CAP)
    rows = run_mesh_steps(
        step, params, Adam(LR).init(params), sfb, batches, seg["refs"], "bfloat16",
        lambda tree: unshard_params(tree, mesh, cfg.num_nodes), dev,
        lambda p, o: ([p["embedding"], o.exp_avg["embedding"], o.exp_avg_sq["embedding"]], mesh),
    )
    return fwd, rows


def train_world1(split, cfg, item_op32, fb16, table, batches, refs32, refs16, seg, dev) -> dict:
    """Phase 15 in a world of 1 over NCCL, in this process: the fast edge
    partition's bf16 step on every fixed batch and its f32 step on the
    first, and the GSPMD segment-sum forward and steps (counted), then K1
    in f32 and bf16 at this world's plans, both directions (not counted):
    the forward's to_items, and the users-side plan on the whole graph that
    the to_items backward runs."""
    init_distributed(f"localhost:{free_port()}", 1, 0, backend="nccl", device=dev)
    try:
        mesh = make_mesh(1, axis_sizes=(1,), axis_names=("model",), device=dev)
        reset_launches()
        out = {}
        out["bf16"], fep16 = edge_train_steps(split, cfg, mesh, fb16.item_op, "bfloat16", HEAVY_USERS,
                                              table, batches, refs16, dev)
        out["f32"], fep32 = edge_train_steps(split, cfg, mesh, item_op32, "float32", 0, table,
                                             batches[:1], refs32, dev)
        out["segment_fwd"], out["segment"] = segment_train_steps(
            fb16, cfg, make_mesh(1, axis_sizes=(1, 1), device=dev), table, batches, seg, dev
        )
        out["launches"] = read_launches()
    finally:
        torch.distributed.destroy_process_group()
    E_u, E_i = table[: split.n_users], table[split.n_users :]
    with torch.no_grad():
        out["k1"] = {
            "f32_to_items": check_rank_k1("world 1 K1 f32 to_items", E_u, fep32.items_stack.plan),
            "f32_to_users": check_rank_k1("world 1 K1 f32 to_users", E_i, fep32.users_stack.plan),
            "bf16_to_items": check_rank_k1("world 1 K1 bf16 to_items", bf16_rows(E_u),
                                           fep16.items_stack.plan),
            "bf16_to_users": check_rank_k1("world 1 K1 bf16 to_users", bf16_rows(E_i),
                                           fep16.users_stack.plan),
        }
    return out


def train_rank(rank: int, world: int, store: str, payload: dict, queue) -> None:
    """One rank of phase 15's gloo world on cuda:0: the fast edge
    partition's and the GSPMD fast bf16 steps, and the GSPMD segment-sum
    forward and steps on a (data 2, model 1) mesh (counted), then, in turns
    with the other ranks (not counted), K1 at this rank's GSPMD shapes and
    its cast at the rank's edge-partition user rows. Puts its results, or its traceback, on ``queue``."""
    try:
        p = payload
        dev = resolve_device(p["device"])
        torch.cuda.set_device(dev)
        init_distributed(f"file://{store}", world, rank, backend="gloo", device=dev)
        split, cfg = p["split"], LightGCNConfig(p["num_nodes"], DIM, LAYERS)
        res = {"rank": rank}
        reset_launches()
        t0 = time.perf_counter()
        mesh = make_mesh(world, axis_sizes=(world,), axis_names=("model",), device=dev)
        res["edge"], _ = edge_train_steps(split, cfg, mesh, p["fb16"].item_op, "bfloat16",
                                          HEAVY_USERS, p["table"], p["batches"], p["refs16"], dev)
        t1 = time.perf_counter()
        mesh2d = make_mesh(world, axis_sizes=(1, world), device=dev)
        res["gspmd"], sfb = gspmd_train_steps(p["fb16"], cfg, mesh2d, p["table"], p["batches"],
                                              p["refs16"], dev)
        torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        # The GSPMD segment-sum path with the arcs split over data.
        res["segment_fwd"], res["segment"] = segment_train_steps(
            p["fb16"], cfg, make_mesh(world, axis_sizes=(world, 1), device=dev), p["table"],
            p["batches"], p["seg"], dev,
        )
        torch.cuda.synchronize(dev)
        res["edge_s"], res["gspmd_s"], res["segment_s"] = t1 - t0, t2 - t1, time.perf_counter() - t2
        res["launches"] = read_launches()
        # K1 bf16 and its cast at this rank's GSPMD shapes (the gloo world
        # runs bf16 only), one rank at a time.
        sfo = sfb.fops
        E_u, E_i = p["table"][: split.n_users], p["table"][split.n_users :]
        for turn in range(world):
            barrier()
            if turn == rank:
                with torch.no_grad():
                    res["k1"] = {
                        "bf16_to_items": check_rank_k1(f"rank {rank} GSPMD K1 bf16 to_items",
                                                       bf16_rows(E_u), sfo.items_stack.plan),
                        "bf16_to_users": check_rank_k1(f"rank {rank} GSPMD K1 bf16 to_users",
                                                       bf16_rows(E_i), sfo.users_stack.plan),
                    }
                    R = user_rows_per_shard(split.n_users, world, 512)
                    res["cast"] = check_cast(E_u[rank * R : (rank + 1) * R])  # an edge rank's rows
        barrier()
        torch.distributed.destroy_process_group()
        queue.put(res)
    except BaseException:
        queue.put({"rank": rank, "error": traceback.format_exc()})
        raise


def steps_line(rows: list) -> str:
    return ", ".join(
        f"loss {r['loss']:.6f} (rel {r['loss_rel']:.1e}) table_rel {r['table_rel']:.2e} grad_rel "
        f"{r['grad_rel']:.2e} {r['ms']:.1f} ms"
        for r in rows
    )


def mesh_train_path(split, cfg, params: dict, fb, fb16, prepared: PreparedData, seed: int,
                    dev) -> tuple[str, dict, list]:
    """Phase 15: the multi-device train steps at the main configuration's
    width on MESH_TRAIN_STEPS fixed batches, against the one-device
    main-path step from the same params: in a world of 1 over NCCL (edge
    bf16, and one edge f32 step), then in a gloo world of MESH_WORLD ranks
    sharing this card (edge bf16 and GSPMD bf16); in both, the GSPMD
    segment-sum forward and steps against the one-device plan-less ones.
    Returns (detail, the
    path's launches over every process, each gloo rank's K1 rows, the
    world of 1's K1 rows)."""
    batches = [fixed_batch(prepared, seed + 10 + b, dev) for b in range(MESH_TRAIN_STEPS)]
    refs16 = one_device_steps(fb16, params, batches)
    refs32 = one_device_steps(fb, params, batches[:1])
    # The plan-less one-device references of the GSPMD segment-sum path
    # (JAX's FastBipartite(split, item_op)) on the bf16 B_ii.
    fb_seg = FastBipartite(split, fb16.item_op, user_csr=fb16.user_csr)
    with torch.no_grad():
        seg = {"emb": fast_get_embedding(params, fb_seg, LAYERS)}
    seg["refs"] = one_device_steps(fb_seg, params, batches)
    del fb_seg
    w1 = train_world1(split, cfg, fb.item_op, fb16, params["embedding"], batches,
                      refs32, refs16, seg, dev)
    counts = w1["launches"]
    assert counts["segreduce_f32"] >= 1 and counts["segreduce_bf16"] >= 1, counts
    payload = {
        "device": dev, "split": split, "num_nodes": cfg.num_nodes, "table": params["embedding"],
        "fb16": fb16, "batches": batches, "refs16": refs16, "seg": seg,
    }
    ranks = mesh_world2(payload, train_rank, "phase 15")
    del payload, refs16, refs32, seg
    for r in ranks:
        for name, n in r["launches"].items():
            counts[name] += n
        assert r["launches"]["segreduce_bf16"] >= 1 and r["launches"]["segreduce_cast_bf16"] >= 1, r["launches"]
    seg_line = lambda r: (
        f"GSPMD segment-sum forward max_abs_err {r['segment_fwd']['err']:.3e} vs one device, "
        f"{r['segment_fwd']['ms']:.1f} ms; steps {steps_line(r['segment'])}"
    )
    detail = (
        f"NCCL world 1: edge bf16 {steps_line(w1['bf16'])}; edge f32 {steps_line(w1['f32'])}; "
        f"{seg_line(w1)}; "
        f"gloo world {MESH_WORLD}, ranks sharing one card (times are staging through host memory, "
        f"not a scaling figure): "
        + "; ".join(
            f"rank {r['rank']}: edge bf16 {steps_line(r['edge'])} ({r['edge_s']:.2f} s with the "
            f"build); GSPMD bf16 {steps_line(r['gspmd'])} ({r['gspmd_s']:.2f} s with the build); "
            f"data 2: {seg_line(r)} ({r['segment_s']:.2f} s with the build)"
            for r in ranks
        )
    )
    return detail, counts, ranks, w1["k1"]


def mesh_cli_path(work: str) -> str:
    """Phase 12's mesh step: two cli.train ranks (gloo, sharing cuda:0,
    torch's four variables) on the phase's edges CSV, --mesh 2 --partition
    edge --fast bf16 for 2 epochs with rank 0's checkpoints, then --resume
    for a third. Best val R@20 of the first launch at least
    CLI_POPULARITY_FACTOR x popularity and within MESH_CLI_RECALL_TOL of the
    one-device cli.train's on the same corpus and seed."""
    with open(os.path.join(work, "model-checkpoints", "train_log.jsonl")) as f:
        one_device_best = max(r["val_recall"] for r in map(json.loads, f) if "epoch" in r)
    mesh_dir = os.path.join(work, "mesh")
    os.makedirs(mesh_dir)
    edges_csv = os.path.join(work, "edges.csv")
    root = os.path.dirname(os.path.abspath(__file__))
    args = [
        "--edges", edges_csv, *CLI_TRAIN_ARGS[2:], "--mesh", str(MESH_WORLD), "--partition",
        "edge", "--device", "cuda:0", "--backend", "gloo",
    ]

    def launch(extra: list) -> float:
        port = free_port()
        t0 = time.perf_counter()
        procs = []
        for rank in range(MESH_WORLD):
            env = {**os.environ, "PYTHONPATH": root, "MASTER_ADDR": "localhost",
                   "MASTER_PORT": str(port), "WORLD_SIZE": str(MESH_WORLD), "RANK": str(rank)}
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "gnn_ecommerce_tpu_torch.cli.train", *args, *extra],
                cwd=mesh_dir, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        outs = []
        try:
            for proc in procs:
                outs.append(proc.communicate(timeout=MESH_TIMEOUT_S)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(10)
        for rank, (proc, out) in enumerate(zip(procs, outs)):
            assert proc.returncode == 0, f"mesh cli.train rank {rank} failed:\n{out[-4000:]}"
            assert "done: best epoch" in out, out[-2000:]
        return time.perf_counter() - t0

    t_train = launch(["-e", "2"])
    ckpt = os.path.join(mesh_dir, "model-checkpoints")
    with open(os.path.join(ckpt, "train_log.jsonl")) as f:
        hist = [r for r in map(json.loads, f) if "epoch" in r]
    assert [h["epoch"] for h in hist] == [0, 1], hist
    assert all(h["dropped_arcs"] == 0.0 for h in hist), hist
    best = max(h["val_recall"] for h in hist)
    prepared = load_prepared(os.path.join(mesh_dir, "data/prepared"))
    pop = popularity_recall_at_k(prepared, k=20)
    assert best >= CLI_POPULARITY_FACTOR * pop, (best, pop)
    assert abs(best - one_device_best) <= MESH_CLI_RECALL_TOL, (best, one_device_best)
    t_resume = launch(["-e", "3", "--resume"])
    with open(os.path.join(ckpt, "train_log.jsonl")) as f:
        resumed = [r for r in map(json.loads, f) if "epoch" in r]
    assert [h["epoch"] for h in resumed] == [0, 1, 2], resumed
    leaves, meta = load_checkpoint(ckpt, LAST_NAME)
    assert meta["epoch"] == 2 and leaves[0].shape == (prepared.n_users + prepared.n_items, DIM)
    recalls = " ".join(f"{h['val_recall']:.6f}" for h in hist)
    epochs = " ".join(f"{h['epoch_s']:.2f}" for h in hist)
    return (
        f"mesh cli.train (2 ranks sharing the card, gloo): {t_train:.1f} s, val R@20 {recalls} "
        f"(one device best {one_device_best:.6f}, popularity {pop:.6f}), epoch_s {epochs}; "
        f"--resume {t_resume:.1f} s, epoch 2 val R@20 {resumed[-1]['val_recall']:.6f}"
    )


def writer_bytes_check(params: dict, work: str) -> str:
    """The banded asynchronous save of the trained table (and zero moments)
    against a synchronous, unbanded save of the same tensors: equal npz
    bytes."""
    opt = AdamState(1, {"embedding": torch.zeros_like(params["embedding"])},
                    {"embedding": torch.zeros_like(params["embedding"])})
    kw = dict(epoch=0, precision=0.0, recall=0.0)
    writer = CheckpointWriter(os.path.join(work, "banded"), {})
    try:
        t0 = time.perf_counter()
        writer.save(params, opt, [("ckpt", kw)])
        save_s = time.perf_counter() - t0
        writer.flush()
    finally:
        writer.stop(timeout=120)
    save_checkpoint(os.path.join(work, "plain"), params, opt, hyperparams={}, name="ckpt", **kw)
    a, b = (os.path.join(work, d, "ckpt", "checkpoint.npz") for d in ("banded", "plain"))
    assert filecmp.cmp(a, b, shallow=False), "the banded checkpoint's bytes differ from an unbanded save"
    return (
        f"banded snapshot: {writer.stats['snapshot_copies']} copies, save {save_s:.3f} s, npz "
        f"{os.path.getsize(a)} bytes equal to an unbanded save"
    )


def eda_path(work: str) -> str:
    """Phase 12's EDA step: cli.eda on the phase's event CSV; its stats
    against the CSV's own counts, its projection equal to the CSV (the same
    three columns), every section in the report."""
    events_csv = os.path.join(work, "events.csv")
    out = {name: os.path.join(work, name) for name in ("stats.json", "report.html", "user_item_event.csv")}
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # the stats JSON: read back below
        eda_cli.main([
            "--events", events_csv, "--stats", out["stats.json"], "--report", out["report.html"],
            "--out-events", out["user_item_event.csv"],
        ])
    seconds = time.perf_counter() - t0
    cols = read_csv(events_csv)
    with open(out["stats.json"]) as f:
        stats = json.load(f)
    names, counts = np.unique(cols["event_type"], return_counts=True)
    assert stats["n_events"] == len(cols["user_id"]), stats
    assert stats["n_users"] == len(np.unique(cols["user_id"])), stats
    assert stats["n_items"] == len(np.unique(cols["item_id"])), stats
    assert stats["event_type_counts"] == dict(zip(names.tolist(), counts.tolist())), stats
    assert filecmp.cmp(events_csv, out["user_item_event.csv"], shallow=False)
    with open(out["report.html"]) as f:
        report = f.read()
    missing = [s for s in EDA_SECTIONS if f"<section id='{s}'>" not in report]
    assert not missing, f"report lacks sections {missing}"
    return (
        f"cli.eda {seconds:.2f} s: {stats['n_events']} events, {stats['n_users']} users, "
        f"{stats['n_items']} items, purchase share {stats['purchase_share']:.4f}; report "
        f"{len(report)} bytes, all {len(EDA_SECTIONS)} sections; projection equal to the CSV"
    )


def finite_numbers(tree, where: str = "") -> None:
    """Every number in a JSON tree is finite."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            finite_numbers(v, f"{where}.{k}")
    elif isinstance(tree, list):
        for n, v in enumerate(tree):
            finite_numbers(v, f"{where}[{n}]")
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        assert np.isfinite(tree), f"bench line: {where} = {tree}"


def bench_path(kind: str) -> tuple[dict, dict]:
    """Phase 16: ``python -m gnn_ecommerce_tpu_torch.bench`` at root
    bench.py's full shapes in a process of its own (its device memory goes
    back when it ends). Checks the line's keys, finite numbers, the graph,
    the card, K1 bf16 and its cast launched on its path and no roofline
    share above 100%. Returns (the line, its launches per kernels-line
    row)."""
    root = os.path.dirname(os.path.abspath(__file__))
    done = subprocess.run(
        [sys.executable, "-m", "gnn_ecommerce_tpu_torch.bench"], cwd=root,
        env={**os.environ, "PYTHONPATH": root}, capture_output=True, text=True,
        timeout=BENCH_TIMEOUT_S,
    )
    for line in done.stderr.splitlines():
        print(f"  bench: {line}", flush=True)
    if done.returncode != 0:
        raise RuntimeError(f"the benchmark exited with {done.returncode}")
    lines = done.stdout.splitlines()
    assert len(lines) == 1, f"the benchmark printed {len(lines)} lines"
    r = json.loads(lines[0])
    print(f"  bench line: {lines[0]}", flush=True)
    assert {"metric", "value", "unit", "vs_baseline", "detail"} <= set(r), sorted(r)
    d = r["detail"]
    missing = [k for k in BENCH_DETAIL_KEYS if k not in d]
    assert not missing, missing
    finite_numbers(r)
    want = f"{bench.N_USERS}x{bench.N_ITEMS}, {bench.N_EDGES} edges, dim {bench.DIM}, {bench.LAYERS} layers"
    assert d["graph"] == want, d["graph"]
    assert r["device"]["name"] == kind and r["device"]["power_limit"], r["device"]
    rl = d["roofline"]
    shares = {name: ph["pct_of_floor"] for name, ph in rl["phases"].items()}
    shares.update(forward=rl["forward"]["pct_of_floor"], train_step=rl["train_step"]["pct_of_floor"])
    over = {k: v for k, v in shares.items() if not 0.0 < v <= 100.0}
    assert not over, f"roofline shares outside (0, 100]: {over}"
    launches = {name: r["launches"].get(f"{k.STEM}.{mode}", 0) for name, (k, mode) in KERNELS.items()}
    for name, mode in ACCUMULATE.items():
        launches[f"{name}_accumulate"] = r["launches"].get(f"{SEGREDUCE.STEM}.{mode}", 0)
        launches[name] += launches[f"{name}_accumulate"]
    launches[TO_USERS] = 0
    for name in ("segreduce_bf16", "segreduce_cast_bf16"):
        assert launches[name] >= 1, f"the benchmark did not launch {name}"
    # The bucketed candidate: SRC_BUCKETS K1 bf16 launches a to_items, all
    # but the first accumulating; it runs whenever the plans have a head.
    assert set(d["forward_ms"]) == {"segment", "plans", "bucketed"}, d["forward_ms"]
    acc, per_call = launches["segreduce_bf16_accumulate"], bench.SRC_BUCKETS - 1
    assert acc >= per_call and acc % per_call == 0, f"bucketed candidate: {acc} accumulate launches"
    assert launches["segreduce_f32_accumulate"] == 0, launches
    assert d["fast_path"] in ("segment", "plans", "bucketed"), d["fast_path"]
    assert d["fast_forward_ms"] == min(d["forward_ms"].values()), d["forward_ms"]
    return r, launches


def check_bench_kernels(dev: torch.device) -> dict:
    """K1 bf16 and its cast against their plain versions at the benchmark's
    shapes: its initial [1,639,358, 80] user table (seed 0) over the tail
    plan of its graph (16,384-user bf16 head). Returns each check's
    kernels-line row by name."""
    graph, _, _ = bench.build_synthetic_graph(device="cpu")
    cfg = LightGCNConfig(graph.num_nodes, bench.DIM, bench.LAYERS)
    split = split_graph(graph)
    plan = build_fast_ops(split, "bfloat16", bench.HEAVY_USERS, "bfloat16", device=dev).items_plan
    del graph
    E_u = init_params(torch.Generator().manual_seed(0), cfg, device=dev)["embedding"][: bench.N_USERS]
    print(f"  bench shapes: [{E_u.shape[0]}, {E_u.shape[1]}] user table, {plan.src.numel()} tail arcs",
          flush=True)
    with torch.no_grad():
        cast = check_cast(E_u)
        E_u16 = bf16_rows(E_u)
        k1 = check_kernel("segreduce_bf16", E_u16, plan)
        tail = split_heavy_users(split, bench.HEAVY_USERS, "bfloat16", build_head=False, device="cpu")[2:5]
        k1["bucketed"] = {str(bench.SRC_BUCKETS): check_bucketed(
            "bench", E_u16, plan, tail, bench.N_USERS, bench.SRC_BUCKETS)}
    del E_u, E_u16, plan
    torch.cuda.empty_cache()
    return {row["name"]: row for row in (cast, k1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the corpus and weights")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = resolve_device(torch.device("cuda", 0))
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    division = check_scalar_division(dev, args.seed)
    phase(0, "device", t0, f"{kind}; torch {torch.__version__} cuda {torch.version.cuda}; {division}")

    t0 = time.perf_counter()
    build_kernels()
    phase(1, "build", t0)

    t0 = time.perf_counter()
    prepared = make_prepared(args.seed, N_USERS, N_ITEMS, N_EDGES)
    graph_host = build_graph(
        prepared.edge_user, prepared.edge_item_node, prepared.edge_weight,
        prepared.n_users, prepared.n_items, items_offset=True, device="cpu",
    )
    split = split_graph(graph_host)
    deg = np.bincount(split.ui_src_user, minlength=prepared.n_users)
    head_share = np.sort(deg)[::-1][:HEAVY_USERS].sum() / len(split.ui_src_user)
    phase(
        2, "data", t0,
        f"users {prepared.n_users} items {prepared.n_items} train edges {len(prepared.edge_user)} "
        f"head share {head_share:.4f} buyers {len(prepared.sampler.users)} "
        f"val users {len(prepared.val.user_ids)} test users {len(prepared.test.user_ids)}",
    )
    assert len(prepared.edge_user) == N_EDGES_TRAIN

    cfg = LightGCNConfig(prepared.n_users + prepared.n_items, DIM, LAYERS)
    params = init_params(torch.Generator().manual_seed(args.seed), cfg, device=dev)
    path_launches = {}
    with torch.no_grad():
        t0 = time.perf_counter()
        # The probes' kernels first: torch.profiler has returned no kernel
        # for pass_times after the profiled phases 4-8 of a run.
        probe_rows = probe_kernel_rows(dev, args.seed)
        E_u = params["embedding"][: prepared.n_users]
        full_plan = build_segreduce_plan(
            split.ui_src_user, split.ui_dst_item, split.ui_w, split.n_items, device=dev
        )
        rows = [check_kernel("segreduce_f32", E_u, full_plan)]
        del full_plan
        check_kernel_cases(dev, args.seed)
        check_accumulate_cases(dev, args.seed)
        _, w_hi, t_src, t_dst, t_w, *_ = split_heavy_users(split, HEAVY_USERS, "bfloat16", device=dev)
        del w_hi
        tail_plan = build_segreduce_plan(t_src, t_dst, t_w, split.n_items, device=dev)
        # The main path's bf16 table: gather_segreduce's cast into 16-byte rows.
        rows.append(check_cast(E_u))
        E_u16 = bf16_rows(E_u)
        rows.append(check_kernel("segreduce_bf16", E_u16, tail_plan))
        rows[-1]["bucketed"] = {
            str(nb): check_bucketed("main configuration", E_u16, tail_plan, (t_src, t_dst, t_w),
                                    split.n_users, nb)
            for nb in BUCKET_COUNTS
        }
        msgs = tail_messages(E_u16, tail_plan)
        rows.append(check_stream_sum(msgs))
        del tail_plan, E_u, E_u16, msgs
        torch.cuda.empty_cache()
        phase(3, "kernel", t0)

        # Serving path (phases 4-6): every launch count starts at 0 here.
        reset_launches()
        t0 = time.perf_counter()
        svc = RecommenderService(prepared, params, cfg, k=20, device=dev)
        f32_launches = SEGREDUCE.launches["float32"]
        assert f32_launches >= 1, "the service did not propagate through the kernel"
        fb = svc.fast_bipartite
        emb = svc.final_emb
        graph_dev = build_graph(
            prepared.edge_user, prepared.edge_item_node, prepared.edge_weight,
            prepared.n_users, prepared.n_items, items_offset=True, device=dev,
        )
        ref = get_embedding(params, graph_dev, cfg)
        del graph_dev
        scale = ref.abs().max().item()
        fwd_err = (emb - ref).abs().max().item()
        torch.testing.assert_close(emb, ref, rtol=1e-4, atol=1e-5 * scale)
        del ref
        fwd_ms = time_ms(
            lambda: fast_get_embedding(params, fb, LAYERS, alpha=cfg.alphas()), reps=5, warmup=1
        )
        device_profile(
            "f32 forward", lambda: fast_get_embedding(params, fb, LAYERS, alpha=cfg.alphas())
        )
        phase(
            4, "forward", t0,
            f"B_ii {fb.build_seconds['item_op']:.2f} s plans {fb.build_seconds['plans']:.2f} s "
            f"refresh {svc.last_refresh_s:.2f} s forward_ms {fwd_ms:.3f} "
            f"max_abs_err {fwd_err:.3e} (max |ref| {scale:.3e}) f32 launches {f32_launches}",
        )

        t0 = time.perf_counter()
        fb16 = build_fast_bipartite(
            graph_host, dtype=torch.bfloat16, fast_ops=True, msgs_dtype="bfloat16",
            heavy_users=HEAVY_USERS, heavy_dtype="bfloat16", device=dev,
        )
        emb16 = fast_get_embedding(params, fb16, LAYERS, alpha=cfg.alphas())
        assert torch.isfinite(emb16).all()
        rel16 = ((emb16.float() - emb).norm() / emb.norm()).item()
        assert rel16 <= BF16_FORWARD_REL, rel16
        fwd16_ms = time_ms(
            lambda: fast_get_embedding(params, fb16, LAYERS, alpha=cfg.alphas()), reps=5, warmup=1
        )
        device_profile(
            "bf16 forward", lambda: fast_get_embedding(params, fb16, LAYERS, alpha=cfg.alphas())
        )
        phase(
            5, "bf16", t0,
            f"B_ii {fb16.build_seconds['item_op']:.2f} s plans {fb16.build_seconds['plans']:.2f} s "
            f"forward_ms {fwd16_ms:.3f} rel_frobenius_vs_f32 {rel16:.3e}",
        )

    t0 = time.perf_counter()
    lat, answers = serve_requests(svc, prepared, np.random.default_rng(args.seed + 1))
    path_launches["serve"] = read_launches()
    with torch.no_grad():
        for ids, items in answers:
            assert len(items) == len(ids) and all(len(r) == 20 for r in items)
            check_answer(items, *plain_topk(emb, ids, prepared, 20))
    f32_pct = percentiles(lat)
    phase(
        6, "serve", t0,
        f"refresh {svc.last_refresh_s:.2f} s; {REQUESTS_PER_SIZE} timed requests per size, "
        f"{len(answers)} answers checked; p50/p90/p99 ms {f32_pct}",
    )
    del answers

    # The quantized serving path on the same operators: counts from 0.
    t0 = time.perf_counter()
    reset_launches()
    detail = quantized_path(prepared, params, svc, args.seed, f32_pct)
    path_launches["quantized"] = read_launches()
    torch.cuda.empty_cache()
    phase(13, "quantized", t0, detail)

    # The multi-device forward and sharded eval on phase 4/5's operators:
    # counts from 0 here, in this process and in every rank.
    t0 = time.perf_counter()
    detail, path_launches["mesh"], mesh_ranks = mesh_path(
        split, cfg, params, svc.fast_bipartite, fb16, emb, emb16.float(), prepared, dev
    )
    del emb, emb16
    torch.cuda.empty_cache()
    phase(14, "mesh", t0, detail)

    # The multi-device train steps on the same operators: counts from 0
    # here, in this process and in every rank.
    t0 = time.perf_counter()
    detail, path_launches["mesh_train"], train_ranks, train_world1_k1 = mesh_train_path(
        split, cfg, params, svc.fast_bipartite, fb16, prepared, args.seed, dev
    )
    torch.cuda.empty_cache()
    phase(15, "mesh_train", t0, detail)

    # Gradient path: the exact fast batched loss and the full fast forward's
    # loss against the layered loss, on one fixed batch.
    t0 = time.perf_counter()
    reset_launches()
    users, pos, neg = fixed_batch(prepared, args.seed + 2, dev)
    leaf = {"embedding": params["embedding"].detach().requires_grad_()}

    def grad_of(loss_fn, graph):
        loss, (_, _, dropped) = loss_fn(leaf, graph, users, pos, neg)
        assert int(dropped) == 0
        return torch.autograd.grad(loss, leaf["embedding"])[0]

    graph_dev = build_graph(
        prepared.edge_user, prepared.edge_item_node, prepared.edge_weight,
        prepared.n_users, prepared.n_items, items_offset=True, device=dev,
    )
    g_layered = grad_of(make_loss_fn(cfg, DECAY), graph_dev)
    ref = layered_grad_f64(params, graph_dev, cfg, users, pos, neg)
    del graph_dev
    g_batch = grad_of(
        make_loss_fn(
            cfg, DECAY,
            batch_embed_fn=lambda p, fb_, u, po, ne: fast_batch_embeddings(
                p, fb_, LAYERS, u, po, ne, edge_cap=EDGE_CAP
            ),
        ),
        fb,
    )
    full_loss = make_loss_fn(cfg, DECAY, embed_fn=lambda p, fb_: fast_get_embedding(p, fb_, LAYERS))
    loss, _ = full_loss(leaf, fb, users, pos, neg)
    fwd_launches = SEGREDUCE.launches["float32"]
    g_full = torch.autograd.grad(loss, leaf["embedding"])[0]
    bwd_launches = SEGREDUCE.launches["float32"] - fwd_launches
    assert bwd_launches >= 1, "fast_to_users' backward did not launch the segment reduce"
    scale = ref.abs().max().item()
    errs, margins = {}, {}
    for name, g in (("batch", g_batch), ("full", g_full), ("layered_f32", g_layered)):
        diff = (g.double() - ref).abs()
        errs[name] = diff.max().item()
        # Largest error as a share of what the check allows (< 1 passes).
        margins[name] = (diff / (1e-5 * scale + 1e-4 * ref.abs())).max().item()
        del diff
    for g in (g_batch, g_full):
        torch.testing.assert_close(g.double(), ref, rtol=1e-4, atol=1e-5 * scale)
    path_launches["grad"] = read_launches()
    phase(
        7, "grad", t0,
        f"max |ref grad| {scale:.3e} (layered, f64); max abs err / check margin: batched "
        f"{errs['batch']:.3e} / {margins['batch']:.3f}, full {errs['full']:.3e} / "
        f"{margins['full']:.3f}, layered f32 {errs['layered_f32']:.3e} / "
        f"{margins['layered_f32']:.3f} (not checked); K1 f32 launches forward "
        f"{fwd_launches} backward {bwd_launches}",
    )
    del leaf, ref, g_batch, g_full, g_layered, loss, svc, fb
    torch.cuda.empty_cache()

    # Step breakdown (the port of scripts/profile_step.py) on the main
    # configuration's operators.
    t0 = time.perf_counter()
    reset_launches()
    with torch.no_grad():
        E_u = params["embedding"][: prepared.n_users]
        x_items = params["embedding"][prepared.n_users :].float()
        plan = fb16.fops.items_plan
        E_u16 = bf16_rows(E_u)
        msgs = tail_messages(E_u16, plan)
        both = torch.cat([x_items, x_items], 1).to(torch.bfloat16)
        parts = {
            "fast_to_items": time_ms(lambda: fast_to_items(E_u, fb16.fops)),
            "fast_to_users": time_ms(lambda: fast_to_users(x_items, fb16.fops)),
            "B_ii_pair_matmul": time_ms(lambda: mm_f32(fb16.item_op, both), reps=10),
            "K1_segreduce_bf16": time_ms(lambda: SEGREDUCE(E_u16, plan)),
            "K3_stream_sum_bf16": time_ms(lambda: stream_sum(msgs)),
        }
        device_profile("fast_to_users", lambda: fast_to_users(x_items, fb16.fops))
        del msgs, both, E_u16
        val_buckets = build_eval_buckets(prepared.val, width_floor=256, device=dev)
        emb0 = fast_get_embedding(params, fb16, LAYERS)
        untrained_p, untrained_r = evaluate_bucketed(emb0, val_buckets, prepared.n_users, 20)
        pop = torch.from_numpy(
            np.bincount(prepared.edge_item_node - prepared.n_users, minlength=prepared.n_items)
        ).float().to(dev)
        pop_emb = torch.cat([torch.ones(prepared.n_users, 1, device=dev), pop[:, None]])
        pop_p, pop_r = evaluate_bucketed(pop_emb, val_buckets, prepared.n_users, 20)
        del emb0, pop_emb
    step_params = {"embedding": params["embedding"].clone()}
    adam = Adam(LR)
    step_state = adam.init(step_params)
    sdata = make_sampler_data(prepared.sampler, prepared.n_users, prepared.n_items, dev)
    train_step, _ = make_train_fns(
        cfg, adam, BATCH, DECAY,
        batch_embed_fn=lambda p, fb_, u, po, ne: fast_batch_embeddings(
            p, fb_, LAYERS, u, po, ne, edge_cap=EDGE_CAP
        ),
    )
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    one_step = lambda: train_step(step_params, step_state, fb16, sdata, gen)
    parts["train_step"] = time_ms(one_step, reps=10)
    device_profile("train step", one_step, top=10)
    path_launches["breakdown"] = read_launches()
    print(
        "  step breakdown ms: " + " ".join(f"{k} {v:.4f}" for k, v in parts.items())
        + f"; K3/K1 {parts['K3_stream_sum_bf16'] / parts['K1_segreduce_bf16']:.3f}",
        flush=True,
    )
    phase(
        8, "breakdown", t0,
        f"val R@20 untrained {untrained_r:.6f} popularity {pop_r:.6f} "
        f"(P@20 {untrained_p:.6f} / {pop_p:.6f})",
    )
    del fb16, step_params, step_state, sdata, train_step, x_items, E_u
    torch.cuda.empty_cache()

    # Training path: train() and a resume, as a user runs them.
    t0 = time.perf_counter()
    reset_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt:
        config = TrainConfig(
            latent_dim=DIM, n_layers=LAYERS, batch_size=BATCH, lr=LR, decay=DECAY,
            fast_bipartite="bf16", heavy_users=HEAVY_USERS, epochs=2,
            checkpoint_dir=ckpt, async_saves=True, seed=args.seed,
        )
        result = train(prepared, config, device=dev)
        hist = result.history
        assert all(np.isfinite(h["loss"]) for h in hist), hist
        assert hist[1]["loss"] < hist[0]["loss"], "loss did not fall between the epochs"
        assert all(h["dropped_arcs"] == 0.0 for h in hist)
        assert result.best_val_recall > untrained_r, (result.best_val_recall, untrained_r)
        for name in (BEST_NAME, LAST_NAME):
            leaves, meta = load_checkpoint(ckpt, name)
            assert meta["num_leaves"] == 4 and leaves[0].shape == (cfg.num_nodes, DIM), meta
        # The resume writes back to back (duty 1.0); the first run idled a
        # write's time after each (the default 0.5).
        resumed = train(
            prepared, dataclasses.replace(config, epochs=3, resume=True, async_save_duty=1.0), device=dev
        )
        assert [h["epoch"] for h in resumed.history] == [2], resumed.history
        with open(f"{ckpt}/train_log.jsonl") as f:
            log = [json.loads(line) for line in f]
    path_launches["train"] = read_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_band_") as work:
        banded = writer_bytes_check(resumed.params, work)
    flushes = [r for r in log if "flush_s" in r]
    assert len(flushes) == 2, flushes
    for duty, rec, run in zip((config.async_save_duty, 1.0), flushes, (hist, resumed.history)):
        print(
            f"  writer at duty {duty}: save_s {' '.join(f'{h['save_s']:.3f}' for h in run if 'save_s' in h)} "
            f"busy {rec['writer_busy_s']:.3f} s idle {rec['writer_idle_s']:.3f} s bytes "
            f"{rec['writer_bytes']} written {rec['written']} snapshot copies {rec['snapshot_copies']} "
            f"final flush {rec['flush_s']:.3f} s",
            flush=True,
        )
    builds = [r["item_op_s"] for r in log if "item_op_s" in r]
    n_batch = N_EDGES_TRAIN // (BATCH * 40)
    for h in hist + resumed.history:
        print(
            f"  epoch {h['epoch']}: loss {h['loss']:.6f} bpr {h['bpr_loss']:.6f} "
            f"reg {h['reg_loss']:.6f} step_ms {h['train_s'] / n_batch * 1e3:.3f} "
            f"train_s {h['train_s']:.3f} eval_s {h['eval_s']:.3f} epoch_s {h['epoch_s']:.3f} "
            f"save_s {h.get('save_s', float('nan')):.3f} val R@20 {h['val_recall']:.6f}",
            flush=True,
        )
    phase(
        9, "train", t0,
        f"B_ii builds {' '.join(f'{b:.2f}' for b in builds)} s; best val R@20 "
        f"{result.best_val_recall:.6f} (untrained {untrained_r:.6f}, popularity {pop_r:.6f}) "
        f"test R@20 {result.test_recall:.6f}; resumed test R@20 {resumed.test_recall:.6f}; {banded}",
    )

    # Probes (the ports of the gather and segment-reduce probe scripts):
    # every count from 0 and each probe's main as a user runs it (K2, K4,
    # K5 and K6 were held against their plain versions in phase 3).
    t0 = time.perf_counter()
    del result, resumed
    torch.cuda.empty_cache()
    rows += probe_rows
    reset_launches()
    probe_results = run_probe_mains(dev)
    to_users = sum(
        probe_results["proto_segreduce"]["launches"][s].get("tile_segreduce.bfloat16", 0)
        for s in TO_USERS_SECTIONS
    )
    path_launches["probes"] = read_launches(to_users)
    phase(10, "probes", t0)

    # The entry points from an event log, as a user runs them.
    t0 = time.perf_counter()
    reset_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as work:
        detail = cli_path(work)
        path_launches["cli"] = read_launches()
        mesh_cli_detail = mesh_cli_path(work)
        eda_detail = eda_path(work)
        cli_rows = check_cli_kernels(work, dev)
        reset_launches()
        infer_detail = infer_path(work, dev)
        path_launches["infer"] = read_launches()
        torch.cuda.empty_cache()
        reset_launches()
        svd_detail = svd_path(work, dev, args.seed)
        path_launches["svd"] = read_launches()
    assert path_launches["cli"]["segreduce_bf16"] >= 1, "cli.train did not launch K1 bf16"
    for row in rows:
        if row["name"] in cli_rows:  # the same kernel held at the cli path's shapes
            row["cli"] = {key: cli_rows[row["name"]][key] for key in CLI_ROW_KEYS}
        mode = {"segreduce_f32": "f32", "segreduce_bf16": "bf16"}.get(row["name"])
        if mode:  # the same kernel held at each mesh rank's shapes
            for key, ranks in (("mesh", mesh_ranks), ("mesh_train", train_ranks)):
                held = [r for r in ranks if f"{mode}_to_items" in r["k1"]]  # gloo GSPMD: bf16 only
                if held:
                    row[key] = [
                        {"rank": r["rank"], **{d: r["k1"][f"{mode}_{d}"] for d in ("to_items", "to_users")}}
                        for r in held
                    ]
            row["mesh_train_world1"] = {d: train_world1_k1[f"{mode}_{d}"] for d in ("to_items", "to_users")}
        if row["name"] == "segreduce_cast_bf16":  # at each GSPMD rank's user table
            row["mesh_train"] = [{"rank": r["rank"], **r["cast"]} for r in train_ranks]
    k1_cli = cli_rows["segreduce_bf16"]
    phase(
        12, "cli", t0,
        f"{detail}; at these shapes K1 bf16 max_abs_err {k1_cli['max_abs_err']:.3e} kernel_ms "
        f"{k1_cli['ms']:.4f} plain_ms {k1_cli['plain_ms']:.4f}, its cast exact; {mesh_cli_detail}; "
        f"{eda_detail}; "
        f"{infer_detail}; {svd_detail}",
    )

    # The benchmark entry point at root bench.py's shapes, in its own
    # process (its launches counted there from 0), then K1 bf16 and its
    # cast at its shapes, outside the counts.
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    line, path_launches["bench"] = bench_path(kind)
    t_bench = time.perf_counter() - t0
    bench_rows = check_bench_kernels(dev)
    for row in rows:
        if row["name"] in bench_rows:
            row["bench"] = {key: bench_rows[row["name"]][key] for key in CLI_ROW_KEYS}
            if "bucketed" in bench_rows[row["name"]]:
                row["bench"]["bucketed"] = bench_rows[row["name"]]["bucketed"]
    d = line["detail"]
    rl = d["roofline"]
    phase(
        16, "bench", t0,
        f"process {t_bench:.1f} s; value {line['value']:.6e} edges/s vs_baseline "
        f"{line['vs_baseline']:.4f}; fast path {d['fast_path']} (forward ms {d['forward_ms']}); "
        f"layered_forward_ms {d['layered_forward_ms']:.3f} train_step_ms {d['train_step_ms']:.3f} "
        f"eval_s {d['eval_s']:.3f} b_ii_build_s {d['b_ii_build_s']:.2f} R@20 "
        f"{d['heldout_recall_at_20']:.5f} projected_train_hours {d['projected_train_hours']:.4f}; "
        f"forward {rl['forward']['pct_of_floor']:.1f}% of floor, train step "
        f"{rl['train_step']['pct_of_floor']:.1f}%; launches "
        f"{ {k: v for k, v in path_launches['bench'].items() if v} }; at these shapes K1 bf16 "
        f"max_abs_err {bench_rows['segreduce_bf16']['max_abs_err']:.3e} kernel_ms "
        f"{bench_rows['segreduce_bf16']['ms']:.4f}, its cast exact",
    )

    t0 = time.perf_counter()
    names = (*KERNELS, TO_USERS, *(f"{name}_accumulate" for name in ACCUMULATE))
    totals = {name: sum(counts[name] for counts in path_launches.values()) for name in names}
    for row in rows:
        row["launches"] = totals[row["name"]]
        row["launches_by_path"] = {p: counts[row["name"]] for p, counts in path_launches.items()}
        if row["name"] in ACCUMULATE:  # of those, the accumulate mode's
            acc = f"{row['name']}_accumulate"
            row["accumulate_launches"] = totals[acc]
            row["accumulate_launches_by_path"] = {p: counts[acc] for p, counts in path_launches.items()}
        assert row["launches"] >= 1, f"{row['name']} was not launched on the main path"
    assert path_launches["train"]["segreduce_bf16"] >= 1
    print(json.dumps({"kernels": rows}), flush=True)
    phase(11, "kernels", t0, f"launches by path {path_launches}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
