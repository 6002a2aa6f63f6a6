#!/usr/bin/env bash
# The port's full-scale quality run on one card: cli.train on the clustered
# corpus of scripts/full_corpus_r3.py (seed 42, 768 co-clusters, affinity
# 0.85, item skew 0.9) at the settings of scripts/train_full_r5b.py (dim 90,
# 5 layers, bf16 fast path, 16,384-user head, 20 epochs), in a temporary
# directory; then the saved artifact's hash and the popularity baseline;
# then cli.infer on the best checkpoint (P/R@20 over the val and test users,
# shortest paths of the first 2,000 hit users, as the TPU's INFER_r4.json
# was made); then the four serving runs of gnn_ecommerce_tpu_torch/runs/
# at the JAX scripts' protocols on the best checkpoint (serve_register_r5
# registers the last), each in its own process, each JSON line to
# OUT_DIR/<run>.json and its progress to OUT_DIR/<run>.err.
#
#   bash quality_run.sh [OUT_DIR]      # default OUT_DIR: quality_run_out/
#   bash quality_run.sh --hash DIR     # hash a prepared-artifact directory
#   bash quality_run.sh --triangle OUT_DIR
#   bash quality_run.sh --spread OUT_DIR
#   bash quality_run.sh --rehearsal OUT_DIR
#   bash quality_run.sh --sweeps OUT_DIR
#
# --triangle runs the quality runs of gnn_ecommerce_tpu_torch/runs/ at the
# JAX scripts' settings, each in its own process, each JSON line to
# OUT_DIR/<run>.json and its progress to OUT_DIR/<run>.err: movielens_bench
# (BASELINE config 2), config3_subsample_r3 (config 3), then full_corpus_r3
# saves the full corpus once (the artifact and its held-out edges), and
# svd_full_r5, bprmf_full_r5 and skyline_full_r3 run on it. --spread saves
# that corpus, trains train_full_r5b on it at seeds 1 and 2
# (OUT_DIR/train_full_r5b_seed<N>.json), then cli.train on the same corpus
# in an NCCL world of one rank with the fast edge partition (--distributed
# --mesh 1 --partition edge, 20 epochs: mesh_train.out and
# mesh_train_log.jsonl), holds its best val R@20 within 0.01 of each seed
# run's (OUT_DIR/mesh_bars.json) and hashes that run's artifact. Each run
# holds its line to its quality bars (gnn_ecommerce_tpu_torch/runs/bars.py)
# and fails, printing no line, where one is missed: a mode exits non-zero
# if any run failed.
#
# --rehearsal runs real_data_rehearsal at the script's size (1,000,000
# fabricated rows in five Kaggle-schema monthly CSVs, cli.train at dim 32,
# 3 layers, 5 epochs) in a temporary directory, held to the TPU file's
# counts exactly and its best val R@20 within 0.02; --sweeps runs
# heavy_k_sweep_r3 and depth_dim_sweep_r3 at root bench.py's shape, every
# output held to its reference. Each run in its own process, as above.
#
# The hash is a sha256 over each array of DIR/prepared.npz (in the order of
# DIR/manifest.json) and one over those digests, so that the port's
# artifact can be held against the JAX package's, made on any host with
#   python -c "import sys; sys.path[:0] = ['.', 'scripts']
#   from full_corpus_r3 import build_prepared
#   from gnn_ecommerce_tpu.data.artifacts import save_prepared
#   save_prepared(build_prepared()[0], 'jax_prepared')"
# OUT_DIR receives train.out (the CLI's output), train_log.jsonl, the
# artifact's manifest.json, infer.out, the path table hit_df.csv and the
# serving runs' serve_*.json and serve_*.err.
set -euo pipefail
REPO=$(cd "$(dirname "$0")" && pwd)
export PYTHONPATH="$REPO"

hash_artifact() {
  python - "$1" <<'PY'
import json
import sys
import time

from gnn_ecommerce_tpu_torch.data.artifacts import load_prepared
from gnn_ecommerce_tpu_torch.eval.baselines import popularity_recall_at_k
from gnn_ecommerce_tpu_torch.runs.full_corpus_r3 import artifact_sha256

d = sys.argv[1]
print("artifact_sha256", json.dumps(artifact_sha256(d)))
p = load_prepared(d)
t = time.perf_counter()
print(
    "popularity_recall_at_20 val", popularity_recall_at_k(p, k=20),
    "test", popularity_recall_at_k(p, p.test, k=20), "s", time.perf_counter() - t,
)
PY
}

# One quality run in its own process: its line to $OUT/$name.json, its
# progress to $OUT/$name.err; a failed run prints the end of its progress.
quality() {
  local name=$1 module=$2
  shift 2
  local t
  t=$(date +%s.%N)
  python -m "gnn_ecommerce_tpu_torch.runs.$module" "$@" --out "$OUT/$name.json" \
    2> "$OUT/$name.err" || { tail -n 40 "$OUT/$name.err"; return 1; }
  python -c "print('${name}_wall_s', $(date +%s.%N) - $t)"
}

card_and_versions() {
  nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
  python -c "import sys, numpy, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda, numpy.__version__)"
}

if [ "${1:-}" = "--hash" ]; then
  hash_artifact "$2"
  exit 0
fi
if [ "${1:-}" = "--rehearsal" ] || [ "${1:-}" = "--sweeps" ]; then
  OUT=$(mkdir -p "$2" && cd "$2" && pwd)
  WORK=$(mktemp -d)
  trap 'rm -rf "$WORK"' EXIT
  cd "$WORK"
  card_and_versions
  if [ "$1" = "--rehearsal" ]; then
    quality real_data_rehearsal real_data_rehearsal --rows 1000000 --work "$WORK/rehearsal"
    exit 0
  fi
  status=0
  quality heavy_k_sweep_r3 heavy_k_sweep_r3 || status=1
  quality depth_dim_sweep_r3 depth_dim_sweep_r3 || status=1
  exit $status
fi
if [ "${1:-}" = "--triangle" ] || [ "${1:-}" = "--spread" ]; then
  OUT=$(mkdir -p "$2" && cd "$2" && pwd)
  WORK=$(mktemp -d)
  trap 'rm -rf "$WORK"' EXIT
  cd "$WORK"
  card_and_versions
  if [ "$1" = "--triangle" ]; then
    # Every run is tried; the exit code says whether one failed.
    status=0
    quality movielens_bench movielens_bench --work "$WORK/movielens" || status=1
    quality config3_subsample_r3 config3_subsample_r3 --work "$WORK/config3" || status=1
    quality full_corpus_r3 full_corpus_r3 -o "$WORK/data" || exit 1
    quality svd_full_r5 svd_full_r5 -d "$WORK/data" || status=1
    quality bprmf_full_r5 bprmf_full_r5 -d "$WORK/data" --work "$WORK/bprmf" || status=1
    quality skyline_full_r3 skyline_full_r3 -d "$WORK/data" || status=1
    exit $status
  fi
  quality full_corpus_r3 full_corpus_r3 -o "$WORK/data"
  status=0
  for seed in 1 2; do
    quality "train_full_r5b_seed$seed" train_full_r5b -d "$WORK/data" --seed "$seed" \
      --work "$WORK/seed$seed" || status=1
    rm -rf "$WORK/seed$seed"
  done
  PORT=$(python -c "import socket; s = socket.socket(); s.bind(('localhost', 0)); print(s.getsockname()[1])")
  T=$(date +%s.%N)
  MASTER_ADDR=localhost MASTER_PORT=$PORT WORLD_SIZE=1 RANK=0 LOCAL_RANK=0 \
    python -m gnn_ecommerce_tpu_torch.cli.train --distributed --mesh 1 --partition edge --synthetic \
    --synthetic-users 1639358 --synthetic-items 54571 --synthetic-events 20692840 \
    --synthetic-pairs 10157407 --synthetic-clusters 768 --synthetic-affinity 0.85 \
    --synthetic-item-skew 0.9 -e 20 --dim 90 --layers 5 --fast bf16 --heavy-users 16384 \
    > "$OUT/mesh_train.out" 2>&1 || { tail -n 40 "$OUT/mesh_train.out"; exit 1; }
  python -c "print('mesh_train_wall_s', $(date +%s.%N) - $T)"
  tail -n 3 "$OUT/mesh_train.out"
  cp model-checkpoints/train_log.jsonl "$OUT/mesh_train_log.jsonl"
  hash_artifact data/prepared
  python - "$OUT" <<'PY' || status=1
import json
import sys

from gnn_ecommerce_tpu_torch.runs import bars

out = sys.argv[1]
seeds = []
for seed in (1, 2):
    try:
        with open(f"{out}/train_full_r5b_seed{seed}.json") as f:
            seeds.append(json.load(f))
    except FileNotFoundError:
        sys.exit(f"no one-device line at seed {seed} to hold the mesh run against")
line = bars.hold({}, bars.mesh_world_one(f"{out}/mesh_train_log.jsonl", seeds))
print(json.dumps(line))
with open(f"{out}/mesh_bars.json", "w") as f:
    f.write(json.dumps(line) + "\n")
PY
  exit $status
fi
OUT=$(mkdir -p "${1:-$REPO/quality_run_out}" && cd "${1:-$REPO/quality_run_out}" && pwd)
WORK=$(mktemp -d)
trap 'rm -rf "$WORK"' EXIT
cd "$WORK"
card_and_versions
T0=$(date +%s.%N)
python -m gnn_ecommerce_tpu_torch.cli.train --synthetic \
  --synthetic-users 1639358 --synthetic-items 54571 --synthetic-events 20692840 \
  --synthetic-pairs 10157407 --synthetic-clusters 768 --synthetic-affinity 0.85 \
  --synthetic-item-skew 0.9 -e 20 --dim 90 --layers 5 --fast bf16 --heavy-users 16384 \
  2>&1 | tee "$OUT/train.out"
T1=$(date +%s.%N)
python -c "print('wall_s', $T1 - $T0)"
cp model-checkpoints/train_log.jsonl data/prepared/manifest.json "$OUT/"
hash_artifact data/prepared
T2=$(date +%s.%N)
python -m gnn_ecommerce_tpu_torch.cli.infer -d data/prepared -c model-checkpoints -k 20 \
  --out recs --max-path-users 2000 2>&1 | tee "$OUT/infer.out"
T3=$(date +%s.%N)
python -c "print('infer_wall_s', $T3 - $T2)"
cp recs/hit_df.csv "$OUT/"
for run in serve_sustained_r3 serve_r4 serve_r5 serve_register_r5; do
  T=$(date +%s.%N)
  python -m gnn_ecommerce_tpu_torch.runs.$run -d data/prepared -c model-checkpoints \
    --out "$OUT/$run.json" 2> "$OUT/$run.err" || { tail -n 40 "$OUT/$run.err"; exit 1; }
  python -c "print('${run}_wall_s', $(date +%s.%N) - $T)"
done
