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
import hashlib
import json
import os
import sys
import time

import numpy as np

from gnn_ecommerce_tpu_torch.data.artifacts import load_prepared
from gnn_ecommerce_tpu_torch.eval.baselines import popularity_recall_at_k

d = sys.argv[1]
names = list(json.load(open(os.path.join(d, "manifest.json")))["arrays"])
total, per = hashlib.sha256(), {}
with np.load(os.path.join(d, "prepared.npz")) as z:
    for name in names:
        a = np.ascontiguousarray(z[name])
        digest = hashlib.sha256(a.tobytes()).hexdigest()
        per[name] = [str(a.dtype), list(a.shape), digest[:16]]
        total.update(digest.encode())
print("artifact_sha256", json.dumps({"sha256": total.hexdigest(), "arrays": per}))
p = load_prepared(d)
t = time.perf_counter()
print(
    "popularity_recall_at_20 val", popularity_recall_at_k(p, k=20),
    "test", popularity_recall_at_k(p, p.test, k=20), "s", time.perf_counter() - t,
)
PY
}

if [ "${1:-}" = "--hash" ]; then
  hash_artifact "$2"
  exit 0
fi
OUT=$(mkdir -p "${1:-$REPO/quality_run_out}" && cd "${1:-$REPO/quality_run_out}" && pwd)
WORK=$(mktemp -d)
trap 'rm -rf "$WORK"' EXIT
cd "$WORK"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c "import sys, numpy, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda, numpy.__version__)"
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
