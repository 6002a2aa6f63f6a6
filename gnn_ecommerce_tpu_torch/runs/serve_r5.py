"""Port of ``scripts/serve_r5.py``: batching, the bypass and int8 under a
drift-controlled protocol (``SERVE_r5.json``).

Short slices (5 s), strictly interleaved A/B/A/B, ``reps`` (6) measured per
config after one discarded warm pair; each config's mean users/s with its
spread and stdev; an effect stands only if it exceeds twice the larger
stdev (``_load.interleaved_ab``). Four comparisons on five servers over two
live services, ``svc`` (f32) and ``svc_q`` (quantized):

- small requests (16 clients x 4 users): batched against unbatched;
- big requests (8 x 64): the batcher's ``solo_min`` bypass against forced
  coalescing (``solo_min=128``, ``max_users=512``);
- big requests: int8 against f32 (plain servers);
- small requests, batched: int8 against f32.

``int8_accuracy`` is the overlap of the int8 top-20 with the f32 top-20 on
4,096 users, through the two services. ``conclusions`` are written from
this run's numbers. Plus ``EXTRA_KEYS``: the card, the host, the answers
checked (every slice's, after the slice, against the plain top-K of the
service that served it: f32 or int8) and ``services``, the seconds and the
card's memory of the quantized service's build where this run builds it.

Each service builds its own f32 B_ii (``RecommenderService.__init__``), so
the two services hold two [I, I] f32 operators on the card.

    python -m gnn_ecommerce_tpu_torch.runs.serve_r5 -d DATA_DIR -c CKPT_DIR [--out x.json]
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..serve import BatchingRecommender, RecommenderService
from ..train.checkpoint import load_checkpoint
from . import _load
from ._cli import checkpoint_of, cli

SLICE_S = 5.0
REPS = 6  # interleaved slices per config
BIG_CLIENTS, BIG_BATCH = 8, 64
SMALL_CLIENTS, SMALL_BATCH = 16, 4
MAX_WAIT_S = 0.004
ACCURACY_USERS = 4096
EXTRA_KEYS = {"device", "host", "answers", "services"}


def int8_accuracy(svc, svc_q, users: int) -> dict:
    """Top-20 overlap of ``svc_q`` with ``svc`` on ``users`` random users
    (the script's draw: ``default_rng(7)``)."""
    ids = np.random.default_rng(7).integers(0, svc.prepared.n_users, users)
    t0 = time.perf_counter()
    top_f32 = svc.recommend(ids)
    top_i8 = svc_q.recommend(ids)
    overlap = np.array([len(set(a) & set(b)) / len(a) for a, b in zip(top_f32, top_i8)])
    return {
        "users": int(len(ids)),
        "top20_overlap_mean": round(float(overlap.mean()), 4),
        "top20_overlap_p10": round(float(np.percentile(overlap, 10)), 4),
        "top20_overlap_min": round(float(overlap.min()), 4),
        "seconds": round(time.perf_counter() - t0, 1),
    }


def _verdict(ab: dict, a: str, b: str) -> str:
    x, y = ab[a], ab[b]
    return (
        f"{a} {x['mean_users_per_s']} +/- {x['stdev_users_per_s']} vs {b} {y['mean_users_per_s']} "
        f"+/- {y['stdev_users_per_s']} users/s ({ab['effect_a_over_b']}x; p99 {x['p99_ms']} vs "
        f"{y['p99_ms']} ms): "
        + ("the effect exceeds 2x the across-slice stdev" if ab["effect_exceeds_spread"]
           else "within 2x the across-slice stdev, no conclusion")
    )


def conclusions(res: dict, slice_s: float, reps: int) -> dict:
    """The script's conclusions, written from this run's numbers."""
    acc = res["int8_accuracy"]
    return {
        "small_request_batching": _verdict(res["small_batched_vs_unbatched"], "batched", "unbatched"),
        "big_request_bypass": _verdict(res["big_bypass_vs_coalesce"], "bypass", "coalesce"),
        "int8_serving": (
            f"top-20 overlap with f32 mean {acc['top20_overlap_mean']}, p10 "
            f"{acc['top20_overlap_p10']}, min {acc['top20_overlap_min']} over {acc['users']} users; "
            f"big requests: {_verdict(res['big_int8_vs_f32'], 'int8', 'f32')}; small batched: "
            f"{_verdict(res['small_batched_int8_vs_f32'], 'int8', 'f32')}"
        ),
        "measurement_note": (
            f"{res['device']}; {res['host']['cpu_count']} CPUs, {res['host']['process']}; "
            f"{slice_s:g} s slices, {reps} measured per config after a discarded warm pair; every "
            f"answer held against its service's plain top-20 after its slice"
        ),
    }


def run(svc, svc_q, checkpoint: str, slice_s: float = SLICE_S, reps: int = REPS,
        big: tuple = (BIG_CLIENTS, BIG_BATCH), small: tuple = (SMALL_CLIENTS, SMALL_BATCH),
        services: dict | None = None) -> dict:
    """The script's four A/B comparisons on ``svc`` (f32) and ``svc_q``
    (quantized), both serving ``checkpoint``, with ``big`` and ``small``
    (clients, users) requests; ``services`` is what their build cost, where
    the caller measured it. Raises on a failed request or a wrong answer."""
    if svc.quantized or not svc_q.quantized:
        raise ValueError("serve_r5 needs an f32 service and a quantized one")
    n_users = svc.prepared.n_users
    results = {
        "benchmark": "serve_r5",
        "scale": f"{n_users}x{svc.prepared.n_items}, dim {svc.cfg.embedding_dim}",
        "checkpoint": checkpoint,
        "protocol": (
            f"interleaved A/B slices, {slice_s:g}s each, {reps} measured per config (first pair "
            "discarded as warmup); conclusions require effect > 2x the across-slice stdev"
        ),
        "int8_accuracy": int8_accuracy(svc, svc_q, ACCURACY_USERS),
    }
    _load.log(f"int8 accuracy: {results['int8_accuracy']}")
    check = _load.AnswerCheck(svc.k)
    ref_f32, ref_i8 = _load.Reference.of(svc), _load.Reference.of(svc_q)
    servers = {
        "f32": _load.Server(svc),
        "f32_batched": _load.Server(BatchingRecommender(svc, max_wait_s=MAX_WAIT_S)),
        "f32_coalesce": _load.Server(BatchingRecommender(
            svc, max_wait_s=MAX_WAIT_S, solo_min=big[1] * 2, max_users=512
        )),
        "int8": _load.Server(svc_q),
        "int8_batched": _load.Server(BatchingRecommender(svc_q, max_wait_s=MAX_WAIT_S)),
    }

    def ab(key, a, server_a, b, server_b, clients, batch):
        refs = {a: ref_i8 if server_a.startswith("int8") else ref_f32,
                b: ref_i8 if server_b.startswith("int8") else ref_f32}
        _load.log(f"A/B {key}: {a} vs {b}")
        results[key] = _load.interleaved_ab(
            ((a, servers[server_a].port), (b, servers[server_b].port)), n_users, clients, batch,
            lambda name, answers: check.check(answers, {name: refs[name]}), reps, slice_s,
        )

    try:
        ab("small_batched_vs_unbatched", "batched", "f32_batched", "unbatched", "f32", *small)
        ab("big_bypass_vs_coalesce", "bypass", "f32_batched", "coalesce", "f32_coalesce", *big)
        ab("big_int8_vs_f32", "int8", "int8", "f32", "f32", *big)
        ab("small_batched_int8_vs_f32", "int8", "int8_batched", "f32", "f32_batched", *small)
    finally:
        for s in servers.values():
            s.close()
    results.update({
        "device": _load.card(svc.device), "host": _load.host(), "answers": check.stats(),
        "services": services,
    })
    results["conclusions"] = conclusions(results, slice_s, reps)
    return results


def build_quantized(svc, checkpoint_dir: str, checkpoint_name: str) -> tuple:
    """A second, quantized service on the same artifact and checkpoint: its
    own f32 B_ii and int8 cache. Returns it and its build seconds and card
    memory (GB allocated by the build; "not measured" on the CPU)."""
    dev = svc.device
    before = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None
    t0 = time.perf_counter()
    leaves, meta = load_checkpoint(checkpoint_dir, checkpoint_name)
    params = RecommenderService._checkpoint_params(leaves, meta, svc.cfg, dev)
    svc_q = RecommenderService(svc.prepared, params, svc.cfg, k=svc.k, quantized=True, device=dev)
    seconds = time.perf_counter() - t0
    memory = ("not measured" if before is None
              else round((torch.cuda.memory_allocated(dev) - before) / 1e9, 3))
    return svc_q, {"quantized_build_s": round(seconds, 1), "quantized_device_gb": memory}


def _main(svc, load_s, args) -> dict:
    svc_q, services = build_quantized(svc, args.checkpoint_dir, args.checkpoint_name)
    _load.log(f"quantized service up: {services}")
    return run(svc, svc_q, checkpoint_of(args), services={"f32_load_s": round(load_s, 1), **services})


def main(argv=None) -> int:
    return cli(__doc__, argv, _main)


if __name__ == "__main__":
    sys.exit(main())
