"""The quality bars: each quality run's numbers held to the TPU's.

The TPU's numbers are those of the JAX scripts' result files, on the same
corpora (each built bit for bit as the JAX package builds it):

| Run | Bar |
|---|---|
| ``movielens_bench`` (config 2) | LightGCN val / test R@20 within 0.02 of 0.18901 / 0.18383 (``MOVIELENS_r4.json``) and above the SVD ranker's; the SVD's 5-fold CV P/R@10 within 0.02 of 0.6515 / 0.7035 |
| ``config3_subsample_r3`` | best val R@20 within 0.01 of 0.35254 and at least 3x popularity; popularity 0.06656 to 1e-5 |
| ``svd_full_r5`` | surprise-parity val / test P/R@10 within 0.01 of ``SVD_FULL_r5.json``'s; full-ranking val R@20 below popularity (0.03443) |
| ``bprmf_full_r5`` | best val R@20 within 0.01 of 0.00908 |
| ``skyline_full_r3`` | within 1e-3 of 0.17829 |
| ``train_full_r5b`` (any seed) | best val / test R@20 within 0.01 of 0.324422 / 0.318471 |
| mesh, world of 1 | best val R@20 within 0.01 of each one-device run beside it |
| ``real_data_rehearsal`` | 20 items in the REST answer; on the TPU's run (1,000,000 fabricated rows, dim 32, 3 layers, 5 epochs) the file's counts exactly (1,000,000 rows in 5 files, 43,921 users x 2,500 items, 238,048 unique edges) and best val R@20 within 0.02 of 0.43598 |
| ``heavy_k_sweep_r3``, ``depth_dim_sweep_r3`` | every output held to its reference (each record's ``check``) and every time finite; no time bar (the TPU's times are not the card's) |

Each run's ``main`` holds its line with :func:`hold` before it prints it:
a missed bar raises :class:`BarMissed` (the line goes to stderr, no JSON
line is printed). The bars are the full-scale runs': a run cut in epochs
or corpus is held by its caller instead.
"""
from __future__ import annotations

import dataclasses
import json
import math

from . import _load

TPU = {
    "movielens_lightgcn_val": 0.18900739562210686,
    "movielens_lightgcn_test": 0.1838252481021401,
    "movielens_svd_cv_precision": 0.6515059322472141,
    "movielens_svd_cv_recall": 0.7034764180827613,
    "config3_best_val": 0.35254,
    "config3_popularity": 0.06656,
    "svd_parity_val_precision": 0.04707607994842037,
    "svd_parity_val_recall": 0.0479110251450677,
    "svd_parity_test_precision": 0.047825295249986986,
    "svd_parity_test_recall": 0.04830003641850061,
    "full_corpus_popularity": 0.03443,
    "bprmf_best_val": 0.009084461665454697,
    "skyline": 0.17829,
    "train_full_best_val": 0.32442182846871753,
    "train_full_test": 0.3184713523890762,
    # scripts/real_data_rehearsal.json
    "rehearsal_rows": 1_000_000,
    "rehearsal_files": 5,
    "rehearsal_users": 43_921,
    "rehearsal_items": 2_500,
    "rehearsal_edges": 238_048,
    "rehearsal_best_val": 0.43597867774466675,
}
# The TPU's rehearsal: fabricated rows and cli.train's (dim, layers, epochs).
REHEARSAL_RUN = {"rows": 1_000_000, "train": (32, 3, 5)}
REHEARSAL_ITEMS = 20


class BarMissed(AssertionError):
    """A quality run missed one of its bars."""


@dataclasses.dataclass(frozen=True)
class Bar:
    """``lo <= value <= hi``; ``ref`` the number the bar is centred on
    (the TPU's, or a one-device run's), where it is."""

    what: str
    value: float
    lo: float = -math.inf
    hi: float = math.inf
    ref: float | None = None

    @property
    def held(self) -> bool:
        return self.lo <= self.value <= self.hi

    def record(self) -> dict:
        """The bar as JSON: an open end (infinite) is null."""
        end = lambda x: x if math.isfinite(x) else None
        return {"what": self.what, "value": self.value, "lo": end(self.lo), "hi": end(self.hi),
                "ref": self.ref, "held": self.held}


def exactly(what: str, value: float, ref: float) -> Bar:
    return Bar(what, value, ref, ref, ref)


def finite(what: str, value: float) -> Bar:
    """1 where ``value`` is finite, else 0: held at 1."""
    return Bar(f"{what} finite", float(math.isfinite(value)), lo=1.0)


def near(what: str, value: float, ref: float, tol: float) -> Bar:
    return Bar(what, value, ref - tol, ref + tol, ref)


def movielens_bench(line: dict) -> list[Bar]:
    lg, svd = line["same_split_top20"]["lightgcn"], line["same_split_top20"]["svd_ranker"]
    cv = line["svd_cv_reference_protocol"]
    return [
        near("LightGCN val R@20", lg["val"]["recall"], TPU["movielens_lightgcn_val"], 0.02),
        near("LightGCN test R@20", lg["test"]["recall"], TPU["movielens_lightgcn_test"], 0.02),
        Bar("LightGCN val R@20 above the SVD ranker's", lg["val"]["recall"],
            lo=math.nextafter(svd["val"]["recall"], math.inf)),
        Bar("LightGCN test R@20 above the SVD ranker's", lg["test"]["recall"],
            lo=math.nextafter(svd["test"]["recall"], math.inf)),
        near("SVD 5-fold CV P@10", cv["precision_mean"], TPU["movielens_svd_cv_precision"], 0.02),
        near("SVD 5-fold CV R@10", cv["recall_mean"], TPU["movielens_svd_cv_recall"], 0.02),
    ]


def config3_subsample_r3(line: dict) -> list[Bar]:
    pop = line["popularity_baseline_val_recall_at_20"]
    return [
        near("best val R@20", line["best_val_recall_at_20"], TPU["config3_best_val"], 0.01),
        Bar("best val R@20 at least 3x popularity", line["best_val_recall_at_20"], lo=3 * pop),
        near("popularity val R@20", pop, TPU["config3_popularity"], 1e-5),
    ]


def svd_full_r5(line: dict) -> list[Bar]:
    par = line["surprise_parity"]
    return [
        *(near(f"parity {s} {m}@10", par[s][f"{m}@10"], TPU[f"svd_parity_{s}_{m}"], 0.01)
          for s in ("val", "test") for m in ("precision", "recall")),
        Bar("full-ranking val R@20 below popularity", line["full_ranking"]["val"]["recall@20"],
            hi=math.nextafter(TPU["full_corpus_popularity"], -math.inf)),
    ]


def bprmf_full_r5(line: dict) -> list[Bar]:
    return [near("best val R@20", line["quality"]["best_val_recall@20"], TPU["bprmf_best_val"], 0.01)]


def skyline_full_r3(line: dict) -> list[Bar]:
    return [near("val R@20", line["value"], TPU["skyline"], 1e-3)]


def train_full_r5b(line: dict) -> list[Bar]:
    q = line["quality"]
    return [
        near("best val R@20", q["best_val_recall"], TPU["train_full_best_val"], 0.01),
        near("test R@20", q["test_recall"], TPU["train_full_test"], 0.01),
    ]


def mesh_world_one(log_path: str, one_device: list[dict]) -> list[Bar]:
    """The best val R@20 of a ``cli.train`` log (``train_log.jsonl``)
    within 0.01 of each one-device ``train_full_r5b`` line's."""
    with open(log_path) as f:
        best = max(r["val_recall"] for r in map(json.loads, f) if "val_recall" in r)
    return [near(f"mesh best val R@20 against seed {d['seed']} on one device", best,
                 d["quality"]["best_val_recall"], 0.01) for d in one_device]


def real_data_rehearsal(line: dict) -> list[Bar]:
    t = line["train"]
    out = [exactly("items in the REST answer", line["serve"]["n_items"], REHEARSAL_ITEMS)]
    tpu_run = ("fabricate" in line and line["rows_requested"] == REHEARSAL_RUN["rows"]
               and (t["dim"], t["layers"], t["epochs"]) == REHEARSAL_RUN["train"])
    if tpu_run:
        out += [
            exactly("rows", line["concat"]["rows"], TPU["rehearsal_rows"]),
            exactly("monthly files", line["concat"]["files"], TPU["rehearsal_files"]),
            exactly("users", line["eda"]["n_users"], TPU["rehearsal_users"]),
            exactly("items", line["eda"]["n_items"], TPU["rehearsal_items"]),
            exactly("unique edges", line["preprocess"]["unique_edges"], TPU["rehearsal_edges"]),
            near("best val R@20", t["val_recall"], TPU["rehearsal_best_val"], 0.02),
        ]
    return out


# The numbers of a sweep's record that must be finite.
SWEEP_NUMBERS = ("ms", "to_items_ms", "to_users_ms", "pair_ms", "plan_build_s", "head_gb_bf16")


def sweep_records(line: dict, groups: tuple) -> list[Bar]:
    """Each output of each record held (its ``check``) and its numbers finite."""
    out = []
    for group in groups:
        for rec in line[group]:
            name = f"{group} " + " ".join(f"{k} {rec[k]}" for k in ("K", "layers", "dim") if k in rec)
            out += [Bar(f"{name}: {what} held", float(c["held"]), lo=1.0)
                    for what, c in rec.get("check", {}).items()]
            out += [finite(f"{name}: {k}", rec[k]) for k in SWEEP_NUMBERS if k in rec]
    return out


def heavy_k_sweep_r3(line: dict) -> list[Bar]:
    return sweep_records(line, ("results",))


def depth_dim_sweep_r3(line: dict) -> list[Bar]:
    return sweep_records(line, ("layered", "fast"))


BARS = {
    "movielens_bench": movielens_bench,
    "config3_subsample_r3": config3_subsample_r3,
    "svd_full_r5": svd_full_r5,
    "bprmf_full_r5": bprmf_full_r5,
    "skyline_full_r3": skyline_full_r3,
    "train_full_r5b": train_full_r5b,
    "real_data_rehearsal": real_data_rehearsal,
    "heavy_k_sweep_r3": heavy_k_sweep_r3,
    "depth_dim_sweep_r3": depth_dim_sweep_r3,
}


def hold(line: dict, bars: list[Bar]) -> dict:
    """``line`` with its ``bars`` records; raises :class:`BarMissed` (the
    line logged) if one is missed."""
    line = {**line, "bars": [b.record() for b in bars]}
    missed = [b.record() for b in bars if not b.held]
    if missed:
        _load.log(json.dumps(line))
        raise BarMissed(f"quality bars missed: {missed}")
    return line
