"""The quality runs (``runs/svd_full_r5.py``, ``bprmf_full_r5.py``,
``skyline_full_r3.py``, ``movielens_bench.py``, ``config3_subsample_r3.py``)
on the CPU, against the JAX scripts' arithmetic at small sizes. The scripts
are loaded from ``scripts/`` unedited; their ``main`` writes into the repo
and is never called, except the skyline's with its corpus and its ``open``
replaced.

- SVD: on JAX's fit carried across (``convert.svd_params_to_torch``), the
  surprise-parity P/R@10 on the held-out edges, the full-ranking P/R@20
  with ``svd_full_r5``'s packing and the SVD ranker's P/R@20 with
  ``movielens_bench``'s packing equal JAX's on the same parameters
  (``REL`` relative).
- Skyline: each val user's Recall@20 equals the script's scipy loop
  (``skyline_scipy``, whose mean is the script's own ``main``'s value) on
  a corpus with continuous weights, where no user has a tie at the 20th
  score (``tied_users`` 0), and the line's value is the script's.
- BPR-MF: at 0 layers the port's embedding is the table, and JAX's
  ``get_embedding`` on the same parameters; ``bprmf_full_r5.run`` ends.
- MovieLens: the run writes the repo's fixture's bytes into ``--work``
  and leaves the repo's file untouched.
- Config 3: the corpus's popularity baseline equals JAX's on JAX's splits.
- Each line has its TPU file's keys plus the run's ``EXTRA_KEYS``
  (``BPRMF_FULL_r5.json``'s ``generous_budget_10x``, a second run that the
  script does not make, aside). These small runs would miss the full-scale
  quality bars, so their bars are replaced by none; ``svd_full_r5 -d``
  repeats the run that builds the corpus.
- Bars (``runs/bars.py``): the H100's full-scale numbers hold every bar,
  half of each misses one, a ``main`` that misses a bar raises and prints
  and writes no line, and the mesh run is held to the one-device runs.
"""
import dataclasses
import functools
import hashlib
import importlib
import importlib.util
import io
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_ecommerce_tpu.data import events_to_edges as jax_events_to_edges
from gnn_ecommerce_tpu.data import prepare_splits as jax_prepare_splits
from gnn_ecommerce_tpu.data import split_edges as jax_split_edges
from gnn_ecommerce_tpu.data import synthetic_events as jax_synthetic_events
from gnn_ecommerce_tpu.data.events import EVENT_TYPE_WEIGHTS_V1
from gnn_ecommerce_tpu.eval import build_eval_buckets as jax_build_eval_buckets
from gnn_ecommerce_tpu.eval import evaluate_bucketed as jax_evaluate_bucketed
from gnn_ecommerce_tpu.eval import build_eval_batch as jax_build_eval_batch
from gnn_ecommerce_tpu.eval.baselines import popularity_recall_at_k as jax_popularity
from gnn_ecommerce_tpu.eval.evaluate import evaluate as jax_evaluate
from gnn_ecommerce_tpu.graph.build import build_graph as jax_build_graph
from gnn_ecommerce_tpu.models import lightgcn as jax_lightgcn
from gnn_ecommerce_tpu.models import svd as jax_svd
from gnn_ecommerce_tpu_torch.cli.svd import run_cv
from gnn_ecommerce_tpu_torch.convert import svd_params_to_torch
from gnn_ecommerce_tpu_torch.data.events import Edges
from gnn_ecommerce_tpu_torch.data.prepare import prepare_splits, split_edges
from gnn_ecommerce_tpu_torch.eval.baselines import popularity_recall_at_k
from gnn_ecommerce_tpu_torch.graph.build import build_graph
from gnn_ecommerce_tpu_torch.models import lightgcn
from gnn_ecommerce_tpu_torch.models.svd import SVDConfig
from gnn_ecommerce_tpu_torch.runs import (
    bars,
    bprmf_full_r5,
    config3_subsample_r3,
    full_corpus_r3,
    movielens_bench,
    skyline_full_r3,
    svd_full_r5,
)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = ROOT / "scripts"
FIXTURE = ROOT / "data" / "ml100k_synth_u.data"
REL = 1e-6
SMALL = dict(N_USERS=3000, N_ITEMS=400, N_EVENTS=40000, N_PAIRS=15000,
             GEN_KWARGS=dict(seed=42, n_clusters=12, affinity=0.85, item_skew=0.9))
SMALL_CONFIG3 = dict(n_users=3000, n_items=300, n_events=30000, seed=42, n_pairs=12000,
                     n_clusters=10, affinity=0.85, item_skew=0.9)
# Keys of a TPU file that its script does not write.
NOT_WRITTEN = {"BPRMF_FULL_r5.json": {"generous_budget_10x"}}


def _script(name: str):
    spec = importlib.util.spec_from_file_location(f"_quality_script_{name}", SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tpu_keys(path: str) -> set:
    return set(json.loads((ROOT / path).read_text())) - NOT_WRITTEN.get(path, set())


@pytest.fixture()
def small_corpus(monkeypatch):
    for name, value in SMALL.items():
        monkeypatch.setattr(full_corpus_r3, name, value)


@pytest.fixture()
def no_bars(monkeypatch):
    """Each run's bars replaced by none (a small run misses the full-scale
    bars)."""
    for name in list(bars.BARS):
        monkeypatch.setitem(bars.BARS, name, lambda line: [])


@pytest.fixture(scope="module")
def svd_case():
    """JAX's prepared splits of the small corpus, the port's with its
    held-out edges, and JAX's SVD fitted on JAX's train split."""
    script = _script("full_corpus_r3")
    saved = {name: getattr(full_corpus_r3, name) for name in SMALL}
    for name, value in SMALL.items():
        setattr(script, name, value)
        setattr(full_corpus_r3, name, value)
    try:
        jax_prepared, _ = script.build_prepared()
        tr, va, te, _ = full_corpus_r3.build_splits()
    finally:
        for name, value in saved.items():
            setattr(full_corpus_r3, name, value)
    prepared = prepare_splits(tr, va, te)
    n_users = jax_prepared.n_users
    params = jax_svd.fit_svd(
        np.asarray(jax_prepared.edge_user, np.int64),
        np.asarray(jax_prepared.edge_item_node, np.int64) - n_users,
        np.asarray(jax_prepared.edge_weight, np.float32),
        n_users, jax_prepared.n_items,
        jax_svd.SVDConfig(n_factors=8, n_epochs=20, batch_size=1024, seed=42),
    )
    return jax_prepared, prepared, full_corpus_r3.heldout_edges(tr, va, te), params


def test_svd_parity_metric_matches_script(svd_case):
    jax_prepared, _, heldout, jparams = svd_case
    got = svd_full_r5.parity(svd_params_to_torch(jparams, "cpu"), heldout)
    for name, df in (("val", jax_prepared.val_df), ("test", jax_prepared.test_df)):
        # The script's lines 84-92.
        p10, r10 = jax_svd.precision_recall_at_k(
            jparams, df["user_id_idx"].to_numpy(np.int64), df["item_id_idx"].to_numpy(np.int64),
            df["weight"].to_numpy(np.float32), k=10, rel_threshold=1.0, est_threshold=0.5,
        )
        assert got[name]["edges"] == len(df)
        np.testing.assert_allclose([got[name]["precision@10"], got[name]["recall@10"]], [p10, r10],
                                   rtol=REL)
        assert r10 > 0


def test_svd_full_ranking_matches_script(svd_case):
    jax_prepared, prepared, _, jparams = svd_case
    got = svd_full_r5.full_ranking(svd_params_to_torch(jparams, "cpu"), prepared)
    n_users, n_items = jax_prepared.n_users, jax_prepared.n_items
    # The script's packing (lines 101-118).
    emb = jnp.concatenate([
        jnp.concatenate([jparams["p"], jparams["b_u"][:, None], jnp.ones((n_users, 1), jnp.float32)], 1),
        jnp.concatenate([jparams["q"], jnp.ones((n_items, 1), jnp.float32), jparams["b_i"][:, None]], 1),
    ]).astype(jnp.float32)
    for name, split in (("val", jax_prepared.val), ("test", jax_prepared.test)):
        p20, r20 = jax_evaluate_bucketed(emb, jax_build_eval_buckets(split, width_floor=256), n_users, k=20)
        assert got[name]["users"] == len(split.user_ids)
        np.testing.assert_allclose([got[name]["precision@20"], got[name]["recall@20"]], [p20, r20],
                                   rtol=REL)
    assert got["val"]["recall@20"] + got["test"]["recall@20"] > 0


def test_svd_ranker_packing_matches_script(svd_case):
    jax_prepared, prepared, _, jparams = svd_case
    emb = movielens_bench.ranker_embedding(svd_params_to_torch(jparams, "cpu"))
    # The script's packing (scripts/movielens_bench.py:84-91).
    pu, qi = np.asarray(jparams["p"], np.float32), np.asarray(jparams["q"], np.float32)
    bu = np.asarray(jparams["b_u"], np.float32)[:, None]
    bi = np.asarray(jparams["b_i"], np.float32)[:, None]
    mu = float(jparams["mu"])
    fake = jnp.asarray(np.concatenate([np.concatenate([pu, bu * 0 + 1.0, bu], 1),
                                       np.concatenate([qi, mu + bi, np.ones_like(bi)], 1)]))
    np.testing.assert_array_equal(emb.numpy(), np.asarray(fake))
    from gnn_ecommerce_tpu_torch.eval.evaluate import build_eval_batch, evaluate

    recalls = []
    for split, jsplit in ((prepared.val, jax_prepared.val), (prepared.test, jax_prepared.test)):
        p, r, _, _, _ = evaluate(emb, build_eval_batch(split, "cpu"), prepared.n_users, k=20)
        jp, jr, _, _, _ = jax_evaluate(fake, jax_build_eval_batch(jsplit), jax_prepared.n_users, k=20)
        np.testing.assert_allclose([p, r], [jp, jr], rtol=REL)
        recalls.append(r)
    assert sum(recalls) > 0


def _continuous_corpus():
    """Unique random pairs, 40% purchases (weight 1.0) and the rest
    continuous weights: no user ties at its 20th skyline score."""
    rng = np.random.default_rng(0)
    pairs = np.unique(np.stack([rng.integers(0, 300, 6000), rng.integers(0, 120, 6000)], 1), axis=0)
    w = np.where(rng.random(len(pairs)) < 0.4, 1.0, rng.random(len(pairs)) * 0.5).astype(np.float32)
    return prepare_splits(*split_edges(Edges(pairs[:, 0], pairs[:, 1], w), seed=1, test_size=0.2))


@pytest.mark.parametrize("chunk", [7, 1024])
def test_skyline_matches_script_loop(chunk):
    prepared = _continuous_corpus()
    sky = skyline_full_r3.skyline(prepared, device="cpu", chunk=chunk)
    assert int(sky.tied.sum()) == 0
    want = skyline_full_r3.skyline_scipy(prepared)
    assert len(want) == len(sky.recall) > 100
    np.testing.assert_array_equal(sky.recall, want)
    assert 0 < sky.value < 1


def test_skyline_line_is_the_scripts(monkeypatch, tmp_path):
    """The script's main on the same corpus (its build_prepared and its
    ``open`` replaced): its value is the port's line's."""
    prepared = _continuous_corpus()
    monkeypatch.syspath_prepend(str(SCRIPTS))
    script = _script("skyline_full_r3")
    written = {}

    class Capture(io.StringIO):
        def close(self):
            written["text"] = self.getvalue()
            super().close()

    monkeypatch.setattr(script, "build_prepared", lambda: (prepared, 0))
    monkeypatch.setattr(script, "open", lambda path, mode="r": Capture(), raising=False)
    script.main()
    want = json.loads(written["text"])
    line = skyline_full_r3.run(prepared, device="cpu")
    assert line["value"] == want["value"] and line["n_val_users"] == want["n_val_users"]
    assert round(float(np.mean(skyline_full_r3.skyline_scipy(prepared))), 5) == want["value"]
    assert line["tied_users"] == 0
    assert set(line) == _tpu_keys("scripts/skyline_full_r3.json") | skyline_full_r3.EXTRA_KEYS - {
        "device", "launches", "bars"}


def test_skyline_counts_ties():
    """A user whose 2-hop scores tie at the 20th is counted."""
    # Ten items all reached from one user by one co-buyer: equal scores.
    users = np.array([0] * 3 + [1] * 25 + [2])
    items = np.array([0, 1, 2] + list(range(25)) + [30])
    w = np.ones(len(users), np.float32)
    prepared = prepare_splits(Edges(users, items, w), Edges(np.array([0]), np.array([30]),
                                                            np.ones(1, np.float32)),
                              Edges(np.array([0]), np.array([30]), np.ones(1, np.float32)))
    sky = skyline_full_r3.skyline(prepared, device="cpu")
    assert len(sky.recall) == 1 and bool(sky.tied[0])


def test_zero_layers_embedding_is_the_table(svd_case):
    jax_prepared, prepared, _, _ = svd_case
    cfg = lightgcn.LightGCNConfig(prepared.n_users + prepared.n_items, 8, 0)
    params = lightgcn.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    graph = build_graph(prepared.edge_user, prepared.edge_item_node, prepared.edge_weight,
                        prepared.n_users, prepared.n_items, items_offset=True, device="cpu")
    got = lightgcn.get_embedding(params, graph, cfg)
    assert torch.equal(got, params["embedding"])
    jcfg = jax_lightgcn.LightGCNConfig(cfg.num_nodes, 8, 0)
    jgraph = jax_build_graph(jax_prepared.edge_user, jax_prepared.edge_item_node,
                             jax_prepared.edge_weight, jax_prepared.n_users, jax_prepared.n_items,
                             items_offset=True)
    jparams = {"embedding": jnp.asarray(params["embedding"].numpy())}
    want = np.asarray(jax_lightgcn.get_embedding(jparams, jgraph, jcfg))
    np.testing.assert_array_equal(got.numpy(), want)


def test_bprmf_runs_on_the_cpu(small_corpus, no_bars, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(bprmf_full_r5, "CONFIG", dataclasses.replace(bprmf_full_r5.CONFIG, epochs=2))
    d = tmp_path / "data"
    assert full_corpus_r3.main(["-o", str(d), "--device", "cpu"]) == 0
    capsys.readouterr()
    assert bprmf_full_r5.main(["-d", str(d), "--device", "cpu", "--work", str(tmp_path / "w")]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == _tpu_keys("BPRMF_FULL_r5.json") | bprmf_full_r5.EXTRA_KEYS
    q = line["quality"]
    assert set(q) == set(json.loads((ROOT / "BPRMF_FULL_r5.json").read_text())["quality"])
    assert len(q["val_recall_curve"]) == 2 and 0 <= q["best_val_recall@20"] <= 1
    assert (tmp_path / "w" / bprmf_full_r5.CHECKPOINT_SUBDIR / "LightGCN_best" / "meta.json").exists()
    with open(tmp_path / "w" / bprmf_full_r5.CHECKPOINT_SUBDIR / "train_log.jsonl") as f:
        assert any("0 layers" in json.loads(r).get("msg", "") for r in f)


def test_svd_line_has_the_tpu_files_keys(small_corpus, no_bars, tmp_path, monkeypatch, capsys):
    """The line's keys; ``-d`` on the saved corpus (its held-out edges
    included) gives the numbers of the run that builds it."""
    monkeypatch.setattr(svd_full_r5, "CONFIG", dataclasses.replace(svd_full_r5.CONFIG, n_epochs=1))
    assert svd_full_r5.main(["--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = json.loads((ROOT / "SVD_FULL_r5.json").read_text())
    assert set(line) == set(want) | svd_full_r5.EXTRA_KEYS
    for key in ("config", "surprise_parity", "full_ranking", "timings_s"):
        assert set(line[key]) == set(want[key]), key
    assert line["config"]["n_epochs"] == 1 and line["config"]["n_factors"] == 100
    d = tmp_path / "data"
    assert full_corpus_r3.main(["-o", str(d), "--device", "cpu"]) == 0
    capsys.readouterr()
    assert svd_full_r5.main(["-d", str(d), "--device", "cpu"]) == 0
    saved = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("config", "surprise_parity", "full_ranking"):
        assert saved[key] == line[key], key


def test_movielens_writes_fixture_bytes_into_work(no_bars, tmp_path, monkeypatch, capsys):
    """The run's corpus file is the repo's fixture, byte for byte, and the
    fixture stays as it was. (The SVD's CV at 2 epochs keeps the test
    short; the card runs the script's 20.)"""
    before = hashlib.sha256(FIXTURE.read_bytes()).hexdigest()
    monkeypatch.setattr(movielens_bench, "run_cv", functools.partial(run_cv, cfg=SVDConfig(n_epochs=2)))
    work = tmp_path / "w"
    assert movielens_bench.main(["--epochs", "1", "--dim", "8", "--layers", "1", "--device", "cpu",
                                 "--work", str(work)]) == 0
    assert (work / movielens_bench.RATINGS_FILE).read_bytes() == FIXTURE.read_bytes()
    assert hashlib.sha256(FIXTURE.read_bytes()).hexdigest() == before
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = json.loads((ROOT / "MOVIELENS_r4.json").read_text())
    assert set(line) == set(want) | movielens_bench.EXTRA_KEYS
    assert (line["n_edges"], line["n_users"], line["n_items"]) == (
        want["n_edges"], want["n_users"], want["n_items"])
    assert set(line["same_split_top20"]["lightgcn"]) == set(want["same_split_top20"]["lightgcn"])


def test_config3_popularity_and_line(no_bars, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(config3_subsample_r3, "CORPUS", SMALL_CONFIG3)
    monkeypatch.setattr(config3_subsample_r3, "CONFIG",
                        dataclasses.replace(config3_subsample_r3.CONFIG, epochs=1))
    prepared = prepare_splits(*config3_subsample_r3.build_splits())
    jedges = jax_events_to_edges(jax_synthetic_events(**SMALL_CONFIG3), EVENT_TYPE_WEIGHTS_V1)
    jprepared = jax_prepare_splits(*jax_split_edges(jedges, seed=42))
    assert popularity_recall_at_k(prepared, k=20) == jax_popularity(jprepared, k=20)
    np.testing.assert_array_equal(prepared.edge_weight, jprepared.edge_weight)
    assert config3_subsample_r3.main(["--device", "cpu", "--work", str(tmp_path)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == _tpu_keys("scripts/config3_subsample_r3.json") | config3_subsample_r3.EXTRA_KEYS
    assert line["popularity_baseline_val_recall_at_20"] == round(jax_popularity(jprepared, k=20), 5)


# The H100's full-scale lines (NVIDIA H100 80GB HBM3, 700 W; quality_run.sh
# --triangle, --spread, --rehearsal and --sweeps), cut to the numbers the
# bars read, the path of each run's main number and a value of it that
# misses a bar: half the card's, but for BPR-MF, whose bar (0.00908 +- 0.01)
# holds anything below 0.01908, and for the sweeps, whose bars hold each
# output's check.
_HELD = {"held": True}
CARD_LINES = {
    "movielens_bench": ({
        "svd_cv_reference_protocol": {"precision_mean": 0.6518999592911623,
                                      "recall_mean": 0.7034986297712453},
        "same_split_top20": {
            "svd_ranker": {"val": {"recall": 0.017003202810883522},
                           "test": {"recall": 0.020210174843668938}},
            "lightgcn": {"val": {"recall": 0.18812495371788193}, "test": {"recall": 0.18458094383176002}},
        },
    }, ("same_split_top20", "lightgcn", "val", "recall"), 0.0940625),
    "config3_subsample_r3": ({"best_val_recall_at_20": 0.3519, "popularity_baseline_val_recall_at_20": 0.06656},
                             ("best_val_recall_at_20",), 0.17595),
    "svd_full_r5": ({
        "surprise_parity": {"val": {"precision@10": 0.04483558994197292, "recall@10": 0.045647969052224374},
                            "test": {"precision@10": 0.04786431507205661, "recall@10": 0.04827402320378752}},
        "full_ranking": {"val": {"recall@20": 0.0005609284586055164}},
    }, ("surprise_parity", "val", "recall@10"), 0.022823984526112187),
    "bprmf_full_r5": ({"quality": {"best_val_recall@20": 0.008452611287382054}},
                      ("quality", "best_val_recall@20"), 0.0191),
    "skyline_full_r3": ({"value": 0.17829}, ("value",), 0.089145),
    "train_full_r5b": ({"quality": {"best_val_recall": 0.3242154756286389,
                                    "test_recall": 0.31561182554830425}}, ("quality", "best_val_recall"),
                       0.16210773781431945),
    "real_data_rehearsal": ({
        "rows_requested": 1000000, "fabricate": {}, "concat": {"rows": 1000000, "files": 5},
        "eda": {"n_users": 43921, "n_items": 2500}, "preprocess": {"unique_edges": 238048},
        "train": {"val_recall": 0.42770789248438984, "dim": 32, "layers": 3, "epochs": 5},
        "serve": {"n_items": 20},
    }, ("train", "val_recall"), 0.21385394624219492),
    "heavy_k_sweep_r3": ({"results": [
        {"K": k, "head_gb_bf16": gb, "to_items_ms": ti, "to_users_ms": tu, "pair_ms": ti + tu,
         "plan_build_s": s, "check": {"to_items": _HELD, "to_users": _HELD}}
        for k, gb, ti, tu, s in ((0, 0.0, 0.8149920105934143, 16.686800003051758, 0.22744939600002567),
                                 (8192, 0.894091264, 1.1903520226478577, 14.038335800170898, 0.9292230700000061),
                                 (16384, 1.788182528, 1.465279996395111, 13.623568058013916, 1.0346692660000087),
                                 (32768, 3.576365056, 2.0245440006256104, 13.116719722747803, 1.1515610049999907))
    ]}, ("results", 2, "check", "to_users", "held"), False),
    "depth_dim_sweep_r3": ({
        "layered": [{"layers": 4, "dim": 80, "ms": 139.76599884033203},
                    {"layers": 5, "dim": 80, "ms": 174.54705810546875}],
        "fast": [{"layers": l, "dim": d, "ms": ms, "check": {"forward": _HELD}}
                 for l, d, ms in ((4, 80, 31.93604850769043), (5, 80, 36.64012908935547),
                                  (4, 90, 29.450703620910645), (5, 90, 34.70024108886719))],
    }, ("fast", 3, "check", "forward", "held"), False),
}


@pytest.mark.parametrize("name", sorted(CARD_LINES))
def test_bars_hold_the_card_lines_and_miss_half(name):
    line, path, wrong = CARD_LINES[name]
    held = bars.hold(line, bars.BARS[name](line))
    assert held["bars"] and all(b["held"] for b in held["bars"])
    json.dumps(held, allow_nan=False)  # strict JSON: open ends are null
    missed = json.loads(json.dumps(line))
    node = missed
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = wrong
    with pytest.raises(bars.BarMissed):
        bars.hold(missed, bars.BARS[name](missed))


def test_bars_cover_every_quality_run():
    assert set(bars.BARS) == set(CARD_LINES)
    for name in bars.BARS:
        assert "bars" in importlib.import_module(f"gnn_ecommerce_tpu_torch.runs.{name}").EXTRA_KEYS


def test_missed_bar_prints_no_line(monkeypatch, tmp_path, capsys):
    """A run that misses a bar raises; no JSON line is printed or written."""
    prepared = _continuous_corpus()
    monkeypatch.setattr(full_corpus_r3, "prepared_of", lambda d: (prepared, None, 0.0))
    monkeypatch.setitem(bars.TPU, "skyline", 2.0)
    out = tmp_path / "sky.json"
    with pytest.raises(bars.BarMissed, match="val R@20"):
        skyline_full_r3.main(["--device", "cpu", "--out", str(out)])
    assert capsys.readouterr().out == "" and not out.exists()
    monkeypatch.setitem(bars.TPU, "skyline", float(np.mean(skyline_full_r3.skyline_scipy(prepared))))
    assert skyline_full_r3.main(["--device", "cpu", "--out", str(out)]) == 0
    line = json.loads(out.read_text())
    assert [b["held"] for b in line["bars"]] == [True]


def test_mesh_bar_reads_the_train_log(tmp_path):
    log = tmp_path / "train_log.jsonl"
    log.write_text("".join(json.dumps(r) + "\n" for r in (
        {"etl_s": 1.0}, {"msg": "training"}, {"epoch": 0, "val_recall": 0.30},
        {"epoch": 1, "val_recall": 0.322049}, {"epoch": 2, "val_recall": 0.31}, {"msg": "Best epoch (1)"})))
    seeds = [{"seed": s, "quality": {"best_val_recall": v}} for s, v in ((1, 0.324215), (2, 0.323784))]
    got = bars.mesh_world_one(str(log), seeds)
    assert [b.value for b in got] == [0.322049, 0.322049] and all(b.held for b in got)
    seeds[1]["quality"]["best_val_recall"] = 0.333
    with pytest.raises(bars.BarMissed, match="seed 2"):
        bars.hold({}, bars.mesh_world_one(str(log), seeds))
