"""The port's GSPMD segment-sum path, ``shard_fast_bipartite(fb, mesh)``
with JAX's default ``fast_ops=False``, against the JAX package's on the
same numpy inputs.

In a gloo world of 2 spawned CPU ranks (``torch_dist_worker.py``, job
``gspmd_segment``), on a (data 2, model 1) mesh, where each rank sums half
of every direction's arcs and one all-reduce adds the halves, and on a
(data 1, model 2) mesh, where B_ii is in row bands: ``sharded_fast_embedding``
against JAX's plan-less ``fast_get_embedding`` and JAX's own GSPMD path
(``shard_fast_bipartite`` on its 8-device CPU mesh), and one step of
``make_sharded_fast_train_step`` on a fixed batch against the port's
one-device plan-less step, JAX's one-device step (``jax.grad``,
``optax.adam``) and JAX's GSPMD step on the same batch, at
``tests/test_parallel.py``'s bounds: loss rtol 1e-5, table rtol 1e-4 /
atol 1e-6 (the forward at rtol 1e-5 / atol 1e-6). No arc is dropped and
every rank holds the same bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnn_ecommerce_tpu.models import LightGCNConfig as JaxConfig
from gnn_ecommerce_tpu.models import losses as jlosses
from gnn_ecommerce_tpu.ops import bipartite as jbip
from gnn_ecommerce_tpu.parallel import make_mesh as jax_make_mesh
from gnn_ecommerce_tpu.parallel import make_sharded_fast_train_step as jax_sharded_step
from gnn_ecommerce_tpu.parallel import shard_fast_bipartite as jax_shard_fast_bipartite
from gnn_ecommerce_tpu.parallel import shard_params as jax_shard_params
from gnn_ecommerce_tpu.parallel import sharded_train as jax_sharded_train
from gnn_ecommerce_tpu_torch.models.lightgcn import LightGCNConfig
from gnn_ecommerce_tpu_torch.ops import bipartite as tbip
from gnn_ecommerce_tpu_torch.train.step import Adam, make_train_fns

from torch_dist_worker import SEGMENT_MESHES, run_world
from torch_port_case import graphs, normal

torch.set_num_threads(1)

DIM, LAYERS, BATCH, LR, DECAY, EDGE_CAP = 16, 3, 64, 1e-2, 1e-4, 4096
WORLD = 2
MESHES = sorted(SEGMENT_MESHES)


def _arcs():
    """301 users × 83 items, as ``tests/test_torch_parallel_train.py``'s
    case, with an odd arc count: the data shards get a no-op pad arc."""
    rng = np.random.default_rng(29)
    n_u, n_i = 301, 83
    u = rng.integers(0, n_u, 2600)
    i = rng.integers(0, n_i, 2600)
    key = np.unique(u * 128 + i)
    key = key[: len(key) - 1 + len(key) % 2]
    u, i = key // 128, key % 128
    w = rng.random(len(u)).astype(np.float32) + 0.05
    return u, i, w, n_u, n_i


@pytest.fixture(scope="module")
def case():
    u, i, w, n_u, n_i = _arcs()
    jg, pg = graphs(u, i, w, n_u, n_i)
    rng = np.random.default_rng(31)
    c = {
        "u": u, "i": i, "w": w, "n_u": n_u, "n_i": n_i, "dim": DIM, "layers": LAYERS, "lr": LR,
        "decay": DECAY, "batch": BATCH, "edge_cap": EDGE_CAP,
        "params": normal(6, (n_u + n_i, DIM)) * 0.1,
        "users0": rng.integers(0, n_u, BATCH),
        "pos0": n_u + rng.integers(0, n_i, BATCH),
        "neg0": n_u + rng.integers(0, n_i, BATCH),
    }
    return c, jg, pg


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    return run_world("gspmd_segment", WORLD, case[0], tmp_path_factory.mktemp("segment"), timeout=180)


def _batch(c, lib):
    return tuple(lib(c[k]) for k in ("users0", "pos0", "neg0"))


def _jax_loss(fb):
    def loss(params, users, pos, neg):
        u, p, n, _ = jbip.fast_batch_embeddings(params, fb, LAYERS, users, pos, neg, edge_cap=EDGE_CAP)
        bpr = jlosses.bpr_loss(jnp.sum(u * p, -1), jnp.sum(u * n, -1))
        reg = jlosses.reg_loss(params["embedding"], users, pos, neg, DECAY)
        return bpr + reg
    return loss


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def refs(case, monkeypatch_module):
    """The forward and one step of: JAX's one-device plan-less path, JAX's
    GSPMD segment path on its 8-device CPU mesh, and the port's one-device
    plan-less step. Each step: (loss, table, Adam's first moment)."""
    c, jg, pg = case
    jfb = jbip.build_fast_bipartite(jg)
    params = {"embedding": jnp.asarray(c["params"])}
    out = {"jax_embed": np.asarray(jbip.fast_get_embedding(params, jfb, LAYERS))}
    opt = optax.adam(LR)
    state = opt.init(params)
    loss, grads = jax.value_and_grad(_jax_loss(jfb))(params, *_batch(c, jnp.asarray))
    updates, state = opt.update(grads, state, params)
    out["jax_step"] = (float(loss), np.asarray(optax.apply_updates(params, updates)["embedding"]),
                       np.asarray(state[0].mu["embedding"]))

    mesh = jax_make_mesh(8)
    batch = tuple(jnp.asarray(a, jnp.int32) for a in _batch(c, np.asarray))
    monkeypatch_module.setattr(jax_sharded_train, "sample_batch", lambda *a, **k: batch)
    with mesh:
        sfb = jax_shard_fast_bipartite(jfb, mesh)
        sp = jax_shard_params({"embedding": jnp.asarray(c["params"])}, mesh)
        out["jax_gspmd_embed"] = np.asarray(jbip.fast_get_embedding(sp, sfb, LAYERS))
        so = opt.init(sp)
        step = jax_sharded_step(JaxConfig(jg.num_nodes, DIM, LAYERS), opt, mesh, BATCH, DECAY, EDGE_CAP)
        p8, s8, m8 = step(sp, so, sfb, None, jax.random.key(0))
        out["jax_gspmd_step"] = (float(m8["loss"]), np.asarray(p8["embedding"]),
                                 np.asarray(s8[0].mu["embedding"]))
        assert float(m8["dropped_arcs"]) == 0.0

    cfg = LightGCNConfig(pg.num_nodes, DIM, LAYERS)
    fb = tbip.build_fast_bipartite(pg, device="cpu")
    adam = Adam(LR)
    step, _ = make_train_fns(cfg, adam, BATCH, DECAY, batch_embed_fn=lambda p, g_, u, po, ne: (
        tbip.fast_batch_embeddings(p, g_, LAYERS, u, po, ne, edge_cap=EDGE_CAP)))
    tp = {"embedding": torch.from_numpy(c["params"].copy())}
    ts = adam.init(tp)
    _, _, m = step.on_batch(tp, ts, fb, *_batch(c, torch.from_numpy))
    out["port_step"] = (float(m["loss"]), tp["embedding"].numpy(), ts.exp_avg["embedding"].numpy())
    return out


def _hold_step(r: dict, key: str, ref: tuple) -> None:
    loss, emb, mu = ref
    np.testing.assert_allclose(r[f"{key}_metrics"][0], loss, rtol=1e-5)
    np.testing.assert_allclose(r[f"{key}_emb"], emb, rtol=1e-4, atol=1e-6)
    assert np.linalg.norm(r[f"{key}_mu"] - mu) / np.linalg.norm(mu) <= 1e-4


@pytest.mark.parametrize("mesh", MESHES)
def test_segment_forward_matches_jax(ranks, refs, mesh):
    for r in ranks:
        for ref in (refs["jax_embed"], refs["jax_gspmd_embed"]):
            np.testing.assert_allclose(r[f"{mesh}_embed"], ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mesh", MESHES)
def test_segment_step_matches_port_one_device(ranks, refs, mesh):
    for r in ranks:
        _hold_step(r, mesh, refs["port_step"])


@pytest.mark.parametrize("mesh", MESHES)
def test_segment_step_matches_jax(ranks, refs, mesh):
    """Against JAX's one-device step and its GSPMD segment path's step."""
    for r in ranks:
        _hold_step(r, mesh, refs["jax_step"])
        _hold_step(r, mesh, refs["jax_gspmd_step"])


@pytest.mark.parametrize("mesh", MESHES)
def test_segment_replicas_bit_equal_and_nothing_dropped(ranks, mesh):
    """The same metrics, table and moments on every rank, bit for bit; on
    the (data 2, model 1) mesh both ranks hold the one band, equal bits."""
    first = ranks[0]
    for r in ranks:
        assert r[f"{mesh}_metrics"][3] == 0.0
        for k in ("metrics", "emb", "mu", "embed"):
            np.testing.assert_array_equal(r[f"{mesh}_{k}"], first[f"{mesh}_{k}"])
        if SEGMENT_MESHES[mesh][1] == 1:
            np.testing.assert_array_equal(r[f"{mesh}_band"], first[f"{mesh}_band"])


def test_segment_arcs_split_over_data(case, ranks):
    """Over ``data`` each rank holds half of each direction's arcs, padded
    to an even count; over ``model`` alone each holds them all."""
    c = case[0]
    e = len(c["w"])
    assert e % 2 == 1  # a real pad arc
    for r in ranks:
        np.testing.assert_array_equal(r["data2_arcs"], [(e + 1) // 2] * 2)
        np.testing.assert_array_equal(r["model2_arcs"], [e, e])
