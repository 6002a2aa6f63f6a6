"""The port's multi-device forward and evaluation (``parallel/``) against the
JAX package's on the same numpy inputs.

In this process: ``mesh_factorization`` for n 1-64, the bootstrap's refusal
of a partial world, and every shard's fast-edge-partition plans, batch CSR
and head block (exact; built here shard by shard). In gloo worlds of 2 and
4 spawned CPU ranks (``torch_dist_worker.py``): the mesh's axis groups, the
fast edge partition's ``embed`` against JAX's on meshes of 2 and 4 of the
8-device CPU platform (``tests/test_edge_partition_fast.py``'s bound: rtol
2e-5, atol 2e-6), its SpMM pair's transpose, the params view round trip
(exact), and ``sharded_evaluate`` / ``make_sharded_eval_fn`` against JAX's
``evaluate`` / ``evaluate_bucketed`` (``tests/test_parallel.py``: rel 1e-6,
ids equal)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnn_ecommerce_tpu.data.prepare import CsrList as JaxCsrList, EvalSplit as JaxEvalSplit
from gnn_ecommerce_tpu.eval import build_eval_batch as jax_build_eval_batch
from gnn_ecommerce_tpu.eval import build_eval_buckets as jax_build_eval_buckets
from gnn_ecommerce_tpu.eval import evaluate as jax_evaluate
from gnn_ecommerce_tpu.eval import evaluate_bucketed as jax_evaluate_bucketed
from gnn_ecommerce_tpu.models import LightGCNConfig as JaxConfig
from gnn_ecommerce_tpu.ops.bipartite import (
    build_item_operator as jax_build_item_operator,
    split_graph as jax_split_graph,
)
from gnn_ecommerce_tpu.parallel import make_mesh as jax_make_mesh
from gnn_ecommerce_tpu.parallel import mesh_factorization as jax_mesh_factorization
from gnn_ecommerce_tpu.parallel.edge_partition_fast import (
    build_fast_edge_partition as jax_build_fep,
    make_fast_edge_fns as jax_make_fast_edge_fns,
    split_ep_tree as jax_split_ep_tree,
)
from gnn_ecommerce_tpu_torch.ops.bipartite import split_graph
from gnn_ecommerce_tpu_torch.parallel import build_fast_edge_partition, mesh_factorization
from gnn_ecommerce_tpu_torch.parallel.distributed import init_distributed
from gnn_ecommerce_tpu_torch.parallel.mesh import mesh_description

from torch_dist_worker import run_world
from torch_port_case import graphs, normal

torch.set_num_threads(1)

HEAVY, DIM, LAYERS = 16, 16, 3
WORLDS = (2, 4)


def _arcs():
    """301 users × 83 items (not divisible by the shard counts: real row
    padding), as ``tests/test_edge_partition_fast.py``'s case."""
    rng = np.random.default_rng(17)
    n_u, n_i = 301, 83
    u = rng.integers(0, n_u, 2600)
    i = rng.integers(0, n_i, 2600)
    key = np.unique(u * 128 + i)
    u, i = key // 128, key % 128
    w = rng.random(len(u)).astype(np.float32) + 0.05
    return u, i, w, n_u, n_i


def _eval_case(rng):
    """``tests/test_parallel.py``'s bucketed case: 91 users, 23 items, 41
    eval users whose masks span several power-of-two buckets."""
    n_users, n_items = 91, 23
    emb = rng.standard_normal((n_users + n_items, 8)).astype(np.float32)
    uids = np.sort(rng.choice(n_users, 41, replace=False)).astype(np.int64)
    truth_lens = rng.integers(1, 4, len(uids))
    truth = rng.integers(0, n_items, int(truth_lens.sum()))
    mask_lens = rng.integers(0, 9, len(uids))
    mask = rng.integers(0, n_items, int(mask_lens.sum()))
    return {
        "eval_emb": emb, "ev_n_users": n_users, "ev_uids": uids,
        "ev_truth_ptr": np.append(0, np.cumsum(truth_lens)), "ev_truth": truth,
        "ev_mask_ptr": np.append(0, np.cumsum(mask_lens)), "ev_mask": mask,
    }


@pytest.fixture(scope="module")
def case():
    u, i, w, n_u, n_i = _arcs()
    jg, pg = graphs(u, i, w, n_u, n_i)
    c = {
        "u": u, "i": i, "w": w, "n_u": n_u, "n_i": n_i, "heavy": HEAVY,
        "dim": DIM, "layers": LAYERS,
        "params": normal(5, (n_u + n_i, DIM)) * 0.1,
        "x_i": normal(6, (n_i, DIM)),
        "x_u_full": normal(7, (n_u + n_i, DIM)),
    }
    c.update(_eval_case(np.random.default_rng(42)))
    return c, jg, pg


@pytest.fixture(scope="module")
def jax_item_op(case):
    _, jg, _ = case
    split = jax_split_graph(jg)
    return split, jax_build_item_operator(split, dtype=jnp.float32)


def _jax_fep(jax_item_op, world):
    split, item_op = jax_item_op
    mesh = jax_make_mesh(world, axis_sizes=(world,), axis_names=("model",))
    with mesh:
        return mesh, jax_build_fep(split, mesh, item_op, heavy_users=HEAVY)


def _jax_eval_split(c):
    return JaxEvalSplit(
        user_ids=c["ev_uids"],
        truth=JaxCsrList(c["ev_truth_ptr"], c["ev_truth"]),
        train_mask=JaxCsrList(c["ev_mask_ptr"], c["ev_mask"]),
    )


@pytest.fixture(scope="module")
def worlds(case, jax_item_op, tmp_path_factory):
    c, jg, _ = case
    out = {}
    emb = jnp.asarray(c["eval_emb"])
    ev = _jax_eval_split(c)
    ref_eval = jax_evaluate(emb, jax_build_eval_batch(ev), c["ev_n_users"], k=5, item_tile=8)
    ref_buckets = jax_evaluate_bucketed(
        emb, jax_build_eval_buckets(ev, width_floor=4), c["ev_n_users"], k=5, item_tile=8
    )
    cfg = JaxConfig(num_nodes=jg.num_nodes, embedding_dim=DIM, num_layers=LAYERS)
    params = {"embedding": jnp.asarray(c["params"])}
    for world in WORLDS:
        ranks = run_world("parallel", world, c, tmp_path_factory.mktemp(f"w{world}"))
        mesh, fep = _jax_fep(jax_item_op, world)
        with mesh:
            sp = jax_split_ep_tree(params, fep, mesh)
            embed, _ = jax_make_fast_edge_fns(
                cfg, optax.adam(1e-2), mesh, fep, batch_size=32, decay=1e-4, edge_cap=2048
            )
            ref_embed = np.asarray(jax.jit(embed)(sp, fep))
        out[world] = (ranks, {"embed": ref_embed, "eval": ref_eval, "buckets": ref_buckets})
    return out


@pytest.mark.parametrize("n", range(1, 65))
def test_mesh_factorization_matches_jax(n):
    assert mesh_factorization(n) == jax_mesh_factorization(n)


@pytest.mark.parametrize("spec", [
    {"coordinator_address": "localhost:1"},
    {"num_processes": 2},
    {"process_id": 1},
    {"coordinator_address": "localhost:1", "num_processes": 2},
    {"num_processes": 2, "process_id": 0},
])
def test_partial_world_raises(spec):
    """A deliberate difference: the reference starts a runtime from
    ``process_id`` alone (``parallel/distributed.py:52``)."""
    with pytest.raises(ValueError, match="go together"):
        init_distributed(**spec, device="cpu")


@pytest.mark.parametrize("env", [{"RANK": "1"}, {"WORLD_SIZE": "2", "RANK": "0"},
                                 {"MASTER_ADDR": "localhost", "MASTER_PORT": "1"}])
def test_partial_environment_raises(env, monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="partial"):
        init_distributed(device="cpu")


def test_force_without_a_world_raises(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="needs a world"):
        init_distributed(force=True, device="cpu")
    assert init_distributed(device="cpu")["process_count"] == 1


def _jax_arcs(stack, s):
    ch = stack.ch
    gw = np.asarray(stack.gw[s])
    seg = np.asarray(stack.seg[s]).reshape(-1, ch)
    dst = (np.asarray(stack.tile_map[s])[:, None] * stack.ot + seg).reshape(-1)
    real = gw != 0
    return np.asarray(stack.gidx[s])[real], dst[real], gw[real]


@pytest.mark.parametrize("world", WORLDS)
def test_every_shard_of_the_partition_equals_jax(case, jax_item_op, world):
    """Plans, batch CSR, head block and B_ii band of every shard, exactly
    (the JAX slabs' padding is zero)."""
    _, _, pg = case
    _, ref = _jax_fep(jax_item_op, world)
    split = split_graph(pg)
    item_op = torch.from_numpy(np.array(jax_item_op[1]))
    for s in range(world):
        fep = build_fast_edge_partition(
            split, mesh_description((world,), s, ("model",), device="cpu"), item_op,
            heavy_users=HEAVY,
        )
        assert fep.rows_per_shard == ref.rows_per_shard
        for mine, theirs in ((fep.items_stack, ref.items_stack), (fep.users_stack, ref.users_stack)):
            src, dst, w = _jax_arcs(theirs, s)
            np.testing.assert_array_equal(mine.plan.src.numpy(), src)
            np.testing.assert_array_equal(mine.plan.dst.numpy(), dst)
            np.testing.assert_array_equal(mine.plan.w.numpy(), w)
        np.testing.assert_array_equal(fep.indptr_loc.numpy(), np.asarray(ref.indptr_loc[s]))
        a = len(fep.batch_item)
        np.testing.assert_array_equal(fep.batch_item.numpy(), np.asarray(ref.batch_item[s])[:a])
        np.testing.assert_array_equal(fep.batch_w.numpy(), np.asarray(ref.batch_w[s])[:a])
        assert not np.asarray(ref.batch_w[s])[a:].any()
        k = 0 if fep.hi_loc is None else len(fep.hi_loc)
        if k:
            np.testing.assert_array_equal(fep.hi_loc.numpy(), np.asarray(ref.hi_loc[s])[:k])
            np.testing.assert_array_equal(fep.w_hi.numpy(), np.asarray(ref.w_hi[s])[:, :k])
        assert not np.asarray(ref.w_hi[s])[:, k:].any()
        band = np.asarray(ref.item_op)[s * fep.item_op.band : (s + 1) * fep.item_op.band]
        rows = fep.item_op.rows.shape[0]
        np.testing.assert_array_equal(fep.item_op.rows.numpy(), band[:rows])
        assert not band[rows:].any()


@pytest.mark.parametrize("world", WORLDS)
def test_axis_groups_sum_their_ranks(worlds, world):
    ranks, _ = worlds[world]
    data, model = 2, world // 2
    for rank, r in enumerate(ranks):
        d, m = divmod(rank, model)
        np.testing.assert_array_equal(r["coords"], [d, m])
        assert float(r["axis_sum_model"][0]) == sum(d * model + j for j in range(model))
        assert float(r["axis_sum_data"][0]) == sum(i * model + m for i in range(data))


@pytest.mark.parametrize("world", WORLDS)
def test_replicate_tree_and_agreement_guard(worlds, world):
    """``replicate_tree`` gives every rank rank 0's leaves (the JAX
    replication's result); ``assert_cross_host_agreement`` passes equal
    values and raises on different ones."""
    ranks, _ = worlds[world]
    for r in ranks:
        np.testing.assert_array_equal(r["replicated"], [0, 0, 0, 1, 1, 1, 1])
        assert bool(r["disagreement_raises"])


@pytest.mark.parametrize("world", WORLDS)
def test_embed_matches_jax(worlds, world):
    ranks, ref = worlds[world]
    for r in ranks:
        np.testing.assert_allclose(r["embed"], ref["embed"], rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_ep_pair_is_self_transpose(worlds, world):
    """The gradient of ep_to_items at a shard's rows is that shard's rows
    of ep_to_users of the cotangent."""
    ranks, _ = worlds[world]
    for r in ranks:
        np.testing.assert_allclose(r["ep_vjp_items"], r["ep_to_users"], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("world", WORLDS)
def test_params_view_round_trip(case, worlds, world):
    c = case[0]
    ranks, _ = worlds[world]
    R = ranks[0]["emb_users"].shape[0]
    for s, r in enumerate(ranks):
        np.testing.assert_array_equal(r["merged"], c["params"])
        np.testing.assert_array_equal(r["merged_opt"], c["x_u_full"])
        assert int(r["opt_step"]) == 0
        rows = c["params"][s * R : min((s + 1) * R, c["n_u"])]
        np.testing.assert_array_equal(r["emb_users"][: len(rows)], rows)
        assert not r["emb_users"][len(rows):].any()


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_evaluate_matches_jax(worlds, world):
    ranks, ref = worlds[world]
    p1, r1, rec1, prec1, idx1 = ref["eval"]
    for r in ranks:
        assert r["se"][0] == pytest.approx(p1, rel=1e-6)
        assert r["se"][1] == pytest.approx(r1, rel=1e-6)
        np.testing.assert_array_equal(r["se_idx"], idx1)
        np.testing.assert_allclose(r["se_recall"], rec1, rtol=1e-6)
        np.testing.assert_allclose(r["se_precision"], prec1, rtol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mesh", ["mesh2d", "model"])
def test_sharded_eval_fn_matches_bucketed(worlds, world, mesh):
    ranks, ref = worlds[world]
    p1, r1 = ref["buckets"]
    for r in ranks:
        p2, r2 = r[f"buckets_{mesh}"]
        assert p2 == pytest.approx(p1, rel=1e-6)
        assert r2 == pytest.approx(r1, rel=1e-6)
