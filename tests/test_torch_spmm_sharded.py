"""The port's sharded SpMM pair (``ops/spmm_sharded.py``) against the JAX
package's on the same numpy arcs: each shard's plan exactly (built here for
every shard), and ``sharded_to_items`` / ``sharded_to_users`` with their
transpose pair in gloo worlds of 2 and 4 spawned CPU ranks against JAX's on
meshes of 2 and 4 of the 8-device CPU platform, at JAX's own bounds
(``tests/test_parallel.py``: rtol 1e-4, atol 1e-5)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_ecommerce_tpu.ops.bipartite import split_graph as jax_split_graph
from gnn_ecommerce_tpu.ops.spmm_sharded import (
    build_sharded_fast_ops as jax_build_sharded,
    sharded_to_items as jax_sti,
    sharded_to_users as jax_stu,
)
from gnn_ecommerce_tpu.parallel import make_mesh as jax_make_mesh
from gnn_ecommerce_tpu_torch.ops.bipartite import split_graph
from gnn_ecommerce_tpu_torch.ops.spmm_sharded import build_sharded_fast_ops
from gnn_ecommerce_tpu_torch.parallel.mesh import mesh_description

from torch_dist_worker import run_world
from torch_port_case import graphs, normal, small_arcs

torch.set_num_threads(1)

HEAVY, OT, CH = 16, 8, 16
WORLDS = (2, 4)


@pytest.fixture(scope="module")
def case():
    u, i, w, n_u, n_i = small_arcs(seed=13)
    jg, pg = graphs(u, i, w, n_u, n_i)
    return {
        "u": u, "i": i, "w": w, "n_u": n_u, "n_i": n_i,
        "x_u": normal(1, (n_u, 8)), "x_i": normal(2, (n_i, 8)),
        "heavy": HEAVY, "ot": OT,
        "jax_split": jax_split_graph(jg), "split": split_graph(pg),
    }


def _numpy_case(case):
    return {k: v for k, v in case.items() if k not in ("jax_split", "split")}


@pytest.fixture(scope="module")
def worlds(case, tmp_path_factory):
    """Each world's rank results, and JAX's on a mesh of the same size."""
    out = {}
    for world in WORLDS:
        ranks = run_world("spmm", world, _numpy_case(case), tmp_path_factory.mktemp(f"w{world}"))
        mesh = jax_make_mesh(world)
        ref = {}
        for mode in ("float32", "bfloat16"):
            sfo = jax_build_sharded(
                case["jax_split"], mesh, msgs_dtype=mode, heavy_users=HEAVY, ot=OT, ch=CH
            )
            with mesh:
                ref[f"to_items_{mode}"] = np.asarray(jax_sti(jnp.asarray(case["x_u"]), sfo))
                ref[f"to_users_{mode}"] = np.asarray(jax_stu(jnp.asarray(case["x_i"]), sfo))
                if mode == "float32":
                    # JAX's VJP of each direction is the other direction
                    # applied to the cotangent (its custom_vjp pairing).
                    ref["vjp_items"] = np.asarray(jax_stu(jnp.asarray(ref["to_items_float32"]), sfo))
                    ref["vjp_users"] = np.asarray(jax_sti(jnp.asarray(ref["to_users_float32"]), sfo))
        out[world] = (ranks, ref)
    return out


def _jax_plan_arcs(stack, d):
    """Device ``d``'s real arcs (src, local dst, w) of a JAX PlanStack: the
    padded layout's entries with a nonzero weight, in plan order."""
    ch = stack.ch
    gw = np.asarray(stack.gw[d])
    seg = np.asarray(stack.seg[d]).reshape(-1, ch)
    dst = (np.asarray(stack.tile_map[d])[:, None] * stack.ot + seg).reshape(-1)
    real = gw != 0
    return np.asarray(stack.gidx[d])[real], dst[real], gw[real]


def _assert_plan_equal(plan, arcs):
    src, dst, w = arcs
    np.testing.assert_array_equal(plan.src.numpy(), src)
    np.testing.assert_array_equal(plan.dst.numpy(), dst)
    np.testing.assert_array_equal(plan.w.numpy(), w)


@pytest.mark.parametrize("world", WORLDS)
def test_every_shard_plan_equals_jax(case, world):
    ref = jax_build_sharded(
        case["jax_split"], jax_make_mesh(world), heavy_users=HEAVY, ot=OT, ch=CH
    )
    for s in range(world):
        sfo = build_sharded_fast_ops(
            case["split"], mesh_description((1, world), s, device="cpu"),
            heavy_users=HEAVY, ot=OT, ch=CH,
        )
        _assert_plan_equal(sfo.items_stack.plan, _jax_plan_arcs(ref.items_stack, s))
        _assert_plan_equal(sfo.users_stack.plan, _jax_plan_arcs(ref.users_stack, s))
        assert sfo.users_stack.n_out == ref.users_stack.n_out
        np.testing.assert_array_equal(sfo.hi_ids.numpy(), np.asarray(ref.hi_ids))
        np.testing.assert_array_equal(sfo.w_hi.numpy(), np.asarray(ref.w_hi))


@pytest.mark.parametrize("world", WORLDS)
def test_shard_partials_add_up_in_one_process(case, worlds, world):
    """Each shard's part alone, here: the to_items partials add up, and the
    to_users rows stack, to JAX's tails (with the head added), f32."""
    from gnn_ecommerce_tpu_torch.ops.spmm_sharded import local_to_items, local_to_users

    x_u, x_i = torch.from_numpy(case["x_u"]), torch.from_numpy(case["x_i"])
    parts = [
        build_sharded_fast_ops(
            case["split"], mesh_description((1, world), s, device="cpu"), heavy_users=HEAVY, ot=OT, ch=CH
        )
        for s in range(world)
    ]
    head = parts[0]
    items = sum(local_to_items(x_u, p) for p in parts)
    items = items + head.w_hi @ x_u[head.hi_ids.long()]
    users = torch.cat([local_to_users(x_i, p) for p in parts])[: case["n_u"]]
    users = users.index_add(0, head.hi_ids.long(), head.w_hi.T @ x_i)
    _, ref = worlds[world]
    np.testing.assert_allclose(items.numpy(), ref["to_items_float32"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(users.numpy(), ref["to_users_float32"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_users_side_plans_pack_short_rows(case, worlds, world):
    """Each shard's users-side plan packs its short rows (packed chunks of
    CH arcs), and K1's summation order over it (``_kernel_order``: every
    row written once, a row with no arc zero), the shards' rows stacked and
    the head added, gives JAX's to_users (f32, JAX's bound)."""
    from test_torch_spmm_fast import _geometry, _kernel_order

    x_i = torch.from_numpy(case["x_i"])
    parts = [
        build_sharded_fast_ops(
            case["split"], mesh_description((1, world), s, device="cpu"), heavy_users=HEAVY, ot=OT, ch=CH
        )
        for s in range(world)
    ]
    assert all(p.users_stack.plan.n_packed for p in parts)
    users = np.concatenate(
        [_kernel_order(case["x_i"], p.users_stack.plan, *_geometry(x_i)) for p in parts]
    )[: case["n_u"]]
    head = parts[0]
    users = torch.from_numpy(users).index_add(0, head.hi_ids.long(), head.w_hi.T @ x_i)
    _, ref = worlds[world]
    np.testing.assert_allclose(users.numpy(), ref["to_users_float32"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", [
    "to_items_float32", "to_users_float32", "to_items_bfloat16", "to_users_bfloat16",
    "vjp_items", "vjp_users",
])
def test_sharded_pair_matches_jax(worlds, world, key):
    ranks, ref = worlds[world]
    for r in ranks:  # every rank holds the whole result
        np.testing.assert_allclose(r[key], ref[key], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_vjp_is_the_other_direction(worlds, world):
    """The gradient of to_items is to_users of the cotangent, and back."""
    ranks, _ = worlds[world]
    r = ranks[0]
    np.testing.assert_allclose(
        r["vjp_items"], _port_to_users(r["to_items_float32"]), rtol=1e-5, atol=1e-6
    )


def _port_to_users(g):
    """The one-device port's fast_to_users of ``g`` on the same graph."""
    from gnn_ecommerce_tpu_torch.graph.build import build_graph
    from gnn_ecommerce_tpu_torch.ops.bipartite import build_fast_ops, fast_to_users

    u, i, w, n_u, n_i = small_arcs(seed=13)
    split = split_graph(build_graph(u, i, w, n_u, n_i, device="cpu"))
    fops = build_fast_ops(split, heavy_users=HEAVY, device="cpu")
    return fast_to_users(torch.from_numpy(g), fops).numpy()
