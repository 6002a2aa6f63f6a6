"""One rank of a gloo world on the CPU, for the port's multi-device tests.

``run_world(job, world, case, tmp)`` spawns ``world`` processes of
:func:`_rank_main`; each joins a gloo world through a file store, runs
``job`` on the numpy inputs of the npz ``case`` and writes its results to
``rank<r>.npz``. The children import only torch, numpy and the port. A rank
that hangs is killed at ``timeout`` seconds and the world fails.
"""
import multiprocessing
import os
import sys
import time
import traceback

import numpy as np


def _graph_split(c):
    from gnn_ecommerce_tpu_torch.graph.build import build_graph
    from gnn_ecommerce_tpu_torch.ops.bipartite import split_graph

    g = build_graph(c["u"], c["i"], c["w"], int(c["n_u"]), int(c["n_i"]), device="cpu")
    return g, split_graph(g)


def _job_spmm(c, mesh):
    """sharded_to_items / sharded_to_users in f32 and bf16, and the VJP."""
    import torch

    from gnn_ecommerce_tpu_torch.ops.spmm_sharded import (
        build_sharded_fast_ops, sharded_to_items, sharded_to_users,
    )

    _, split = _graph_split(c)
    out = {}
    x_u, x_i = torch.from_numpy(c["x_u"]), torch.from_numpy(c["x_i"])
    for mode in ("float32", "bfloat16"):
        sfo = build_sharded_fast_ops(
            split, mesh, msgs_dtype=mode, heavy_users=int(c["heavy"]), ot=int(c["ot"]), ch=16
        )
        out[f"to_items_{mode}"] = sharded_to_items(x_u, sfo).numpy()
        out[f"to_users_{mode}"] = sharded_to_users(x_i, sfo).numpy()
        if mode == "float32":
            x = x_u.clone().requires_grad_()
            g = torch.from_numpy(out["to_items_float32"])
            (gx,) = torch.autograd.grad(sharded_to_items(x, sfo), x, g)
            out["vjp_items"] = gx.numpy()
            x = x_i.clone().requires_grad_()
            gu = torch.from_numpy(out["to_users_float32"])
            (gy,) = torch.autograd.grad(sharded_to_users(x, sfo), x, gu)
            out["vjp_users"] = gy.numpy()
    return out


def _job_parallel(c, mesh_default):
    """The fast edge partition's embed, its SpMM pair's VJP, the params view
    round trip, the sharded evals and the axis groups of a (data 2, model
    world/2) mesh."""
    import torch

    from gnn_ecommerce_tpu_torch.data.prepare import CsrList, EvalSplit
    from gnn_ecommerce_tpu_torch.eval.evaluate import build_eval_batch, build_eval_buckets
    from gnn_ecommerce_tpu_torch.models.lightgcn import LightGCNConfig
    from gnn_ecommerce_tpu_torch.ops.bipartite import build_item_operator
    from gnn_ecommerce_tpu_torch.parallel import (
        build_fast_edge_partition, ep_to_items, ep_to_users, make_fast_edge_fns, make_mesh,
        make_sharded_eval_fn, merge_ep_view, sharded_evaluate, split_ep_tree,
    )
    from gnn_ecommerce_tpu_torch.parallel.distributed import (
        all_reduce_sum, assert_cross_host_agreement, replicate_tree,
    )
    from gnn_ecommerce_tpu_torch.train.step import Adam

    world = mesh_default.size
    mesh_2d = make_mesh(world, axis_sizes=(2, world // 2), device="cpu")
    out = {}
    # The 2-D mesh's axis groups: sums of the ranks along each axis.
    r = torch.tensor([float(mesh_2d.rank)])
    for axis in mesh_2d.axis_names:
        out[f"axis_sum_{axis}"] = all_reduce_sum(r.clone(), mesh_2d, axis).numpy()
    out["coords"] = np.array([mesh_2d.index(a) for a in mesh_2d.axis_names])
    # replicate_tree: every leaf becomes rank 0's; the agreement guard.
    tree = {"a": torch.full((3,), float(mesh_2d.rank)), "b": [torch.full((2, 2), mesh_2d.rank + 1.0)]}
    replicate_tree(tree, mesh_2d)
    out["replicated"] = np.concatenate([tree["a"].numpy(), tree["b"][0].numpy().ravel()])
    assert_cross_host_agreement(1.5, "equal everywhere")
    try:
        assert_cross_host_agreement(float(mesh_2d.rank), "the rank")
        out["disagreement_raises"] = np.array(False)
    except AssertionError:
        out["disagreement_raises"] = np.array(True)

    g, split = _graph_split(c)
    mesh = make_mesh(world, axis_sizes=(world,), axis_names=("model",), device="cpu")
    item_op = build_item_operator(split, dtype=torch.float32, device="cpu")
    fep = build_fast_edge_partition(split, mesh, item_op, heavy_users=int(c["heavy"]))
    cfg = LightGCNConfig(num_nodes=g.num_nodes, embedding_dim=int(c["dim"]), num_layers=int(c["layers"]))
    params = {"embedding": torch.from_numpy(c["params"])}
    sp = split_ep_tree(params, fep)
    embed, train_step = make_fast_edge_fns(cfg, Adam(1e-2), mesh, fep, 32, 1e-4, 2048)
    with torch.no_grad():
        out["embed"] = embed(sp, fep).numpy()
    try:
        train_step(sp, None, fep, None, None)
    except NotImplementedError:
        out["train_step_raises"] = np.array(True)
    # The pair's VJP, shard by shard.
    x = sp["emb_users"].clone().requires_grad_()
    gi = torch.from_numpy(c["x_i"])
    (gx,) = torch.autograd.grad(ep_to_items(x, fep), x, gi)
    out["ep_vjp_items"] = gx.numpy()
    out["ep_to_users"] = ep_to_users(gi, fep).detach().numpy()
    out["emb_users"] = sp["emb_users"].numpy()
    # The params view round trip, also of an optimizer state.
    out["merged"] = merge_ep_view(sp, fep)["embedding"].numpy()
    opt = Adam(1e-2).init(params)
    opt.exp_avg["embedding"].copy_(torch.from_numpy(c["x_u_full"]))
    opt_back = merge_ep_view(split_ep_tree(opt, fep), fep)
    out["merged_opt"] = opt_back.exp_avg["embedding"].numpy()
    out["opt_step"] = np.array(opt_back.step)

    # Sharded evaluation on the same users as the JAX tests.
    emb = torch.from_numpy(c["eval_emb"])
    ev = EvalSplit(
        user_ids=c["ev_uids"],
        truth=CsrList(c["ev_truth_ptr"], c["ev_truth"]),
        train_mask=CsrList(c["ev_mask_ptr"], c["ev_mask"]),
    )
    p, rr, rec, prec, idx = sharded_evaluate(
        emb, build_eval_batch(ev, device="cpu"), int(c["ev_n_users"]), mesh_2d, k=5, item_tile=8
    )
    out["se"] = np.array([p, rr])
    out["se_idx"], out["se_recall"], out["se_precision"] = idx, rec, prec
    buckets = build_eval_buckets(ev, width_floor=4, device="cpu")
    for name, m in (("mesh2d", mesh_2d), ("model", mesh)):
        fn = make_sharded_eval_fn(m, int(c["ev_n_users"]), k=5, item_tile=8)
        out[f"buckets_{name}"] = np.array(fn(emb, buckets))
    return out


_JOBS = {"spmm": _job_spmm, "parallel": _job_parallel}


def _rank_main(job, rank, world, store, case, out_dir):
    try:
        import torch

        torch.set_num_threads(1)
        from gnn_ecommerce_tpu_torch.parallel import make_mesh
        from gnn_ecommerce_tpu_torch.parallel.distributed import init_distributed

        init_distributed(f"file://{store}", world, rank, device="cpu")
        c = dict(np.load(case))
        out = _JOBS[job](c, make_mesh(world, device="cpu"))
        jax_side = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "gnn_ecommerce_tpu."))]
        assert not jax_side, f"a rank imported {jax_side[:3]}"
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        import torch.distributed as dist

        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_world(job: str, world: int, case: dict, tmp, timeout: float = 90.0) -> list:
    """Run ``job`` in a gloo world of ``world`` spawned CPU processes; return
    each rank's results (dicts of numpy arrays), or raise with the ranks'
    tracebacks if any rank failed or outlived ``timeout``."""
    tmp = str(tmp)
    case_path = os.path.join(tmp, f"{job}_case.npz")
    np.savez(case_path, **case)
    ctx = multiprocessing.get_context("spawn")
    procs = [
        ctx.Process(
            target=_rank_main,
            args=(job, r, world, os.path.join(tmp, f"{job}_store_{world}"), case_path, tmp),
        )
        for r in range(world)
    ]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = []
    for r in range(world):
        err = os.path.join(tmp, f"rank{r}.err")
        if os.path.exists(err):
            errors.append(f"rank {r}:\n" + open(err).read())
    if hung or errors or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(
            f"world of {world} failed (hung ranks {hung}, exit codes "
            f"{[p.exitcode for p in procs]})\n" + "\n".join(errors)
        )
    return [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(world)]
