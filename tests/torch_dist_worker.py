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
    embed, _ = make_fast_edge_fns(cfg, Adam(1e-2), mesh, fep, 32, 1e-4, 2048)
    with torch.no_grad():
        out["embed"] = embed(sp, fep).numpy()
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


# The training steps of every mesh strategy (tests/test_torch_parallel_train.py).
EDGE_FAST_MODES = (("float32", 0), ("float32", 16), ("bfloat16", 0), ("bfloat16", 16))


def _two_steps(out, key, step, params, opt, graph, c, view):
    """Two ``on_batch`` steps on the case's fixed batches; each step's
    metrics, then the unified params and Adam moments (``view``)."""
    import torch

    for b in range(2):
        users, pos, neg = (torch.from_numpy(c[f"{k}{b}"]) for k in ("users", "pos", "neg"))
        _, _, m = step.on_batch(params, opt, graph, users, pos, neg)
        out[f"{key}_metrics{b}"] = np.array(
            [float(m[k]) for k in ("loss", "bpr_loss", "reg_loss", "dropped_arcs")]
        )
    p, o = view(params), view(opt)
    out[f"{key}_emb"] = p["embedding"].numpy()
    out[f"{key}_mu"] = o.exp_avg["embedding"].numpy()
    out[f"{key}_nu"] = o.exp_avg_sq["embedding"].numpy()


def _job_train(c, mesh_default):
    """Two train steps of the fast edge partition (f32 and bf16, with and
    without the head), the GSPMD steps (fast and layered) and the explicit
    edge partition on fixed batches, from one table; ItemBand's backward;
    the explicit partition's embed."""
    import torch

    from gnn_ecommerce_tpu_torch.models.lightgcn import LightGCNConfig
    from gnn_ecommerce_tpu_torch.ops.bipartite import build_fast_bipartite, build_item_operator
    from gnn_ecommerce_tpu_torch.parallel import (
        build_edge_partition, build_fast_edge_partition, make_explicit_fns, make_fast_edge_fns,
        make_mesh, make_sharded_fast_train_step, make_sharded_train_step, merge_ep_view,
        pad_params, place_item_op, shard_fast_bipartite, shard_graph, shard_params, split_ep_tree,
    )
    from gnn_ecommerce_tpu_torch.parallel.edge_partition import unpad_params
    from gnn_ecommerce_tpu_torch.parallel.sharded_train import unshard_params
    from gnn_ecommerce_tpu_torch.train.step import Adam

    world = mesh_default.size
    g, split = _graph_split(c)
    cfg = LightGCNConfig(g.num_nodes, int(c["dim"]), int(c["layers"]))
    lr, decay, B, cap = float(c["lr"]), float(c["decay"]), int(c["batch"]), int(c["edge_cap"])
    table = torch.from_numpy(c["params"])
    out = {}
    mesh = make_mesh(world, axis_sizes=(world,), axis_names=("model",), device="cpu")
    ops = {dt: build_item_operator(split, dtype=dt, device="cpu") for dt in (torch.float32, torch.bfloat16)}

    for mode, heavy in EDGE_FAST_MODES:
        dt = torch.bfloat16 if mode == "bfloat16" else torch.float32
        fep = build_fast_edge_partition(split, mesh, ops[dt], msgs_dtype=mode, heavy_users=heavy,
                                        heavy_dtype=mode)
        _, step = make_fast_edge_fns(cfg, Adam(lr), mesh, fep, B, decay, cap)
        params = split_ep_tree({"embedding": table.clone()}, fep)
        opt = Adam(lr).init(params)
        key = f"edge_fast_{mode}_{heavy}"
        _two_steps(out, key, step, params, opt, fep, c, lambda t: merge_ep_view(t, fep))
        out[f"{key}_replicated"] = torch.stack(
            [params["emb_items"], opt.exp_avg["emb_items"], opt.exp_avg_sq["emb_items"]]
        ).numpy()
        out[f"{key}_own"] = torch.stack(
            [params["emb_users"], opt.exp_avg["emb_users"], opt.exp_avg_sq["emb_users"]]
        ).numpy()

    # ItemBand's backward against the gradient of the whole product.
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        band = place_item_op(ops[dt], mesh)
        x = torch.from_numpy(c["band_x"]).to(dt).requires_grad_()
        (gx,) = torch.autograd.grad(band(x), x, torch.from_numpy(c["band_g"]))
        out[f"band_grad_{name}"] = gx.float().numpy()

    meshes = {"gspmd_1x{}".format(world): make_mesh(world, axis_sizes=(1, world), device="cpu")}
    if world == 4:
        meshes["gspmd_2x2"] = make_mesh(world, axis_sizes=(2, 2), device="cpu")
    fbs = {
        mode: build_fast_bipartite(g, dtype=dt, device="cpu")
        for mode, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16))
    }
    for name, m in meshes.items():
        for mode in ("float32", "bfloat16", "off"):
            if mode == "off":
                graph = shard_graph(g, m)
                step = make_sharded_train_step(cfg, Adam(lr), m, B, decay)
            else:
                graph = shard_fast_bipartite(fbs[mode], m, True, mode, int(c["heavy"]), mode)
                step = make_sharded_fast_train_step(cfg, Adam(lr), m, B, decay, cap)
            params = shard_params({"embedding": table.clone()}, m)
            opt = Adam(lr).init(params)
            key = f"{name}_{mode}"
            _two_steps(out, key, step, params, opt, graph, c, lambda t: unshard_params(t, m, g.num_nodes))
            out[f"{key}_band"] = torch.stack(
                [params["embedding"], opt.exp_avg["embedding"], opt.exp_avg_sq["embedding"]]
            ).numpy()

    part = build_edge_partition(g, mesh)
    embed, step = make_explicit_fns(cfg, Adam(lr), mesh, part, B, decay)
    params = pad_params({"embedding": table.clone()}, part)
    with torch.no_grad():
        out["explicit_embed"] = embed(params, part)[: g.num_nodes].numpy()
    opt = Adam(lr).init(params)
    _two_steps(out, "explicit", step, params, opt, part, c, lambda t: unpad_params(t, part))
    return out


# train() on a mesh (tests/test_torch_parallel_driver.py): name -> config.
DRIVER_RUNS = {
    "edge_fast_f32": dict(partition="edge", fast_bipartite="f32", heavy_users=16),
    "edge_fast_bf16": dict(partition="edge", fast_bipartite="bf16", heavy_users=16),
    "edge_plain": dict(partition="edge"),
    "gspmd_fast_f32": dict(partition="gspmd", fast_bipartite="f32", heavy_users=16),
    "gspmd_plain": dict(partition="gspmd"),
}
PROFILED_RUN = "gspmd_plain"  # its epoch 1 runs under the profiler
DRIVER_BASE = dict(latent_dim=8, n_layers=2, epochs=2, batch_size=128, batches_per_epoch=4, lr=0.02)


def driver_prepared():
    """The port's prepared splits of a small synthetic corpus (every rank
    and the test process build the same)."""
    from gnn_ecommerce_tpu_torch.data.events import EVENT_TYPE_WEIGHTS_V1, events_to_edges
    from gnn_ecommerce_tpu_torch.data.prepare import prepare_splits, split_edges
    from gnn_ecommerce_tpu_torch.data.synthetic import synthetic_events

    events = synthetic_events(n_users=200, n_items=50, n_events=4000, seed=13)
    return prepare_splits(*split_edges(events_to_edges(events, EVENT_TYPE_WEIGHTS_V1), seed=13))


def _history(result) -> np.ndarray:
    return np.array([[h[k] for k in ("loss", "bpr_loss", "reg_loss", "val_precision", "val_recall",
                                      "dropped_arcs")] for h in result.history])


def _job_driver(c, mesh_default):
    """train() with every mesh branch (checkpoints under the case's
    ``dir``), and a resume at lr 0 that must not beat the saved BEST."""
    from gnn_ecommerce_tpu_torch.train.driver import TrainConfig, train

    prepared = driver_prepared()
    root = str(c["dir"])
    out = {}
    for name, kw in DRIVER_RUNS.items():
        cfg = TrainConfig(**DRIVER_BASE, **kw, mesh_devices=0, checkpoint_dir=os.path.join(root, name),
                          profile_dir=os.path.join(root, name, "profile") if name == PROFILED_RUN else None)
        r = train(prepared, cfg, verbose=False, device="cpu")
        out[f"{name}_history"] = _history(r)
        out[f"{name}_test"] = np.array([r.best_epoch, r.best_val_recall, r.test_precision, r.test_recall])
        if name == "edge_fast_f32":
            import dataclasses

            r2 = train(prepared, dataclasses.replace(cfg, epochs=3, resume=True, lr=0.0),
                       verbose=False, device="cpu")
            out["resume_history"] = _history(r2)
            out["resume_test"] = np.array([r2.best_epoch, r2.best_val_recall, r2.test_precision,
                                           r2.test_recall])
    return out


_JOBS = {"spmm": _job_spmm, "parallel": _job_parallel, "train": _job_train, "driver": _job_driver}


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
