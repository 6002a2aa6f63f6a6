"""Driver ``train_steps``: closed-loop BPR training steps on the main path.

Set-up builds what ``train/driver.py``'s one-device fast branch builds (the
graph, ``build_fast_bipartite`` with the configuration's precision and heavy
head, the sampler, Adam, ``make_train_fns`` over ``fast_batch_embeddings``)
as one object, and drives it from the seed through the mix's first
``check_steps`` steps with the window's own call (``run_steps``) and
sampler stream: they warm every shape, and their losses, the first
gradient (Adam's first moment after one step over ``1 - b1``) and the
table's change after the last of them are what the reference follows. The
window then calls ``run_steps`` ``steps_per_call`` steps at a time, one call
after the other, until ``--seconds`` have passed; ``train_step_ms`` is its
seconds over its steps. No eval, no save.
"""
from __future__ import annotations

import math
import time
import types

import numpy as np
import torch

from gnn_ecommerce_tpu_torch.graph.build import build_graph
from gnn_ecommerce_tpu_torch.models.lightgcn import LightGCNConfig
from gnn_ecommerce_tpu_torch.ops.bipartite import (
    build_fast_bipartite, fast_batch_embeddings, fast_to_items, fast_to_users, item_chain_core,
)
from gnn_ecommerce_tpu_torch.sampling.bpr import make_sampler_data, sample_batch
from gnn_ecommerce_tpu_torch.train.step import Adam, make_train_fns

from benchmark import inputs, program
from benchmark.harness import Window, log
from benchmark.reference import judge
from benchmark.reference import lightgcn as ref


def setup(cell):
    dev = torch.device(cell.device)
    model, tr = cell.config["model"], cell.config["train"]
    D, L, B = model["embedding_dim"], model["num_layers"], tr["batch_size"]
    g = cell.config["graph"]
    n_users, n_items = g["n_users"], g["n_items"]
    t0 = time.perf_counter()
    (u, i, w), _ = inputs.graph_edges(cell.config, cell.seed, cell.device)
    log(f"inputs: {len(u)} edges in {time.perf_counter() - t0:.3f} s")
    graph = build_graph(u, i, w, n_users, n_items, device=dev)
    prec = tr["precision"]
    fb = build_fast_bipartite(graph, dtype=program.DTYPES[prec], fast_ops=True,
                              msgs_dtype=program.MODES[prec], heavy_users=tr["heavy_users"],
                              heavy_dtype=program.MODES[prec], device=dev)
    del graph
    log(f"fast bipartite: {fb.build_seconds}")
    sdata = make_sampler_data(program.sampler_arrays(u, i, w, n_users), n_users, n_items, dev)
    seeds = inputs.streams(cell.seed)
    params = {"embedding": inputs.xavier_table(seeds["table"], n_users + n_items, D, dev)}
    optimizer = Adam(tr["lr"])
    opt_state = optimizer.init(params)
    cap = tr["batch_edge_cap"]
    _, run_steps = make_train_fns(
        LightGCNConfig(n_users + n_items, D, L), optimizer, B, tr["decay"],
        batch_embed_fn=lambda p, fb_, us, po, ne: fast_batch_embeddings(p, fb_, L, us, po, ne, edge_cap=cap),
    )
    gen = torch.Generator(device=dev).manual_seed(inputs.torch_seed(seeds["sampler"]))

    # The first steps: the window's call, one step a call, with the triples
    # each drew (the sampler's stream replayed from its state).
    p0 = params["embedding"].clone()
    losses, batches, dropped, grad, grad_norm = [], [], 0.0, None, None
    for k in range(cell.mix["check_steps"]):
        before = gen.get_state()
        params, opt_state, m = run_steps(params, opt_state, fb, sdata, gen, 1)
        replay = torch.Generator(device=dev)
        replay.set_state(before)
        batches.append(tuple(t.cpu() for t in sample_batch(replay, sdata, B)))
        losses.append(m["loss"])
        dropped += m["dropped_arcs"]
        if k == 0:
            grad = (opt_state.exp_avg["embedding"] / (1 - optimizer.b1)).cpu()
            grad_norm = float(grad.double().norm())
    change_norm = float((params["embedding"] - p0).double().norm())
    del p0
    log(f"check steps: losses {losses}, grad norm {grad_norm!r}, change norm {change_norm!r}, "
        f"dropped arcs {dropped}")

    alpha = torch.full((L + 1,), 1.0 / (L + 1), dtype=torch.float32, device=dev)
    st = types.SimpleNamespace(
        u=u, i=i, w=w, fb=fb, sdata=sdata, params=params, opt_state=opt_state, run_steps=run_steps,
        gen=gen, program={"losses": losses, "grad": grad, "grad_norm": grad_norm, "change_norm": change_norm,
                          "batches": batches},
        shape=program.graph_shape(u, i, n_users, n_items, D, L), precision=prec,
    )

    def x_users():
        return st.params["embedding"][:n_users]

    def x_items():
        return st.params["embedding"][n_users:]

    # The layers alone, for the per-layer readers.
    st.ops = {
        "chain": lambda: item_chain_core(x_items(), x_items(), lambda x: x, st.fb.item_op, L, alpha),
        "to_items": lambda: fast_to_items(x_users(), st.fb.fops),
        "to_users": lambda: fast_to_users(x_items(), st.fb.fops),
    }

    def time_steps(n: int) -> float:
        """Seconds a step over ``n`` steps of the window's call."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        st.params, st.opt_state, _ = run_steps(st.params, st.opt_state, st.fb, st.sdata, st.gen, n)
        return (time.perf_counter() - t) / n

    st.time_steps = time_steps
    return st


def window(cell, st, seconds: float) -> Window:
    chunk = int(cell.mix["steps_per_call"])
    steps, bad, dropped = 0, 0, 0.0
    t0 = time.perf_counter()
    while True:
        st.params, st.opt_state, m = st.run_steps(st.params, st.opt_state, st.fb, st.sdata, st.gen, chunk)
        steps += chunk
        bad += 0 if math.isfinite(m["loss"]) else chunk
        dropped += m["dropped_arcs"] * chunk
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    log(f"window: {steps} steps in {elapsed:.6f} s, last mean loss {m['loss']!r}, dropped arcs {dropped}")
    return Window(metrics={"train_step_ms": elapsed / steps * 1e3}, attempted=steps, failed=bad)


def release(cell, st) -> None:
    st.fb = st.sdata = st.params = st.opt_state = st.run_steps = st.ops = st.gen = None
    st.time_steps = None


def check(cell, st, win) -> dict:
    """The triples are judged first: each one valid, and together drawn as
    BPR draws them (``sampler_z``). Then the reference follows the first
    steps from the same table on the same triples: the first gradient (its
    distance from the reference's, and its norm) and the norm of the
    table's change, against the program's."""
    dev = torch.device(cell.device)
    prog = st.program
    r = follow(cell, st.u, st.i, st.w, prog["batches"], dev)
    return numbers(prog, r, *judge_triples(cell, st.u, st.i, st.w, prog["batches"]), cell.mix["limits"])


def judge_triples(cell, u, i, w, batches) -> tuple:
    """(bad triples, sampler_z) of the first steps' triples."""
    g = cell.config["graph"]
    n_users, n_items = g["n_users"], g["n_items"]
    purchases = ref.purchase_rows(u, i, w, n_users)
    bad = sum(judge.bad_triples(*b, purchases, n_users, n_items) for b in batches)
    users, pos, neg = (np.concatenate([b[k] for b in batches]) for k in range(3))
    return bad, judge.sampler_z(users, pos, neg, purchases, n_users, n_items)


def follow(cell, u, i, w, batches, dev, quant=None, keep=None) -> dict:
    """The reference (or, with ``quant`` or ``keep``, a control or a planted
    fault in its place) over the run's first steps."""
    model, tr, g = cell.config["model"], cell.config["train"], cell.config["graph"]
    adj = ref.Adjacency(u, i, w, g["n_users"], g["n_items"], dev, quant=quant)
    table0 = inputs.xavier_table(inputs.streams(cell.seed)["table"], g["n_users"] + g["n_items"],
                                 model["embedding_dim"], dev)
    on_dev = [tuple(t.to(dev) for t in b) for b in batches]
    return ref.follow_steps(adj, table0, model["num_layers"], on_dev, tr["lr"], tr["decay"], keep=keep)


def numbers(prog: dict, r: dict, bad: int, z: float, limits: dict) -> dict:
    """Each number compared, beside its limit. The losses' gap is logged and
    not compared: at the Xavier table every loss is ln 2 to a few f32 ulps,
    and neither the control nor a planted fault reads far enough above the
    program (``PERF.md``)."""
    log(f"loss gap (not compared): {loss_gap(prog, r)!r}")
    return {
        "bad_triples": (float(bad), limits["bad_triples"]),
        "sampler_z": (z, limits["sampler_z"]),
        "grad_gap": (judge.diff_gap(prog["grad"], r["grad"]), limits["grad_gap"]),
        "grad_norm_gap": (judge.norm_gap(prog["grad_norm"], r["grad_norm"]), limits["grad_norm_gap"]),
        "change_norm_gap": (judge.norm_gap(prog["change_norm"], r["change_norm"]), limits["change_norm_gap"]),
    }


def loss_gap(prog: dict, r: dict) -> float:
    return max(judge.norm_gap(a, b) for a, b in zip(prog["losses"], r["losses"]))


def sampled_batches(cell, u, i, w, dev) -> list:
    """The first steps' triples as the program's sampler draws them from the
    run's seed (for a control that stands in the program's place)."""
    g, tr = cell.config["graph"], cell.config["train"]
    sdata = make_sampler_data(program.sampler_arrays(u, i, w, g["n_users"]), g["n_users"], g["n_items"], dev)
    gen = torch.Generator(device=dev).manual_seed(inputs.torch_seed(inputs.streams(cell.seed)["sampler"]))
    return [tuple(t.cpu() for t in sample_batch(gen, sdata, tr["batch_size"]))
            for _ in range(cell.mix["check_steps"])]


def by_purchase(cell, u, i, w) -> list:
    """A planted sampler fault: each step's users and positives drawn as a
    purchase uniformly (so a user as often as it bought), the negatives as
    BPR draws them; every triple valid."""
    g, tr = cell.config["graph"], cell.config["train"]
    n_users, n_items, B = g["n_users"], g["n_items"], tr["batch_size"]
    indptr, items = ref.purchase_rows(u, i, w, n_users)
    owner = np.repeat(np.arange(n_users), np.diff(indptr))
    bought = owner * n_items + items  # ascending
    rng = np.random.default_rng(inputs.streams(cell.seed)["sampler"])
    out = []
    for _ in range(cell.mix["check_steps"]):
        k = rng.integers(len(items), size=B)
        users, neg = owner[k], rng.integers(n_items, size=B)
        while True:
            at = np.minimum(np.searchsorted(bought, users * n_items + neg), len(bought) - 1)
            hit = bought[at] == users * n_items + neg
            if not hit.any():
                break
            neg[hit] = rng.integers(n_items, size=int(hit.sum()))
        out.append(tuple(torch.as_tensor(x) for x in (users, items[k] + n_users, neg + n_users)))
    return out


def controls(cell) -> dict:
    """{kind: {number: value}} of the control (the reference in fp8 in the
    program's place), the planted half batch (the mean over the first half)
    and the planted sampler fault, on the program's sampler's triples drawn
    from the seed; the program itself is not built."""
    from benchmark.reference.precision import FP8

    dev = torch.device(cell.device)
    (u, i, w), _ = inputs.graph_edges(cell.config, cell.seed, cell.device)
    batches = sampled_batches(cell, u, i, w, dev)
    bad, z = judge_triples(cell, u, i, w, batches)
    r = follow(cell, u, i, w, batches, dev)
    limits = cell.mix["limits"]
    out = {"program_sampler": {"bad_triples": float(bad), "sampler_z": z}}
    for kind, kw in (("control_fp8", {"quant": FP8}), ("half_batch", {"keep": cell.config["train"]["batch_size"] // 2})):
        c = follow(cell, u, i, w, batches, dev, **kw)
        out[kind] = {**{k: v for k, (v, _) in numbers(c, r, bad, z, limits).items()}, "loss_gap": loss_gap(c, r)}
        del c
    fault_bad, fault_z = judge_triples(cell, u, i, w, by_purchase(cell, u, i, w))
    out["users_by_purchase"] = {"bad_triples": float(fault_bad), "sampler_z": fault_z}
    return out
