"""Driver ``train_cl_steps``: closed-loop SimGCL training steps on the main path.

Set-up builds what ``train/driver.py``'s one-device fast branch builds for
``model="simgcl"``: the graph, ``build_fast_bipartite`` with the
configuration's precision and heavy head, the sampler, Adam, and
``make_train_fns`` over ``models/simgcl.py:make_simgcl_loss_fn`` (the clean
B_ii BPR term with the configuration's layer weights, and two perturbed
full-graph views whose noise a generator seeded from the run's seed draws).
It drives the first ``check_steps`` steps with the window's own call
(``run_steps``), one step a call, keeping each step's triples (the
sampler's stream replayed from its state) and the noise generator's state
before it: they warm every shape, and the reference follows them. The
window then calls ``run_steps`` ``steps_per_call`` steps at a time, as
``train_steps`` does; ``train_step_ms`` is its seconds over its steps. No
eval, no save.

``check`` judges the triples (``bad_triples``, ``sampler_z``), counts the
batch arcs dropped (check steps and window), and has
``reference/simgcl.py`` follow the first steps from the same table on the
same triples and the same noise: the first gradient (its distance from the
reference's, its norm), the norm of the table's change after the last of
them, and the first step's contrastive term (``cl_loss_gap``).
"""
from __future__ import annotations

import math
import time
import types

import numpy as np
import torch

from gnn_ecommerce_tpu_torch.graph.build import build_graph
from gnn_ecommerce_tpu_torch.models.lightgcn import LightGCNConfig
from gnn_ecommerce_tpu_torch.models.simgcl import make_simgcl_loss_fn
from gnn_ecommerce_tpu_torch.ops.bipartite import build_fast_bipartite
from gnn_ecommerce_tpu_torch.sampling.bpr import make_sampler_data, sample_batch
from gnn_ecommerce_tpu_torch.train.step import Adam, make_train_fns

from benchmark import inputs, program
from benchmark.drivers import train_steps as base
from benchmark.harness import Window, log
from benchmark.reference import judge
from benchmark.reference import lightgcn as lref
from benchmark.reference import simgcl as ref


def noise_stream(seed: int) -> np.random.SeedSequence:
    """The noise generator's stream: the child of the run's seed after
    ``inputs.STREAMS``' own."""
    return np.random.SeedSequence(int(seed), spawn_key=(len(inputs.STREAMS),))


def noise_generator(seed: int, dev) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(inputs.torch_seed(noise_stream(seed)))


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
    cfg = LightGCNConfig(n_users + n_items, D, L, alpha=tuple(model["layer_weights"]))
    noise = noise_generator(cell.seed, dev)
    loss_fn = make_simgcl_loss_fn(cfg, tr["decay"], model["cl_weight"], model["cl_eps"], model["cl_temp"],
                                  tr["batch_edge_cap"], noise)
    _, run_steps = make_train_fns(cfg, optimizer, B, tr["decay"], loss_fn=loss_fn)
    gen = torch.Generator(device=dev).manual_seed(inputs.torch_seed(seeds["sampler"]))

    # The first steps: the window's call, one step a call, with the triples
    # each drew and the noise generator's state before it.
    p0 = params["embedding"].clone()
    losses, cls, batches, states, dropped, grad, grad_norm = [], [], [], [], 0.0, None, None
    for k in range(cell.mix["check_steps"]):
        before = gen.get_state()
        states.append(noise.get_state())
        params, opt_state, m = run_steps(params, opt_state, fb, sdata, gen, 1)
        replay = torch.Generator(device=dev)
        replay.set_state(before)
        batches.append(tuple(t.cpu() for t in sample_batch(replay, sdata, B)))
        losses.append(m["loss"])
        cls.append(m["loss"] - m["bpr_loss"] - m["reg_loss"])
        dropped += m["dropped_arcs"]
        if k == 0:
            grad = (opt_state.exp_avg["embedding"] / (1 - optimizer.b1)).cpu()
            grad_norm = float(grad.double().norm())
    change_norm = float((params["embedding"] - p0).double().norm())
    del p0
    log(f"check steps: losses {losses}, contrastive terms {cls}, grad norm {grad_norm!r}, "
        f"change norm {change_norm!r}, dropped arcs {dropped}")

    shape = program.graph_shape(u, i, n_users, n_items, D, L)
    shape.update(batch=B, unique_users=float(np.mean([len(np.unique(b[0])) for b in batches])),
                 unique_pos=float(np.mean([len(np.unique(b[1])) for b in batches])))
    st = types.SimpleNamespace(
        u=u, i=i, w=w, fb=fb, sdata=sdata, params=params, opt_state=opt_state, run_steps=run_steps,
        gen=gen, program={"losses": losses, "cl": cls, "grad": grad, "grad_norm": grad_norm,
                          "change_norm": change_norm, "batches": batches, "noise_states": states,
                          "dropped_arcs": dropped},
        shape=shape, precision=prec,
    )

    def time_steps(n: int) -> float:
        """Seconds a step over ``n`` steps of the window's call."""
        if dev.type == "cuda":
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
    return Window(metrics={"train_step_ms": elapsed / steps * 1e3}, attempted=steps, failed=bad,
                  extra={"dropped_arcs": dropped})


def release(cell, st) -> None:
    st.fb = st.sdata = st.params = st.opt_state = st.run_steps = st.gen = None
    st.time_steps = None


def check(cell, st, win) -> dict:
    dev = torch.device(cell.device)
    prog = st.program
    r = follow(cell, st.u, st.i, st.w, prog["batches"], prog["noise_states"], dev)
    bad, z = base.judge_triples(cell, st.u, st.i, st.w, prog["batches"])
    dropped = prog["dropped_arcs"] + (win.extra or {}).get("dropped_arcs", 0.0)
    return numbers(prog, r, bad, z, dropped, cell.mix["limits"])


def follow(cell, u, i, w, batches, states, dev, quant=None, **fault) -> dict:
    """The reference (or, with ``quant`` or a ``fault`` of
    ``reference/simgcl.py``'s, or ``eps``, a control or a planted fault in
    its place) over the run's first steps."""
    model, tr, g = cell.config["model"], cell.config["train"], cell.config["graph"]
    adj = lref.Adjacency(u, i, w, g["n_users"], g["n_items"], dev, quant=quant)
    table0 = inputs.xavier_table(inputs.streams(cell.seed)["table"], g["n_users"] + g["n_items"],
                                 model["embedding_dim"], dev)
    on_dev = [tuple(t.to(dev) for t in b) for b in batches]
    eps = fault.pop("eps", model["cl_eps"])
    return ref.follow_steps(adj, table0, model["num_layers"], on_dev, states, tr["lr"], tr["decay"],
                            model["cl_weight"], eps, model["cl_temp"], **fault)


def numbers(prog: dict, r: dict, bad: int, z: float, dropped: float, limits: dict) -> dict:
    """Each number compared, beside its limit. The losses' gap is logged and
    not compared (``PERF.md``)."""
    log(f"loss gap (not compared): {base.loss_gap(prog, r)!r}")
    return {
        "bad_triples": (float(bad), limits["bad_triples"]),
        "sampler_z": (z, limits["sampler_z"]),
        "dropped_arcs": (float(dropped), limits["dropped_arcs"]),
        "grad_gap": (judge.diff_gap(prog["grad"], r["grad"]), limits["grad_gap"]),
        "grad_norm_gap": (judge.norm_gap(prog["grad_norm"], r["grad_norm"]), limits["grad_norm_gap"]),
        "change_norm_gap": (judge.norm_gap(prog["change_norm"], r["change_norm"]), limits["change_norm_gap"]),
        "cl_loss_gap": (judge.norm_gap(prog["cl"][0], r["cl"][0]), limits["cl_loss_gap"]),
    }


def noise_states(cell, dev) -> list:
    """The noise generator's state before each of the first steps, as the
    program's loss leaves it: each step draws ``2·L`` [N, D] tables."""
    model, g = cell.config["model"], cell.config["graph"]
    shape = (g["n_users"] + g["n_items"], model["embedding_dim"])
    gen = noise_generator(cell.seed, dev)
    states = []
    for _ in range(cell.mix["check_steps"]):
        states.append(gen.get_state())
        for _ in range(2 * model["num_layers"]):
            torch.rand(shape, generator=gen, device=dev)
    return states


def controls(cell) -> dict:
    """{kind: {number: value}} of the control (the reference in fp8 in the
    program's place) and the planted faults (no noise; InfoNCE over all B
    rows, duplicates kept; layer 0 in every mean; users drawn by purchase),
    on the program's sampler's triples and noise drawn from the seed; the
    program itself is not built."""
    from benchmark.reference.precision import FP8

    dev = torch.device(cell.device)
    (u, i, w), _ = inputs.graph_edges(cell.config, cell.seed, cell.device)
    batches = base.sampled_batches(cell, u, i, w, dev)
    states = noise_states(cell, dev)
    bad, z = base.judge_triples(cell, u, i, w, batches)
    r = follow(cell, u, i, w, batches, states, dev)
    limits = cell.mix["limits"]
    out = {"program_sampler": {"bad_triples": float(bad), "sampler_z": z}}
    for kind, kw in (("control_fp8", {"quant": FP8}), ("no_noise", {"eps": 0.0}),
                     ("duplicates_kept", {"unique": False}), ("layer0_in_mean", {"with_layer0": True})):
        c = follow(cell, u, i, w, batches, states, dev, **kw)
        out[kind] = {**{k: v for k, (v, _) in numbers(c, r, bad, z, 0.0, limits).items()},
                     "loss_gap": base.loss_gap(c, r)}
        del c
    fault_bad, fault_z = base.judge_triples(cell, u, i, w, base.by_purchase(cell, u, i, w))
    out["users_by_purchase"] = {"bad_triples": float(fault_bad), "sampler_z": fault_z}
    return out
