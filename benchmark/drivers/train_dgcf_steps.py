"""Driver ``train_dgcf_steps``: closed-loop DGCF training steps on the main path.

Set-up builds what ``train/driver.py``'s ``model="dgcf"`` branch builds: the
graph, ``ops/routing.py:build_routing_graph`` (both directions' arcs as one
CSR, the reverse-arc permutation, the intent gather's plan; no B_ii, no
plans of the fast bipartite path, no heavy head), the sampler, Adam, and
``make_train_fns`` over ``models/dgcf.py:make_dgcf_loss_fn`` with the
configuration's intents, iterations, layers, ``cor`` weight and rows, rows
gathered in the configuration's precision, and the ``cor`` rows drawn from a
generator seeded from the run's seed (``train_cl_steps.noise_generator``).
It drives the first ``check_steps`` steps with the window's own call
(``run_steps``), one step a call, keeping each step's triples (the
sampler's stream replayed from its state) and the ``cor`` generator's state
before it: they warm every shape, and the reference follows them. The first
step's last-iteration S is ``dgcf_forward`` of the table before that step,
without grad: the function the step runs, on the same table. The window is ``train_cl_steps``' own:
``run_steps`` ``steps_per_call`` steps at a time; ``train_step_ms`` is its
seconds over its steps. No eval, no save.

``check`` judges the triples (``bad_triples``, ``sampler_z``) and has
``reference/dgcf.py`` follow the first steps from the same table on the
same triples and ``cor`` rows: the first gradient (its distance from the
reference's, its norm), the norm of the table's change after the last of
them, the first step's last-iteration S on every arc and intent
(``routing_gap``, the worst) and its ``cor_weight · cor``
(``cor_loss_gap``).
"""
from __future__ import annotations

import time
import types

import torch

from gnn_ecommerce_tpu_torch.graph.build import build_graph
from gnn_ecommerce_tpu_torch.models.dgcf import dgcf_forward, make_dgcf_loss_fn
from gnn_ecommerce_tpu_torch.ops.routing import build_routing_graph
from gnn_ecommerce_tpu_torch.sampling.bpr import make_sampler_data, sample_batch
from gnn_ecommerce_tpu_torch.train.step import Adam, make_train_fns

from benchmark import inputs, program
from benchmark.drivers import train_cl_steps as cl
from benchmark.drivers import train_steps as base
from benchmark.harness import log
from benchmark.reference import dgcf as ref
from benchmark.reference import judge

GATHER = {"bf16": torch.bfloat16, "f32": None}

window = cl.window


def setup(cell):
    dev = torch.device(cell.device)
    model, tr = cell.config["model"], cell.config["train"]
    D, B = model["embedding_dim"], tr["batch_size"]
    K, T, L = model["n_factors"], model["n_iterations"], model["num_layers"]
    g = cell.config["graph"]
    n_users, n_items = g["n_users"], g["n_items"]
    t0 = time.perf_counter()
    (u, i, w), _ = inputs.graph_edges(cell.config, cell.seed, cell.device)
    log(f"inputs: {len(u)} edges in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    rg = build_routing_graph(build_graph(u, i, w, n_users, n_items, device=dev))
    log(f"routing graph: {rg.n_arcs} arcs, {rg.plan.n_split_rows} split rows, "
        f"{time.perf_counter() - t0:.3f} s")
    sdata = make_sampler_data(program.sampler_arrays(u, i, w, n_users), n_users, n_items, dev)
    seeds = inputs.streams(cell.seed)
    params = {"embedding": inputs.xavier_table(seeds["table"], n_users + n_items, D, dev)}
    optimizer = Adam(tr["lr"])
    opt_state = optimizer.init(params)
    cor_gen = cl.noise_generator(cell.seed, dev)
    gather = GATHER[tr["precision"]]
    loss_fn = make_dgcf_loss_fn(K, T, L, tr["decay"], model["cor_weight"], model["cor_batch"], cor_gen, gather)
    _, run_steps = make_train_fns(None, optimizer, B, tr["decay"], loss_fn=loss_fn)
    gen = torch.Generator(device=dev).manual_seed(inputs.torch_seed(seeds["sampler"]))

    # The first step's last S, in the reference's (head, tail) order; then
    # the first steps: the window's call, one step a call, with the triples
    # each drew and the cor generator's state before it.
    with torch.no_grad():
        _, s = dgcf_forward(params["embedding"], rg, K, T, L, gather)
    order = torch.argsort(rg.head.long() * rg.n_nodes + rg.src.long())
    routing = s[order].cpu()
    del s, order
    p0 = params["embedding"].clone()
    losses, cors, batches, states, grad, grad_norm = [], [], [], [], None, None
    for k in range(cell.mix["check_steps"]):
        before = gen.get_state()
        states.append(cor_gen.get_state())
        params, opt_state, m = run_steps(params, opt_state, rg, sdata, gen, 1)
        replay = torch.Generator(device=dev)
        replay.set_state(before)
        batches.append(tuple(t.cpu() for t in sample_batch(replay, sdata, B)))
        losses.append(m["loss"])
        cors.append(m["loss"] - m["bpr_loss"] - m["reg_loss"])
        if k == 0:
            grad = (opt_state.exp_avg["embedding"] / (1 - optimizer.b1)).cpu()
            grad_norm = float(grad.double().norm())
    change_norm = float((params["embedding"] - p0).double().norm())
    del p0
    log(f"check steps: losses {losses}, cor terms {cors}, grad norm {grad_norm!r}, change norm {change_norm!r}")

    shape = program.graph_shape(u, i, n_users, n_items, D, L)
    shape.update(batch=B, n_factors=K, n_iterations=T, cor_batch=model["cor_batch"])
    # ``fb``: the graph that ``train_cl_steps.window`` hands ``run_steps``.
    st = types.SimpleNamespace(
        u=u, i=i, w=w, rg=rg, fb=rg, sdata=sdata, params=params, opt_state=opt_state, run_steps=run_steps,
        gen=gen, program={"losses": losses, "cor": cors, "grad": grad, "grad_norm": grad_norm,
                          "change_norm": change_norm, "batches": batches, "cor_states": states,
                          "routing": routing},
        shape=shape, precision=tr["precision"],
    )

    def time_steps(n: int) -> float:
        """Seconds a step over ``n`` steps of the window's call."""
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        st.params, st.opt_state, _ = run_steps(st.params, st.opt_state, st.rg, st.sdata, st.gen, n)
        return (time.perf_counter() - t) / n

    st.time_steps = time_steps
    return st


def release(cell, st) -> None:
    st.rg = st.fb = st.sdata = st.params = st.opt_state = st.run_steps = st.gen = None
    st.time_steps = None


def check(cell, st, win) -> dict:
    dev = torch.device(cell.device)
    prog = st.program
    r = follow(cell, st.u, st.i, prog["batches"], prog["cor_states"], dev)
    bad, z = base.judge_triples(cell, st.u, st.i, st.w, prog["batches"])
    return numbers(prog, r, bad, z, cell.mix["limits"])


def follow(cell, u, i, batches, states, dev, quant=None, **fault) -> dict:
    """The reference (or, with ``quant``, ``iterations``, ``cor_weight`` or
    a ``fault`` of ``reference/dgcf.py``'s, a control or a planted fault in
    its place) over the run's first steps."""
    model, tr, g = cell.config["model"], cell.config["train"], cell.config["graph"]
    arcs = ref.Arcs(u, i, g["n_users"], g["n_items"], dev, quant=quant)
    table0 = inputs.xavier_table(inputs.streams(cell.seed)["table"], g["n_users"] + g["n_items"],
                                 model["embedding_dim"], dev)
    on_dev = [tuple(t.to(dev) for t in b) for b in batches]
    iterations = fault.pop("iterations", model["n_iterations"])
    cor_weight = fault.pop("cor_weight", model["cor_weight"])
    return ref.follow_steps(arcs, table0, model["n_factors"], iterations, model["num_layers"], on_dev, states,
                            tr["lr"], tr["decay"], cor_weight, model["cor_batch"], **fault)


def routing_gap(prog_s: torch.Tensor, ref_s: torch.Tensor) -> float:
    """The worst arc and intent: ``max |S − S_ref|`` (both in (head, tail)
    order)."""
    worst = 0.0
    for lo in range(0, ref_s.shape[0], ref.BLOCK):
        part = prog_s[lo:lo + ref.BLOCK].to(ref_s.device) - ref_s[lo:lo + ref.BLOCK]
        worst = max(worst, float(part.abs().max()))
    return worst


def numbers(prog: dict, r: dict, bad: int, z: float, limits: dict) -> dict:
    """Each number compared, beside its limit. The losses' gap is logged and
    not compared (``PERF.md``)."""
    log(f"loss gap (not compared): {base.loss_gap(prog, r)!r}")
    return {
        "bad_triples": (float(bad), limits["bad_triples"]),
        "sampler_z": (z, limits["sampler_z"]),
        "grad_gap": (judge.diff_gap(prog["grad"], r["grad"]), limits["grad_gap"]),
        "grad_norm_gap": (judge.norm_gap(prog["grad_norm"], r["grad_norm"]), limits["grad_norm_gap"]),
        "change_norm_gap": (judge.norm_gap(prog["change_norm"], r["change_norm"]), limits["change_norm_gap"]),
        "routing_gap": (routing_gap(prog["routing"], r["routing"]), limits["routing_gap"]),
        "cor_loss_gap": (judge.norm_gap(prog["cor"][0], r["cor"][0]), limits["cor_loss_gap"]),
    }


def cor_states(cell, dev) -> list:
    """The ``cor`` generator's state before each of the first steps, as the
    program's loss leaves it: each step draws one ``randperm`` of the users
    and one of the items."""
    g = cell.config["graph"]
    gen = cl.noise_generator(cell.seed, dev)
    states = []
    for _ in range(cell.mix["check_steps"]):
        states.append(gen.get_state())
        torch.randperm(g["n_users"], generator=gen, device=dev)
        torch.randperm(g["n_items"], generator=gen, device=dev)
    return states


FAULTS = (("one_iteration", {"iterations": 1}), ("softmax_over_arcs", {"softmax_over": "arcs"}),
          ("no_tanh", {"tanh": False}), ("unrouted_degrees", {"unrouted_degrees": True}),
          ("no_cor", {"cor_weight": 0.0}))


def controls(cell) -> dict:
    """{kind: {number: value}} of the control (the reference with fp8 rows
    in the program's place), the planted faults (T = 1; the softmax over
    arcs; no tanh; the unrouted graph's degrees; no cor term) and the planted
    sampler fault (users drawn by purchase), on the program's sampler's
    triples and cor rows drawn from the seed; the program itself is not
    built. The reference's own last S stands in for the program's."""
    from benchmark.reference.precision import FP8

    dev = torch.device(cell.device)
    (u, i, w), _ = inputs.graph_edges(cell.config, cell.seed, cell.device)
    batches = base.sampled_batches(cell, u, i, w, dev)
    states = cor_states(cell, dev)
    bad, z = base.judge_triples(cell, u, i, w, batches)
    r = follow(cell, u, i, batches, states, dev)
    limits = cell.mix["limits"]
    out = {"program_sampler": {"bad_triples": float(bad), "sampler_z": z}}
    for kind, kw in (("control_fp8", {"quant": FP8}),) + FAULTS:
        c = follow(cell, u, i, batches, states, dev, **kw)
        out[kind] = {**{k: v for k, (v, _) in numbers(c, r, bad, z, limits).items()},
                     "loss_gap": base.loss_gap(c, r)}
        del c
    fault_bad, fault_z = base.judge_triples(cell, u, i, w, base.by_purchase(cell, u, i, w))
    out["users_by_purchase"] = {"bad_triples": float(fault_bad), "sampler_z": fault_z}
    return out
