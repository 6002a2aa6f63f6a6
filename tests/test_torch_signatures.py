"""Every public signature that the port shares with the JAX package keeps
JAX's parameters in JAX's order.

The guard walks every module of ``gnn_ecommerce_tpu`` that the port also
has, and in it every public function, class ``__init__`` and public method
that the port's module also defines. The port's parameter names must start
with JAX's, in order and of the same kind (JAX's private ``_``-prefixed
parameters aside); only trailing port-only parameters (``device``) may
follow. ``DELIBERATE`` lists the differences kept on purpose, each with the
reason that ``ROADMAP.md``'s "Faults in the port against the reference" records;
an entry that no longer differs, or that the section does not name, fails.

Then each signature repaired to JAX's is called positionally and by keyword
in both packages on the same numpy inputs (the tolerance stated at each).
Exact checks unless a tolerance is given.
"""
import importlib
import inspect
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnn_ecommerce_tpu.ops import bipartite as jbip
from gnn_ecommerce_tpu_torch.ops import bipartite as tbip
from gnn_ecommerce_tpu_torch.ops import spmm_fast as tfast
from torch_port_case import graphs, normal, small_arcs

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = "gnn_ecommerce_tpu", "gnn_ecommerce_tpu_torch"

# Module-relative names of the deliberate differences, with their reasons
# (ROADMAP.md, "Faults in the port against the reference").
DELIBERATE = {
    "data.prepare.PreparedData.__init__": "ETL: the port's containers carry no pandas frames",
    "data.prepare.prepare_splits": "ETL: numpy Edges in the place of JAX's three frames",
    "models.lightgcn.init_params": "Generators: a torch.Generator in the slot of JAX's key",
    "models.svd.init_svd": "Generators: a torch.Generator in the slot of JAX's key",
    "sampling.bpr.sample_batch": "Generators: a torch.Generator in the slot of JAX's key",
    "ops.spmm_fast.SegReducePlan.__init__": "K1's plan: warp chunks of a CSR (short rows packed), no TPU tile",
    "ops.spmm_fast.build_segreduce_plan": "K1's plan has no TPU tile: no ot",
    "ops.spmm_fast.gather_segreduce": "no interpret mode: a CPU table takes the plain version",
    "ops.spmm_fast.BucketedSegReducePlan.__init__": "its buckets are K1's plans: no TPU tile, no ot",
    "ops.spmm_fast.build_bucketed_segreduce_plan": "its buckets are K1's plans: no TPU tile, no ot",
    "ops.spmm_fast.gather_segreduce_bucketed": "no interpret mode: a CPU table takes the plain version",
    "ops.spmm_sharded.PlanStack.__init__": "a rank holds its own plan unpadded, not a stack",
    "ops.spmm_sharded.ShardedFastOps.__init__": "collectives by process group: no shard_map axes",
    "parallel.edge_partition.build_edge_partition": "a rank builds its own part: the mesh, not n_shards",
}


def _port_modules() -> list[str]:
    names = []
    for path in sorted((ROOT / PORT_PKG).rglob("*.py")):
        parts = list(path.relative_to(ROOT / PORT_PKG).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        if parts and (ROOT / JAX_PKG / pathlib.Path(*parts)).with_suffix(".py").exists():
            names.append(".".join(parts))
    return names


SHARED = _port_modules()


def _params(obj):
    try:
        return list(inspect.signature(obj).parameters.values())
    except (TypeError, ValueError):
        return None


def _pairs(jmod, tmod):
    """(name, JAX callable, port callable) for every public function, class
    ``__init__`` and public method defined in ``jmod`` that ``tmod`` has."""
    for attr, jobj in vars(jmod).items():
        if attr.startswith("_") or getattr(jobj, "__module__", None) != jmod.__name__:
            continue
        tobj = getattr(tmod, attr, None)
        if tobj is None:
            continue
        if inspect.isclass(jobj) and inspect.isclass(tobj):
            yield f"{attr}.__init__", jobj, tobj
            for m in vars(jobj):
                if m.startswith("_") or not callable(getattr(jobj, m)):
                    continue
                if callable(getattr(tobj, m, None)):
                    yield f"{attr}.{m}", getattr(jobj, m), getattr(tobj, m)
        elif callable(jobj) and callable(tobj):  # functions, and JAX's jitted ones
            yield attr, jobj, tobj


def _mismatch(jfn, tfn) -> str | None:
    jp, tp = _params(jfn), _params(tfn)
    if jp is None or tp is None:
        return None
    jp = [p for p in jp if not p.name.startswith("_")]
    want = [(p.name, p.kind) for p in jp]
    got = [(p.name, p.kind) for p in tp[: len(jp)]]
    return None if got == want else f"JAX {[p.name for p in jp]}, port {[p.name for p in tp]}"


def _mismatches(module: str) -> dict:
    jmod = importlib.import_module(f"{JAX_PKG}.{module}")
    tmod = importlib.import_module(f"{PORT_PKG}.{module}")
    out = {}
    for name, jfn, tfn in _pairs(jmod, tmod):
        why = _mismatch(jfn, tfn)
        if why:
            out[f"{module}.{name}"] = why
    return out


def test_shared_modules_found():
    assert len(SHARED) > 40
    for name in ("ops.bipartite", "train.step", "serve.service", "graph.build", "eval.evaluate"):
        assert name in SHARED


@pytest.mark.parametrize("module", SHARED)
def test_signatures_keep_jax_order(module):
    new = {k: v for k, v in _mismatches(module).items() if k not in DELIBERATE}
    assert not new, new


def test_deliberate_differences_are_real_and_recorded():
    text = (ROOT / "ROADMAP.md").read_text()
    section = text[text.index(". Faults in the port against the reference"): text.index("## Recent")]
    found = {}
    for module in {k.rsplit(".", 2)[0] if k.endswith(".__init__") else k.rsplit(".", 1)[0]
                   for k in DELIBERATE}:
        found.update(_mismatches(module))
    for key in DELIBERATE:
        assert key in found, f"{key} no longer differs: drop it from DELIBERATE and ROADMAP"
        name = key.removesuffix(".__init__").rsplit(".", 1)[-1]
        assert f"`{name}" in section, f"ROADMAP.md's faults section does not record {name}"


# ---------------------------------------------------------------------------
# The repaired signatures, positionally and by keyword against JAX.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def case():
    u, i, w, n_u, n_i = small_arcs()
    jgraph, tgraph = graphs(u, i, w, n_u, n_i)
    return (u, i, w, n_u, n_i), jgraph, tgraph, jbip.split_graph(jgraph), tbip.split_graph(tgraph)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def services():
    """Port and JAX services on the committed fixture, built positionally
    with ``warm=False``; the warm-up's recommend calls counted."""
    from gnn_ecommerce_tpu.data.artifacts import load_prepared as jax_load_prepared
    from gnn_ecommerce_tpu.models import LightGCNConfig as JaxConfig
    from gnn_ecommerce_tpu.serve import RecommenderService as JaxService
    from gnn_ecommerce_tpu_torch.data.artifacts import load_prepared
    from gnn_ecommerce_tpu_torch.models.lightgcn import LightGCNConfig
    from gnn_ecommerce_tpu_torch.serve import RecommenderService
    from gnn_ecommerce_tpu_torch.train.checkpoint import load_checkpoint

    data, ckpt = str(ROOT / "data" / "prepared"), str(ROOT / "model-checkpoints")
    prepared = load_prepared(data)
    leaves, meta = load_checkpoint(ckpt, "LightGCN_best")
    cfg = RecommenderService._config(meta, prepared, LightGCNConfig(0))
    params = RecommenderService._checkpoint_params(leaves, meta, cfg, torch.device("cpu"))
    jcfg = JaxConfig(cfg.num_nodes, cfg.embedding_dim, cfg.num_layers)
    jparams = {"embedding": jnp.asarray(params["embedding"].numpy())}
    calls = {}
    out = {}
    for label, cls, args in (
        ("port", RecommenderService, (prepared, params, cfg)),
        ("jax", JaxService, (jax_load_prepared(data), jparams, jcfg)),
    ):
        orig = cls.recommend

        def counting(self, *a, _orig=orig, _label=label, **k):
            calls[_label] = calls.get(_label, 0) + 1
            return _orig(self, *a, **k)

        cls.recommend = counting
        try:
            if label == "port":
                out["port_pos"] = cls(*args, 20, "neginf", False, device="cpu")
                out["port_kw"] = cls(*args, k=20, mask_mode="neginf", warm=False, device="cpu")
            else:
                out["jax_pos"] = cls(*args, 20, "neginf", False)
        finally:
            cls.recommend = orig
    out["calls"] = calls
    return out


def test_service_warm_false_positional_matches_jax(services):
    assert services["calls"] == {}, "warm=False ran the warm-up"
    users = np.arange(12)
    ref = services["jax_pos"].recommend(users)
    for key in ("port_pos", "port_kw"):
        svc = services[key]
        assert svc.quantized is False and svc.warmup_s == 0.0
        np.testing.assert_array_equal(svc.recommend(users), ref)
    assert services["jax_pos"].quantized is False


def _fixed_batch_step_jax(monkeypatch, jgraph, emb, batches, positional: bool, prop):
    from gnn_ecommerce_tpu.models import LightGCNConfig as JaxConfig
    from gnn_ecommerce_tpu.train import step as jstep

    cfg = JaxConfig(jgraph.num_nodes, emb.shape[1], 2)
    opt = optax.adam(5e-3)
    params = {"embedding": jnp.asarray(emb)}
    state = opt.init(params)
    for users, pos, neg in batches:
        batch = tuple(jnp.asarray(a, jnp.int32) for a in (users, pos, neg))
        monkeypatch.setattr(jstep, "sample_batch", lambda *a, _b=batch, **k: _b)
        if positional:
            step, _ = jstep.make_train_fns(cfg, opt, len(users), 1e-4, prop, True)
        else:
            step, _ = jstep.make_train_fns(cfg, opt, len(users), 1e-4, propagate_fn=prop)
        params, state, _ = step(params, state, jgraph, None, jax.random.key(0))
    return np.asarray(params["embedding"])


@pytest.mark.parametrize("positional", [True, False])
def test_make_train_fns_propagate_fn_matches_jax(case, monkeypatch, positional):
    """Two layered Adam steps with ``propagate_segment_chunked`` (3 chunks)
    as each layer, on fixed numpy batches, against JAX's
    ``make_train_fns(..., propagate_fn)``. Bounds of
    ``test_torch_train_step.py::test_five_step_parameters_match_jax``: the
    change within 1e-4 relative Frobenius, every entry within 2·lr."""
    from gnn_ecommerce_tpu.ops.propagate import propagate_segment_chunked as jchunked
    from gnn_ecommerce_tpu_torch.models.lightgcn import LightGCNConfig
    from gnn_ecommerce_tpu_torch.ops.propagate import propagate_segment_chunked
    from gnn_ecommerce_tpu_torch.train import step as tstep

    (_, _, _, n_u, n_i), jgraph, tgraph, _, _ = case
    rng = np.random.default_rng(11)
    batches = [(rng.integers(0, n_u, 32), n_u + rng.integers(0, n_i, 32), n_u + rng.integers(0, n_i, 32))
               for _ in range(2)]
    emb = np.random.default_rng(12).uniform(-0.3, 0.3, (jgraph.num_nodes, 8)).astype(np.float32)
    ref = _fixed_batch_step_jax(monkeypatch, jgraph, emb, batches, positional,
                                lambda g, x: jchunked(g, x, 3))
    calls = []

    def prop(g, x):
        calls.append(1)
        return propagate_segment_chunked(g, x, 3)

    cfg = LightGCNConfig(tgraph.num_nodes, 8, 2)
    adam = tstep.Adam(5e-3)
    if positional:
        step, _ = tstep.make_train_fns(cfg, adam, 32, 1e-4, prop, True)
    else:
        step, _ = tstep.make_train_fns(cfg, adam, 32, 1e-4, propagate_fn=prop)
    it = iter([tuple(_t(a) for a in b) for b in batches])
    monkeypatch.setattr(tstep, "sample_batch", lambda *a, **k: next(it))
    params = {"embedding": _t(emb.copy())}
    state = adam.init(params)
    for _ in batches:
        params, state, _ = step(params, state, tgraph, None, None)
    out = params["embedding"].numpy()
    assert len(calls) == 2 * 2  # two layers a step
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref - emb) < 1e-4
    assert np.abs(out - ref).max() <= 2 * 5e-3


@pytest.mark.parametrize("positional", [True, False])
def test_build_fast_bipartite_signature_matches_jax(case, positional):
    """JAX's positional and keyword forms build the same kind of operator
    in both packages (bf16 B_ii, messages and a 50-user head); forwards
    within the bf16 bound of test_torch_bipartite.py (1e-2 relative)."""
    _, jgraph, tgraph, _, _ = case
    args = ("bfloat16", 50, "bfloat16", 0, 1e6)
    if positional:
        jfb = jbip.build_fast_bipartite(jgraph, jnp.bfloat16, True, *args)
        tfb = tbip.build_fast_bipartite(tgraph, torch.bfloat16, True, *args, device="cpu")
    else:
        kw = dict(fast_ops=True, msgs_dtype="bfloat16", heavy_users=50, heavy_dtype="bfloat16",
                  src_buckets=0, band_bytes=1e6)
        jfb = jbip.build_fast_bipartite(jgraph, dtype=jnp.bfloat16, **kw)
        tfb = tbip.build_fast_bipartite(tgraph, dtype=torch.bfloat16, device="cpu", **kw)
    assert tfb.fops.msgs_dtype == jfb.fops.msgs_dtype == "bfloat16"
    assert tfb.fops.w_hi.dtype == torch.bfloat16 and tfb.item_op.dtype == torch.bfloat16
    emb = normal(13, (jgraph.num_nodes, 8))
    ref = np.asarray(jbip.fast_get_embedding({"embedding": jnp.asarray(emb)}, jfb, 3))
    out = tbip.fast_get_embedding({"embedding": _t(emb)}, tfb, 3).numpy()
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) <= 1e-2
    # src_buckets in its positional slot: 2 src buckets, f32 (2e-5 of max|ref|).
    jfb = jbip.build_fast_bipartite(jgraph, jnp.float32, True, "float32", 0, "float32", 2)
    tfb = tbip.build_fast_bipartite(tgraph, torch.float32, True, "float32", 0, "float32", 2, device="cpu")
    assert len(tfb.fops.items_plan.buckets) == len(jfb.fops.items_plan.buckets) == 2
    ref = np.asarray(jbip.fast_get_embedding({"embedding": jnp.asarray(emb)}, jfb, 3))
    out = tbip.fast_get_embedding({"embedding": _t(emb)}, tfb, 3).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5 * np.abs(ref).max())


def test_build_fast_ops_src_buckets_slot(case):
    """``src_buckets`` in JAX's positional slot, 0 and 4 (the bucketed
    to_items plan), with a 50-user head: fast_to_items as JAX's (2e-5)."""
    _, _, _, jsplit, tsplit = case
    x = normal(14, (tsplit.n_users, 6))
    for buckets in (0, 4):
        jf = jbip.build_fast_ops(jsplit, "float32", 50, "float32", buckets)
        tf = tbip.build_fast_ops(tsplit, "float32", 50, "float32", buckets, "cpu")
        assert isinstance(tf.items_plan, tfast.BucketedSegReducePlan) == (buckets > 0)
        np.testing.assert_allclose(tbip.fast_to_items(_t(x), tf).numpy(),
                                   np.asarray(jbip.fast_to_items(jnp.asarray(x), jf)), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("positional", [True, False])
def test_split_heavy_users_build_head_matches_jax(case, positional):
    _, _, _, jsplit, tsplit = case
    if positional:
        jout = jbip.split_heavy_users(jsplit, 50, "float32", False)
        tout = tbip.split_heavy_users(tsplit, 50, "float32", False, "cpu")
    else:
        jout = jbip.split_heavy_users(jsplit, 50, "float32", build_head=False)
        tout = tbip.split_heavy_users(tsplit, 50, "float32", build_head=False, device="cpu")
    full = tbip.split_heavy_users(tsplit, 50, "float32", device="cpu")
    assert tout[1] is None and jout[1] is None and full[1] is not None
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    for t_arr, j_arr, f_arr in zip(tout[2:8], jout[2:8], full[2:8]):
        np.testing.assert_array_equal(np.asarray(t_arr), np.asarray(j_arr))
        np.testing.assert_array_equal(np.asarray(t_arr), np.asarray(f_arr))
    for t_arr, j_arr in zip(tout[8], jout[8]):
        np.testing.assert_array_equal(t_arr, j_arr)


def test_build_item_operator_chunks_and_bands_match_jax(case, capsys):
    """Positionally, with scatter chunks of 100 pairs, heavy chunks of 4
    users and bands of 3 rows (``band_bytes``), ``verbose`` on: B_ii equals
    JAX's and the port's default build to f32 summation order (2e-5)."""
    _, _, _, jsplit, tsplit = case
    n = tsplit.n_items
    ref = np.asarray(jbip.build_item_operator(jsplit, jnp.float32, 8, 4, 100, 4.0 * n * 3, True))
    out = tbip.build_item_operator(tsplit, torch.float32, 8, 4, 100, 4.0 * n * 3, True, "cpu")
    assert "b_ii phase heavy matmuls" in capsys.readouterr().err
    default = tbip.build_item_operator(tsplit, device="cpu")
    for got in (out, default):
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5 * np.abs(ref).max())


def test_fast_get_embedding_to_users_fn_matches_jax(case):
    _, jgraph, _, jsplit, tsplit = case
    jfb = jbip.FastBipartite(split=jsplit, item_op=jbip.build_item_operator(jsplit))
    tfb = tbip.FastBipartite(tsplit, tbip.build_item_operator(tsplit, device="cpu"))
    emb = normal(15, (jgraph.num_nodes, 8))
    ref = np.asarray(jbip.fast_get_embedding(
        {"embedding": jnp.asarray(emb)}, jfb, 3, None, lambda s: 2.0 * jbip.to_users(s, jsplit)
    ))
    for out in (
        tbip.fast_get_embedding({"embedding": _t(emb)}, tfb, 3, None, lambda s: 2.0 * tbip.to_users(s, tsplit)),
        tbip.fast_get_embedding({"embedding": _t(emb)}, tfb, 3,
                                to_users_fn=lambda s: 2.0 * tbip.to_users(s, tsplit)),
    ):
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    plain = tbip.fast_get_embedding({"embedding": _t(emb)}, tfb, 3).numpy()
    assert not np.allclose(plain, ref)


def test_build_graph_to_device_false_matches_jax(case):
    """``to_device=False`` keeps the arrays on the host whatever ``device``
    says (no card needed), and the graph carries JAX's w_raw, indptr and
    deg."""
    from gnn_ecommerce_tpu.graph import build_graph as jax_build_graph
    from gnn_ecommerce_tpu_torch.graph.build import build_graph

    (u, i, w, n_u, n_i), _, _, _, _ = case
    ref = jax_build_graph(u, i, w, n_u, n_i, to_device=False)
    g = build_graph(u, i, w, n_u, n_i, to_device=False, device="cuda")
    for field in ("src", "dst", "w_norm", "w_raw", "indptr", "deg"):
        got = getattr(g, field)
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(ref, field)))
    assert (g.n_users, g.n_items) == (ref.n_users, ref.n_items)


def test_eval_batch_num_users_positional_matches_jax():
    """``EvalBatch(user_ids, truth, mask, num_users)``: rows past num_users
    are padding that never reaches the means, in both packages."""
    from gnn_ecommerce_tpu.eval.evaluate import EvalBatch as JaxBatch
    from gnn_ecommerce_tpu.eval.evaluate import evaluate as jax_evaluate
    from gnn_ecommerce_tpu_torch.eval.evaluate import EvalBatch, evaluate

    rng = np.random.default_rng(16)
    n_users, n_items, rows = 40, 30, 12
    emb = rng.standard_normal((n_users + n_items, 8)).astype(np.float32)
    uids = rng.integers(0, n_users, rows)
    truth = rng.integers(0, n_items, (rows, 3))
    mask = np.where(rng.random((rows, 4)) < 0.5, rng.integers(0, n_items, (rows, 4)), -1)
    ref = jax_evaluate(jnp.asarray(emb), JaxBatch(jnp.asarray(uids, jnp.int32), jnp.asarray(truth, jnp.int32),
                                                  jnp.asarray(mask, jnp.int32), 9), n_users, 5)
    for batch in (EvalBatch(_t(uids), _t(truth), _t(mask), 9),
                  EvalBatch(user_ids=_t(uids), truth=_t(truth), mask=_t(mask), num_users=9)):
        assert batch.num_users == 9
        got = evaluate(_t(emb), batch, n_users, 5)
        assert len(got[2]) == 9
        np.testing.assert_allclose(got[:2], ref[:2], rtol=1e-6)
        for a, b in zip(got[2:], ref[2:]):
            np.testing.assert_array_equal(a, b)
    assert EvalBatch(_t(uids), _t(truth), _t(mask)).num_users == rows


@pytest.mark.parametrize("name,module", [
    ("shard_params", "parallel.sharded_train"),
    ("pad_params", "parallel.edge_partition"),
    ("split_ep_tree", "parallel.edge_partition_fast"),
    ("ep_to_items", "parallel.edge_partition_fast"),
    ("shard_fast_bipartite", "parallel.sharded_train"),
])
def test_parallel_signatures_bind_as_jax(name, module):
    """JAX's positional and keyword calls bind to the same parameters in
    the port (these need a world; the guard above holds the order)."""
    jfn = getattr(importlib.import_module(f"{JAX_PKG}.{module}"), name)
    tfn = getattr(importlib.import_module(f"{PORT_PKG}.{module}"), name)
    names = [p.name for p in _params(jfn)]
    tsig = inspect.signature(tfn)
    values = [object() for _ in names]
    assert tsig.bind(*values).arguments == dict(zip(names, values))
    assert tsig.bind(**dict(zip(names, values))).arguments == dict(zip(names, values))


def test_parallel_mesh_arguments_must_be_the_partitions(case):
    """``pad_params`` and ``split_ep_tree`` take JAX's ``mesh``: the
    partition's own (what the port's rank-local parts were built on);
    another raises. ``shard_fast_bipartite(fb, mesh)`` with JAX's default
    ``fast_ops=False`` is JAX's GSPMD segment path: on a one-device mesh
    its forward is JAX's (1e-5 of max|ref|); ``tests/test_torch_gspmd_segment.py``
    holds it on two ranks."""
    from gnn_ecommerce_tpu.parallel import make_mesh as jax_make_mesh
    from gnn_ecommerce_tpu.parallel import shard_fast_bipartite as jax_shard_fast_bipartite
    from gnn_ecommerce_tpu_torch.parallel import make_mesh, sharded_fast_embedding
    from gnn_ecommerce_tpu_torch.parallel.edge_partition import pad_params
    from gnn_ecommerce_tpu_torch.parallel.edge_partition_fast import split_ep_tree
    from gnn_ecommerce_tpu_torch.parallel.sharded_train import shard_fast_bipartite, shard_params

    mesh = types.SimpleNamespace(index=lambda axis: 0, shape={"model": 1})
    other = types.SimpleNamespace(index=lambda axis: 0, shape={"model": 1})
    table = torch.arange(12.0).reshape(6, 2)
    part = types.SimpleNamespace(mesh=mesh)
    for call in (lambda: pad_params({"embedding": table}, part, mesh),
                 lambda: pad_params(params={"embedding": table}, part=part)):
        assert torch.equal(call()["embedding"], table)
    with pytest.raises(ValueError, match="mesh"):
        pad_params({"embedding": table}, part, other)
    with pytest.raises(ValueError, match="mesh"):
        split_ep_tree({"embedding": table}, types.SimpleNamespace(mesh=mesh), other)
    _, jgraph, tgraph, _, _ = case
    emb = normal(17, (jgraph.num_nodes, 8))
    jmesh = jax_make_mesh(1)
    with jmesh:
        ref = np.asarray(jbip.fast_get_embedding(
            {"embedding": jnp.asarray(emb)}, jax_shard_fast_bipartite(jbip.build_fast_bipartite(jgraph), jmesh), 3
        ))
    tmesh = make_mesh(1, device="cpu")
    sfb = shard_fast_bipartite(tbip.build_fast_bipartite(tgraph, device="cpu"), tmesh)
    assert sfb.fops is None
    out = sharded_fast_embedding(shard_params({"embedding": _t(emb)}, tmesh), sfb, 3).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
