"""The sweeps (``runs/heavy_k_sweep_r3.py``, ``runs/depth_dim_sweep_r3.py``)
on the CPU, against the JAX package on the same arcs and weights.

- Heavy K: both directions of the bf16 fast pair at each head size equal
  JAX's at ``rtol=atol=2e-5`` (``test_torch_spmm_fast.py``'s
  ``test_fast_pair_matches_jax``), and the run's records carry the
  script's keys, every output held to the f32 sparse product.
- Depth and dim: the bf16 fast forward at 4 and 5 layers and two widths
  equals JAX's to a relative norm of 1e-2 (``test_torch_bipartite.py``'s
  ``test_fast_get_embedding_bf16_matches_jax``); the layered forward on
  the chunked propagation equals JAX's at 2e-5
  (``test_layered_get_embedding_matches_jax``); the run's records carry
  the script's keys, every fast corner held to the layered forward.
- The bars: held on passing lines, missed on an output not held or a
  number not finite; each ``main`` on the CPU's bench shape.
"""
import json
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_ecommerce_tpu.models import LightGCNConfig as JaxConfig
from gnn_ecommerce_tpu.models import get_embedding as jax_get_embedding
from gnn_ecommerce_tpu.ops import bipartite as jbip
from gnn_ecommerce_tpu.ops.propagate import propagate_segment_chunked as jax_chunked
from gnn_ecommerce_tpu_torch.convert import params_to_torch
from gnn_ecommerce_tpu_torch.models.lightgcn import LightGCNConfig, get_embedding
from gnn_ecommerce_tpu_torch.ops import bipartite as tbip
from gnn_ecommerce_tpu_torch.runs import bars, depth_dim_sweep_r3, heavy_k_sweep_r3
from torch_port_case import graphs, normal, small_arcs

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
HEAVY_KS = (0, 16, 32)
WIDTHS = (16, 24)


@pytest.fixture(scope="module")
def small():
    jgraph, tgraph = graphs(*small_arcs())
    return jgraph, tgraph, jbip.split_graph(jgraph), tbip.split_graph(tgraph)


def _tpu(name: str):
    return json.loads((ROOT / "scripts" / f"{name}.json").read_text())


def _params(graph, dim, seed=0):
    """The same numpy weights for both packages."""
    bound = (6.0 / (graph.num_nodes + dim)) ** 0.5
    emb = np.random.default_rng(seed).uniform(-bound, bound, (graph.num_nodes, dim)).astype(np.float32)
    return {"embedding": jnp.asarray(emb)}, params_to_torch({"embedding": emb}, "cpu")


@pytest.mark.parametrize("k", HEAVY_KS)
def test_heavy_k_pair_matches_jax(small, k):
    _, _, jsplit, tsplit = small
    head = "bfloat16" if k else "float32"
    jfops = jbip.build_fast_ops(jsplit, msgs_dtype="bfloat16", heavy_users=k, heavy_dtype=head)
    tfops = tbip.build_fast_ops(tsplit, msgs_dtype="bfloat16", heavy_users=k, heavy_dtype=head,
                                device="cpu")
    assert (tfops.w_hi is None) == (k == 0)
    x = normal(3, (tsplit.n_users, 16))
    np.testing.assert_allclose(
        tbip.fast_to_items(torch.from_numpy(x), tfops).numpy(),
        np.asarray(jbip.fast_to_items(jnp.asarray(x), jfops)), rtol=2e-5, atol=2e-5,
    )
    y = normal(4, (tsplit.n_items, 16))
    np.testing.assert_allclose(
        tbip.fast_to_users(torch.from_numpy(y), tfops).numpy(),
        np.asarray(jbip.fast_to_users(jnp.asarray(y), jfops)), rtol=2e-5, atol=2e-5,
    )


def test_heavy_k_inputs_are_the_scripts(small):
    _, _, _, tsplit = small
    x_u, x_i = heavy_k_sweep_r3.inputs(tsplit, torch.device("cpu"))
    want_u = np.random.default_rng(0).standard_normal((tsplit.n_users, 80)).astype(np.float32)
    want_i = np.random.default_rng(1).standard_normal((tsplit.n_items, 80)).astype(np.float32)
    assert np.array_equal(x_u.numpy(), want_u) and np.array_equal(x_i.numpy(), want_i)


def test_heavy_k_run_records(small):
    _, _, _, tsplit = small
    seen = []
    records = heavy_k_sweep_r3.run(tsplit, ks=HEAVY_KS, reps=1, device="cpu",
                                   hold=lambda k, fops, x_u: seen.append((k, fops.w_hi is None)))
    assert seen == [(k, k == 0) for k in HEAVY_KS]
    keys = set(_tpu("heavy_k_sweep_r3")[0])
    for k, rec in zip(HEAVY_KS, records):
        assert set(rec) == keys | heavy_k_sweep_r3.RECORD_KEYS
        assert rec["K"] == k and rec["pair_ms"] == rec["to_items_ms"] + rec["to_users_ms"]
        assert rec["head_gb_bf16"] == (tsplit.n_items * k * 2 / 1e9)
        assert all(c["held"] and c["ratio"] <= 1.0 for c in rec["check"].values())
        assert rec["launches"] == {}  # no kernel on the CPU
    line = {"results": records}
    held = bars.hold(line, bars.heavy_k_sweep_r3(line))["bars"]
    assert held and all(b["held"] for b in held)


def test_heavy_k_check_catches_a_wrong_arc(small):
    _, _, _, tsplit = small
    ops = heavy_k_sweep_r3.reference_operators(tsplit, "cpu")
    x_u, _ = heavy_k_sweep_r3.inputs(tsplit, torch.device("cpu"))
    fops = tbip.build_fast_ops(tsplit, "bfloat16", heavy_users=16, heavy_dtype="bfloat16", device="cpu")
    out = tbip.fast_to_items(x_u, fops)
    assert heavy_k_sweep_r3.check(out, ops["to_items"], x_u)["held"]
    out[3] += 0.05 * out[3].abs().max()
    assert not heavy_k_sweep_r3.check(out, ops["to_items"], x_u)["held"]


@pytest.mark.parametrize("dim", WIDTHS)
@pytest.mark.parametrize("layers", depth_dim_sweep_r3.LAYERS)
def test_depth_dim_fast_forward_matches_jax(small, dim, layers):
    """The script's operator (bf16 B_ii in 1.5 GB bands, bf16 plans) with a
    head of 50 users, so that a tail stays for the segment reduce."""
    jgraph, _, jsplit, tsplit = small
    jfb = jbip.FastBipartite(
        split=jsplit,
        item_op=jbip.build_item_operator(jsplit, dtype=jnp.bfloat16, band_bytes=1.5e9),
        fops=jbip.build_fast_ops(jsplit, "bfloat16", heavy_users=50, heavy_dtype="bfloat16"),
    )
    tfb = tbip.FastBipartite(
        split=tsplit,
        item_op=tbip.build_item_operator(tsplit, dtype=torch.bfloat16, band_bytes=1.5e9, device="cpu"),
        fops=tbip.build_fast_ops(tsplit, "bfloat16", heavy_users=50, heavy_dtype="bfloat16",
                                 device="cpu"),
    )
    jp, tp = _params(jgraph, dim, seed=dim)
    ref = np.asarray(jbip.fast_get_embedding(jp, jfb, layers))
    out = tbip.fast_get_embedding(tp, tfb, layers).numpy()
    assert np.isfinite(out).all() and out.shape == ref.shape
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) <= 1e-2


@pytest.mark.parametrize("layers", depth_dim_sweep_r3.LAYERED)
def test_depth_dim_layered_chunked_matches_jax(small, layers):
    jgraph, tgraph, _, _ = small
    jp, tp = _params(jgraph, 16, seed=layers)
    ref = np.asarray(jax_get_embedding(
        jp, jgraph, JaxConfig(jgraph.num_nodes, 16, layers), lambda g, x: jax_chunked(g, x, 8)))
    out = get_embedding(tp, tgraph, LightGCNConfig(tgraph.num_nodes, 16, layers),
                        depth_dim_sweep_r3.chunked)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_depth_dim_references_are_the_layered_forward(small):
    _, tgraph, _, _ = small
    params = depth_dim_sweep_r3.params_for(tgraph, 16, "cpu")
    refs = depth_dim_sweep_r3.layered_references(params, tgraph, {4, 5})
    for layers, ref in refs.items():
        want = get_embedding(params, tgraph, LightGCNConfig(tgraph.num_nodes, 16, layers))
        torch.testing.assert_close(ref, want, rtol=1e-5, atol=1e-6)


def test_depth_dim_run_records(small):
    _, tgraph, _, _ = small
    result = depth_dim_sweep_r3.run(tgraph, device="cpu", reps_layered=1, reps_fast=1)
    tpu = _tpu("depth_dim_sweep_r3")
    assert set(result) == set(tpu)
    assert [(r["layers"], r["dim"]) for r in result["layered"]] == [
        (r["layers"], r["dim"]) for r in tpu["layered"]]
    assert [(r["layers"], r["dim"]) for r in result["fast"]] == [
        (r["layers"], r["dim"]) for r in tpu["fast"]]
    for group in ("layered", "fast"):
        for rec in result[group]:
            extra = {"launches", "check"} if group == "fast" else {"launches"}
            assert set(rec) == set(tpu[group][0]) | extra
            assert math.isfinite(rec["ms"])
    assert all(r["check"]["forward"]["held"] for r in result["fast"])
    assert all(b["held"] for b in bars.hold(result, bars.depth_dim_sweep_r3(result))["bars"])


def _broken(line: dict, group: str, how: str) -> dict:
    rec = dict(line[group][-1])
    if how == "not held":
        rec["check"] = {w: {**c, "held": False} for w, c in rec["check"].items()}
    else:
        rec["ms" if "ms" in rec else "to_users_ms"] = math.nan
    return {**line, group: [*line[group][:-1], rec]}


@pytest.mark.parametrize("how", ["not held", "nan"])
@pytest.mark.parametrize("name,group", [("heavy_k_sweep_r3", "results"), ("depth_dim_sweep_r3", "fast")])
def test_sweep_bars_miss(name, group, how):
    check = {"results": {"to_items": {"held": True}, "to_users": {"held": True}},
             "fast": {"forward": {"held": True}}}[group]
    rec = ({"K": 0, "head_gb_bf16": 0.0, "to_items_ms": 1.0, "to_users_ms": 2.0, "pair_ms": 3.0,
            "plan_build_s": 0.5} if group == "results" else {"layers": 4, "dim": 80, "ms": 30.0})
    line = {group: [{**rec, "check": check}]}
    if group == "fast":
        line["layered"] = [{"layers": 4, "dim": 80, "ms": 100.0}]
    bars.hold(line, bars.BARS[name](line))
    with pytest.raises(bars.BarMissed):
        bad = _broken(line, group, how)
        bars.hold(bad, bars.BARS[name](bad))


@pytest.mark.parametrize("module", [heavy_k_sweep_r3, depth_dim_sweep_r3])
def test_main_on_the_cpu(module, tmp_path, capsys):
    out = tmp_path / "line.json"
    assert module.main(["--device", "cpu", "--out", str(out)]) == 0
    line = json.loads(capsys.readouterr().out.strip())
    assert line == json.loads(out.read_text())
    assert set(line) - module.EXTRA_KEYS == ({"results"} if module is heavy_k_sweep_r3
                                             else {"layered", "fast"})
    assert line["device"] == "cpu" and line["launches"] == {}
    assert line["bars"] and all(b["held"] for b in line["bars"])
