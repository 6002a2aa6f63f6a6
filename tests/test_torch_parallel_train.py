"""The port's multi-device training steps (``parallel/``) against the JAX
package's one-device step and the port's own, on the same numpy inputs.

In gloo worlds of 2 and 4 spawned CPU ranks (``torch_dist_worker.py``,
job ``train``), from one table and two fixed batches of 64: the fast edge
partition's step in f32 and bf16, with and without the heavy head; the
GSPMD steps, fast (f32, bf16) and layered, on a (data 1, model n) mesh and,
in the world of 4, on (data 2, model 2); the explicit edge partition's
step and embed; ``ItemBand``'s backward. Each is held against JAX's
one-device loss, ``jax.grad`` and ``optax.adam`` over two steps (the loss
terms, the table and Adam's first moment, whose value after the steps is a
sum of the gradients): f32 at JAX's own bounds (bpr rtol 1e-5, reg rtol
1e-4, tables rtol 5e-4 / atol 5e-5), bf16 losses at 2e-3 relative, its
gradients at 3e-3 relative Frobenius (the one-device backward keeps the
arc weights f32 where K1 rounds them) and its tables at 5e-3 (Adam moves
an element by ±lr whatever its gradient's size). The port's one-device
step on the same batches is held tighter in f32. Every rank holds the same replicated leaves, bit for bit, and the
padding rows stay zero. In this process: ``shard_graph``'s padding against
JAX's, and every shard of the explicit partition."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnn_ecommerce_tpu.models import LightGCNConfig as JaxConfig
from gnn_ecommerce_tpu.models import get_embedding as jax_get_embedding
from gnn_ecommerce_tpu.models import losses as jlosses
from gnn_ecommerce_tpu.ops import bipartite as jbip
from gnn_ecommerce_tpu.parallel import make_mesh as jax_make_mesh
from gnn_ecommerce_tpu.parallel import shard_graph as jax_shard_graph
from gnn_ecommerce_tpu.parallel.edge_partition import build_edge_partition as jax_build_edge_partition
from gnn_ecommerce_tpu_torch.device import mm_f32
from gnn_ecommerce_tpu_torch.models.lightgcn import LightGCNConfig
from gnn_ecommerce_tpu_torch.ops import bipartite as tbip
from gnn_ecommerce_tpu_torch.parallel import build_edge_partition, shard_graph
from gnn_ecommerce_tpu_torch.parallel.mesh import mesh_description
from gnn_ecommerce_tpu_torch.train.step import Adam, make_loss_fn, make_train_fns

from torch_dist_worker import EDGE_FAST_MODES, run_world
from torch_port_case import graphs, normal

torch.set_num_threads(1)

HEAVY, DIM, LAYERS, BATCH, LR, DECAY, EDGE_CAP = 16, 16, 3, 64, 1e-2, 1e-4, 4096
WORLDS = (2, 4)
BF16_REL = 2e-3
# The bf16 tables after two Adam steps: Adam's first steps move an element
# by about ±lr whatever its gradient's size, so an element whose gradient
# is near zero and rounds to the other sign moves by 2·lr. The port's own
# one-device bf16 step lands 2.04e-3 from JAX's here (its gradients 7.8e-4).
BF16_TABLE_REL = 5e-3
# The bf16 gradients against the one-device ones: on the mesh K1 reduces
# the users-side plans (the backward of to_items) with each arc weight
# rounded to bf16, where the one-device backward (the port's ELL, JAX's
# path) keeps it f32 (2^-9 relative a term); they land 2.14e-3 from JAX's
# and 2.01e-3 from the port's here.
BF16_GRAD_REL = 3e-3


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


@pytest.fixture(scope="module")
def case():
    u, i, w, n_u, n_i = _arcs()
    jg, pg = graphs(u, i, w, n_u, n_i)
    rng = np.random.default_rng(23)
    c = {
        "u": u, "i": i, "w": w, "n_u": n_u, "n_i": n_i, "heavy": HEAVY, "dim": DIM,
        "layers": LAYERS, "lr": LR, "decay": DECAY, "batch": BATCH, "edge_cap": EDGE_CAP,
        "params": normal(5, (n_u + n_i, DIM)) * 0.1,
        "band_x": normal(8, (n_i, 2 * DIM)), "band_g": normal(9, (n_i, 2 * DIM)),
    }
    for b in range(2):
        c[f"users{b}"] = rng.integers(0, n_u, BATCH)
        c[f"pos{b}"] = n_u + rng.integers(0, n_i, BATCH)
        c[f"neg{b}"] = n_u + rng.integers(0, n_i, BATCH)
    return c, jg, pg


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    c = case[0]
    return {w: run_world("train", w, c, tmp_path_factory.mktemp(f"w{w}"), timeout=240) for w in WORLDS}


def _batches(c, lib):
    return [tuple(lib(c[f"{k}{b}"]) for k in ("users", "pos", "neg")) for b in range(2)]


def _jax_run(c, jg, path: str, mode: str = "float32", heavy: int = HEAVY):
    """Two steps of JAX's one-device loss (fast batched or layered),
    ``jax.grad`` and ``optax.adam``: per step (loss, bpr, reg), then the
    table and Adam's mu and nu."""
    if path == "fast":
        bf16 = mode == "bfloat16"
        fb = jbip.build_fast_bipartite(
            jg, dtype=jnp.bfloat16 if bf16 else jnp.float32, fast_ops=True, msgs_dtype=mode,
            heavy_users=heavy, heavy_dtype=mode,
        )
    cfg = JaxConfig(jg.num_nodes, DIM, LAYERS)

    def loss(params, users, pos, neg):
        if path == "fast":
            u, p, n, _ = jbip.fast_batch_embeddings(params, fb, LAYERS, users, pos, neg, edge_cap=EDGE_CAP)
        else:
            out = jax_get_embedding(params, jg, cfg)
            u, p, n = out[users], out[pos], out[neg]
        bpr = jlosses.bpr_loss(jnp.sum(u * p, -1), jnp.sum(u * n, -1))
        reg = jlosses.reg_loss(params["embedding"], users, pos, neg, DECAY)
        return bpr + reg, (bpr, reg)

    opt = optax.adam(LR)
    params = {"embedding": jnp.asarray(c["params"])}
    state = opt.init(params)
    metrics = []
    for users, pos, neg in _batches(c, jnp.asarray):
        (total, (bpr, reg)), grads = jax.value_and_grad(loss, has_aux=True)(params, users, pos, neg)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        metrics.append([float(total), float(bpr), float(reg)])
    return (np.array(metrics), np.asarray(params["embedding"]),
            np.asarray(state[0].mu["embedding"]), np.asarray(state[0].nu["embedding"]))


def _port_run(c, pg, path: str, mode: str = "float32", heavy: int = HEAVY):
    """The port's one-device step on the same two batches."""
    cfg = LightGCNConfig(pg.num_nodes, DIM, LAYERS)
    if path == "fast":
        bf16 = mode == "bfloat16"
        graph = tbip.build_fast_bipartite(
            pg, dtype=torch.bfloat16 if bf16 else torch.float32, fast_ops=True, msgs_dtype=mode,
            heavy_users=heavy, heavy_dtype=mode, device="cpu",
        )
        loss = make_loss_fn(cfg, DECAY, batch_embed_fn=lambda p, g_, u, po, ne: tbip.fast_batch_embeddings(
            p, g_, LAYERS, u, po, ne, edge_cap=EDGE_CAP))
    else:
        graph, loss = pg, make_loss_fn(cfg, DECAY)
    adam = Adam(LR)
    step, _ = make_train_fns(cfg, adam, BATCH, DECAY, loss_fn=loss)
    params = {"embedding": torch.from_numpy(c["params"].copy())}
    state = adam.init(params)
    metrics = []
    for users, pos, neg in _batches(c, torch.from_numpy):
        _, _, m = step.on_batch(params, state, graph, users, pos, neg)
        metrics.append([float(m[k]) for k in ("loss", "bpr_loss", "reg_loss")])
    return (np.array(metrics), params["embedding"].numpy(), state.exp_avg["embedding"].numpy(),
            state.exp_avg_sq["embedding"].numpy())


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _hold(r: dict, key: str, ref, bf16: bool, rtol_tables: float = 5e-4, atol_tables: float = 5e-5,
          loss_rtol=(1e-5, 1e-4)):
    """A rank's two steps against a reference run (JAX's or the port's)."""
    metrics, emb, mu, _ = ref
    got = np.stack([r[f"{key}_metrics{b}"][:3] for b in range(2)])
    if bf16:
        np.testing.assert_allclose(got, metrics, rtol=BF16_REL)
        assert _rel(r[f"{key}_mu"], mu) <= BF16_GRAD_REL
        assert _rel(r[f"{key}_emb"], emb) <= BF16_TABLE_REL
    else:
        np.testing.assert_allclose(got[:, 1], metrics[:, 1], rtol=loss_rtol[0])
        np.testing.assert_allclose(got[:, 2], metrics[:, 2], rtol=loss_rtol[1])
        np.testing.assert_allclose(r[f"{key}_emb"], emb, rtol=rtol_tables, atol=atol_tables)
        # mu after two steps is 0.09·g1 + 0.1·g2: the gradients.
        assert _rel(r[f"{key}_mu"], mu) <= 1e-4


@pytest.fixture(scope="module")
def refs(case):
    c, jg, pg = case
    out = {}
    for mode, heavy in EDGE_FAST_MODES:
        out[("jax", mode, heavy)] = _jax_run(c, jg, "fast", mode, heavy)
        out[("port", mode, heavy)] = _port_run(c, pg, "fast", mode, heavy)
    out[("jax", "off")] = _jax_run(c, jg, "layered")
    out[("port", "off")] = _port_run(c, pg, "layered")
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode,heavy", EDGE_FAST_MODES)
def test_edge_fast_step_matches_one_device(ranks, refs, world, mode, heavy):
    """Both steps of the fast edge partition against JAX's one-device fast
    step and the port's; the same metrics on every rank (dropped arcs 0)."""
    key, bf16 = f"edge_fast_{mode}_{heavy}", mode == "bfloat16"
    for r in ranks[world]:
        _hold(r, key, refs[("jax", mode, heavy)], bf16)
        if bf16:  # the port's bf16 rounds as JAX's does but for K1's weights
            _hold(r, key, refs[("port", mode, heavy)], True)
        else:
            _hold(r, key, refs[("port", mode, heavy)], False, 1e-4, 1e-5, (1e-6, 1e-6))
        for b in range(2):
            np.testing.assert_array_equal(r[f"{key}_metrics{b}"], ranks[world][0][f"{key}_metrics{b}"])
            assert r[f"{key}_metrics{b}"][3] == 0.0


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode,heavy", EDGE_FAST_MODES)
def test_edge_fast_replicated_leaves_bit_equal_and_padding_zero(case, ranks, world, mode, heavy):
    """``emb_items`` and its Adam moments are the same bits on every rank;
    the user rows past ``n_users`` (params and moments) stay zero."""
    n_u = case[0]["n_u"]
    key = f"edge_fast_{mode}_{heavy}"
    first = ranks[world][0][f"{key}_replicated"]
    R = ranks[world][0][f"{key}_own"].shape[1]
    for s, r in enumerate(ranks[world]):
        np.testing.assert_array_equal(r[f"{key}_replicated"], first)
        real = max(0, min(R, n_u - s * R))
        assert not r[f"{key}_own"][:, real:].any()


@pytest.mark.parametrize("world", WORLDS)
def test_item_band_backward(case, ranks, world):
    """The gradient of the banded ``B_ii @ x`` is ``B_iiᵀ g`` (f32 exact to
    f32 sums; bf16 as the one-device bf16 product's gradient: the
    cotangent rounded to bf16, f32 sums, one rounding)."""
    c, _, pg = case
    split = tbip.split_graph(pg)
    g = torch.from_numpy(c["band_g"])
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        B = tbip.build_item_operator(split, dtype=dt, device="cpu")
        x = torch.from_numpy(c["band_x"]).to(dt).requires_grad_()
        (want,) = torch.autograd.grad(mm_f32(B, x), x, g)
        for r in ranks[world]:
            got = r[f"band_grad_{name}"]
            if name == "f32":
                np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-6)
            else:  # f32 sums in another order, rounded once to bf16
                assert _rel(got, want.float().numpy()) <= BF16_REL


def _gspmd_keys(world):
    return [f"gspmd_1x{world}"] + (["gspmd_2x2"] if world == 4 else [])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", ["float32", "bfloat16", "off"])
def test_gspmd_step_matches_one_device(ranks, refs, world, mode):
    """The GSPMD steps (fast with the head, and layered) on every mesh
    against JAX's one-device step and the port's; every rank of a ``data``
    line holds the same band bits."""
    for name in _gspmd_keys(world):
        key = f"{name}_{mode}"
        heavy_key = ("off",) if mode == "off" else (mode, HEAVY)
        for r in ranks[world]:
            _hold(r, key, refs[("jax", *heavy_key)], mode == "bfloat16")
            if mode == "bfloat16":
                _hold(r, key, refs[("port", *heavy_key)], True)
            else:
                _hold(r, key, refs[("port", *heavy_key)], False, 1e-4, 1e-5, (1e-6, 1e-6))
            np.testing.assert_array_equal(r[f"{key}_metrics1"], ranks[world][0][f"{key}_metrics1"])
        if name == "gspmd_2x2":  # data lines (0, m) and (1, m) hold band m
            for m in range(2):
                np.testing.assert_array_equal(ranks[world][m][f"{key}_band"], ranks[world][2 + m][f"{key}_band"])


@pytest.mark.parametrize("world", WORLDS)
def test_explicit_edge_step_and_embed(case, ranks, refs, world):
    """The explicit partition's embed against JAX's layered embedding, and
    its two steps against JAX's and the port's one-device layered step."""
    c, jg, _ = case
    cfg = JaxConfig(jg.num_nodes, DIM, LAYERS)
    want = np.asarray(jax_get_embedding({"embedding": jnp.asarray(c["params"])}, jg, cfg))
    for r in ranks[world]:
        np.testing.assert_allclose(r["explicit_embed"], want, rtol=2e-5, atol=2e-6)
        _hold(r, "explicit", refs[("jax", "off")], False)
        _hold(r, "explicit", refs[("port", "off")], False, 1e-4, 1e-5, (1e-6, 1e-6))


@pytest.mark.parametrize("data", [2, 4, 8])
def test_shard_graph_pads_like_jax(data):
    """Every data shard's arcs, concatenated, are JAX's padded arc arrays
    (no-op tail arcs: weight 0, source 0, destination num_nodes; the case's
    arcs less one edge leave a remainder on 4 and 8 shards)."""
    u, i, w, n_u, n_i = _arcs()
    jg, pg = graphs(u[1:], i[1:], w[1:], n_u, n_i)
    assert (pg.num_arcs % data != 0) == (data > 2)
    ref = jax_shard_graph(jg, jax_make_mesh(8, axis_sizes=(data, 8 // data)))
    shards = [shard_graph(pg, mesh_description((data, 1), d * 1, device="cpu")) for d in range(data)]
    for name in ("src", "dst", "w_norm"):
        got = torch.cat([getattr(s, name) for s in shards]).numpy()
        np.testing.assert_array_equal(got, np.asarray(getattr(ref, name)))
    assert len({s.src.shape[0] for s in shards}) == 1


@pytest.mark.parametrize("world", WORLDS)
def test_explicit_partition_shards_equal_jax(case, world):
    """Each shard's local and remote arcs, remote slots and send rows are
    JAX's (its padding aside)."""
    _, jg, pg = case
    ref = jax_build_edge_partition(jg, world)
    for s in range(world):
        part = build_edge_partition(pg, mesh_description((world,), s, ("model",), device="cpu"))
        assert (part.rows_per_shard, part.max_send) == (ref.rows_per_shard, ref.max_send)
        for name in ("src_loc", "dst_loc", "w_loc", "src_rem", "dst_rem", "w_rem"):
            mine = getattr(part, name).numpy()
            np.testing.assert_array_equal(mine, np.asarray(getattr(ref, name)[s])[: len(mine)])
        for name in ("w_loc", "w_rem"):  # JAX's padding arcs weigh 0
            assert not np.asarray(getattr(ref, name)[s])[len(getattr(part, name)) :].any()
        np.testing.assert_array_equal(part.send_idx.numpy(), np.asarray(ref.send_idx[s]))
