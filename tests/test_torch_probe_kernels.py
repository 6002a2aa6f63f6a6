"""The probes' kernels K2, K4, K5 and K6: the port's functions (their plain
versions, on the CPU) against the TPU kernels of the probe scripts run in
Pallas interpret mode, and the CUDA wrappers' refusal of host tensors (the
kernels themselves run only on the card, in chip_smoke.py).

K2, K5 and K6 never produced a number on the TPU, so interpret mode is what
defines them. The scripts are loaded from ``scripts/`` as they are; K2's
``pallas_call`` is made to interpret through ``monkeypatch``, and the bodies
of K5 and K6 are rebuilt here with ``interpret=True``."""
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gnn_ecommerce_tpu_torch.ops._kernels import LANE_GATHER, ROW_GATHER, TILE_SEGREDUCE
from gnn_ecommerce_tpu_torch.probes import kernels as pk
from gnn_ecommerce_tpu_torch.probes.proto_segreduce import build_plan

torch.set_num_threads(1)

SCRIPTS = pathlib.Path(__file__).resolve().parent.parent / "scripts"


@functools.lru_cache(maxsize=None)
def _script(name: str):
    spec = importlib.util.spec_from_file_location(f"_probe_script_{name}", SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _bits(a) -> np.ndarray:
    """bf16 (jax or torch) as its 16-bit patterns."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.array(a).view(np.uint16)


def _plan_case(seed: int, n_out=600, n_in=300, e=3000, OT=128, CH=256):
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, n_out, e).astype(np.int32))
    src = rng.integers(0, n_in, e).astype(np.int32)
    w = rng.random(e).astype(np.float32)
    plan = build_plan(src, dst, w, n_out, OT, CH)
    T = rng.standard_normal((n_in, 80)).astype(np.float32)
    return plan, T[plan["gidx"]] * plan["gw"][:, None]


def _abs_sums(plan, msgs, OT):
    """Per output element, the sum of its messages' magnitudes."""
    ch = len(plan["seg"]) // plan["n_chunks"]
    rows = np.repeat(plan["tile_map"], ch).astype(np.int64) * OT + plan["seg"]
    out = np.zeros((plan["n_tiles"] * OT, msgs.shape[1]))
    np.add.at(out, rows, np.abs(msgs.astype(np.float64)))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_tile_segreduce_matches_interpret_mode_probe(monkeypatch, dtype, seed):
    OT, CH, D = 128, 256, 80
    plan, msgs = _plan_case(seed, OT=OT, CH=CH)
    if dtype == "bfloat16":  # the same bf16 values for both
        msgs = np.array(jnp.asarray(msgs, jnp.bfloat16).astype(jnp.float32))
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    f = _script("proto_segreduce").make_seg_reduce(
        OT, CH, D, plan["n_tiles"], plan["n_chunks"], getattr(jnp, dtype)
    )
    seg3 = plan["seg"].reshape(-1, 8, CH // 8)
    ref = np.asarray(f(
        jnp.asarray(plan["tile_map"]), jnp.asarray(plan["first"]), jnp.asarray(seg3),
        jnp.asarray(msgs, getattr(jnp, dtype)),
    ))
    out = pk.tile_segreduce(
        torch.from_numpy(msgs).to(getattr(torch, dtype)), torch.from_numpy(seg3),
        torch.from_numpy(plan["tile_map"]), torch.from_numpy(plan["first"]), plan["n_tiles"], OT,
    )
    assert out.shape == ref.shape == (plan["n_tiles"] * OT, D) and out.dtype == torch.float32
    # f32 sums of the same values (exact products) in another order.
    scale = _abs_sums(plan, msgs, OT).max()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=pk.TILE_SEGREDUCE_RTOL * scale)


def _sequential_reference(msgs, seg, tile_map, first, n_tiles, ot):
    """The TPU kernel's sequential grid in numpy: chunk by chunk, zeroing a
    tile at ``first``; a seg outside [0, OT) matches no one-hot row."""
    n_chunks = len(tile_map)
    ch = len(seg) // n_chunks
    out = np.zeros((n_tiles, ot, msgs.shape[1]), np.float64)
    for c in range(n_chunks):
        t = tile_map[c]
        if first[c] == 1:
            out[t] = 0
        for j in range(c * ch, (c + 1) * ch):
            if 0 <= seg[j] < ot:
                out[t, seg[j]] += msgs[j]
    return out.reshape(n_tiles * ot, -1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tile_segreduce_plain_follows_the_sequential_grid(seed):
    """Layouts the plan never makes: unsorted and out-of-range seg, resets
    in the middle of a tile, a tile with no chunk."""
    rng = np.random.default_rng(seed)
    n_tiles, ot, ch, d = 4, 16, 24, 5
    tile_map = np.sort(rng.choice([0, 1, 3], 11)).astype(np.int32)  # tile 2 has none
    first = (rng.random(11) < 0.4).astype(np.int32)
    seg = rng.integers(-2, ot + 2, 11 * ch).astype(np.int32)
    msgs = rng.standard_normal((11 * ch, d)).astype(np.float32)
    want = _sequential_reference(msgs, seg, tile_map, first, n_tiles, ot)
    got = pk.tile_segreduce(*(torch.from_numpy(a) for a in (msgs, seg, tile_map, first)), n_tiles, ot)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    assert not got.numpy()[2 * ot : 3 * ot].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_tile_segreduce_abs_sum_counts_every_chunk(seed):
    """The tolerance's scale: Σ|msg| per output element over every chunk of
    its tile, resets or not; a seg outside [0, OT) adds nowhere."""
    rng = np.random.default_rng(seed)
    n_tiles, ot, ch, d = 4, 16, 24, 5
    tile_map = np.sort(rng.choice([0, 1, 3], 11)).astype(np.int32)
    seg = rng.integers(-2, ot + 2, 11 * ch).astype(np.int32)
    msgs = rng.standard_normal((11 * ch, d)).astype(np.float32)
    want = _sequential_reference(np.abs(msgs), seg, tile_map, np.zeros(11, np.int32), n_tiles, ot)
    got = pk.tile_segreduce_abs_sum(*(torch.from_numpy(a) for a in (msgs, seg, tile_map)), n_tiles, ot)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "n_out,n_in,e,OT,CH", [(1000, 500, 20000, 128, 256), (3000, 700, 2000, 512, 2048), (40, 9, 0, 16, 32)]
)
def test_build_plan_matches_script(n_out, n_in, e, OT, CH):
    rng = np.random.default_rng(n_out)
    dst = np.sort(rng.integers(0, n_out, e).astype(np.int32))
    src = rng.integers(0, n_in, e).astype(np.int32)
    w = rng.random(e).astype(np.float32)
    want = _script("proto_segreduce").build_plan(src, dst, w, n_out, OT, CH)
    got = build_plan(src, dst, w, n_out, OT, CH)
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype
            np.testing.assert_array_equal(got[key], value)
        else:
            assert got[key] == value, key


def test_row_gather_matches_interpret_mode_probe():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((256, 8, 128)).astype(np.float32)
    idx = rng.integers(0, 256, 2048).astype(np.int32)
    ref = np.asarray(_script("pallas_gather_probe").pallas_row_dma_gather(
        jnp.asarray(table), jnp.asarray(idx), k_inflight=4, chunk=1024, interpret=True
    ))
    out = pk.row_gather(torch.from_numpy(table), torch.from_numpy(idx), k_inflight=4, chunk=1024)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_row_gather_bf16_rows_match_take():
    """The probe's phase A shape, [N, 128] bf16 rows, which the TPU kernel
    could not gather one by one."""
    rng = np.random.default_rng(1)
    table = jnp.asarray(rng.standard_normal((512, 128)), jnp.bfloat16)
    idx = rng.integers(0, 512, 4096).astype(np.int32)
    want = jnp.take(table, jnp.asarray(idx), axis=0)
    got = pk.row_gather(torch.from_numpy(_bits(table).view(np.int16)).view(torch.bfloat16),
                        torch.from_numpy(idx))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_row_gather_needs_whole_chunks():
    with pytest.raises(ValueError, match="n % chunk"):
        pk.row_gather(torch.zeros(4, 8), torch.zeros(1000, dtype=torch.int32), chunk=1024)


TILE = 4096


def _lane_probe(idx2d, tab, index_block, index_map, reshape):
    """The kernel bodies of microbench_gather.py:215-219 (K5: index blocks
    [1, TILE]) and microbench_gather2.py:141-145 (K6: [8, TILE/8] blocks
    reshaped to [1, TILE]), in interpret mode."""
    d = tab.shape[0]

    def kernel(idx_ref, tab_ref, out_ref):
        idx = idx_ref[:]
        ib = jnp.broadcast_to(idx.reshape(1, TILE) if reshape else idx, (d, TILE))
        out_ref[:] = jnp.take_along_axis(tab_ref[:], ib, axis=1)

    n_tiles = idx2d.size // TILE
    return pl.pallas_call(
        kernel,
        grid=(n_tiles,),
        in_specs=[
            pl.BlockSpec(index_block, index_map, memory_space=pltpu.VMEM),
            pl.BlockSpec(tab.shape, lambda i: (0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((d, TILE), lambda i: (0, i), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((d, n_tiles * TILE), jnp.bfloat16),
        interpret=True,
    )(idx2d, tab)


def _lane_case(seed: int):
    rng = np.random.default_rng(seed)
    tab = jnp.asarray(rng.standard_normal((80, 1000)), jnp.bfloat16)
    idx = rng.integers(0, 1000, 2 * TILE).astype(np.int32)
    return tab, idx, torch.from_numpy(_bits(tab).view(np.int16)).view(torch.bfloat16)


@pytest.mark.parametrize("seed", [0, 1])
def test_lane_gather_matches_interpret_mode_k5(seed):
    tab, idx, tab_t = _lane_case(seed)
    idx2d = idx.reshape(1, -1)
    want = _lane_probe(jnp.asarray(idx2d), tab, (1, TILE), lambda i: (0, i), reshape=False)
    got = pk.lane_gather(tab_t, torch.from_numpy(idx2d))
    assert got.shape == (80, 2 * TILE) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_lane_gather_8x512_matches_interpret_mode_k6(seed):
    tab, idx, tab_t = _lane_case(seed)
    idx2d = idx.reshape(-1, TILE // 8)
    want = _lane_probe(jnp.asarray(idx2d), tab, (8, TILE // 8), lambda i: (i, 0), reshape=True)
    got = pk.lane_gather_8x512(tab_t, torch.from_numpy(idx2d))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # K6 computes K5's function: the same indices in the other layout.
    np.testing.assert_array_equal(_bits(got), _bits(pk.lane_gather(tab_t, torch.from_numpy(idx.reshape(1, -1)))))


def test_lane_gather_layouts_are_checked():
    tab = torch.zeros(80, 10, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"\[1, n\]"):
        pk.lane_gather(tab, torch.zeros(2, 512, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\[8m, 512\]"):
        pk.lane_gather_8x512(tab, torch.zeros(3, 512, dtype=torch.int32))


def _host_calls():
    seg, tm, fr = (torch.zeros(n, dtype=torch.int32) for n in (64, 2, 2))
    return {
        "tile_segreduce": (TILE_SEGREDUCE, lambda: TILE_SEGREDUCE(torch.zeros(64, 8), seg, tm, fr, 1, 16)),
        "row_gather": (ROW_GATHER, lambda: ROW_GATHER(torch.zeros(4, 8), torch.zeros(1024, dtype=torch.int32))),
        "lane_gather_1xn": (LANE_GATHER, lambda: LANE_GATHER(
            torch.zeros(80, 10, dtype=torch.bfloat16), torch.zeros(1, 8, dtype=torch.int32), "1xn")),
        "lane_gather_8x512": (LANE_GATHER, lambda: LANE_GATHER(
            torch.zeros(80, 10, dtype=torch.bfloat16), torch.zeros(8, 512, dtype=torch.int32), "8x512")),
    }


@pytest.mark.parametrize("name", ["tile_segreduce", "row_gather", "lane_gather_1xn", "lane_gather_8x512"])
def test_kernel_wrappers_refuse_host_tensors(name):
    kernel, call = _host_calls()[name]
    before = dict(kernel.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()
    assert kernel.launches == before


def test_tile_segreduce_splits_depend_only_on_the_plan_shape():
    """Blocks per tile: about 1,024 blocks in all, at most the mean chunks
    per tile; the probe's to_items plan (107 tiles, 5,010 chunks) splits 10
    ways, its to_users plan (3,202 tiles) not at all."""
    assert TILE_SEGREDUCE.n_splits(107, 5010) == 10
    assert TILE_SEGREDUCE.n_splits(3202, 6404) == 1
    assert TILE_SEGREDUCE.n_splits(8, 3) == 1
    assert TILE_SEGREDUCE.n_splits(0, 0) == 1
