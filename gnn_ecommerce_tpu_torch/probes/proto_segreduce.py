"""Port of ``scripts/proto_segreduce.py``: the tiled segment reduce (K2).

Pads each output tile's dst-sorted arc range to whole chunks of CH arcs
(:func:`build_plan`, the script's planner), gathers and weights the
messages in torch (``index_select``, as XLA's ``take`` was), and reduces
them with K2 (``csrc/tile_segreduce.cu``). Sections, under the script's
keys:

- ``correct_small``: 1,000 outputs, 500 inputs, 20,000 arcs, OT 128,
  CH 256, D 80, against a numpy ``add.at`` (relative error < 1e-5 in f32);
- ``to_items`` f32 and bf16 messages: 10,157,407 arcs from 1,639,358 users
  into 54,571 items, OT 512, CH 2048, D 80 (``pad_ratio``, ``ms``);
- ``to_users`` bf16 at CH 2048 and 1024.

Each full-scale case first holds K2 against its plain version on its plan
(``max_abs_err`` within ``TILE_SEGREDUCE_RTOL`` of the largest output
element's Σ|msg|), then is timed.

The script's docstring also names a Mosaic lane-gather lowering test; the
script has no section for it, and neither has this port. On the CPU the
arcs and tables are cut to tiny sizes (``SMALL``); OT, CH and D stay.

    python -m gnn_ecommerce_tpu_torch.probes.proto_segreduce [--out x.json]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ._timing import Probe, cli
from .kernels import TILE_SEGREDUCE_RTOL, tile_segreduce, tile_segreduce_abs_sum, tile_segreduce_plain

E = 10_157_407
NU = 1_639_358
NI = 54_571
D = 80
SMALL = {"E": 4_000, "NU": 1_000, "NI": 600}


def build_plan(src, dst_sorted, w, n_out, OT, CH):
    """Pad each output tile's (dst-sorted) arc range to CH multiples: the
    script's arrays (``gidx``, ``gw``, ``seg`` of length E_pad; ``tile_map``
    and ``first`` per chunk) and sizes."""
    n_tiles = -(-n_out // OT)
    lo = np.searchsorted(dst_sorted, np.arange(n_tiles) * OT)
    hi = np.searchsorted(dst_sorted, (np.arange(n_tiles) + 1) * OT)
    cnt = hi - lo
    chunks = np.maximum(1, -(-cnt // CH))
    padded = chunks * CH
    starts = np.concatenate([[0], np.cumsum(padded)[:-1]])
    E_pad = int(padded.sum())
    gidx = np.zeros(E_pad, np.int32)
    gw = np.zeros(E_pad, np.float32)
    seg = np.zeros(E_pad, np.int32)
    # positions of the real arcs inside the padded layout (dst_sorted is
    # globally sorted, so the tiles' ranges concatenate to the identity)
    take_pos = np.repeat(starts, cnt) + (
        np.arange(int(cnt.sum())) - np.repeat(np.cumsum(np.append(0, cnt[:-1])), cnt)
    )
    gidx[take_pos] = src
    gw[take_pos] = w
    seg[take_pos] = dst_sorted - np.repeat(np.arange(n_tiles) * OT, cnt)
    tile_map = np.repeat(np.arange(n_tiles, dtype=np.int32), chunks)
    first = np.zeros(len(tile_map), np.int32)
    first[np.concatenate([[0], np.cumsum(chunks)[:-1]])] = 1
    return dict(
        gidx=gidx, gw=gw, seg=seg, tile_map=tile_map, first=first,
        n_tiles=int(n_tiles), E_pad=E_pad, n_chunks=len(tile_map),
        pad_ratio=E_pad / max(len(src), 1),
    )


def plan_tensors(plan: dict, device) -> dict:
    """The plan's arrays on ``device``."""
    keys = ("gidx", "gw", "seg", "tile_map", "first")
    return {k: torch.from_numpy(plan[k]).to(device) for k in keys}


def messages(table: torch.Tensor, t: dict, msgs_dtype: torch.dtype) -> torch.Tensor:
    """[E_pad, D] messages ``(table[gidx] * gw)`` in ``msgs_dtype``."""
    return (table.index_select(0, t["gidx"]) * t["gw"][:, None]).to(msgs_dtype)


def make_seg_reduce(OT, CH, D, n_tiles, n_chunks, msgs_dtype):
    """Counterpart of the script's kernel factory: ``f(tile_map, first, seg,
    msgs)`` -> [n_tiles·OT, D] f32 through K2. ``seg`` may keep the TPU's
    [n_chunks, 8, CH/8] layout."""

    def f(tile_map, first, seg, msgs):
        if msgs.shape != (n_chunks * CH, D) or msgs.dtype != msgs_dtype:
            raise ValueError(f"msgs must be [{n_chunks * CH}, {D}] {msgs_dtype}")
        return tile_segreduce(msgs, seg, tile_map, first, n_tiles, OT)

    return f


def arcs(rng: np.random.Generator, n_arcs: int, n_users: int, n_items: int) -> tuple:
    """The script's full-scale arcs, drawn in its order: item-sorted dst,
    random user src and weights (to_items); the same users sorted as dst and
    random item src (to_users)."""
    item_sorted = np.sort(rng.integers(0, n_items, n_arcs).astype(np.int32))
    user_src = rng.integers(0, n_users, n_arcs).astype(np.int32)
    w = rng.random(n_arcs).astype(np.float32)
    item_src = rng.integers(0, n_items, n_arcs).astype(np.int32)
    return item_sorted, user_src, w, np.sort(user_src), item_src


def main(device="cuda", *, reps: int = 4) -> dict:
    """Run the script's sections on ``device`` (full shapes on the card,
    ``SMALL`` on the CPU); returns the results under the script's keys."""
    probe = Probe(device, reps)
    dev, res = probe.device, probe.results
    sizes = {"E": E, "NU": NU, "NI": NI} if dev.type == "cuda" else SMALL
    n_arcs, n_users, n_items = sizes["E"], sizes["NU"], sizes["NI"]
    res["shapes"] = {**sizes, "D": D}
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def t_correct():
        n_out, n_in, e = 1000, 500, 20000
        OT, CH = 128, 256
        dst = np.sort(rng.integers(0, n_out, e).astype(np.int32))
        src = rng.integers(0, n_in, e).astype(np.int32)
        w = rng.random(e).astype(np.float32)
        plan = build_plan(src, dst, w, n_out, OT, CH)
        T = rng.standard_normal((n_in, D)).astype(np.float32)
        ref = np.zeros((n_out, D), np.float32)
        np.add.at(ref, dst, T[src] * w[:, None])
        t = plan_tensors(plan, dev)
        f = make_seg_reduce(OT, CH, D, plan["n_tiles"], plan["n_chunks"], torch.float32)
        msgs = messages(torch.from_numpy(T).to(dev), t, torch.float32)
        out = f(t["tile_map"], t["first"], t["seg"].reshape(-1, 8, CH // 8), msgs)[:n_out]
        err = float(np.abs(out.cpu().numpy() - ref).max() / (np.abs(ref).max() + 1e-9))
        res["correct_small_relerr_f32"] = err
        assert err < 1e-5, err

    probe.section("correct_small", t_correct)

    item_sorted, user_src, w, user_sorted, item_src = arcs(rng, n_arcs, n_users, n_items)

    def reduce_case(src, dst_sorted, n_out, n_in, msgs_dtype, key, OT=512, CH=2048):
        def f():
            plan = build_plan(src, dst_sorted, w, n_out, OT, CH)
            res[f"{key}_pad_ratio"] = plan["pad_ratio"]
            T = torch.randn(n_in, D, generator=gen, device=dev)
            t = plan_tensors(plan, dev)
            kr = make_seg_reduce(OT, CH, D, plan["n_tiles"], plan["n_chunks"], msgs_dtype)
            seg = t["seg"].reshape(-1, 8, CH // 8)

            def run():
                return kr(t["tile_map"], t["first"], seg, messages(T, t, msgs_dtype))[:n_out]

            # K2 against its plain version on this plan, before it is timed.
            msgs = messages(T, t, msgs_dtype)
            args = (msgs, t["seg"], t["tile_map"], t["first"], plan["n_tiles"], OT)
            err = (kr(t["tile_map"], t["first"], seg, msgs) - tile_segreduce_plain(*args)).abs().max().item()
            scale = tile_segreduce_abs_sum(msgs, t["seg"], t["tile_map"], plan["n_tiles"], OT).max().item()
            res[f"{key}_max_abs_err"] = err
            if not err <= TILE_SEGREDUCE_RTOL * scale:
                raise AssertionError(f"{key}: K2 differs from its plain version by {err} (max Σ|msg| {scale})")
            del msgs, args
            res[f"{key}_ms"] = probe.time(run)

        return f

    probe.section("to_items_pallas_bf16", reduce_case(
        user_src, item_sorted, n_items, n_users, torch.bfloat16, "to_items_pl_bf16"))
    probe.section("to_items_pallas_f32", reduce_case(
        user_src, item_sorted, n_items, n_users, torch.float32, "to_items_pl_f32"))
    probe.section("to_users_pallas_bf16", reduce_case(
        item_src, user_sorted, n_users, n_items, torch.bfloat16, "to_users_pl_bf16"))
    probe.section("to_users_pallas_bf16_ch1024", reduce_case(
        item_src, user_sorted, n_users, n_items, torch.bfloat16, "to_users_pl_bf16_ch1024",
        CH=1024))
    return res


if __name__ == "__main__":
    sys.exit(cli(main, __doc__))
