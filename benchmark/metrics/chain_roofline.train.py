"""``chain_roofline.train``: the item chain alone (``item_chain_core`` over
B_ii in the configuration's precision, the first level given) at the cell's
shapes, timed by CUDA events, against the floor of its GEMMs
(``peaks.chain_floor_s``: B_ii, each right-hand side and each f32 product
once, at the bf16 peak)."""
from benchmark import peaks
from benchmark.measure import time_ms


def floor_s(shape: dict, precision: str) -> float:
    return peaks.chain_floor_s(shape["n_items"], shape["dim"], shape["layers"], precision)


def read(ctx):
    ops = getattr(ctx.state, "ops", None) or {}
    if "chain" not in ops:
        return None
    import torch

    with torch.no_grad():
        ms = time_ms(ops["chain"])
    return peaks.share_pct(floor_s(ctx.state.shape, ctx.state.precision), ms / 1e3)
