"""``to_items_roofline.train``: ``fast_to_items`` alone (cast, K1 and the
heavy head) on the table, timed by CUDA events, against the floor of the
sparse product over all item-bound arcs, head users included
(``peaks.spmm_floor_s``: each source user row that an arc reads, once)."""
from benchmark import peaks
from benchmark.measure import time_ms


def floor_s(shape: dict) -> float:
    return peaks.spmm_floor_s(shape["users_with_arcs"], shape["edges"], shape["n_items"], shape["dim"])


def read(ctx):
    ops = getattr(ctx.state, "ops", None) or {}
    if "to_items" not in ops:
        return None
    import torch

    with torch.no_grad():
        ms = time_ms(ops["to_items"])
    return peaks.share_pct(floor_s(ctx.state.shape), ms / 1e3)
