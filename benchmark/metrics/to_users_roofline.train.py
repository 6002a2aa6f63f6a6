"""``to_users_roofline.train``: ``fast_to_users`` alone (the ELL and the
heavy head) on the table, timed by CUDA events, against the floor of the
sparse product over all user-bound arcs (``peaks.spmm_floor_s``: each
source item row that an arc reads, once; every user row written once)."""
from benchmark import peaks
from benchmark.measure import time_ms


def floor_s(shape: dict) -> float:
    return peaks.spmm_floor_s(shape["items_with_arcs"], shape["edges"], shape["n_users"], shape["dim"])


def read(ctx):
    ops = getattr(ctx.state, "ops", None) or {}
    if "to_users" not in ops:
        return None
    import torch

    with torch.no_grad():
        ms = time_ms(ops["to_users"])
    return peaks.share_pct(floor_s(ctx.state.shape), ms / 1e3)
