"""``chain_roofline.refresh``: the service's item chain alone (its f32 B_ii,
TF32 off, the first level given) at the cell's shapes, timed by CUDA events,
against the floor of its GEMMs at the f32 peak (``peaks.chain_floor_s``)."""
from benchmark import peaks
from benchmark.measure import time_ms


def floor_s(shape: dict) -> float:
    return peaks.chain_floor_s(shape["n_items"], shape["dim"], shape["layers"], "f32")


def read(ctx):
    ops = getattr(ctx.state, "ops", None) or {}
    if "chain" not in ops:
        return None
    return peaks.share_pct(floor_s(ctx.state.shape), time_ms(ops["chain"]) / 1e3)
