"""``intent_gather_roofline.train-dgcf``: the routed products' floor a step
(``dgcf_floors.intent_gather_floor_s``, from the program's counter
``train.dgcf.routed_arcs``) against the device time of the span
``train.dgcf.spmm`` a step (each iteration's routed product: the degrees'
row scalings, the cast to gathered rows and the CUDA intent gather-sum),
both from the recording pass of ``benchmark/spans.py``."""
from benchmark import dgcf_floors, peaks, spans


def floor_s(shape: dict, routed_arcs: float) -> float:
    return dgcf_floors.intent_gather_floor_s(shape, routed_arcs)


def read(ctx):
    ms = spans.device_ms_per_unit(ctx, "train.dgcf.spmm")
    shape = getattr(ctx.state, "shape", None)
    if ms is None or not shape or "n_factors" not in shape:
        return None
    rep = spans.report(ctx)
    routed = (rep.get("counters") or {}).get("train.dgcf.routed_arcs")
    if not routed:
        return None
    return peaks.share_pct(floor_s(shape, routed / rep["units"]), ms / 1e3)
