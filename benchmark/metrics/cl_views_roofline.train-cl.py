"""``cl_views_roofline.train-cl``: the views' floor a step
(``cl_floors.views_floor_s``: both directions' sparse products of every view
and layer, and the noise's rows read and written once, from the program's
counters ``train.cl.view_arcs`` and ``train.cl.noised_rows``) against the
device time of the span ``train.cl.view`` a step, both from the recording
pass of ``benchmark/spans.py``."""
from benchmark import cl_floors, peaks, spans


def floor_s(shape: dict, view_arcs: float, noised_rows: float) -> float:
    return cl_floors.views_floor_s(shape, view_arcs, noised_rows)


def read(ctx):
    ms = spans.device_ms_per_unit(ctx, "train.cl.view")
    if ms is None:
        return None
    rep = spans.report(ctx)
    counters = rep.get("counters") or {}
    if not counters.get("train.cl.view_arcs") or not counters.get("train.cl.noised_rows"):
        return None
    per_step = {k: counters[k] / rep["units"] for k in ("train.cl.view_arcs", "train.cl.noised_rows")}
    return peaks.share_pct(floor_s(ctx.state.shape, per_step["train.cl.view_arcs"],
                                   per_step["train.cl.noised_rows"]), ms / 1e3)
