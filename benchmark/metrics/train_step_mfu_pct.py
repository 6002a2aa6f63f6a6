"""``train_step_mfu_pct``: the LightGCN step's model floor
(``peaks.lightgcn_step_floor_s``: its layers over every arc forward and
twice that backward; the table and Adam's moments read and written once)
over the time of a step, taken by the host's clock over ``STEPS`` steps of
the window's own call after the traced window closed."""
from benchmark import peaks

STEPS = 16


def floor_s(shape: dict) -> float:
    return peaks.lightgcn_step_floor_s(shape["n_nodes"], shape["arcs"], shape["dim"], shape["layers"])


def read(ctx):
    time_steps = getattr(ctx.state, "time_steps", None)
    if time_steps is None:
        return None
    return peaks.share_pct(floor_s(ctx.state.shape), time_steps(STEPS))
