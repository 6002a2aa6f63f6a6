"""``train_dgcf_mfu_pct``: the DGCF step's model floor
(``dgcf_floors.dgcf_step_floor_s``: the routed products and score updates
forward and twice that backward, the table, Adam's moments and the arcs
once) over the time of a step, taken by the host's clock over ``STEPS``
steps of the window's own call after the traced window closed, as
``train_cl_mfu_pct`` reads the SimGCL step."""
from benchmark import dgcf_floors, peaks

STEPS = 16


def floor_s(shape: dict) -> float:
    return dgcf_floors.dgcf_step_floor_s(shape)


def read(ctx):
    time_steps = getattr(ctx.state, "time_steps", None)
    shape = getattr(ctx.state, "shape", None)
    if time_steps is None or not shape or "n_factors" not in shape:
        return None
    return peaks.share_pct(floor_s(shape), time_steps(STEPS))
