"""``train_cl_mfu_pct``: the SimGCL step's model floor
(``cl_floors.simgcl_step_floor_s``: the clean LightGCN term, the two views'
L products forward and twice that backward, both InfoNCE GEMMs, the table
and Adam's moments once) over the time of a step, taken by the host's clock
over ``STEPS`` steps of the window's own call after the traced window
closed, as ``train_step_mfu_pct`` reads the LightGCN step."""
from benchmark import cl_floors, peaks

STEPS = 16


def floor_s(shape: dict) -> float:
    return cl_floors.simgcl_step_floor_s(shape)


def read(ctx):
    time_steps = getattr(ctx.state, "time_steps", None)
    shape = getattr(ctx.state, "shape", None)
    if time_steps is None or not shape or "unique_users" not in shape:
        return None
    return peaks.share_pct(floor_s(shape), time_steps(STEPS))
