"""``refresh_mfu_pct``: one full LightGCN forward's model floor
(``peaks.lightgcn_forward_floor_s``) over the time of a refresh, taken by the
host's clock over ``REFRESHES`` refreshes after the traced window closed."""
from benchmark import peaks

REFRESHES = 8


def floor_s(shape: dict) -> float:
    return peaks.lightgcn_forward_floor_s(shape["n_nodes"], shape["arcs"], shape["dim"], shape["layers"])


def read(ctx):
    time_refreshes = getattr(ctx.state, "time_refreshes", None)
    if time_refreshes is None:
        return None
    return peaks.share_pct(floor_s(ctx.state.shape), time_refreshes(REFRESHES))
