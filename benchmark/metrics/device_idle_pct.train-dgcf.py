"""``device_idle_pct.train-dgcf``: the device's idle share of the traced window of DGCF training steps,
from the profiler's trace: 100 x (1 - busy / window), busy being the union
of the intervals in which a device operation ran."""
from benchmark.measure import idle_pct


def read(ctx):
    return idle_pct(ctx.trace)
