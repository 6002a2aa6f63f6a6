"""``routing_score_ms.train-dgcf``: device ms a step of the span
``train.dgcf.score`` (each score update: both normalizations, the tanh and
the blocked per-arc dot product over every arc and intent), in the
recording pass of ``benchmark/spans.py``."""
from benchmark import spans


def read(ctx):
    return spans.device_ms_per_unit(ctx, "train.dgcf.score")
