"""``routing_ms.train-dgcf``: device ms a step of the span ``train.dgcf``
(the whole routed forward: every iteration's softmax, degrees, routed
product and score update), over the stream interval between its CUDA
events, in one recording pass of ``spans.STEPS`` steps after the traced
window closed (``benchmark/spans.py``)."""
from benchmark import spans


def read(ctx):
    return spans.device_ms_per_unit(ctx, "train.dgcf")
