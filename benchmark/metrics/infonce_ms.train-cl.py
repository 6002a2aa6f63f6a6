"""``infonce_ms.train-cl``: device ms a step of the span ``train.cl.infonce``
(both InfoNCE terms over the batch's unique users and positives: the
[B, B] scores, the masked log-softmax, the mean), over the stream interval
between its CUDA events, in the recording pass of ``benchmark/spans.py``."""
from benchmark import spans


def read(ctx):
    return spans.device_ms_per_unit(ctx, "train.cl.infonce")
