"""``sampler_ms.train``: device ms a step of the span ``train.sample`` (the
BPR sampler, ``sampling/bpr.py:sample_batch``), over the stream interval
between its CUDA events, in one recording pass of ``spans.STEPS`` steps in
the window's calls of the mix's ``steps_per_call`` after the traced window
closed (``benchmark/spans.py``): the sampler after each call's wait for the
device, host-bound, weighs as it does in the window."""
from benchmark import spans


def read(ctx):
    return spans.device_ms_per_unit(ctx, "train.sample")
