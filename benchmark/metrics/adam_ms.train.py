"""``adam_ms.train``: device ms a step of the span ``train.adam``
(``Adam.update`` of the whole table and its two moments, in place), over the
stream interval between its CUDA events, in one recording pass of
``spans.STEPS`` steps after the traced window closed (``benchmark/spans.py``)."""
from benchmark import spans


def read(ctx):
    return spans.device_ms_per_unit(ctx, "train.adam")
