"""``cl_views_ms.train-cl``: device ms a step of the span ``train.cl.view``
(each perturbed view's forward: L layers of ``fast_to_users`` and
``fast_to_items`` over every node, each with its noise draw and add; two a
step), over the stream interval between its CUDA events, in one recording
pass of ``spans.STEPS`` steps after the traced window closed
(``benchmark/spans.py``)."""
from benchmark import spans


def read(ctx):
    return spans.device_ms_per_unit(ctx, "train.cl.view")
