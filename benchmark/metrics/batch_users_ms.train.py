"""``batch_users_ms.train``: device ms a step of the span ``ops.batch_users``
(``fast_batch_embeddings``' CSR gather of the batch users' arcs and
``batch_messages``), over the stream interval between its CUDA events, in
one recording pass of ``spans.STEPS`` steps after the traced window closed
(``benchmark/spans.py``)."""
from benchmark import spans


def read(ctx):
    return spans.device_ms_per_unit(ctx, "ops.batch_users")
