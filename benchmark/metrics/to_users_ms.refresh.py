"""``to_users_ms.refresh``: device ms a refresh of the span ``ops.to_users``
(the service's f32 ELL and heavy head, ``fast_to_users``), over the stream
interval between its CUDA events, in one recording pass of
``spans.REFRESHES`` refreshes after the traced window closed
(``benchmark/spans.py``)."""
from benchmark import spans


def read(ctx):
    return spans.device_ms_per_unit(ctx, "ops.to_users")
