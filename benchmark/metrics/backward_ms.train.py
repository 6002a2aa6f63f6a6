"""``backward_ms.train``: device ms a step of the span ``train.backward``
(``torch.autograd.grad`` of the BPR + L2 loss: the chain's GEMMs again, the
batch gather's and ``fast_to_items``' backward), over the stream interval
between its CUDA events, in one recording pass of ``spans.STEPS`` steps after
the traced window closed (``benchmark/spans.py``)."""
from benchmark import spans


def read(ctx):
    return spans.device_ms_per_unit(ctx, "train.backward")
