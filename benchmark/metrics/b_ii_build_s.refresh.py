"""``b_ii_build_s.refresh``: seconds of the service's own f32 B_ii build in
set-up, the program's always-on timer of the code that the span
``setup.item_op`` wraps (``svc.fast_bipartite.build_seconds["item_op"]``)."""


def read(ctx):
    fb = getattr(getattr(ctx.state, "svc", None), "fast_bipartite", None)
    return (getattr(fb, "build_seconds", None) or {}).get("item_op")
