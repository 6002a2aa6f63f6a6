"""``b_ii_build_s.train``: seconds of set-up's B_ii build, the program's own
always-on timer of the code that the span ``setup.item_op`` wraps
(``FastBipartite.build_seconds["item_op"]``: ``build_item_operator`` and its
synchronize). Set-up runs before a reader could turn recording on."""


def read(ctx):
    fb = getattr(ctx.state, "fb", None)
    return (getattr(fb, "build_seconds", None) or {}).get("item_op")
