"""``users_per_batch.serve``: the batcher's own counters over the window,
users it dispatched in shared batches over those batches (requests of
``solo_min`` users or more bypass it and are not counted)."""


def read(ctx):
    c = getattr(ctx.state, "counters", None)
    if not c or not c.get("batches_total"):
        return None
    return c["batched_users_total"] / c["batches_total"]
