"""Dataset statistics of an event log (numpy only).

Counterpart of ``gnn_ecommerce_tpu/data/eda.py:event_stats`` over the
port's :class:`~.events.Events`, with pandas' definitions: ``value_counts``
sorts by count with ties in first-seen order, a median of an even count is
the mean of the two middle values, and a user's "first type" is the type of
their first event in log order.
"""
from __future__ import annotations

import numpy as np

from .events import Events
from .profile import value_counts


def event_stats(events: Events) -> dict:
    """The reference EDA summary: event, user and item counts, event-type
    shares, events per user and single-event-type users."""
    n_events = len(events)
    types = events.type_names()
    names, counts = value_counts(types)
    type_counts = {str(t): int(c) for t, c in zip(names, counts)}
    users, first, inverse, per_user = np.unique(
        events.user_id, return_index=True, return_inverse=True, return_counts=True
    )
    # Distinct types per user: distinct (user, type) pairs counted by user.
    type_codes = np.unique(types, return_inverse=True)[1].ravel()
    pairs = np.unique(inverse.ravel() * (type_codes.max(initial=0) + 1) + type_codes)
    types_per_user = np.bincount(pairs // (type_codes.max(initial=0) + 1), minlength=len(users))
    single = types_per_user == 1
    single_view = int((types[first[single]] == "view").sum())
    n_single = int(single.sum())
    return {
        "n_events": int(n_events),
        "n_users": int(len(users)),
        "n_items": int(len(np.unique(events.item_id))),
        "event_type_counts": type_counts,
        "purchase_share": float(type_counts.get("purchase", 0) / max(n_events, 1)),
        "events_per_user_mean": float(per_user.sum(dtype=np.float64) / len(per_user)),
        "events_per_user_median": float(np.median(per_user)),
        "events_per_user_max": int(per_user.max()),
        "single_event_type_user_share": float(n_single / max(len(users), 1)),
        "single_type_view_only_share": float(single_view / max(n_single, 1)),
    }
