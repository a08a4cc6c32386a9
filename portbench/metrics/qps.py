"""Queries answered per second of the closed loop's window: every query
of every batch, over the wall time from the first batch to the last
result (host clock)."""


def read(rec):
    w = rec["window"]
    if rec["traffic"]["kind"] != "closed" or w["seconds"] <= 0:
        return None
    return w["queries"] / w["seconds"]
