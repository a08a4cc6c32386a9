"""Wall seconds of the index build on the cell's corpus, ending in a
synchronise (host clock)."""


def read(rec):
    return rec["build_s"]
