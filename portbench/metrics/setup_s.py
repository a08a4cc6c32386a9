"""Seconds from the start of the process to the first timed query: data,
build, session, warm-up, and any kernel compilation (host clock)."""


def read(rec):
    return rec["setup_s"]
