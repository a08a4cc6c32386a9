"""Seconds of the window's session's warm-up (the program's span
``session.warmup``)."""

from portbench.metrics._stream import session_s


def read(rec):
    return session_s(rec, "session.warmup")
