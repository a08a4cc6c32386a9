"""Seconds the window's session took to prepare the corpus when it was
made, ended by a synchronise (the program's span ``session.prepare``)."""

from portbench.metrics._stream import session_s


def read(rec):
    return session_s(rec, "session.prepare")
