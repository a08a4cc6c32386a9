"""The program's own records of the window's stream and of its session,
for the readers of program spans and counters.

``arrowspace_torch.utils.profiling.records()`` keeps the last session and
stream records: totals of each span (``count``, ``total_s``, ``self_s``)
and counter.  The window's stream is the one record whose ``batches`` and
``queries`` equal the window's; its session is the session record whose
id it carries.  A program without the recorder, or no unique match,
gives None.
"""


def program_records() -> list:
    try:
        from arrowspace_torch.utils.profiling import records
    except ImportError:
        return []
    return records()


def window_stream(rec):
    w = rec["window"]
    found = [r for r in program_records() if r.get("kind") == "stream"
             and r["counters"].get("batches") == w["requests"]
             and r["counters"].get("queries") == w["queries"]]
    return found[0] if len(found) == 1 else None


def window_session(rec):
    stream = window_stream(rec)
    if stream is None or stream.get("session") is None:
        return None
    found = [r for r in program_records() if r.get("kind") == "session"
             and r["id"] == stream["session"]]
    return found[0] if len(found) == 1 else None


def per_batch_ms(rec, name: str):
    """Milliseconds a batch of span ``name`` in the window's stream (0
    where the stream never entered it)."""
    stream = window_stream(rec)
    if stream is None:
        return None
    sp = stream["spans"].get(name)
    return 1e3 * (sp["total_s"] if sp else 0.0) / stream["counters"][
        "batches"]


def session_s(rec, name: str):
    """Seconds of span ``name`` in the window's session record."""
    session = window_session(rec)
    sp = session["spans"].get(name) if session is not None else None
    return None if sp is None else sp["total_s"]
