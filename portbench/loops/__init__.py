"""Traffic loops, one file per kind, named by a traffic file's ``kind``;
each has ``run(session, pool, params, seconds, seed, tracer, sync, log)``
returning the window's record."""
