"""Adapters that drive the system under test, one file per kind of
deployment, named by a configuration's ``system`` key."""
