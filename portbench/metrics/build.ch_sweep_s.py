"""Seconds of the build's Calinski-Harabasz sweep for the clustering's K
(the program's span ``clustering.ch_sweep``, under
``clustering_seconds["ch_sweep"]``)."""


def read(rec):
    return rec["stages"].get("clustering.ch_sweep")
