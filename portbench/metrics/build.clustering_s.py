"""The build's clustering stage, seconds (the builder's own synchronised
stage timer, ``stage_seconds["clustering"]``)."""


def read(rec):
    return rec["stages"].get("stage.clustering")
