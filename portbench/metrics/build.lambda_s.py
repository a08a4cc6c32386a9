"""The build's λτ stage, seconds (the builder's own synchronised stage
timer, ``stage_seconds["taumode"]``)."""


def read(rec):
    return rec["stages"].get("stage.taumode")
