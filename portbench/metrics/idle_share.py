"""Share of the traced stretch in which no kernel, copy or set ran on the
card: 1 - (union of device intervals) / stretch (torch.profiler)."""

from portbench.trace import idle_share


def read(rec):
    return idle_share(rec.get("trace"))
