"""The least time the traced stretch's scans could take on the card (2·B·N·F
operations at the TF32 peak, or the corpus and query bytes at the memory
bandwidth, whichever is longer, B the queries asked) over the card's busy
time in the stretch, in percent."""

from portbench.roofline import scan_share


def read(rec):
    return scan_share(rec)
