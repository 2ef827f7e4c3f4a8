"""Share of the traced fit in which no kernel and no copy ran on the card,
in percent: one less the union of the busy intervals over the span."""


def read(r):
    if r.work.get("kind") != "train":
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
