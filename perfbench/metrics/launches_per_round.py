"""Device kernels of the traced fit, over its rounds: an exact count of what
the round loop and its dispatch put on the card (every kernel, the port's
and the libraries')."""


def read(r):
    if r.work.get("kind") != "train":
        return None
    return len(r.trace.kernels) / r.work["rounds"]
