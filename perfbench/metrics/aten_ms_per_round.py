"""Device milliseconds a round of the kernels the port does not write
(everything but `kernels/csrc`: the plain-torch growth, routing, gradients
and their copies' kernels), from the traced fit."""


def read(r):
    if r.work.get("kind") != "train":
        return None
    s = sum(e - b for name, b, e in r.trace.kernels if not r.is_port(name)) / 1e6
    return 1e3 * s / r.work["rounds"]
