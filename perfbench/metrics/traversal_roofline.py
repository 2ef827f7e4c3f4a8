"""Share of the traversal kernel's roofline in the traced predict calls, in
percent: the calls' least time (`roofline.traversal_call`, every row
visiting every level of every complete tree) over the device time of the
`ensemble_margins_kernel` launches."""

from perfbench import roofline as RF


def read(r):
    from perfbench.harness import kernel_base

    w = r.work
    if w.get("kind") != "predict":
        return None
    device_s = sum(e - b for name, b, e in r.trace.kernels
                   if kernel_base(name) == "ensemble_margins_kernel") / 1e6
    if device_s <= 0:
        return None
    least = sum(RF.least_s(*RF.traversal_call(b, w["features"], w["n_trees"], w["arena"],
                                              b * w["n_trees"] * w["depth"]))
                for b in w["traced_calls"])
    return 100.0 * least / device_s
