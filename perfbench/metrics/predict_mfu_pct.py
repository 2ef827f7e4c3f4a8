"""The whole predict call's share of the card's peak, in percent: the
window's calls' least time (`roofline.traversal_call`) over their
latencies in the untraced window."""

from perfbench import roofline as RF


def read(r):
    w = r.work
    if w.get("kind") != "predict":
        return None
    least = sum(RF.least_s(*RF.traversal_call(b, w["features"], w["n_trees"], w["arena"],
                                              b * w["n_trees"] * w["depth"]))
                for b, _ in w["window_calls"])
    return 100.0 * least / sum(s for _, s in w["window_calls"])
