"""The whole round's share of the card's peak, in percent: the least time
of the traced rounds' work (`roofline.training_round`) over their time in
the untraced window of the same run (its wall time a round)."""

from perfbench import roofline as RF


def read(r):
    w = r.work
    if w.get("kind") != "train":
        return None
    least = sum(RF.least_s(*RF.training_round(w["rows"], w["features"], w["max_bins"],
                                              w["depth"], rows))
                for rows in w["hist_rows"])
    return 100.0 * least / (w["round_s"] * len(w["hist_rows"]))
