"""Share of the histogram calls' roofline in the traced fit, in percent:
the sum of each call's least time (`roofline.histogram_call`: the root
over every row with the privatised kernel, each level below over the rows
of the smaller children with the row-id kernel, as the reference's routing
of the judged fit counts them) over the device time of every launch that
makes up those calls: the kernels, the fixed-point exponent and the
conversion to float32."""

from perfbench import roofline as RF

KERNELS = {"histogram_private_kernel", "histogram_rows_kernel", "histogram_cluster_kernel",
           "fixed_exponent_kernel", "histogram_dequantise_kernel"}


def read(r):
    from perfbench.harness import kernel_base

    w = r.work
    if w.get("kind") != "train":
        return None
    device_s = sum(e - b for name, b, e in r.trace.kernels if kernel_base(name) in KERNELS) / 1e6
    if device_s <= 0:
        return None
    least = 0.0
    for per_level in w["hist_rows"]:
        for level, rows in enumerate(per_level):
            nodes = 1 if level == 0 else 2 ** (level - 1)
            least += RF.least_s(*RF.histogram_call(rows, w["features"], w["max_bins"], nodes,
                                                   row_ids=level > 0))
    return 100.0 * least / device_s
