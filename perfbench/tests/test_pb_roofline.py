"""The operation and byte counts against hand-worked small shapes."""
import pytest

from perfbench import roofline as RF


def test_peaks_and_least_time():
    assert RF.HBM_BYTES_PER_S == 3.35e12 and RF.FP32_OPS_PER_S == 67e12
    assert RF.least_s(3.35e12, 0) == pytest.approx(1.0)
    assert RF.least_s(0, 67e12) == pytest.approx(1.0)
    assert RF.least_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)  # the larger bound


@pytest.mark.parametrize("max_bins,bytes_per_row", [(256, 28.0), (16, 14.0), (64, 28.0),
                                                     (2, 3.5), (257, 56.0)])
def test_packed_row_bytes(max_bins, bytes_per_row):
    # 28 features: 8-bit symbols for 255 values, 4-bit for 15, 8-bit for 63
    # (bits round up to 1/2/4/8/16), 1-bit for 1, 16-bit for 256.
    assert RF.packed_row_bytes(28, max_bins) == bytes_per_row


def test_histogram_call_by_hand():
    # 1,000 rows x 4 features at 8 bits: 4 B symbols + 8 B (g, h) + 4 B
    # position a row; 2 nodes x 4 features x 256 bins x (g, h) float32 out.
    nbytes, nops = RF.histogram_call(1000, 4, 256, 2, row_ids=False)
    assert nbytes == 1000 * (4 + 8 + 4) + 2 * 4 * 256 * 2 * 4
    assert nops == 2 * 1000 * 4
    with_ids, _ = RF.histogram_call(1000, 4, 256, 2, row_ids=True)
    assert with_ids - nbytes == 8 * 1000


def test_traversal_call_by_hand():
    # 10 rows x 3 features, 2 trees of arena 8 (packed 8 B a node), every
    # row 2 levels deep in each: 3 operations a level, an add a (row, tree).
    nbytes, nops = RF.traversal_call(10, 3, 2, 8, 10 * 2 * 2)
    assert nbytes == 10 * 3 * 4 + 2 * 8 * 8 + 10 * 4
    assert nops == 3 * 40 + 10 * 2


def test_training_round_by_hand():
    # 100 rows x 2 features at 8 bits, depth 3: the packed matrix (2 B a
    # row) once a level; (g, h), label, margin read; position, margin
    # written; adds over the rows each level histograms.
    nbytes, nops = RF.training_round(100, 2, 256, 3, [100, 40, 30])
    assert nbytes == 3 * 100 * 2 + 100 * 16 + 100 * 8
    assert nops == 2 * 2 * 170
