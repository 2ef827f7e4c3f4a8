"""Comparison helpers shared by the port's parity tests (tests/test_torch_*.py)."""
import numpy as np


def assert_cuts_close(got: np.ndarray, want: np.ndarray, x: np.ndarray) -> None:
    """Rank-flip model; the +inf dedup padding must agree exactly."""
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    for j in range(x.shape[1]):
        col = np.sort(x[:, j][np.isfinite(x[:, j])])
        gap = float(np.diff(col).max()) if col.size >= 2 else 0.0
        tol = (np.spacing(np.float32(max(col.size, 2))) * max(gap, 1.0)
               + 1e-5 + 1e-5 * np.abs(want[j]))
        fin = np.isfinite(want[j])
        assert np.all(np.abs(got[j][fin] - want[j][fin]) <= tol[fin]), j


def tied_split_histogram(starts, n_features: int, max_bins: int, gap: int = 5,
                         missing_g: float = 0.0):
    """A split-scan input whose best thresholds tie exactly: one node per
    entry of `starts`, every feature alike. Node i's value bins below
    k = starts[i] hold (g, h) = (-(i + 1), 1), the bins from k + gap on
    (i + 1, 1), and the run between them nothing, so thresholds k - 1 ..
    k + gap - 1 split the rows alike and the lowest, k - 1, must win. The
    missing bin holds (missing_g * (i + 1), 1), or nothing when missing_g is
    0. Integer sums are exact in any order. Returns float32 (hist, parent)."""
    n_nodes = len(starts)
    b = np.arange(max_bins)[None, :]
    k = np.asarray(starts)[:, None]
    scale = np.arange(1, n_nodes + 1)[:, None]
    empty = (b >= k) & (b < k + gap)
    g = np.where(empty, 0, np.where(b < k, -scale, scale))
    h = np.where(empty, 0, 1)
    g[:, -1] = missing_g * scale[:, 0]
    h[:, -1] = 1 if missing_g else 0
    hist = np.stack([g, h], axis=-1).astype(np.float32)[:, None]
    hist = np.ascontiguousarray(np.broadcast_to(hist, (n_nodes, n_features, max_bins, 2)))
    return hist, hist[:, 0].sum(axis=1)
