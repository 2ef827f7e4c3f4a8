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
