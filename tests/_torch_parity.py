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


def constrained_split_inputs(rng, n_nodes: int, n_features: int, max_bins: int):
    """Random split-scan inputs for the constrained and masked scan:
    (hist, parent, monotone, bounds, mask). Bins 5-8 are empty (thresholds
    that tie exactly); the constraints cycle through -1, 0, +1; the nodes'
    [lower, upper] bounds cycle through unbounded, bounds that clip most
    child weights, one-sided ones and a pinched pair (lower == upper); the
    (n_nodes, n_features) mask leaves out about half the (node, feature)
    pairs and every feature of node 0. float32, int8, float32, bool."""
    hist = np.stack([rng.normal(size=(n_nodes, n_features, max_bins)),
                     rng.random((n_nodes, n_features, max_bins)) * 2],
                    axis=-1).astype(np.float32)
    hist[..., 5:9, :] = 0.0
    s = 1.0 / np.sqrt(max_bins)  # the scale of a child's weight -G / (H + lam)
    choices = np.array([[-np.inf, np.inf], [-0.3 * s, 0.5 * s], [-np.inf, 0.2 * s],
                        [0.0, np.inf], [-0.1 * s, -0.1 * s]], np.float32)
    mask = rng.random((n_nodes, n_features)) < 0.5
    mask[0] = False
    return (hist, hist[:, 0].sum(axis=1), (np.arange(n_features) % 3 - 1).astype(np.int8),
            choices[np.arange(n_nodes) % len(choices)], mask)


def jax_key(path):
    """The reference's key of a draw path: PRNGKey(path[0]) folded with
    each later integer, as `repro.core.sampling` and its booster fold
    (seed, round, class, tag[, level])."""
    import jax  # only the CPU parity tests replay the reference's draws

    key = jax.random.PRNGKey(path[0])
    for v in path[1:]:
        key = jax.random.fold_in(key, v)
    return key


def replay_uniform(path, shape, device):
    """`repro_torch.core.sampling.uniform` as the reference draws: JAX's
    uniforms at `jax_key(path)`, as a float32 tensor on `device`."""
    import jax
    import torch

    u = np.array(jax.random.uniform(jax_key(path), tuple(shape)), dtype=np.float32)
    return torch.from_numpy(u).to(device)


# The fixed-point exponent's edge inputs, (n, 2) float32 (g, h): the CPU
# tests hold the exponent kernel's arithmetic to `fixed.exponent` on them,
# the card tests the kernel itself.
EXPONENT_EDGES = {
    "no_rows": np.zeros((0, 2), np.float32),
    "one_row": np.array([[0.75, -3.0]], np.float32),
    "all_zero": np.zeros((1000, 2), np.float32),
    "subnormal": np.full((17, 2), np.float32(1e-40)) * np.array([1, -1], np.float32),
    "two_to_127": np.array([[2.0**127, 1.0], [0.0, -1.0]], np.float32),
    "inf": np.array([[1.0, 2.0], [np.inf, 0.5]], np.float32),
    "nan": np.array([[1.0, np.nan], [3.0, 0.5]], np.float32),
}
