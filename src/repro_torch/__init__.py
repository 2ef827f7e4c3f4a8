"""PyTorch / CUDA port of the `repro` GBDT system (paper Figure 1 pipeline).

The JAX package `repro` is the reference; this package keeps its module
layout and public names (`core/quantile.py`, `core/booster.py`,
`kernels/ops.py`, ...) so each counterpart is found by path. It imports
torch and numpy only. Entry points run on the card (`device="cuda"`) unless
the caller asks for the CPU; on a CUDA tensor every hot operation launches
a hand-written Hopper kernel (`kernels/csrc/*.cu`), on a CPU tensor its
plain PyTorch version (`kernels/ref.py`).

    from repro_torch.core import Booster, DeviceDMatrix
    dtrain = DeviceDMatrix(x, label=y)            # cuda by default
    bst = Booster(n_rounds=10, objective="binary:logistic").fit(dtrain)
    p = bst.predict(x_new)
"""
from repro_torch.device import resolve_device
