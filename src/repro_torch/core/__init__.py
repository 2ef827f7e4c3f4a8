"""Core of the port: the packed matrix, tree growth, boosting and metrics."""
# Function re-exports must not shadow submodule names (`predict`), as in
# the reference: its `predict` shim is exported as predict_proba.
from repro_torch.core.booster import Booster, BoosterConfig, TrainState
from repro_torch.core.booster import predict_margins, train
from repro_torch.core.booster import predict as predict_proba
from repro_torch.core.compress import (
    ChunkedPackedBins,
    CompressedMatrix,
    PackedBins,
    pack,
    unpack,
)
from repro_torch.core.compress import compress as compress_matrix
from repro_torch.core.convert import booster_from_numpy
from repro_torch.core.dmatrix import DeviceDMatrix, ExternalDMatrix
from repro_torch.core.metrics import Metric, get_metric, register_metric
from repro_torch.core.quantile import StreamingQuantileSketch, compute_cuts, quantize
from repro_torch.core.resilience import (
    ChunkIntegrityError,
    DivergenceError,
    NumericError,
    TrainingFault,
)
from repro_torch.core.sampling import StochasticParams, TreeContext
from repro_torch.core.split import SplitParams
from repro_torch.core.tree import Tree, grow_tree
from repro_torch.core.objectives import (
    Objective,
    as_objective,
    get_objective,
    register_objective,
)
from repro_torch.core.predict import (
    Ensemble,
    concat_ensembles,
    predict_binned,
    predict_binned_packed,
    predict_raw,
    truncate_rounds,
)

# Last: checkpoint/io.py imports the core modules above.
from repro_torch.checkpoint.io import CheckpointError  # noqa: E402

__all__ = [
    "Booster",
    "BoosterConfig",
    "CheckpointError",
    "ChunkIntegrityError",
    "ChunkedPackedBins",
    "DivergenceError",
    "NumericError",
    "TrainingFault",
    "StreamingQuantileSketch",
    "CompressedMatrix",
    "PackedBins",
    "compress_matrix",
    "pack",
    "unpack",
    "compute_cuts",
    "quantize",
    "SplitParams",
    "StochasticParams",
    "Tree",
    "TreeContext",
    "grow_tree",
    "TrainState",
    "train",
    "predict_proba",
    "predict_margins",
    "DeviceDMatrix",
    "ExternalDMatrix",
    "booster_from_numpy",
    "Metric",
    "Objective",
    "get_metric",
    "get_objective",
    "as_objective",
    "register_objective",
    "register_metric",
    "Ensemble",
    "concat_ensembles",
    "truncate_rounds",
    "predict_binned",
    "predict_binned_packed",
    "predict_raw",
]
