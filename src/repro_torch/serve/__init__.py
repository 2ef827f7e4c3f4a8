"""Serving: batched inference over the ensemble arena; counterpart of
`repro.serve`.

  * `traversal` — the ensemble-traversal kernel over raw rows, and the
    per-tree leaves over raw rows or packed words.
  * `engine`    — `PredictEngine`: a bucket ladder of programs, one CUDA
    graph a bucket on the card, pinned staging, p50/p99 accounting.
  * `interop`   — XGBoost JSON import and export.
"""
from repro_torch.serve.engine import PredictEngine
from repro_torch.serve.interop import export_xgboost_json, import_xgboost_json

__all__ = ["PredictEngine", "export_xgboost_json", "import_xgboost_json"]
