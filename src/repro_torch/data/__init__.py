"""Data of the port: synthetic generators for the paper's six benchmark
datasets (Table 1 shapes) and the LM substrate's deterministic token
stream, as `repro.data` exports them."""
from repro_torch.data.datasets import DATASETS, DatasetSpec, dataset_spec, make_dataset
from repro_torch.data.tokens import TokenStream

__all__ = ["DATASETS", "DatasetSpec", "dataset_spec", "make_dataset", "TokenStream"]
