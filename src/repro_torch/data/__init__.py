from repro_torch.data.datasets import DATASETS, DatasetSpec, dataset_spec, make_dataset
