"""The benchmark of the PyTorch and CUDA port (`src/repro_torch`): one
command runs one cell once (`perfbench/run.py`); BENCHMARK.json at the
root of the repository names the cells, their configurations, traffic
mixes and metrics."""
