"""`aten_ms_per_round` of the ranking cells, which report `rank_round_ms`: the same
reader."""
from perfbench.harness import load_metric

read = load_metric("aten_ms_per_round").read
