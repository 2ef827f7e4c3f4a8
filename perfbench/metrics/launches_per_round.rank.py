"""`launches_per_round` of the ranking cells, which report `rank_round_ms`: the same
reader."""
from perfbench.harness import load_metric

read = load_metric("launches_per_round").read
