"""`device_idle_pct.train` of the ranking cells, which report
`rank_round_ms`: the same reader."""
from perfbench.harness import load_metric

read = load_metric("device_idle_pct.train").read
