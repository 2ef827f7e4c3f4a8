"""Runs of every cell on the card, short: the result line, `correct`, and
the traced metrics. Skipped without a CUDA device; run on the card with

    python -m pytest -q -m cuda perfbench/tests/test_pb_card.py
"""
import json
import subprocess
import sys

import pytest
import torch

from perfbench import harness as H

SPEC = H.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(cell, trace):
    chips = next(w["chips"] for w in SPEC["workloads"] if w["name"] == cell)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA device(s)")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
                        str(2**32 + 17), "--seconds", "2", "--trace", str(trace)],
                       cwd=H.ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == chips
    assert res["device"]["kind"] == torch.cuda.get_device_name(0)
    reported = {m["name"] for m in H.end_to_end_for(SPEC, cell)}
    if trace:
        want = {m["name"] for m in H.per_layer_for(SPEC, cell, reported)}
        assert set(res["metrics"]) == want
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        for name, m in res["metrics"].items():
            if name.endswith("_roofline") or "mfu" in name:
                assert 0 < m["value"] <= 100
    else:
        assert set(res["metrics"]) == reported
    last = p.stderr.strip().splitlines()[-len(res["checks"]):]
    assert all(" limit " in line for line in last)
