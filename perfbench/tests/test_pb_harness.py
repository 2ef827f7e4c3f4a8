"""The harness on the CPU: BENCHMARK.json against its contract, the result
line, the refusals, a cell added by files alone, the check's control and
its faults. Card runs are in test_pb_card.py."""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import harness as H
from perfbench import trace as TR
from perfbench.reference import growth as RG

from .conftest import small_cell

ROOT = H.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_benchmark_json_meets_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "perfbench/run.py"] and SPEC["paths"] == ["perfbench"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    n_cells = len(SPEC["workloads"])
    # A full check of the 24 cells the benchmark may grow to fits its time.
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    configs = {c["name"]: c for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["why"]) <= 200 and len(c["source"]) <= 200
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in configs
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (H.HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (H.HERE / "limits" / f"{w['name']}.json").is_file()
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, n_cells // 4)
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and (H.HERE / "metrics" / f"{m['name']}.py").is_file()
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for cell in m.get("workloads", []):
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
    for cell in CELLS:  # every cell: setup_s, another end-to-end metric, a per-layer one
        reported = {m["name"] for m in H.end_to_end_for(SPEC, cell)}
        assert "setup_s" in reported and len(reported) >= 2
        assert H.per_layer_for(SPEC, cell, reported)
    assert len(json.dumps(SPEC)) <= 64 * 1024


def _run(name, trace=False, seed=7, **kw):
    res = H.run(name, seed, 0.3, trace, device="cpu", cell=small_cell(name, seed, **kw))
    for k in ("_compared", "_errors", "_phases"):
        res.pop(k)
    return res


def _fake_traced(fn):
    """The profiler's tables as the card gives them, from a CPU run."""
    fn()
    t = TR.Trace(start=0.0, end=1000.0)
    t.kernels = [("void (anonymous namespace)::histogram_private_kernel<4, 1024, false>(int)",
                  10.0, 110.0),
                 ("void (anonymous namespace)::ensemble_margins_kernel<1>(float const*)",
                  120.0, 220.0),
                 ("void at::native::vectorized_elementwise_kernel<4>(int)", 300.0, 700.0)]
    t.copies = [("Memcpy DtoD (Device -> Device)", 650.0, 800.0)]
    t.host = [("aten::index", 0.0, 10.0), ("cudaLaunchKernel", 850.0, 990.0)]
    return t


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_keys(cell):
    res = _run(cell)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    reported = {m["name"] for m in H.end_to_end_for(SPEC, cell)}
    assert set(res["metrics"]) == reported
    assert all(set(v) == {"value", "unit"} for v in res["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    assert set(res["checks"]) == set(json.loads((H.HERE / "limits" / f"{cell}.json").read_text()))
    json.loads(json.dumps(res, allow_nan=False))


@pytest.mark.parametrize("cell", CELLS)
def test_traced_result_keys(cell, monkeypatch):
    monkeypatch.setattr(TR, "traced", _fake_traced)
    res = _run(cell, trace=True)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "breakdown", "device",
                         "checks"]
    reported = {m["name"] for m in H.end_to_end_for(SPEC, cell)}
    want = {m["name"] for m in H.per_layer_for(SPEC, cell, reported)}
    assert set(res["metrics"]) <= want and res["metrics"]
    assert res["device"]["busy_s"] > 0 and res["device"]["window_s"] == 1e-3
    ops = dict(res["breakdown"]["device_ops"])
    assert "histogram_private_kernel" in ops and len(res["breakdown"]["idle_gaps"]) <= 10


def test_trace_reductions():
    t = _fake_traced(lambda: None)
    assert t.busy_intervals() == [(10.0, 110.0), (120.0, 220.0), (300.0, 800.0)]
    assert t.busy_s() == pytest.approx(700e-6)
    gaps = dict(TR.top(t.idle_gaps()))
    assert gaps["aten::index"] == pytest.approx(10e-6)
    assert gaps["cudaLaunchKernel"] == pytest.approx(200e-6)
    assert sum(gaps.values()) == pytest.approx(300e-6)


def _cli(args, cwd=ROOT, env_extra=None):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env_extra or {})}
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True,
                          env=env, timeout=300)


def test_without_a_card_no_result_and_no_cpu_fallback():
    p = _cli(["perfbench/run.py", "--workload", CELLS[0], "--seed", "3", "--seconds", "1"])
    assert p.returncode != 0
    assert "{" not in p.stdout and "CUDA" in p.stderr


def _copy(tmp_path: Path, with_src: bool) -> Path:
    dst = tmp_path / "checkout"
    dst.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", dst)
    shutil.copytree(H.HERE, dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    if with_src:
        (dst / "src").symlink_to(ROOT / "src")
    return dst


SNIPPET = """
import json, sys
sys.path[:0] = [{src!r}, '.']
import torch
torch.set_num_threads(2)
from perfbench import harness as H, trace as TR
{patch}
cell = H.load_cell({cell!r}, 5, 'cpu')
cell.config.update(rows=4000)
cell.traffic.update(rounds=3, warm_rounds=1, trace_rounds=2)
res = H.run({cell!r}, 5, 0.2, {trace}, device='cpu', cell=cell)
print(json.dumps({{k: v for k, v in res.items() if not k.startswith('_')}}))
"""


def test_only_the_benchmark_files_fail(tmp_path):
    dst = _copy(tmp_path, with_src=False)
    code = SNIPPET.format(src=str(dst / "src"), patch="", cell=CELLS[0], trace=False)
    p = _cli(["-c", code], cwd=dst, env_extra={"PYTHONPATH": ""})
    assert p.returncode != 0 and "{" not in p.stdout
    assert "repro_torch" in p.stderr


def test_a_cell_from_added_files_alone(tmp_path):
    dst = _copy(tmp_path, with_src=True)
    before = {p: p.read_bytes() for p in (dst / "perfbench").rglob("*") if p.is_file()}
    pb = dst / "perfbench"
    (pb / "configs" / "year-prediction.json").write_text(json.dumps({
        "name": "year-prediction", "generator": "tabular", "rows": 5000, "features": 90,
        "objective": "binary:logistic", "max_depth": 4, "max_bins": 64, "learning_rate": 0.3,
        "reg_lambda": 1.0, "min_child_weight": 1.0, "reduced": []}))
    (pb / "traffic" / "fits-3.json").write_text(json.dumps(
        {"driver": "train", "rounds": 3, "warm_rounds": 1, "trace_rounds": 2,
         "round_metric": "train_round_ms"}))
    (pb / "metrics" / "rounds_traced.py").write_text(
        "def read(r):\n    return r.work.get('rounds')\n")
    (pb / "limits" / "year-train.json").write_text(json.dumps(
        {"split_regret": 1e-3, "leaf_gap": 1e-4, "margin_gap": 1e-3, "threshold_mismatch": 0}))
    spec = json.loads((dst / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "year-prediction", "source": "https://example.org/year",
                            "file": "perfbench/configs/year-prediction.json", "reduced": [],
                            "why": "a wide table"})
    spec["workloads"].append({"name": "year-train", "config": "year-prediction",
                              "traffic": "fits-3", "chips": 1, "why": "short fits"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_round_ms":
            m["workloads"].append("year-train")
    spec["per_layer"].append({"name": "rounds_traced", "unit": "rounds", "better": "higher",
                              "source": "program_counter", "layer": "round loop and dispatch",
                              "moves": "train_round_ms", "workloads": ["year-train"]})
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    patch = ("def fake(fn):\n    fn()\n    t = TR.Trace(start=0.0, end=10.0)\n"
             "    t.kernels = [('void k(int)', 1.0, 2.0)]\n    return t\nTR.traced = fake")
    for trace in (False, True):
        code = SNIPPET.format(src=str(dst / "src"), patch=patch, cell="year-train", trace=trace)
        p = _cli(["-c", code], cwd=dst)
        assert p.returncode == 0, p.stderr[-3000:]
        res = json.loads(p.stdout.strip().splitlines()[-1])
        assert res["correct"] is True
        if trace:
            assert res["metrics"]["rounds_traced"] == {"value": 2.0, "unit": "rounds"}
        else:
            assert set(res["metrics"]) == {"train_round_ms", "setup_s"}
    after = {p: p.read_bytes() for p in before}
    assert after == before  # no file of the benchmark was edited


@pytest.mark.parametrize("cell", [c for c in CELLS if "predict" not in c])
def test_the_control_fails_the_training_limits(cell):
    drv = H.driver_for(small_cell(cell))
    drv.data = __import__("perfbench.data.generators", fromlist=["make"]).make(
        drv.cell.config, drv.cell.seed, drv.dev)
    got = drv.judge(*drv.stand_in(torch.bfloat16))
    assert any(v > drv.cell.limits[k] for k, v in got.items()), got
    own = drv.judge(*drv.stand_in(torch.float32))
    assert all(v <= drv.cell.limits[k] for k, v in own.items()), own


def test_the_control_fails_the_predict_limit():
    drv = H.driver_for(small_cell("higgs-predict", rows=200_000))
    drv.setup()
    drv.window(0.5)
    drv.release()
    assert drv.check()["prob_gap"] <= drv.cell.limits["prob_gap"]
    assert drv.judge(drv.stand_in(torch.bfloat16))["prob_gap"] > drv.cell.limits["prob_gap"]


def _stale_round(monkeypatch):
    import repro_torch.core.booster as B

    real, calls = B._apply_trees, {"n": 0}

    def apply(cfg, trees, data, margins):
        calls["n"] += 1
        return margins if calls["n"] % cfg.n_rounds == 2 else real(cfg, trees, data, margins)
    monkeypatch.setattr(B, "_apply_trees", apply)


def _half_batch(monkeypatch):
    from repro_torch.core import objectives as O

    for name in ("binary:logistic", "rank:pairwise"):
        obj = O.OBJECTIVES[name]

        def grad(m, y, _g=obj.grad, **extra):
            gh = _g(m, y, **extra)
            keep = (torch.arange(gh.shape[0]) % 2 == 0).to(gh.dtype)[:, None, None]
            return gh * 2 * keep
        monkeypatch.setitem(O.OBJECTIVES, name, obj._replace(grad=grad))


def _altered_leaf(monkeypatch):
    import repro_torch.core.tree as T

    real, calls = T.grow_tree, {"n": 0}

    def grow(*a, **k):
        tree = real(*a, **k)
        calls["n"] += 1
        if calls["n"] % 3 == 0:
            tree = tree._replace(leaf_value=tree.leaf_value * 1.05)
        return tree
    monkeypatch.setattr(T, "grow_tree", grow)


def _altered_answer(monkeypatch):
    from repro_torch.core import Booster

    real = Booster.predict

    def predict(self, data, *a, **k):
        out = real(self, data, *a, **k).clone()
        out[0] += 1e-3
        return out
    monkeypatch.setattr(Booster, "predict", predict)


def _half_batch_scored(monkeypatch):
    from repro_torch.core import Booster

    real = Booster.predict

    def predict(self, data, *a, **k):
        half = data.shape[0] // 2
        out = real(self, data[:half], *a, **k)
        return torch.cat([out, out.mean().expand(data.shape[0] - half)])
    monkeypatch.setattr(Booster, "predict", predict)


TRAIN_FAULTS = [_stale_round, _half_batch, _altered_leaf]
PREDICT_FAULTS = [_altered_answer, _half_batch_scored]
FAULT_CASES = [(c, f) for c in CELLS
               for f in (PREDICT_FAULTS if "predict" in c else TRAIN_FAULTS)]


@pytest.mark.parametrize("cell,fault", FAULT_CASES,
                         ids=[f"{c}-{f.__name__.strip('_')}" for c, f in FAULT_CASES])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    assert _run(cell)["correct"] is True
    fault(monkeypatch)
    res = _run(cell)
    assert res["correct"] is False, res["checks"]


def test_grow_faults_read_above_the_reference():
    cell = small_cell("higgs-train")
    drv = H.driver_for(cell)
    drv.data = __import__("perfbench.data.generators", fromlist=["make"]).make(
        cell.config, cell.seed, drv.dev)
    base = drv.judge(*drv.stand_in(torch.float32))
    for fault in (RG.Fault(stale_round=1), RG.Fault(half_batch=True),
                  RG.Fault(alter_round=2)):
        got = drv.judge(*drv.stand_in(torch.float32, fault))
        assert got["leaf_gap"] > 10 * max(base["leaf_gap"], 1e-9), (fault, got)
