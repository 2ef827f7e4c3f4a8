"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the plain reference, and the result line.

Everything that belongs to one cell is found by its name in
`BENCHMARK.json`: the configuration's file (`configs/<config>.json`), the
traffic mix (`traffic/<traffic>.json`, whose "driver" names the loop in
`drivers/`), the limits of its check (`limits/<cell>.json`) and each
per-layer metric's reader (`metrics/<metric>.py`). Adding a cell, a mix or
a metric adds files and entries; no file here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import re
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

import torch

from perfbench import trace as TR

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, whole


@dataclass
class Cell:
    """What a driver gets: the cell's entries and files, resolved."""

    name: str
    seed: int
    device: torch.device
    config: dict
    traffic: dict
    limits: dict
    spec: dict = field(repr=False, default_factory=dict)


@dataclass
class Compared:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit  # NaN fails


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(name: str, seed: int, device, root: Path = ROOT,
              spec: dict | None = None) -> Cell:
    spec = spec or load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    limits_file = HERE / "limits" / f"{name}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.exists() else {}
    return Cell(name, int(seed), torch.device(device), config, traffic, limits, spec)


def driver_for(cell: Cell):
    module = importlib.import_module(f"perfbench.drivers.{cell.traffic['driver']}")
    return module.Driver(cell)


def load_metric(name: str):
    """The reader of per-layer metric `name` (`metrics/<name>.py`, loaded by
    path: names may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def port_kernel_names(root: Path = ROOT) -> frozenset[str]:
    """The `__global__` functions of the port's CUDA sources: the kernels
    the port writes itself. Every other device kernel is a library's."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?"
                     r"(\w+)\s*\(", re.S)
    names = set()
    for src in sorted((root / "src" / "repro_torch" / "kernels" / "csrc").glob("*.cu")):
        text = re.sub(r"//[^\n]*|/\*.*?\*/", "", src.read_text(), flags=re.S)
        names.update(pat.findall(text))
    return frozenset(names)


def kernel_base(name: str) -> str:
    """A profiler kernel name without its return type, template arguments
    and parameters: `void f<4, 1024>(int*)` -> `f`."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].split("::")[-1].strip()


@dataclass
class Readout:
    """What a per-layer metric reads: the traced stretch and the work the
    driver counted."""

    trace: TR.Trace
    work: dict
    port_kernels: frozenset

    def is_port(self, kernel: str) -> bool:
        return kernel_base(kernel) in self.port_kernels


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    try:
        return float(out.stdout.split()[0])
    except (IndexError, ValueError):
        return None


def finite(v) -> float:
    """A reading as a JSON number: an infinite or undefined gap (a split the
    reference finds invalid) reads as the largest float."""
    v = float(v)
    return v if math.isfinite(v) else sys.float_info.max


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def per_layer_for(spec: dict, cell: str, reported: set[str]) -> list[dict]:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list that move an end-to-end metric it reports."""
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def end_to_end_for(spec: dict, cell: str) -> list[dict]:
    return [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]


def run(name: str, seed: int, seconds: float, trace: bool, *, device="cuda",
        started: float | None = None, root: Path = ROOT, cell: Cell | None = None) -> dict:
    """One run; returns the result object (the result line's keys). Raises
    if the run cannot finish. `cell` may carry a configuration resized for
    a test; `started` is when the process started (set-up counts from it)."""
    started = time.perf_counter() if started is None else started
    cell = cell or load_cell(name, seed, device, root)
    spec = cell.spec
    on_card = cell.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(cell.device)
    drv = driver_for(cell)
    drv.setup()
    if on_card:
        torch.cuda.synchronize(cell.device)
    setup_s = time.perf_counter() - started
    e2e = drv.window(seconds)
    e2e["setup_s"] = setup_s
    phases = {"setup": setup_s, "window": time.perf_counter() - started - setup_s}
    traced = drv.trace() if trace else None
    memory_peak = (max(torch.cuda.max_memory_allocated(i) for i in range(drv.n_devices))
                   if on_card else 0)
    drv.release()
    t0 = time.perf_counter()
    compared = [Compared(n, finite(v), float(cell.limits[n])) for n, v in drv.check().items()]
    correct = drv.failed == 0 and all(c.ok for c in compared)
    phases["check"] = time.perf_counter() - t0
    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    device_info = {"platform": "gpu" if on_card else cell.device.type,
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": drv.n_devices, "memory_peak_bytes": int(memory_peak),
                   "power_limit_w": power_limit_w() if on_card else None}
    result = {"correct": correct, "attempted": drv.attempted, "failed": drv.failed}
    if not trace:
        names = [m["name"] for m in end_to_end_for(spec, cell.name)]
        result["metrics"] = {n: {"value": e2e[n], "unit": units[n]} for n in names}
    else:
        readout = Readout(traced, drv.work(), port_kernel_names(root))
        reported = {m["name"] for m in end_to_end_for(spec, cell.name)}
        metrics = {}
        for m in per_layer_for(spec, cell.name, reported):
            value = load_metric(m["name"]).read(readout)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        result["metrics"] = metrics
        device_info["busy_s"] = traced.busy_s()
        device_info["window_s"] = traced.window_s
        by_kernel = [(kernel_base(k), s) for k, s in traced.device_s_by_kernel().items()]
        result["breakdown"] = {"device_ops": TR.top(by_kernel),
                               "idle_gaps": TR.top(traced.idle_gaps())}
    result["device"] = device_info
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in compared}
    result["_compared"] = compared
    result["_errors"] = drv.errors
    phases["total"] = time.perf_counter() - started
    result["_phases"] = phases
    return result


def main(args, started: float) -> int:
    cell = load_cell(args.workload, args.seed, "cuda")
    chips = next(w["chips"] for w in cell.spec["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this cell needs {chips} CUDA device(s); found {have}. The benchmark "
              "runs only on the card and never falls back to the CPU", file=sys.stderr)
        return 2
    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                     started=started, cell=cell)
    except Exception:
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or of the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    compared, errors = result.pop("_compared"), result.pop("_errors")
    for e in errors[:3]:
        print(e, file=sys.stderr)
    print("seconds " + " ".join(f"{k} {v:.3f}" for k, v in result.pop("_phases").items()),
          file=sys.stderr)
    for c in compared:
        print(f"{c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
