"""What every cell shares: the command line, finding a cell's files by
name in ``BENCHMARK.json``, the import guard, the device check, the
metric readers and the result line.

A cell is ``(configuration, traffic mix)``.  The configuration is
``bench/configs/<config>.json`` (the sizes as run, and the name of its
plain reference under ``bench/reference/``); the traffic mix is
``bench/traffic/<traffic>.json``, whose ``kind`` picks the general driver
(``bench/harness/<kind>.py``); each metric is read by
``bench/metrics/<metric>.py``; the limits that decide ``correct`` are
``bench/limits/<cell>.json``.  A later configuration, mix or metric is a
new file and a new entry in ``BENCHMARK.json``, never an edit here.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

#: top-level module names no run may hold: JAX and the JAX package the
#: port was made from (compared whole: ``repro_torch`` is not ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

#: the NVIDIA H100 SXM data sheet's dense peaks, at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def cache_env(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout:
    the port's nvcc builds go to ``build/repro_torch`` (fixed in its code),
    a torch extension or Triton kernel to ``build/``; JAX is kept away from
    any library that would load it."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module of ``bench/`` found by file name (names may hold dots and
    dashes, which no import statement takes)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic and
    limits, each read from its own file."""

    def __init__(self, name: str, root: Path = ROOT):
        bench_file = root / "BENCHMARK.json"
        if not bench_file.is_file():
            raise FileNotFoundError(f"{bench_file} is missing")
        self.spec = load_json(bench_file)
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"there are {sorted(cells)}")
        self.name = name
        self.bench = root / "bench"
        self.workload = cells[name]
        configs = {c["name"]: c for c in self.spec["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = load_json(root / self.config_entry["file"])
        self.traffic_name = self.workload["traffic"]
        self.traffic = load_json(self.bench / "traffic" / f"{self.traffic_name}.json")
        self.limits = load_json(self.bench / "limits" / f"{name}.json")
        self.chips = int(self.workload["chips"])

    def metrics(self, trace: int) -> List[dict]:
        """The metrics this cell reports: its end-to-end ones untraced, its
        per-layer ones traced."""
        group = self.spec["per_layer"] if trace else self.spec["end_to_end"]
        return [m for m in group if "workloads" not in m or self.name in m["workloads"]]

    def reference(self):
        """The configuration's plain reference module."""
        mod = self.config["reference"]
        return load_module(self.bench / "reference" / f"{mod}.py", f"bench_reference_{mod}")


def forbidden_modules(names=None) -> List[str]:
    """Top-level names in ``sys.modules`` (or ``names``) that are JAX or
    the JAX package, compared whole."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def check_device(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench: torch.cuda.is_available() is False; this cell runs on "
                         "NVIDIA GPUs only")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"bench: the cell asks for {chips} cards, "
                         f"torch.cuda.device_count() is {torch.cuda.device_count()}")


def quantile(values, q: float) -> float:
    """The q-th quantile (0..1) by linear interpolation between order
    statistics (numpy's default)."""
    v = sorted(values)
    if not v:
        return float("nan")
    pos = q * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


class Run:
    """One run of a cell: its arguments, what the driver collected, and
    what the metric readers take from it.  ``records`` holds the driver's
    own host-clock readings, ``gauges`` the program's observer gauges
    summed, ``trace`` the device trace of the traced span (``--trace 1``),
    ``checks`` each number compared with its limit."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: int, t0: float,
                 device: str = "cuda", guard: bool = True):
        self.cell = cell
        self.guard = guard  # the benchmark's own process: no JAX may be loaded
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.t0 = t0
        self.device = device
        self.setup_s: Optional[float] = None
        self.records: Dict[str, Any] = {}
        self.gauges: Dict[str, List[float]] = {}
        self.device_trace = None  # the traced span, the device alone
        self.host_trace = None  # a span with the host's ops, naming idle gaps
        self.checks: Dict[str, Dict[str, float]] = {}
        self.attempted = 0
        self.failed = 0
        self.memory_peak_bytes = 0

    def finish_setup(self) -> None:
        """Set-up is over: its seconds from the process's start; and, in
        the benchmark's own process, nothing of JAX loaded by then."""
        import time

        if self.guard and forbidden_modules():
            raise SystemExit(f"bench: set-up imported {forbidden_modules()}")
        self.setup_s = time.perf_counter() - self.t0

    def check(self, name: str, value: float, limit: float) -> bool:
        """Record one compared number beside its limit; within it or not."""
        self.checks[name] = {"value": float(value), "limit": float(limit)}
        return float(value) <= float(limit)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c["value"] <= c["limit"]
                                         for c in self.checks.values())


class Gauges:
    """An observer for the server (``.gauge(name, value)``): every value
    of every gauge, kept in memory for the metric readers."""

    def __init__(self):
        self.values: Dict[str, List[float]] = {}

    def gauge(self, name: str, value: float) -> None:
        self.values.setdefault(name, []).append(float(value))


def read_metrics(run: Run) -> Dict[str, Dict[str, Any]]:
    """Each of the cell's metrics from its reader; a reader that finds
    nothing to read returns None and the metric is left out."""
    out: Dict[str, Dict[str, Any]] = {}
    for m in run.cell.metrics(run.trace):
        reader = load_module(run.cell.bench / "metrics" / f"{m['name']}.py",
                             f"bench_metric_{m['name'].replace('.', '_')}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def device_info(run: Run) -> Dict[str, Any]:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": run.cell.chips, "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.trace and run.device_trace is not None:
        info["busy_s"] = run.device_trace.busy_s
        info["window_s"] = run.device_trace.window_s
    return info


def result_line(run: Run, metrics: Dict[str, Any], device: Dict[str, Any]) -> dict:
    out = {"correct": run.correct, "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics, "device": device}
    if run.trace and run.device_trace is not None:
        out["breakdown"] = run.device_trace.breakdown(run.host_trace)
    # the numbers compared, each beside its limit, as the last key
    out["checks"] = run.checks
    return out


def print_result(line: dict) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
