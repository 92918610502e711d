"""Cells cut to a size a CPU test can hold: the configuration's
``reduced()`` model (d_model 128, 4 layers, 4 experts) and a traffic mix
of a few short requests or steps, run on the CPU.  The tests drive the
rest of a run with them: the drivers, the readers, the result line and
the check against the reference."""
from __future__ import annotations

import dataclasses
import time

from bench.harness import core
from bench.harness.model import as_dict, model_config

#: each kind's traffic at the small size
SMALL_TRAFFIC = {
    "serve": dict(clients=3, slots=3, max_cache_len=96, round=6,
                  prompt_tokens={"dist": "lognormal", "median": 16, "sigma": 0.5, "min": 4,
                                 "max": 40},
                  output_tokens={"dist": "uniform", "min": 3, "max": 10},
                  profile_after_s=0.0, profile_s=0.3,
                  check={"requests": 3, "served_tokens": 40}),
    "train": dict(batch=2, seq=32),
}


def small_cell(name: str, dtype: str = None, root=core.ROOT) -> core.Cell:
    cell = core.Cell(name, root=root)
    m = model_config(cell.config["model"]).reduced()
    if dtype is not None:
        m = dataclasses.replace(m, dtype=dtype)
    cell.config = dict(cell.config, model=as_dict(m))
    cell.traffic = dict(cell.traffic, **SMALL_TRAFFIC[cell.traffic["kind"]])
    return cell


def small_run(cell: core.Cell, seed: int, seconds: float = 1.0, trace: int = 0) -> core.Run:
    """Drive one run of ``cell`` on the CPU, the card check left out."""
    import importlib

    run = core.Run(cell, seed, seconds, trace, time.perf_counter(), device="cpu", guard=False)
    importlib.import_module(f"bench.harness.{cell.traffic['kind']}").run_cell(run)
    return run
