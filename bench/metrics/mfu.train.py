"""3 x the forward model FLOPs of a step's tokens (the configuration's
formulas, bench/reference/; recomputation not counted) over the median
step's seconds in the window (host clock) times the bf16 peak, in %."""
import statistics

from bench.harness.core import PEAK_BF16_FLOPS


def read(run):
    steps = run.records.get("step_s")
    if not steps:
        return None
    spec, cfg = run.cell.traffic, run.cell.config["model"]
    flops = run.cell.reference().train_step_flops(cfg, spec["batch"], spec["seq"])
    return 100.0 * flops / (statistics.median(steps) * PEAK_BF16_FLOPS)
