"""The readings a cell's limits are set from, several seeds in one
process.  For each seed: the program's numbers (a run of the cell at its
own load, with a window of ``--seconds``), judged by the cell's limits;
and the control's, the reference computed with float8 e4m3 products in
the program's place, judged by the same comparison and limits, which it
has to fail.  For a training cell also the fault of a step whose loss
leaves out half of the batch, planted in the reference.  Prints one JSON
line a seed, with ``correct`` for the program, the control and the fault,
and exits 1 where the program comes out not correct, or the control or
the fault correct: the limits do not separate them.

    python3 bench/calibrate.py --workload dsmoe16b.rag --seeds 1,2,3 --seconds 10
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from bench.harness import core, serve, train  # noqa: E402
from bench.reference.layers import Precision  # noqa: E402

FP8 = Precision("fp8")

#: the serving cells' own check, kept before ``main`` puts the readings
#: in its place
SERVE_CHECK = serve.check


def _judged(run: core.Run) -> dict:
    return {"correct": run.correct, "checks": run.checks}


def serve_readings(run, layout, sample) -> None:
    """The program's served tokens, then the control's first choices in
    their place, each through the cell's own check."""
    SERVE_CHECK(run, layout, sample)
    ctl = core.Run(run.cell, run.seed, run.seconds, 0, time.perf_counter(), run.device, False)
    SERVE_CHECK(ctl, layout, sample, prec=FP8)
    run.records["readings"] = {"program": _judged(run), "control": _judged(ctl),
                               "tokens": run.records.get("checked_tokens"),
                               "requests": len(sample)}


def train_readings(run, layout, losses, grad_norms, change) -> None:
    """The program's numbers, the control's and the half-batch fault's,
    each against the reference and judged by the cell's limits."""
    ref = train.reference_steps(run, layout)
    gc.collect()
    low = train.reference_steps(run, layout, prec=FP8)
    gc.collect()
    half = train.reference_steps(run, layout, rows=run.cell.traffic["batch"] // 2)
    out = {}
    for who, got in {"program": (losses, grad_norms, change),
                     "control": (low["losses"], low["grad_norms"], low["change_norms"]),
                     "half_batch": (half["losses"], half["grad_norms"],
                                    half["change_norms"])}.items():
        judged = run if who == "program" else core.Run(
            run.cell, run.seed, run.seconds, 0, time.perf_counter(), run.device, False)
        readings = train.judge(judged, *got, ref)
        out[who] = dict(_judged(judged), readings={
            name: {"value": v, "at": str(where)} for name, (v, where) in readings.items()})
    run.records["readings"] = out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    core.cache_env()
    cell = core.Cell(args.workload)
    core.check_device(cell.chips)
    kind = cell.traffic["kind"]
    if kind == "serve":
        serve.check = serve_readings
        driver = serve
    elif kind == "train":
        train.check = train_readings
        driver = train
    else:
        raise SystemExit(f"bench: no control to read for a {kind!r} cell")
    held = True
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        run = core.Run(cell, seed, args.seconds, 0, t)
        driver.run_cell(run)
        readings = run.records["readings"]
        held &= all(r["correct"] == (who == "program") for who, r in readings.items()
                    if isinstance(r, dict))
        print(json.dumps({"workload": cell.name, "seed": seed, **readings,
                          "seconds": time.perf_counter() - t}), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0 if held else 1


if __name__ == "__main__":
    sys.exit(main())
