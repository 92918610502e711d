"""Run one benchmark cell once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights drawn on the card from the seed, the cell's shapes warmed)
counts from the start of this process; then the window of ``--seconds``;
then the check against the plain reference.  ``--trace 1`` reports the
cell's per-layer metrics from a profiled span of the window instead of
its end-to-end ones.  Exits non-zero with no result where there is no
card, where the cell asks for more cards than there are, or where JAX or
the JAX package was imported.
"""
import time

T0 = time.perf_counter()

import importlib  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness import core  # noqa: E402


def main(argv=None) -> int:
    args = core.parse_args(argv)
    core.cache_env()
    cell = core.Cell(args.workload)
    core.check_device(cell.chips)
    driver = importlib.import_module(f"bench.harness.{cell.traffic['kind']}")
    run = core.Run(cell, args.seed, args.seconds, args.trace, T0)
    driver.run_cell(run)
    metrics = core.read_metrics(run)
    bad = core.forbidden_modules()
    if bad:
        print(f"bench: the run imported {bad}: the benchmark measures repro_torch alone",
              file=sys.stderr)
        return 3
    core.print_result(core.result_line(run, metrics, core.device_info(run)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
