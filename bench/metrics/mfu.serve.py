"""The model FLOPs of every prompt prefilled and token decoded in the
window (the configuration's formulas, bench/reference/) over the window's
seconds times the bf16 peak, in %."""
from bench.harness.core import PEAK_BF16_FLOPS


def read(run):
    r = run.records
    p = r.get("processed")
    if not p or not r.get("window_s"):
        return None
    ref, cfg = run.cell.reference(), run.cell.config["model"]
    flops = (sum(ref.prefill_flops(cfg, n) for n in p["prefills"])
             + sum(ref.decode_flops(cfg, pos) for pos in p["decode_positions"]))
    return 100.0 * flops / (r["window_s"] * PEAK_BF16_FLOPS)
