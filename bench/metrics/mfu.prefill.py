"""The model FLOPs of the prompts prefilled in the window over the
seconds of the server's poll stage, which runs them (its
``serving.stage.poll_us`` gauge), times the bf16 peak, in %."""
from bench.harness.core import PEAK_BF16_FLOPS


def read(run):
    p = run.records.get("processed", {}).get("prefills")
    poll_s = sum(run.gauges.get("serving.stage.poll_us", [])) / 1e6
    if not p or poll_s <= 0:
        return None
    ref, cfg = run.cell.reference(), run.cell.config["model"]
    return 100.0 * sum(ref.prefill_flops(cfg, n) for n in p) / (poll_s * PEAK_BF16_FLOPS)
