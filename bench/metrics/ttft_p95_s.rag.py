"""The 95th percentile of time to first token, enqueue to the end of the
step that gave the first token (host clock), over every request whose
first token came in the window."""
from bench.harness.core import quantile


def read(run):
    v = run.records.get("ttft_s")
    return quantile(v, 0.95) if v else None
