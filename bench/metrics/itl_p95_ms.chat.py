"""The 95th percentile, over all requests, of the gap between two
consecutive server steps that gave the request tokens (host clock),
in ms."""
from bench.harness.core import quantile


def read(run):
    v = run.records.get("itl_s")
    return 1e3 * quantile(v, 0.95) if v else None
