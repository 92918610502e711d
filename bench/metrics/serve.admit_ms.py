"""The server's poll stage (commit, batch-1 prefill, splice) per
admission in the window: the sum of its ``serving.stage.poll_us`` gauge
over the prompts prefilled, in ms."""


def read(run):
    n = len(run.records.get("processed", {}).get("prefills", []))
    v = run.gauges.get("serving.stage.poll_us", [])
    return sum(v) / n / 1e3 if n and v else None
