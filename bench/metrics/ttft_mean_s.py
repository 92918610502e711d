"""The mean time to first token, enqueue to the end of the step that gave
the first token (host clock), over every request whose first token came
in the window."""


def read(run):
    v = run.records.get("ttft_s")
    return sum(v) / len(v) if v else None
