"""The server's decode stage per step in the window: the sum of its
``serving.stage.decode_us`` gauge over the steps that ran it, in ms (the
stage ends by reading the step's tokens, so it holds the device's work)."""


def read(run):
    v = [x for x in run.gauges.get("serving.stage.decode_us", []) if x > 0]
    return sum(v) / len(v) / 1e3 if v else None
