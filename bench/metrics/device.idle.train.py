"""The share of the profiled span in which no operation ran on the card
(torch.profiler), in %."""


def read(run):
    tr = run.device_trace
    return 100.0 * (1.0 - tr.busy_s / tr.window_s) if tr is not None and tr.window_s else None
