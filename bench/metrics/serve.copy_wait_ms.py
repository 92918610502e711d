"""A request's wait from its copy burst's acceptance until its prefill
starts (the server's ``serving.request.copy_wait_us`` gauge, one an
admission), the mean over the window's admissions, in ms."""
from bench.harness import stages


def read(run):
    return stages.gauge_mean_ms(run, "serving.request.copy_wait_us")
