"""A request's wait from ``enqueue()`` until its prompt's copy burst is
accepted (the server's ``serving.request.queue_wait_us`` gauge, one an
admission), the mean over the window's admissions, in ms."""
from bench.harness import stages


def read(run):
    return stages.gauge_mean_ms(run, "serving.request.queue_wait_us")
