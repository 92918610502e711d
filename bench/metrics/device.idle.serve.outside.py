"""The card's idle time between kernels while the host was inside no
stage span of the program (the caller's loop between server steps), over
the device span, in %."""
from bench.harness import stages


def read(run):
    return stages.idle_share(run, None)
