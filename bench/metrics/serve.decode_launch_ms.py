"""The host time of the decode stage until ``_decode`` returns, before
the step's tokens are read (the server's ``serving.stage.decode_launch_us``
gauge), the mean over the window's steps that decoded, in ms."""
from bench.harness import stages


def read(run):
    return stages.gauge_mean_ms(run, "serving.stage.decode_launch_us")
