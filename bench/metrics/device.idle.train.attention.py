"""The card's idle time between kernels while the host was inside any
``model.attention`` span on any thread (the forward, its remat replay and
the attention backward), over the device span, in %."""
from bench.harness import stages


def read(run):
    return stages.idle_share(run, ("model.attention",))
