"""The card's idle time between kernels while the host was inside a
``model.ssm`` span (the Mamba-2 mixer's forward and its remat replay; its
backward runs in autograd's engine with no Python frame to hold a span),
over the device span, in %."""
from bench.harness import stages


def read(run):
    return stages.idle_share(run, ("model.ssm",))
