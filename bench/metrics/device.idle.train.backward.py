"""The card's idle time between kernels while the host was inside
``train.backward`` (``torch.autograd.grad``: the remat replays and the
attention backward with it), over the device span, in %."""
from bench.harness import stages


def read(run):
    return stages.idle_share(run, ("train.backward",))
