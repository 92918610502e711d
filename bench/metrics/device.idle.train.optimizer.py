"""The card's idle time between kernels while the host was inside
``train.optimizer`` (the gradient clip, ``AdamW.update`` and the layout
maps), over the device span, in %."""
from bench.harness import stages


def read(run):
    return stages.idle_share(run, ("train.optimizer",))
