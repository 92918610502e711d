"""The card's idle time between kernels while the host was inside a
``model.mla`` span (the latent attention sub-block of a prefill or a
decode step), over the device span, in %."""
from bench.harness import stages


def read(run):
    return stages.idle_share(run, ("model.mla",))
