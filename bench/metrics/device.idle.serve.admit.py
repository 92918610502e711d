"""The card's idle time between kernels while the host was inside an
admission (the program's ``serve.admit`` stage spans: the batch-1 prefill,
the splice, the first token's read), over the device span, in %."""
from bench.harness import stages


def read(run):
    return stages.idle_share(run, ("serve.admit",))
