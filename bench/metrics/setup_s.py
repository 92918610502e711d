"""Set-up seconds: process start to the first timed step (the weights
drawn, the model and server or step built, kernels built where the
checkout has none yet, the cell's shapes warmed)."""


def read(run):
    return run.setup_s
