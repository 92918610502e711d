"""Tokens of all whole training steps run in the window over the time
those steps took (host clock; each step ends when its loss is read)."""


def read(run):
    r = run.records
    return r["tokens"] / r["window_s"] if r.get("steps") else None
