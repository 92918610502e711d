"""Output tokens the server gave in the window over the window's seconds
(host clock): every token of every request, first tokens included."""


def read(run):
    r = run.records
    return r["tokens"] / r["window_s"] if r.get("window_s") else None
