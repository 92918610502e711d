"""The program's own stage spans and request gauges, read after the
window: what the per-layer metrics of the server's waits, the decode
step's launch and the card's idle time by program stage share.

The spans come from ``repro_torch.obs.spans.STAGES``, which records while
a ``torch.profiler`` session does, so a traced run's device span holds
them; they are stamped on the profiler's clock, the kernels' own.  A
program without the recorder, or a run without a device span, gives
nothing to read, and each reader returns None."""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple


def program_spans(run) -> Optional[list]:
    """The stage spans that overlap the device span's kernels (the first
    kernel's start to the last one's end), or None where there are no
    kernels, the program has no recorder, or its ring let spans go (the
    shares would then read spans as missing)."""
    tr = run.device_trace
    if tr is None or not tr.kernels:
        return None
    try:
        from repro_torch.obs import spans as spans_mod
    except ImportError:
        return None
    recorder = getattr(spans_mod, "STAGES", None)
    if recorder is None or recorder.dropped:
        return None
    lo, hi = tr.kernels[0][0], max(e for _, e, _ in tr.kernels)
    return [s for s in recorder.spans() if s.t1_ns > lo and s.t0_ns < hi]


def idle_gaps(kernels) -> List[Tuple[int, int]]:
    """The idle stretches between consecutive kernels, in ns, as
    ``DeviceTrace.gaps()`` finds them: from the latest end so far to the
    next kernel's start, where it starts later."""
    out, cur_e = [], None
    for s, e, _ in kernels:
        if cur_e is not None and s > cur_e:
            out.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return out


def _union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def covered_ns(gaps: List[Tuple[int, int]], intervals) -> int:
    """How much of ``gaps`` (sorted, disjoint) lies inside the union of
    ``intervals``."""
    cover = _union(intervals)
    total, j = 0, 0
    for a, b in gaps:
        while j < len(cover) and cover[j][1] <= a:
            j += 1
        k = j
        while k < len(cover) and cover[k][0] < b:
            total += min(b, cover[k][1]) - max(a, cover[k][0])
            k += 1
    return total


def idle_share(run, names: Optional[Tuple[str, ...]]) -> Optional[float]:
    """The idle time between kernels of the device span while the host was
    inside a span named in ``names`` (on any thread), over the span's
    ``window_s``, in %; with ``names`` None, while it was in no span at all.
    None where no such span was recorded."""
    spans = program_spans(run)
    if not spans:
        return None
    tr = run.device_trace
    gaps = idle_gaps(tr.kernels)
    if names is None:
        idle = sum(b - a for a, b in gaps)
        ns = idle - covered_ns(gaps, [(s.t0_ns, s.t1_ns) for s in spans])
    else:
        chosen = [(s.t0_ns, s.t1_ns) for s in spans if s.phase in names]
        if not chosen:
            return None
        ns = covered_ns(gaps, chosen)
    return 100.0 * ns / 1e9 / tr.window_s if tr.window_s else None


def gauge_mean_ms(run, name: str) -> Optional[float]:
    """The mean of a server gauge (in us) over the window, in ms."""
    v = run.gauges.get(name, [])
    return sum(v) / len(v) / 1e3 if v else None
