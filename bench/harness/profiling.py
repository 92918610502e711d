"""The device trace of a traced span: ``torch.profiler`` over a stretch
of the window (CUPTI), reduced to the seconds the card was busy, the
kernel time by name, the longest idle gaps and what the host was doing
in each.

Recording the host's ops doubles the time of an eager step, so a span
records the device alone (``host=False``: busy seconds, kernels by name);
a second span with the host's ops on names the idle gaps."""
from __future__ import annotations

import time
from typing import Dict, List, Tuple


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    return int(fn()) if fn is not None else int(getattr(ev, f"{what}_us")() * 1000)


class DeviceTrace:
    """``with DeviceTrace(sync) as tr: ...`` profiles the block; ``sync``
    waits for the device at both ends, so that the span holds all of the
    block's device work."""

    def __init__(self, sync, host: bool = False):
        self.sync, self.record_host = sync, host
        self.kernels: List[Tuple[int, int, str]] = []  # (start ns, end ns, name)
        self.host: List[Tuple[int, int, str]] = []
        self.window_s = 0.0
        self.busy_s = 0.0

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.sync()
        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if self.record_host else [])
        if not torch.cuda.is_available():  # a CPU test: no device to trace
            acts = [ProfilerActivity.CPU]
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        self._torch = torch
        return self

    def __exit__(self, *exc):
        self.sync()
        t1 = time.perf_counter()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        self.window_s = t1 - self._t0
        cuda = self._torch.autograd.DeviceType.CUDA
        for ev in self._prof.profiler.kineto_results.events():
            start = _ns(ev, "start")
            end = start + _ns(ev, "duration")
            if ev.device_type() == cuda:
                self.kernels.append((start, end, ev.name()))
            elif end > start:
                self.host.append((start, end, ev.name()))
        self.kernels.sort()
        self.busy_s = self._union_ns() / 1e9
        del self._prof
        return False

    def _union_ns(self) -> int:
        total, cur_s, cur_e = 0, None, None
        for s, e, _ in self.kernels:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total

    def kernel_seconds(self, *names: str) -> float:
        """Device seconds of the kernels whose name holds any of ``names``."""
        return sum(e - s for s, e, n in self.kernels if any(x in n for x in names)) / 1e9

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s, e, n in self.kernels:
            out[n] = out.get(n, 0.0) + (e - s) / 1e9
        return out

    def gaps(self) -> List[Tuple[float, str]]:
        """Idle gaps between kernels, longest first, each named by the
        innermost host span that covers its middle (the benchmark's own
        ``bench.*`` spans and the program's ops)."""
        out = []
        cur_e = None
        for s, e, _ in self.kernels:
            if cur_e is not None and s > cur_e:
                out.append((cur_e, s))
            cur_e = e if cur_e is None else max(cur_e, e)
        out.sort(key=lambda g: g[0] - g[1])
        named = []
        for a, b in out[:10]:
            mid = (a + b) // 2
            cover = [(e - s, n) for s, e, n in self.host if s <= mid <= e]
            named.append(((b - a) / 1e9, min(cover)[1] if cover else "(no host span)"))
        return named

    def breakdown(self, named=None) -> dict:
        """The device ops that took most time in this span, and the longest
        idle gaps of ``named`` (a span with the host's ops recorded), or of
        this one."""
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:200], s] for n, s in ops],
                "idle_gaps": [[n[:200], s] for s, n in (named or self).gaps()]}


class Spans:
    """A traced run's two spans, one after the other inside the window:
    the device alone for ``device_s`` seconds, ``after_s`` after the window
    opens, then the host's ops too for ``host_s``.  ``tick()`` after each
    unit of work opens and closes them (a span of 0 s holds one unit)."""

    def __init__(self, run, sync, after_s: float, device_s: float, host_s: float):
        self.run, self.sync = run, sync
        self.plan = [(after_s, device_s, False), (0.0, host_s, True)] if run.trace else []
        self.open = None
        self.since = None  # when the last span closed (or the window opened)
        self.device_span = None  # (t0, t1) of the device span

    def tick(self, t_open: float) -> None:
        now = time.perf_counter()
        if self.open is not None and now - self.t0 >= self.dur:
            self._close()
            now = time.perf_counter()
        if self.open is None and self.plan and now - (self.since or t_open) >= self.plan[0][0]:
            _, self.dur, host = self.plan.pop(0)
            self.open = DeviceTrace(self.sync, host).__enter__()
            self.t0 = time.perf_counter()

    def _close(self) -> None:
        self.open.__exit__(None, None, None)
        self.since = time.perf_counter()
        if self.open.record_host:
            self.run.host_trace = self.open
        else:
            self.run.device_trace = self.open
            self.device_span = (self.t0, self.since)
        self.open = None

    def finish(self) -> None:
        if self.open is not None:
            self._close()
