"""Opt-in descriptor-lifecycle tracing (the per-operation view of §3.3/§5).

``Tracer`` owns a bounded ring of ``DescTrace`` span trees plus the
dependency edges (``after=`` fences, ``Future.then`` continuations) and
host wait spans needed to reconstruct the offload critical path.  It is
wired in by ``make_device(trace=...)``:

    device = make_device(trace=0.1)          # sample 10% of submissions
    ... workload ...
    from repro_torch.obs import to_perfetto, critical_path, phase_breakdown
    to_perfetto(device.tracer, "trace.json")  # chrome://tracing / Perfetto

Design constraints, in order:

  * hot path untouched when off: ``Device.submit`` does one attribute
    check; an unsampled submission costs one accumulator update;
  * bounded memory: traces / edges / wait spans live in fixed-capacity
    deques, while per-phase occupancy folds into MONOTONIC counters the
    ``Sampler`` delta-ticks (so live views survive ring rotation);
  * deterministic sampling: a fractional accumulator admits exactly
    ``rate`` of anonymous submissions (no RNG), and request-scoped
    contexts (``tracer.request(id)``) decide once per request id via a
    stable hash so every descriptor of a request is traced together;
  * typed configuration errors: a sampling rate outside [0, 1] raises
    ``TraceRateError`` (dsalint rule DSA105 flags literal occurrences
    statically).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import zlib
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

from repro_torch.obs.series import percentile
from repro_torch.obs.spans import PHASES, DescTrace


class TraceRateError(ValueError):
    """A ``trace=`` sampling rate outside [0, 1] (dsalint DSA105).

    Probabilities don't extrapolate: a rate of 1.5 silently tracing every
    submission (or -0.1 tracing none) hides a config bug, so the bad value
    is rejected at device construction with this typed error.
    """

    code = "DSA105"

    def __init__(self, rate: Any):
        super().__init__(
            f"trace sampling rate must be a number in [0, 1], got {rate!r} "
            f"[{self.code}]"
        )
        self.rate = rate


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Tracer knobs: sampling ``rate`` in [0, 1] (fraction of submissions
    traced; request contexts decide per request id) and ring ``capacity``
    (retained traces; edges/wait spans keep a few multiples)."""

    rate: float = 1.0
    capacity: int = 4096

    def __post_init__(self):
        try:
            ok = 0.0 <= float(self.rate) <= 1.0
        except (TypeError, ValueError):
            ok = False
        if not ok:
            raise TraceRateError(self.rate)
        if self.capacity < 1:
            raise ValueError(f"TraceConfig.capacity must be >= 1, "
                             f"got {self.capacity}")


@dataclasses.dataclass
class WaitSpan:
    """One WaitPolicy.wait interval with its host-cycle split — the same
    busy/free seconds the policy folds into the device's ``WaitStats``
    bucket, so span-derived host-free fractions reconcile exactly."""

    policy: str
    t0: float
    t1: float
    busy_s: float
    free_s: float
    completions: int = 0


def _op_name(desc: Any) -> str:
    op = getattr(desc, "op", None)
    if op is not None:
        return getattr(op, "value", None) or str(op)
    return "batch"


class Tracer:
    """Bounded, sampled collector of descriptor lifecycle traces."""

    def __init__(self, config: Optional[TraceConfig] = None):
        self.config = config or TraceConfig()
        cap = self.config.capacity
        # plain (uninstrumented) leaf lock: the tracer never calls out
        # while holding it, so it cannot extend the lockcheck lock graph
        self._lock = threading.Lock()
        self._ring: "collections.deque[DescTrace]" = collections.deque(maxlen=cap)
        self._edges: "collections.deque[Tuple[int, int, str]]" = (
            collections.deque(maxlen=8 * cap))
        self._waits: "collections.deque[WaitSpan]" = (
            collections.deque(maxlen=8 * cap))
        self._acc = 0.0  # fractional sampling accumulator
        self._tls = threading.local()
        # monotonic counters (delta-sampled by repro_torch.obs.Sampler)
        self.counters: Dict[str, float] = {
            "sampled": 0, "skipped": 0,
            "wait_spans": 0, "wait_busy_s": 0.0, "wait_free_s": 0.0,
        }
        self.phase_s: Dict[str, float] = {p: 0.0 for p in PHASES}
        self.phase_n: Dict[str, int] = {p: 0 for p in PHASES}

    # ------------------------------------------------------------------ sampling
    def _sample(self) -> bool:
        """Deterministic fractional-accumulator admission: over any run of
        N anonymous submissions, floor/ceil(N * rate) are sampled."""
        self._acc += self.config.rate
        if self._acc >= 1.0:
            self._acc -= 1.0
            return True
        return False

    def _sample_id(self, trace_id: str) -> bool:
        """Stable per-id decision (same id -> same answer on every entry,
        so a request re-entering its context keeps one verdict)."""
        rate = self.config.rate
        if rate >= 1.0:
            return True
        if rate <= 0.0:
            return False
        h = zlib.crc32(str(trace_id).encode()) & 0xFFFFFFFF
        return h < rate * 0x100000000

    @contextlib.contextmanager
    def request(self, trace_id: str):
        """Request-scoped trace context: every submission on this thread
        inside the block shares ``trace_id`` (and its sampling verdict).
        Re-entrant; restores the enclosing context on exit."""
        prev = getattr(self._tls, "ctx", None)
        self._tls.ctx = (str(trace_id), self._sample_id(str(trace_id)))
        try:
            yield
        finally:
            self._tls.ctx = prev

    def current_trace_id(self) -> Optional[str]:
        ctx = getattr(self._tls, "ctx", None)
        return ctx[0] if ctx is not None else None

    # ------------------------------------------------------------------ recording
    def begin(self, desc: Any) -> Optional[DescTrace]:
        """Start a trace for one submittable (Device.submit entry), or
        None when sampling skips it.  Inside a request context the
        request's id and verdict apply; otherwise the accumulator decides
        and the trace id derives from the descriptor id."""
        ctx = getattr(self._tls, "ctx", None)
        if ctx is not None:
            trace_id, sampled = ctx
        else:
            with self._lock:
                sampled = self._sample()
            trace_id = f"d{getattr(desc, 'desc_id', 0)}"
        if not sampled:
            with self._lock:
                self.counters["skipped"] += 1
            return None
        dt = DescTrace(trace_id, getattr(desc, "desc_id", -1), _op_name(desc),
                       nbytes=getattr(desc, "nbytes", 0), tracer=self)
        members = getattr(desc, "descriptors", None)
        if members is not None:
            dt.attrs["batch"] = len(members)
            created = [getattr(d, "created_t", None) for d in members]
            created = [t for t in created if t is not None]
        else:
            created = []
        t_create = getattr(desc, "created_t", None)
        if created:
            t_create = min(created) if t_create is None else min(
                [t_create] + created)
        if t_create is not None:
            dt.marks["create"] = t_create
        dt.mark("submit_enter")
        with self._lock:
            self._ring.append(dt)
            self.counters["sampled"] += 1
        return dt

    def begin_host(self, trace_id: str, desc_id: int, op: str) -> DescTrace:
        """Trace for a host-side continuation (Future.then): two phases —
        host_wait until the parent retires, callback for the function."""
        dt = DescTrace(trace_id, desc_id, op, tracer=self)
        dt.attrs["kind"] = "then"
        dt.mark("create")
        with self._lock:
            self._ring.append(dt)
            self.counters["sampled"] += 1
        return dt

    def edge(self, parent_desc_id: int, child_desc_id: int, kind: str) -> None:
        """Record a dependency edge ("after" fence or "then" continuation)
        for the critical-path DAG."""
        with self._lock:
            self._edges.append((int(parent_desc_id), int(child_desc_id), kind))

    def wait_span(self, policy: str, t0: float, t1: float,
                  busy_s: float, free_s: float, completions: int = 0) -> None:
        with self._lock:
            self._waits.append(WaitSpan(policy, t0, t1, busy_s, free_s,
                                        completions))
            c = self.counters
            c["wait_spans"] += 1
            c["wait_busy_s"] += busy_s
            c["wait_free_s"] += free_s

    def _fold(self, dt: DescTrace) -> None:
        """Fold ``dt``'s newly-completed phases into the monotonic
        occupancy counters (each phase of each trace counts once; called
        from terminal marks, possibly from several threads)."""
        durs = dt.phase_durations()
        with self._lock:
            for phase, d in durs.items():
                if phase in dt._folded:
                    continue
                dt._folded.add(phase)
                self.phase_s[phase] += d
                self.phase_n[phase] += 1

    # ------------------------------------------------------------------ snapshots
    def traces(self) -> List[DescTrace]:
        with self._lock:
            return list(self._ring)

    def edges(self) -> List[Tuple[int, int, str]]:
        with self._lock:
            return list(self._edges)

    def wait_spans(self) -> List[WaitSpan]:
        with self._lock:
            return list(self._waits)

    def counters_snapshot(self) -> Dict[str, float]:
        """Monotonic counters incl. per-phase folded seconds/counts
        (delta-sampling safe, like ``StreamEngine.counters_snapshot``)."""
        with self._lock:
            snap = dict(self.counters)
            for p in PHASES:
                snap[f"phase.{p}_s"] = self.phase_s[p]
                snap[f"phase.{p}_n"] = float(self.phase_n[p])
            return snap


def make_tracer(spec: Union[None, bool, int, float, TraceConfig, Tracer]
                ) -> Optional[Tracer]:
    """Resolve a ``trace=`` spec: None/False -> off, True -> rate 1.0, a
    number -> sampling rate (validated: TraceRateError outside [0, 1]), a
    TraceConfig or prebuilt Tracer pass through."""
    if spec is None or spec is False:
        return None
    if isinstance(spec, Tracer):
        return spec
    if isinstance(spec, TraceConfig):
        return Tracer(spec)
    if spec is True:
        return Tracer(TraceConfig(rate=1.0))
    if isinstance(spec, (int, float)):
        return Tracer(TraceConfig(rate=float(spec)))
    raise TypeError(f"trace= expects None, bool, a rate in [0, 1], a "
                    f"TraceConfig, or a Tracer; got {type(spec).__name__}")


# --------------------------------------------------------------------------- analyzers
def _as_traces(tracer_or_traces: Union[Tracer, Iterable[DescTrace]]
               ) -> List[DescTrace]:
    if isinstance(tracer_or_traces, Tracer):
        return tracer_or_traces.traces()
    return list(tracer_or_traces)


def phase_breakdown(tracer_or_traces: Union[Tracer, Iterable[DescTrace]]
                    ) -> Dict[str, Dict[str, float]]:
    """Aggregate per-phase stats across traces — the generalized Fig. 5:
    {phase: {count, total_s, mean_s, p95_s, share}} where ``share`` is the
    phase's fraction of summed span time."""
    traces = _as_traces(tracer_or_traces)
    per: Dict[str, List[float]] = {p: [] for p in PHASES}
    for dt in traces:
        for phase, d in dt.phase_durations().items():
            per[phase].append(d)
    grand = sum(sum(v) for v in per.values()) or 1.0
    out: Dict[str, Dict[str, float]] = {}
    for phase in PHASES:
        vals = per[phase]
        if not vals:
            continue
        total = sum(vals)
        out[phase] = {
            "count": float(len(vals)),
            "total_s": total,
            "mean_s": total / len(vals),
            "p95_s": percentile(vals, 95.0),
            "share": total / grand,
        }
    return out


def critical_path(tracer: Tracer) -> Dict[str, Any]:
    """Longest dependency chain through the retained traces.

    Nodes are traced descriptors; edges are the recorded ``after=``
    fences and ``then`` continuations.  A node only contributes the part
    of its span extent AFTER its chain predecessor's end — a ``then``
    continuation's host_wait runs concurrently with its parent's
    execution and must not double-count that wall time — so the chain's
    on-path total never exceeds its wall extent.  Edges point forward in
    time, so ordering nodes by start time is a valid topological order
    for the DP.  Returns the chain (desc ids), its on-path seconds, wall
    extent, per-phase seconds along the chain (clipped the same way),
    and each phase's share — where the end-to-end time actually went
    (the real Fig. 5, generalized across dependencies)."""
    traces = {dt.desc_id: dt for dt in tracer.traces() if dt.marks}
    parents: Dict[int, List[int]] = {d: [] for d in traces}
    for p, c, _kind in tracer.edges():
        if p in traces and c in traces:
            parents[c].append(p)
    order = sorted(traces, key=lambda d: traces[d].start)
    best: Dict[int, float] = {}
    pred: Dict[int, Optional[int]] = {}
    for d in order:
        dt = traces[d]
        b, pr = dt.duration_s, None
        for p in parents[d]:
            if p not in best:
                continue
            contrib = max(dt.end - max(dt.start, traces[p].end), 0.0)
            if best[p] + contrib > b:
                b, pr = best[p] + contrib, p
        best[d] = b
        pred[d] = pr
    if not best:
        return {"chain": [], "total_s": 0.0, "elapsed_s": 0.0,
                "phases": {}, "shares": {}}
    endpoint = max(best, key=lambda d: best[d])
    chain: List[int] = []
    at: Optional[int] = endpoint
    while at is not None:
        chain.append(at)
        at = pred[at]
    chain.reverse()
    phases: Dict[str, float] = {}
    for i, d in enumerate(chain):
        # clip to time after the predecessor's end (matches the DP weight)
        cut = traces[chain[i - 1]].end if i else float("-inf")
        for sp in traces[d].spans():
            clipped = max(sp.t1 - max(sp.t0, cut), 0.0)
            if clipped > 0:
                phases[sp.phase] = phases.get(sp.phase, 0.0) + clipped
    total = best[endpoint]
    elapsed = max(traces[chain[-1]].end - traces[chain[0]].start, 0.0)
    denom = sum(phases.values()) or 1.0
    shares = {p: v / denom for p, v in phases.items()}
    return {"chain": chain, "total_s": total, "elapsed_s": elapsed,
            "phases": phases, "shares": shares}


def host_free_fraction(tracer: Tracer) -> float:
    """Fraction of waited host time spent parked (free), from the
    tracer's wait spans.  Folded from the same local WaitStats each
    WaitPolicy.wait merges into ``device.wait_stats``, so this agrees
    with the Fig. 11 accounting by construction."""
    c = tracer.counters_snapshot()
    total = c["wait_busy_s"] + c["wait_free_s"]
    return c["wait_free_s"] / total if total > 0 else 0.0


def slowest(tracer_or_traces: Union[Tracer, Iterable[DescTrace]],
            k: int = 10) -> List[DescTrace]:
    """The k traces with the largest span extent, slowest first."""
    traces = [t for t in _as_traces(tracer_or_traces) if t.marks]
    return sorted(traces, key=lambda t: t.duration_s, reverse=True)[:k]
