"""SLO classes, latency accounting, and graceful-overload admission.

The QoS machinery built across PRs 2/3/5 — priority WQs, ``wait_any``,
per-node admission — only earns its keep when traffic exceeds capacity.
This module is the policy layer that exercises it:

  SLOClass             a named service class: a p99 latency target, the WQ
                       its admission copies ride (mapped onto the PR 2
                       priority WQs), an admission priority (higher-priority
                       classes jump the waiting queue), and whether overload
                       sheds it first.
  LatencyTracker       per-class virtual-clock latency accounting (TTFT and
                       end-to-end), with exact percentile queries — what
                       the fig17 benchmark and the overload soak assert on.
  AdmissionController  SLO-aware admission with graceful shedding.  Three
                       signals gate an arrival, in order of cost:
                         (1) per-class waiting-queue watermarks (shed-first
                             classes get half the depth budget),
                         (2) the device WQ occupancy probe
                             (``Device.occupancy``, PR 7's queues.py hook),
                         (3) per-node engine occupancy from a live
                             ``obs.Sampler`` when one is attached.
                       ``QueueFull`` backpressure from the engine is the
                       fourth, reactive signal: the serving pipeline calls
                       ``on_backpressure`` when a submit exhausts backoff.
                       Every decision is counted, and the accounting
                       identity  generated == admitted + shed  is checked
                       by ``closes()`` — the soak test's conservation law.

Hyperion (PAPERS.md, arXiv 2205.08882) argues queue-level backpressure must
be the producer/datapath contract rather than host-side pacing; this module
implements exactly that contract for the Vhost-style server.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple


# --------------------------------------------------------------------------- classes
@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One service class.

    target_p99_s   end-to-end p99 latency target on the VIRTUAL clock;
                   requests finishing within it count toward goodput.
    wq             name of the WQ its admission copies target (``None``:
                   the device default) — the PR 2 priority-WQ mapping.
    priority       admission ordering: among queued requests, the highest
                   priority class admits first (FIFO within a class).
    shed_first     overload sheds this class before protected ones (its
                   queue watermark is halved, and reactive shedding prefers
                   it when draining backlog).
    """

    name: str
    target_p99_s: float
    wq: Optional[str] = None
    priority: int = 1
    shed_first: bool = False

    def __post_init__(self):
        if self.target_p99_s <= 0:
            raise ValueError(
                f"target_p99_s must be > 0, got {self.target_p99_s}")
        if self.priority < 1:
            raise ValueError(f"priority must be >= 1, got {self.priority}")


#: the serving default: an interactive class riding the high-priority
#: dedicated WQ, and a throughput class riding the shared bulk WQ that
#: overload sheds first (paper Fig. 9 QoS mapped to SLOs).
DEFAULT_SLO_CLASSES = (
    SLOClass("latency", target_p99_s=0.25, wq="latency", priority=12),
    SLOClass("bulk", target_p99_s=2.0, wq="bulk", priority=2,
             shed_first=True),
)


def classes_by_name(
        classes: Iterable[SLOClass] = DEFAULT_SLO_CLASSES
) -> Dict[str, SLOClass]:
    out: Dict[str, SLOClass] = {}
    for c in classes:
        if c.name in out:
            raise ValueError(f"duplicate SLO class {c.name!r}")
        out[c.name] = c
    return out


# --------------------------------------------------------------------------- latency accounting
def percentile(values: Sequence[float], p: float) -> float:
    """Exact nearest-rank percentile (p in [0, 100]); NaN when empty so a
    missing class can't silently pass a threshold assertion."""
    if not 0 <= p <= 100:
        raise ValueError(f"p must be in [0, 100], got {p}")
    if not values:
        return float("nan")
    xs = sorted(values)
    rank = max(int(math.ceil(p / 100.0 * len(xs))) - 1, 0)
    return float(xs[rank])


class LatencyTracker:
    """Per-class virtual-time latency samples: TTFT (arrival -> first
    token) and e2e (arrival -> done)."""

    def __init__(self, classes: Iterable[SLOClass] = DEFAULT_SLO_CLASSES):
        self.classes = classes_by_name(classes)
        self._ttft: Dict[str, List[float]] = {c: [] for c in self.classes}
        self._e2e: Dict[str, List[float]] = {c: [] for c in self.classes}

    def record(self, slo: str, arrival_s: float,
               first_token_s: Optional[float], done_s: float) -> None:
        if slo not in self.classes:
            raise KeyError(f"unknown SLO class {slo!r}; "
                           f"have {sorted(self.classes)}")
        if first_token_s is not None:
            self._ttft[slo].append(first_token_s - arrival_s)
        self._e2e[slo].append(done_s - arrival_s)

    def count(self, slo: str) -> int:
        return len(self._e2e[slo])

    def p(self, slo: str, q: float, kind: str = "e2e") -> float:
        samples = {"e2e": self._e2e, "ttft": self._ttft}[kind][slo]
        return percentile(samples, q)

    def within_slo(self, slo: str) -> int:
        """How many completions met their class's p99 target (the goodput
        numerator)."""
        target = self.classes[slo].target_p99_s
        return sum(1 for v in self._e2e[slo] if v <= target)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for name in sorted(self.classes):
            e2e = self._e2e[name]
            out[name] = {
                "n": len(e2e),
                "p50_s": percentile(e2e, 50),
                "p99_s": percentile(e2e, 99),
                "ttft_p50_s": percentile(self._ttft[name], 50),
                "ttft_p99_s": percentile(self._ttft[name], 99),
                "within_slo": self.within_slo(name),
            }
        return out


# --------------------------------------------------------------------------- admission
class AdmissionController:
    """Graceful-overload gate between the traffic source and the server.

    A ``None`` device/sampler simply disables that signal, so the
    controller degrades to pure queue-watermark shedding — the configuration
    the deterministic soak test uses."""

    def __init__(self, classes: Iterable[SLOClass] = DEFAULT_SLO_CLASSES, *,
                 queue_watermark: int = 64,
                 wq_occupancy_high: float = 0.95,
                 node_occupancy_high: float = 0.98,
                 device: Any = None, sampler: Any = None):
        if queue_watermark < 1:
            raise ValueError(
                f"queue_watermark must be >= 1, got {queue_watermark}")
        self.classes = classes_by_name(classes)
        self.queue_watermark = queue_watermark
        self.wq_occupancy_high = wq_occupancy_high
        self.node_occupancy_high = node_occupancy_high
        self.device = device
        self.sampler = sampler
        zero = {"generated": 0, "admitted": 0, "shed": 0,
                "shed_watermark": 0, "shed_wq_occupancy": 0,
                "shed_node_occupancy": 0, "shed_backpressure": 0}
        self.counters: Dict[str, Dict[str, int]] = {
            c: dict(zero) for c in self.classes}

    # -- signal reads --------------------------------------------------------
    def _watermark(self, cls: SLOClass) -> int:
        # shed-first classes get half the backlog budget: under overload
        # their arrivals are turned away while protected classes still queue
        return max(self.queue_watermark // (2 if cls.shed_first else 1), 1)

    def _wq_saturated(self, cls: SLOClass) -> bool:
        if self.device is None or cls.wq is None:
            return False
        occ = self.device.occupancy(wq=cls.wq)
        return occ is not None and occ >= self.wq_occupancy_high

    def _node_saturated(self, node: Optional[int]) -> bool:
        if self.sampler is None:
            return False
        occ = _sampler_node_occupancy(self.sampler, node)
        return occ is not None and occ >= self.node_occupancy_high

    # -- decisions -----------------------------------------------------------
    def admit(self, slo: str, queue_depth: int,
              node: Optional[int] = None) -> bool:
        """Admission decision for one arrival; counts both outcomes.
        ``queue_depth`` is the class's current waiting-queue depth."""
        cls = self.classes[slo]
        c = self.counters[slo]
        c["generated"] += 1
        if queue_depth >= self._watermark(cls):
            c["shed"] += 1
            c["shed_watermark"] += 1
            return False
        if self._wq_saturated(cls):
            c["shed"] += 1
            c["shed_wq_occupancy"] += 1
            return False
        if self._node_saturated(node):
            c["shed"] += 1
            c["shed_node_occupancy"] += 1
            return False
        c["admitted"] += 1
        return True

    def on_backpressure(self, slo: str) -> bool:
        """The engine said no (``QueueFull`` survived bounded backoff) for
        an ALREADY-ADMITTED request.  Shed-first classes are dropped (their
        admission converts to a shed); protected classes are kept queued —
        backpressure pushes back on bulk before it touches latency traffic.
        Returns True when the request should be shed."""
        cls = self.classes[slo]
        c = self.counters[slo]
        if cls.shed_first:
            c["admitted"] -= 1
            c["shed"] += 1
            c["shed_backpressure"] += 1
            return True
        c["shed_backpressure"] += 0  # keep key hot for exports
        return False

    # -- accounting ----------------------------------------------------------
    def totals(self) -> Dict[str, int]:
        out = {"generated": 0, "admitted": 0, "shed": 0}
        for c in self.counters.values():
            for k in out:
                out[k] += c[k]
        return out

    def closes(self) -> bool:
        """The conservation law: every generated request was either
        admitted or shed, per class and in total."""
        return all(c["generated"] == c["admitted"] + c["shed"]
                   for c in self.counters.values())


def _sampler_node_occupancy(sampler: Any, node: Optional[int]) -> Optional[float]:
    """Most recent per-engine WQ-occupancy gauge from an obs Sampler,
    restricted to ``node``'s engines when given (engine names carry the
    node: ``n{node}dsa{i}``), else the max across the fabric."""
    series = getattr(sampler, "series", None)
    if not series:
        return None
    want = None if node is None else f"engine.n{node}dsa"
    best: Optional[float] = None
    for name, s in series.items():
        if not (name.startswith("engine.") and name.endswith(".wq_occupancy")):
            continue
        if want is not None and not name.startswith(want):
            continue
        if len(s) == 0:
            continue
        v = s.last()
        best = v if best is None else max(best, v)
    return best
