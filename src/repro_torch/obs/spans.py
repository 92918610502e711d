"""Descriptor-lifecycle span model (the per-operation Fig. 5).

A traced descriptor accumulates a small dict of write-once perf_counter
timestamps ("marks") as it moves through the offload pipeline:

  create -> submit_enter -> validate0/1 -> accept -> dispatch
         -> exec0/exec1 -> resolved -> observed -> cb0/cb1

Consecutive marks bound the lifecycle *phases* the paper's latency
breakdown reasons about:

  create            descriptor allocation until Device.submit is entered
  validate          desclint validation (submit-time descriptor checks)
  submit            policy selection + WQ enqueue (ENQCMD/MOVDIR64B path)
  wq_wait           queued in the WQ (plus fence hold for after= deps)
  engine_dispatch   group arbiter pop -> PE worker pickup
  pe_exec           kernel dispatch on the PE worker
  completion_write  dispatch done -> completion record resolved
  host_wait         resolved -> the host observes completion
  callback          user done-callbacks

Marks are written causally along the descriptor's path (submit thread ->
arbiter -> PE worker -> retire thread -> observer), each exactly once, so
a plain dict is safe under the GIL; ``clean_marks`` clamps any residual
cross-thread clock skew so derived spans are always monotonic.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

#: lifecycle phases in pipeline order (every derived series/export uses
#: these names)
PHASES: Tuple[str, ...] = (
    "create",
    "validate",
    "submit",
    "wq_wait",
    "engine_dispatch",
    "pe_exec",
    "completion_write",
    "host_wait",
    "callback",
)

#: raw mark names in causal order
MARK_ORDER: Tuple[str, ...] = (
    "create",
    "submit_enter",
    "validate0",
    "validate1",
    "accept",
    "dispatch",
    "exec0",
    "exec1",
    "resolved",
    "observed",
    "cb0",
    "cb1",
)

#: phase -> (start mark, end mark) for engine-submitted descriptors
_PHASE_BOUNDS: Dict[str, Tuple[str, str]] = {
    "create": ("create", "submit_enter"),
    "validate": ("validate0", "validate1"),
    "submit": ("validate1", "accept"),
    "wq_wait": ("accept", "dispatch"),
    "engine_dispatch": ("dispatch", "exec0"),
    "pe_exec": ("exec0", "exec1"),
    "completion_write": ("exec1", "resolved"),
    "host_wait": ("resolved", "observed"),
    "callback": ("cb0", "cb1"),
}

#: host-side continuations (Future.then) reuse two phases: waiting on the
#: parent, then running the continuation function
_THEN_BOUNDS: Dict[str, Tuple[str, str]] = {
    "host_wait": ("create", "exec0"),
    "callback": ("exec0", "exec1"),
}

#: phases that run on the submitting host vs the engine fabric (Perfetto
#: track assignment)
HOST_PHASES = frozenset(
    {"create", "validate", "submit", "host_wait", "callback"})


@dataclasses.dataclass
class Span:
    """One derived lifecycle interval of a traced descriptor."""

    phase: str
    t0: float
    t1: float
    track: str  # "host" | "engine"

    @property
    def dur(self) -> float:
        return max(self.t1 - self.t0, 0.0)


class DescTrace:
    """The span tree of one traced submittable.

    Identity: ``trace_id`` groups every descriptor of one logical request
    (request-scoped contexts in the serving pipeline); ``desc_id`` is the
    per-descriptor node the critical-path DAG is keyed on.
    """

    __slots__ = ("trace_id", "desc_id", "op", "nbytes", "marks", "attrs",
                 "_tracer", "_folded")

    def __init__(self, trace_id: str, desc_id: int, op: str,
                 nbytes: int = 0, tracer: Optional[Any] = None):
        self.trace_id = trace_id
        self.desc_id = desc_id
        self.op = op
        self.nbytes = nbytes
        self.marks: Dict[str, float] = {}
        self.attrs: Dict[str, Any] = {}
        self._tracer = tracer
        self._folded: set = set()

    def __repr__(self) -> str:  # keep record reprs readable
        return (f"DescTrace({self.trace_id!r}, desc_id={self.desc_id}, "
                f"op={self.op!r}, marks={len(self.marks)})")

    # -- marks ---------------------------------------------------------------
    def mark(self, name: str, t: Optional[float] = None) -> float:
        """Stamp ``name`` once (repeat marks keep the first timestamp, so
        concurrent observers can't rewrite history).  Terminal marks fold
        this trace's finished phases into the tracer's monotonic
        occupancy counters."""
        have = self.marks.get(name)
        if have is not None:
            return have
        if t is None:
            t = time.perf_counter()
        self.marks[name] = t
        if name in ("resolved", "observed", "cb1") and self._tracer is not None:
            self._tracer._fold(self)
        return t

    @property
    def start(self) -> Optional[float]:
        ts = self.marks.values()
        return min(ts) if ts else None

    @property
    def end(self) -> Optional[float]:
        ts = self.marks.values()
        return max(ts) if ts else None

    @property
    def duration_s(self) -> float:
        if not self.marks:
            return 0.0
        return max(self.end - self.start, 0.0)

    def clean_marks(self) -> Dict[str, float]:
        """Marks clamped monotonically non-decreasing along MARK_ORDER
        (cross-thread perf_counter skew must never yield negative spans)."""
        out: Dict[str, float] = {}
        floor: Optional[float] = None
        for name in MARK_ORDER:
            t = self.marks.get(name)
            if t is None:
                continue
            if floor is not None and t < floor:
                t = floor
            out[name] = t
            floor = t
        return out

    # -- derived spans -------------------------------------------------------
    def _bounds(self) -> Dict[str, Tuple[str, str]]:
        return (_THEN_BOUNDS if self.attrs.get("kind") == "then"
                else _PHASE_BOUNDS)

    def phase_durations(self) -> Dict[str, float]:
        """Seconds per completed lifecycle phase (phases whose boundary
        marks have not both landed yet are absent)."""
        marks = self.clean_marks()
        out: Dict[str, float] = {}
        for phase, (m0, m1) in self._bounds().items():
            t0, t1 = marks.get(m0), marks.get(m1)
            if t0 is not None and t1 is not None:
                out[phase] = max(t1 - t0, 0.0)
        return out

    def spans(self) -> List[Span]:
        """The trace as ordered Span intervals (Perfetto slices)."""
        marks = self.clean_marks()
        bounds = self._bounds()
        out: List[Span] = []
        for phase in PHASES:
            bound = bounds.get(phase)
            if bound is None:
                continue
            t0, t1 = marks.get(bound[0]), marks.get(bound[1])
            if t0 is None or t1 is None:
                continue
            track = ("host" if phase in HOST_PHASES
                     or self.attrs.get("kind") == "then" else "engine")
            out.append(Span(phase, t0, t1, track))
        return out
