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

Stage spans (``StageSpan``, ``StageRecorder``, ``stage``) are the
program's own stages on the same ``Span`` record: see the section at the
end of this module and docs/tracing.md.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from torch.autograd import profiler as _profiler

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


# --------------------------------------------------------------------------- stage spans
# The program's own stages (a served request's admission, the decode
# step's launch and read, a training step's phases, the model's layer
# kinds), recorded while a ``torch.profiler`` session records or inside
# ``recording()``, and nowhere else: off, a span site reads two
# attributes and returns the shared ``NULL_STAGE``.  Each span is stamped
# on ``perf_counter_ns`` (the descriptor marks' clock) and carries the
# offset to the profiler's clock (epoch nanoseconds, as kineto's events),
# taken when recording turns on, so a span lines up with the device trace
# of the same session.  Spans go to a bounded ring that counts what it
# drops; nothing is written out until a caller asks.

#: a quarter second with no span opened: the next span takes the offset
#: again (a new profiler session; the clocks drift a few ppm apart)
_RESYNC_NS = 250_000_000

#: the ring's size: the last this many spans are kept
_RING = 1 << 16


@dataclasses.dataclass
class StageSpan(Span):
    """One program stage: ``phase`` is its name, ``t0``/``t1`` its ends on
    ``perf_counter`` (the descriptor spans' clock), ``t0_ns``/``t1_ns`` on
    the profiler's clock.  ``parent`` is the ``sid`` of the span it ran
    inside (on its thread, or the open cross-thread span of another), so
    self time can be taken; ``req`` is the ``Tracer``'s request id
    (``req<id>``) where there is one; ``mode`` is "prefill", "decode",
    "train" or "backward", where the stage has one."""

    sid: int = 0
    parent: Optional[int] = None
    thread: int = 0
    req: Optional[str] = None
    mode: Optional[str] = None
    t0_ns: int = 0
    t1_ns: int = 0


class _NullStage:
    """The span site's context while nothing records: no state, shared."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL_STAGE = _NullStage()


def _clock_offset_ns() -> int:
    """``time.time_ns() - perf_counter_ns()``, read between the two ends of
    the narrowest of three brackets."""
    best = None
    for _ in range(3):
        a = time.perf_counter_ns()
        e = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, e - (a + b) // 2)
    return best[1]


class _OpenStage:
    """One span while it is open: pushed on its thread's stack at entry,
    recorded at exit."""

    __slots__ = ("_rec", "_name", "_mode", "_req", "_cross", "_sid", "_parent", "_t0",
                 "_stack")

    def __init__(self, rec: "StageRecorder", name: str, mode, req, cross: bool):
        self._rec, self._name, self._mode, self._req, self._cross = rec, name, mode, req, cross

    def __enter__(self):
        rec = self._rec
        tls = rec._tls
        stack = getattr(tls, "stack", None)
        if stack is None:
            stack = tls.stack = []
        self._stack = stack
        self._sid = sid = next(rec._ids)
        self._parent = stack[-1] if stack else (rec._shared[-1] if rec._shared else None)
        stack.append(sid)
        if self._cross:
            rec._shared.append(sid)
        t0 = time.perf_counter_ns()
        if t0 - rec._last_ns > _RESYNC_NS:
            rec._offset_ns = _clock_offset_ns()
        rec._last_ns = t0
        self._t0 = t0
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        rec, sid = self._rec, self._sid
        self._stack.pop()
        if self._cross:
            rec._shared.remove(sid)
        rec._last_ns = t1
        rec._add((sid, self._name, self._t0, t1, self._parent, threading.get_ident(),
                  self._req, self._mode, rec._offset_ns))
        return False


class StageRecorder:
    """The bounded ring of stage spans: ``spans()`` reads it; ``dropped``
    counts the spans it let go."""

    def __init__(self):
        self._ring: "collections.deque[tuple]" = collections.deque(maxlen=_RING)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self._shared: List[int] = []  # open cross-thread spans, innermost last
        self._forced = 0  # depth of recording() contexts
        self._offset_ns = _clock_offset_ns()
        self._last_ns = 0
        self.dropped = 0

    def _add(self, rec: tuple) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(rec)

    def spans(self) -> List[StageSpan]:
        """The retained spans, in the order they closed."""
        with self._lock:
            raw = list(self._ring)
        out = []
        for sid, name, t0, t1, parent, tid, req, mode, off in raw:
            if isinstance(req, int):
                req = f"req{req}"
            out.append(StageSpan(name, t0 / 1e9, t1 / 1e9, "stage", sid=sid, parent=parent,
                                 thread=tid, req=req, mode=mode, t0_ns=t0 + off,
                                 t1_ns=t1 + off))
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0


#: the process's recorder: every span site of the program records here
STAGES = StageRecorder()


def stage(name: str, mode: Optional[str] = None, req: Any = None,
          cross_thread: bool = False):
    """``with stage("serve.decode", "decode"): ...`` at a span site of the
    program: a span recorded into ``STAGES``, or ``NULL_STAGE`` while
    nothing records.  ``req`` is a request id (an int becomes
    ``req<id>``); ``cross_thread`` makes the span the parent of the spans
    another thread opens with none of its own open (autograd's backward
    thread)."""
    if _profiler._is_profiler_enabled or STAGES._forced:
        return _OpenStage(STAGES, name, mode, req, cross_thread)
    return NULL_STAGE


@contextlib.contextmanager
def recording():
    """Record the program's stage spans into ``STAGES`` inside the block,
    whether or not a profiler runs (to export a Perfetto file of them)."""
    rec = STAGES
    rec._forced += 1
    rec._offset_ns = _clock_offset_ns()
    rec._last_ns = time.perf_counter_ns()
    try:
        yield rec
    finally:
        rec._forced -= 1
