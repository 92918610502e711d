"""Event-driven completion subsystem (paper Fig. 11 + the "choose your wait
scheme" guideline).

How the host waits on completions decides how many CPU cycles are left for
real work.  The paper measures four schemes on DSA; each maps onto a
``WaitPolicy`` here:

  spin       busy-poll the completion record: lowest observation latency,
             every waited cycle is host-busy.
  pause      spin throttled with PAUSE: the core stays occupied (still
             host-busy) but polls less often — kinder to the SMT sibling
             and the power budget.
  umwait     UMONITOR/UMWAIT on the completion record: the core parks
             (host-FREE) until the engine's completion write wakes it, at a
             modeled C0.2 exit latency per wake.
  interrupt  completion interrupt: the host is fully free until the IRQ;
             each wake bills a modeled delivery+handler cost, and one IRQ
             retires every completion that is ready (coalescing).

On the card: host-busy time is the measured wall time spent pumping the
engine (kick + completion-queue scan); host-free time is the measured wall
time blocked in ``torch.cuda.Event.synchronize()`` on the in-flight
kernels' completion events: the card genuinely streams during that
interval, exactly like hardware behind UMWAIT.  Modeled wake/IRQ costs (perfmodel constants) are
billed into busy time and tracked separately in ``modeled_overhead_s``.

Set-oriented waiting replaces per-Future pump loops: a ``CompletionSet`` is
a device-level completion queue — ``StreamEngine`` notifies the ``Device``
on record resolution, the device delivers the owning ``Future`` to every
registered set, and ``wait_any`` / ``wait_all`` / ``as_completed`` drive ONE
policy loop over the whole set instead of N independent busy-waits.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import time
from typing import Any, Callable, Deque, Dict, Iterable, List, Optional, Union

from repro_torch.analysis import lockcheck as _lockcheck


class WaitTimeout(TimeoutError):
    """A bounded wait expired before the required completions arrived."""


def _is_done(fut: Any) -> bool:
    """Completion check over anything future-shaped (Future, Promise,
    CompletionRecord, or any object exposing done()/is_done())."""
    check = getattr(fut, "done", None) or getattr(fut, "is_done")
    return bool(check())


# --------------------------------------------------------------------------- stats
@dataclasses.dataclass
class WaitStats:
    """Host-cycle accounting for one wait policy (the measured Fig. 11).

    busy_s  wall time the host spent pumping (kick/scan/poll) plus the
            modeled wake/IRQ overheads — cycles NOT available for real work.
    free_s  wall time the host spent parked (UMWAIT block / IRQ sleep) while
            the engine streamed — cycles available for other threads/work.
    """

    waits: int = 0
    polls: int = 0
    wakes: int = 0
    irqs: int = 0
    completions: int = 0
    busy_s: float = 0.0
    free_s: float = 0.0
    modeled_overhead_s: float = 0.0

    @property
    def host_free_frac(self) -> float:
        total = self.busy_s + self.free_s
        return self.free_s / total if total > 0 else 0.0

    def merge(self, other: "WaitStats") -> "WaitStats":
        """Fold another WaitStats in (each WaitPolicy.wait bills a local
        instance, merged into the device's per-policy bucket at the end:
        totals identical to incremental billing, and the same numbers feed
        the tracer's wait span, so both views always reconcile)."""
        self.waits += other.waits
        self.polls += other.polls
        self.wakes += other.wakes
        self.irqs += other.irqs
        self.completions += other.completions
        self.busy_s += other.busy_s
        self.free_s += other.free_s
        self.modeled_overhead_s += other.modeled_overhead_s
        return self

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["host_free_frac"] = self.host_free_frac
        return d


# --------------------------------------------------------------------------- completion sets
class CompletionSet:
    """Device-level completion queue over a fixed set of futures.

    The owning device pushes every resolved future into each registered set
    (engine notification -> ``Device._on_future_done`` -> ``_deliver``); a
    ``scan()`` fallback catches futures that resolve outside the engine
    notification path (host promises, chained continuations, completions
    observed before the set existed).  Thread-safe; completion order is the
    delivery order.
    """

    def __init__(self, device, futures: Iterable[Any]):
        self.device = device
        self.futures = list(futures)
        self._lock = _lockcheck.checked_lock("completion.set")
        self._pending: Dict[int, Any] = {id(f): f for f in self.futures}
        self._ready: Deque[Any] = collections.deque()
        self.delivered = 0
        self._unattributed = 0  # delivered but not yet billed to a WaitStats
        device._add_sink(self)
        self.scan()

    # -- delivery ------------------------------------------------------------
    def _deliver(self, fut: Any):
        with self._lock:
            if id(fut) not in self._pending:
                return
            del self._pending[id(fut)]
            self._ready.append(fut)
            self.delivered += 1
            self._unattributed += 1

    def take_delivered(self) -> int:
        """Completions delivered since the last call — consumed by the wait
        policy that observed them, so pre-wait (seeded) completions are
        billed to the first wait over the set rather than lost."""
        with self._lock:
            n, self._unattributed = self._unattributed, 0
            return n

    def scan(self):
        """Sweep watched futures for completions the push path missed."""
        with self._lock:
            pending = list(self._pending.values())
        for f in pending:
            if _is_done(f):
                self._deliver(f)

    # -- consumption ---------------------------------------------------------
    @property
    def n_pending(self) -> int:
        return len(self._pending)

    @property
    def n_ready(self) -> int:
        return len(self._ready)

    def pop(self) -> Optional[Any]:
        with self._lock:
            return self._ready.popleft() if self._ready else None

    def close(self):
        self.device._remove_sink(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# --------------------------------------------------------------------------- policies
class WaitPolicy:
    """One host-side wait scheme.  ``wait`` pumps the device and scans the
    completion set until ``satisfied()`` or the timeout; subclasses decide
    what happens between polls (nothing / PAUSE / park / IRQ sleep) and how
    the interval is billed (busy vs free)."""

    name = "base"

    def wait(self, device, sink: CompletionSet,
             satisfied: Callable[[], bool],
             timeout: Optional[float] = None) -> bool:
        # bill into a LOCAL WaitStats, folded into the device's per-policy
        # bucket once on exit: totals are preserved exactly (Fig. 11
        # unchanged) and the tracer records this wait's busy/free split as
        # one wait span from the same numbers
        stats = WaitStats(waits=1)
        t_begin = time.perf_counter()
        deadline = None if timeout is None else t_begin + timeout
        try:
            while True:  # dsalint: disable=DSA103 — WaitPolicy internals ARE the sanctioned pump
                t0 = time.perf_counter()
                device.kick()
                sink.scan()
                stats.polls += 1
                stats.busy_s += time.perf_counter() - t0
                if satisfied():
                    return True
                if deadline is not None and time.perf_counter() >= deadline:
                    return False
                self._idle(device, stats, deadline)
        finally:
            stats.completions += sink.take_delivered()
            device._wait_bucket(self.name).merge(stats)
            tracer = getattr(device, "tracer", None)
            if tracer is not None:
                tracer.wait_span(self.name, t_begin, time.perf_counter(),
                                 stats.busy_s, stats.free_s,
                                 stats.completions)

    def _idle(self, device, stats: WaitStats, deadline: Optional[float]):
        raise NotImplementedError

    # -- shared helpers ------------------------------------------------------
    @staticmethod
    def _model(device):
        return device.engines[0].model if device.engines else None

    @staticmethod
    def _park(device, stats: WaitStats, deadline: Optional[float],
              idle_poll_s: float) -> float:
        """Block host-free until in-flight engine work lands (the monitored
        completion write): first completion among the PE workers, else the
        completion events of already-launched kernels.  With nothing
        locally in flight — e.g. everything is fenced on a host promise —
        nap briefly instead.  Returns the parked interval; the caller bills
        it as free time."""
        work, events = device._inflight_work()
        t0 = time.perf_counter()
        budget = None if deadline is None else max(deadline - t0, 0.0)
        if work:
            concurrent.futures.wait(
                work, timeout=budget,
                return_when=concurrent.futures.FIRST_COMPLETED,
            )
        elif events and budget is None:
            for ev in events:
                ev.synchronize()
        else:
            # bounded wait: Event.synchronize has no deadline, so honor the
            # budget with a nap-and-repoll instead of an unbounded block
            nap = idle_poll_s if budget is None else min(idle_poll_s, budget)
            if nap > 0:
                time.sleep(nap)
        parked = time.perf_counter() - t0
        stats.free_s += parked
        return parked


class SpinWait(WaitPolicy):
    """Busy-poll: every waited cycle is host-busy, wake latency ~0."""

    name = "spin"

    def _idle(self, device, stats, deadline):
        pass  # tight loop — the next pump is the next poll


class PauseWait(WaitPolicy):
    """PAUSE-throttled spin: the core is still occupied (busy), but the poll
    loop backs off, modeling the paper's lower-power spin variant."""

    name = "pause"

    def __init__(self, pause_s: Optional[float] = None):
        self.pause_s = pause_s

    def _idle(self, device, stats, deadline):
        model = self._model(device)
        pause = self.pause_s if self.pause_s is not None else (
            model.pause_poll_s if model else 0.1e-6
        )
        t0 = time.perf_counter()
        if pause > 0:
            time.sleep(pause)  # the core is NOT free in PAUSE: bill busy
        stats.busy_s += time.perf_counter() - t0


class UmwaitWait(WaitPolicy):
    """UMONITOR/UMWAIT: park host-free until the completion write, then pay
    a modeled C0.2 exit latency per wake."""

    name = "umwait"

    def __init__(self, wake_latency_s: Optional[float] = None,
                 idle_poll_s: float = 50e-6):
        self.wake_latency_s = wake_latency_s
        self.idle_poll_s = idle_poll_s

    def _idle(self, device, stats, deadline):
        self._park(device, stats, deadline, self.idle_poll_s)
        stats.wakes += 1
        model = self._model(device)
        wake = self.wake_latency_s if self.wake_latency_s is not None else (
            model.umwait_wake_s if model else 0.5e-6
        )
        stats.busy_s += wake
        stats.modeled_overhead_s += wake


class InterruptWait(WaitPolicy):
    """Completion interrupt: host fully free until the IRQ.  One IRQ retires
    every completion ready at wake (coalescing — in-flight descriptors land
    together), optionally widened by a coalescing window; each IRQ bills a
    modeled delivery + handler + reschedule cost."""

    name = "interrupt"

    def __init__(self, irq_cost_s: Optional[float] = None,
                 coalesce_window_s: float = 0.0,
                 idle_poll_s: float = 50e-6):
        self.irq_cost_s = irq_cost_s
        self.coalesce_window_s = coalesce_window_s
        self.idle_poll_s = idle_poll_s

    def _idle(self, device, stats, deadline):
        self._park(device, stats, deadline, self.idle_poll_s)
        if self.coalesce_window_s > 0:
            # hold the IRQ open so more completions land in this batch
            t0 = time.perf_counter()
            time.sleep(self.coalesce_window_s)
            stats.free_s += time.perf_counter() - t0
        stats.wakes += 1
        stats.irqs += 1
        model = self._model(device)
        irq = self.irq_cost_s if self.irq_cost_s is not None else (
            model.irq_cost_s if model else 4e-6
        )
        stats.busy_s += irq
        stats.modeled_overhead_s += irq


WAIT_POLICIES: Dict[str, Callable[[], WaitPolicy]] = {
    "spin": SpinWait,
    "pause": PauseWait,
    "umwait": UmwaitWait,
    "interrupt": InterruptWait,
}


def get_wait_policy(policy: Union[str, WaitPolicy, None]) -> WaitPolicy:
    """Resolve a wait-policy spec: name, instance, or None (-> umwait, the
    paper's default guideline: free the cycles unless latency is king)."""
    if policy is None:
        return UmwaitWait()
    if isinstance(policy, WaitPolicy):
        return policy
    try:
        return WAIT_POLICIES[policy]()
    except KeyError:
        raise ValueError(f"unknown wait policy {policy!r}; "
                         f"expected one of {sorted(WAIT_POLICIES)}") from None


# --------------------------------------------------------------------------- set waits
def wait_any(device, futures, *, policy: Optional[Union[str, WaitPolicy]] = None,
             timeout: Optional[float] = None):
    """Wait until at least one future completes; returns (done, pending)
    lists in input order.  ``timeout=0`` is a single poll pass (pump + scan,
    never park); on timeout ``done`` may be empty."""
    futures = list(futures)
    pol = device._resolve_wait_policy(policy)
    with CompletionSet(device, futures) as sink:
        pol.wait(device, sink,
                 lambda: sink.n_ready > 0 or sink.n_pending == 0, timeout)
    done = [f for f in futures if _is_done(f)]
    pending = [f for f in futures if not _is_done(f)]
    return done, pending


def wait_all(device, futures, *, policy: Optional[Union[str, WaitPolicy]] = None,
             timeout: Optional[float] = None):
    """Wait until every future completes; returns the futures.  Raises
    WaitTimeout if the deadline passes first.  Completion != success: a
    failed descriptor is "complete" here — call ``result()`` to raise."""
    futures = list(futures)
    pol = device._resolve_wait_policy(policy)
    with CompletionSet(device, futures) as sink:
        pol.wait(device, sink, lambda: sink.n_pending == 0, timeout)
        if sink.n_pending:
            raise WaitTimeout(
                f"wait_all: {sink.n_pending}/{len(futures)} futures still "
                f"pending after {timeout}s"
            )
    return futures


def as_completed(device, futures, *, policy: Optional[Union[str, WaitPolicy]] = None,
                 timeout: Optional[float] = None):
    """Iterate futures in COMPLETION order (not submission order), driving
    one policy loop for the whole set.  Raises WaitTimeout if ``timeout``
    elapses with futures still pending."""
    futures = list(futures)
    pol = device._resolve_wait_policy(policy)
    deadline = None if timeout is None else time.perf_counter() + timeout
    sink = CompletionSet(device, futures)
    try:
        remaining = len(futures)
        while remaining:
            fut = sink.pop()
            if fut is None:
                left = None if deadline is None else deadline - time.perf_counter()
                pol.wait(device, sink, lambda: sink.n_ready > 0, left)
                fut = sink.pop()
                if fut is None:
                    raise WaitTimeout(
                        f"as_completed: {remaining}/{len(futures)} futures "
                        f"still pending after {timeout}s"
                    )
            remaining -= 1
            yield fut
    finally:
        sink.close()
