"""Lockdep-style runtime race detector (opt-in; zero cost when disabled).

The reentrant-drain race (a serving reorder buffer once drained itself
from inside its own completion callback) is a whole bug class: a completion callback fires while engine-adjacent state is locked,
re-enters the locked path, and commits against state the outer frame is
mid-way through mutating.  Linux lockdep showed that this class is
detectable at runtime from two invariants:

  1. **Acquisition order** — for every pair of lock CLASSES ever nested,
     the nesting order must be globally consistent.  The detector records
     an edge ``A -> B`` whenever a thread acquires a ``B`` lock while
     holding an ``A`` lock; a path ``B -> ... -> A`` already in the graph
     means two threads can deadlock (ABBA), flagged at the moment the
     second order is OBSERVED — no actual deadlock required.  Nesting two
     instances of the same class is flagged for the same reason.
  2. **No user code under a lock** — completion callbacks / listeners must
     never be invoked while an instrumented lock is held: the callback can
     re-enter the locked subsystem (the drain race) or block on a
     wait that needs the lock to make progress (deadlock).  Dispatch
     points mark themselves with ``notify_region``; entering one with any
     instrumented lock held is a ``notify-under-lock`` violation.

Like lockdep, violations are recorded by lock CLASS (the ``lockclass``
string given at construction), deduplicated, and carry the acquisition
stacks, so one run over a representative workload certifies the ordering
discipline of the whole tree.

Wiring: the locks in ``StreamEngine`` (counters, PE pool),
``CompletionSet``, ``WorkQueue`` and ``Device`` are created through
:func:`checked_lock` / :func:`checked_rlock`.  While the detector is disabled (the default) those
factories return plain ``threading`` locks — no wrapper, no overhead.
After :func:`enable` newly created locks are instrumented and violations
accumulate on the global detector (this module is the port's own copy: its
detector is separate from the JAX package's).

Tests that deliberately manufacture hazards should build a private
``LockCheck(enabled=True)`` instance so the global report stays clean.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import traceback
from typing import Dict, List, Optional, Set, Tuple, Union


@dataclasses.dataclass
class LockViolation:
    """One recorded hazard.  ``kind`` is "order-cycle" (ABBA / same-class
    nesting) or "notify-under-lock" (user-callback dispatch while holding
    an instrumented lock)."""

    kind: str
    detail: str
    stack: str = ""

    def __str__(self) -> str:
        return f"[{self.kind}] {self.detail}"


class CheckedLock:
    """Instrumented lock: a plain ``threading`` lock plus acquisition
    bookkeeping on its owning :class:`LockCheck`.  Supports the standard
    ``acquire``/``release``/context-manager protocol."""

    __slots__ = ("lockclass", "reentrant", "_lock", "_check")

    def __init__(self, check: "LockCheck", lockclass: str, reentrant: bool):
        self.lockclass = lockclass
        self.reentrant = reentrant
        self._lock = threading.RLock() if reentrant else threading.Lock()
        self._check = check

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self._check._on_acquire(self)
        return ok

    def release(self) -> None:
        self._check._on_release(self)
        self._lock.release()

    def _is_owned(self) -> bool:
        """RLock duck-compat: does the calling thread hold this lock?"""
        return self._lock._is_owned()  # type: ignore[union-attr]

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "CheckedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<CheckedLock {self.lockclass!r} reentrant={self.reentrant}>"


class LockCheck:
    """One detector: an acquisition-order graph over lock classes, per-
    thread held stacks, and a deduplicated violation list."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        # lockclass -> set of lockclasses acquired while it was held
        self._edges: Dict[str, Set[str]] = {}
        self._violations: List[LockViolation] = []
        self._seen_keys: Set[Tuple[str, str]] = set()
        self._mu = threading.Lock()  # guards edges/violations (plain: internal)
        self._tls = threading.local()

    # ------------------------------------------------------------------ factories
    def lock(self, lockclass: str) -> Union[CheckedLock, threading.Lock]:
        """A mutex of class ``lockclass`` — instrumented iff enabled NOW."""
        if not self.enabled:
            return threading.Lock()
        return CheckedLock(self, lockclass, reentrant=False)

    def rlock(self, lockclass: str) -> Union[CheckedLock, threading.RLock]:
        """A reentrant mutex of class ``lockclass`` (reentrant re-acquires
        are tracked but never edge-recorded)."""
        if not self.enabled:
            return threading.RLock()
        return CheckedLock(self, lockclass, reentrant=True)

    # ------------------------------------------------------------------ tracking
    def _stack(self) -> List[List]:
        s = getattr(self._tls, "stack", None)
        if s is None:
            s = self._tls.stack = []
        return s  # entries: [CheckedLock, hold_count]

    def _on_acquire(self, lock: CheckedLock) -> None:
        if not self.enabled:
            return
        stack = self._stack()
        for ent in stack:
            if ent[0] is lock:  # reentrant re-acquire of the same instance
                ent[1] += 1
                return
        held = [ent[0].lockclass for ent in stack]
        if held:
            with self._mu:
                for hc in dict.fromkeys(held):  # unique, order-preserving
                    if hc == lock.lockclass:
                        self._violate(
                            "order-cycle",
                            f"same-class nesting: a {lock.lockclass!r} lock "
                            f"acquired while another {hc!r} instance is held "
                            f"(ABBA hazard between instances)",
                            key=(hc, lock.lockclass),
                        )
                        continue
                    self._edges.setdefault(hc, set()).add(lock.lockclass)
                    if self._reaches(lock.lockclass, hc):
                        self._violate(
                            "order-cycle",
                            f"lock order inversion: acquiring "
                            f"{lock.lockclass!r} while holding {hc!r}, but "
                            f"the graph already orders {lock.lockclass!r} "
                            f"before {hc!r} (ABBA deadlock possible)",
                            key=(hc, lock.lockclass),
                        )
        stack.append([lock, 1])

    def _on_release(self, lock: CheckedLock) -> None:
        stack = getattr(self._tls, "stack", None)
        if not stack:
            return  # acquired before instrumentation/enable: nothing tracked
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] is lock:
                stack[i][1] -= 1
                if stack[i][1] == 0:
                    del stack[i]
                return

    def _reaches(self, src: str, dst: str) -> bool:
        """DFS: is there a recorded path src -> ... -> dst?"""
        seen: Set[str] = set()
        frontier = [src]
        while frontier:
            n = frontier.pop()
            if n == dst:
                return True
            if n in seen:
                continue
            seen.add(n)
            frontier.extend(self._edges.get(n, ()))
        return False

    def _violate(self, kind: str, detail: str,
                 key: Optional[Tuple[str, str]] = None) -> None:
        k = (kind, key if key is not None else detail)
        if k in self._seen_keys:
            return
        self._seen_keys.add(k)
        stack = "".join(traceback.format_stack(limit=12)[:-2])
        self._violations.append(LockViolation(kind, detail, stack))

    # ------------------------------------------------------------------ notify regions
    def held(self) -> List[str]:
        """Lock classes held by the calling thread, outermost first."""
        return [ent[0].lockclass for ent in getattr(self._tls, "stack", ())]

    @contextlib.contextmanager
    def notify_region(self, label: str):
        """Mark a dispatch point that runs USER code (completion callbacks,
        listeners).  Entering it with an instrumented lock held is the
        reentrant-drain hazard: the callback can re-enter the locked
        subsystem or block on work that needs the lock."""
        if self.enabled:
            held = self.held()
            if held:
                with self._mu:
                    self._violate(
                        "notify-under-lock",
                        f"{label}: user callbacks dispatched while holding "
                        f"{held} — a callback re-entering the locked "
                        f"subsystem deadlocks or double-commits",
                        key=(label, ",".join(held)),
                    )
        yield

    # ------------------------------------------------------------------ reporting
    @property
    def violations(self) -> List[LockViolation]:
        with self._mu:
            return list(self._violations)

    def clear(self) -> None:
        with self._mu:
            self._violations.clear()
            self._seen_keys.clear()
            self._edges.clear()

    def edges(self) -> Dict[str, Set[str]]:
        with self._mu:
            return {k: set(v) for k, v in self._edges.items()}

    def report(self) -> str:
        vs = self.violations
        if not vs:
            return "lockcheck: clean (no ordering or notify hazards recorded)"
        lines = [f"lockcheck: {len(vs)} violation(s)"]
        for v in vs:
            lines.append(f"  {v}")
            if v.stack:
                lines.append("    recorded at:")
                lines.extend("    " + ln for ln in v.stack.rstrip().splitlines())
        return "\n".join(lines)


#: The process-global detector the core locks register with.  Disabled by
#: default: ``checked_lock``/``checked_rlock`` then return PLAIN threading
#: locks, so production paths carry no wrapper at all.  ``enable()`` must
#: run before the objects whose locks should be watched are constructed
#: (enable it before importing anything that builds engines or devices).
GLOBAL = LockCheck(enabled=False)


def enable() -> None:
    GLOBAL.enabled = True


def disable() -> None:
    GLOBAL.enabled = False


def enabled() -> bool:
    return GLOBAL.enabled


def checked_lock(lockclass: str):
    """A mutex for core subsystems: plain when the global detector is off,
    instrumented (class-tagged) when it is on."""
    return GLOBAL.lock(lockclass)


def checked_rlock(lockclass: str):
    return GLOBAL.rlock(lockclass)


def notify_region(label: str):
    """Context manager marking a user-callback dispatch point (see
    :meth:`LockCheck.notify_region`).  Cheap no-op when disabled."""
    return GLOBAL.notify_region(label)


def violations() -> List[LockViolation]:
    return GLOBAL.violations


def report() -> str:
    return GLOBAL.report()
