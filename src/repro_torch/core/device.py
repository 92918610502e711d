"""First-class submission futures and the policy-driven Device facade.

The paper's software lesson (§3.3, §5) is that DSA pays off only when
offload is *asynchronous* and completion handling is cheap: ENQCMD retry
must be bounded, descriptors inside a batch can be ordered with fences, and
throughput scales by balancing submissions across instances (Fig. 10).
This module makes each of those a first-class API object:

  Future        one submitted descriptor: owns its engine + completion
                record, supports wait()/poll()/result()/then()/callbacks,
                and can be passed as ``after=`` to any submit to express a
                dependency fence (the engine defers launch until every
                parent retires).
  Promise       an externally-completed Future (``device.promise()``) —
                a software fence for gating submissions on host events.
  SubmitPolicy  pluggable instance selection: round_robin, least_loaded
                (by WQ occupancy), sticky (per-producer affinity).
  WaitPolicy    pluggable completion waiting (core/completion.py): spin /
                pause / umwait / interrupt, selectable per device and per
                wait; ``wait_any``/``wait_all``/``as_completed`` drive one
                policy loop over a whole set of futures, fed by engine
                completion notifications instead of per-Future pumping.
  Device        the top-level entry point: owns N StreamEngine instances,
                applies the policy per submission, and converts ENQCMD
                RETRY into bounded exponential backoff ending in
                ``QueueFull`` instead of an unbounded spin.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
import zlib
from collections import Counter, defaultdict, deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.analysis import lockcheck as _lockcheck
from repro_torch.core import completion as _completion
from repro_torch.core.completion import WaitPolicy, WaitStats, get_wait_policy
from repro_torch.core.descriptor import (
    BatchDescriptor,
    CompletionRecord,
    OpType,
    Status,
    WorkDescriptor,
    op_name,
)
from repro_torch.core.engine import DeviceConfig, StreamEngine
from repro_torch.core.queues import Submittable, WQConfig
from repro_torch.core.topology import Topology


class QueueFull(RuntimeError):
    """All backoff attempts exhausted: every eligible WQ kept returning
    RETRY (ENQCMD's carry flag).  Carries the engine and attempt count so
    callers can rebalance or shed load instead of spinning forever."""

    def __init__(self, engine_name: str, attempts: int):
        super().__init__(
            f"work queue full on {engine_name} after {attempts} submission "
            f"attempts with exponential backoff"
        )
        self.engine_name = engine_name
        self.attempts = attempts


# --------------------------------------------------------------------------- futures
class Future:
    """Handle for one in-flight descriptor: engine + completion record,
    completion callbacks, and chaining.  Replaces the raw (engine, record)
    tuples of the old Stream API."""

    def __init__(self, device: Optional["Device"], engine: Optional[StreamEngine],
                 record: CompletionRecord):
        self.device = device
        self.engine = engine
        self.record = record
        self._callbacks: List[Callable[["Future"], None]] = []
        self._fired = False
        self._cb_lock = _lockcheck.checked_lock("future.callbacks")

    # -- state ---------------------------------------------------------------
    @property
    def status(self) -> Status:
        return self.record.status

    @property
    def op(self) -> Optional[str]:
        return self.record.op

    @property
    def error(self) -> Optional[str]:
        return self.record.error

    # -- WQ QoS attribution (stamped at dispatch; None/0 until then) ---------
    @property
    def wq(self) -> Optional[str]:
        return self.record.wq

    @property
    def queue_delay_us(self) -> float:
        return self.record.queue_delay_us

    @property
    def steering(self) -> Optional[str]:
        return self.record.steering

    def done(self) -> bool:
        """Non-kicking completion check."""
        return self.record.is_done()

    # queues.py / engine fences duck-type on is_done(), so a Future can be a
    # dependency anywhere a CompletionRecord can
    def is_done(self) -> bool:
        return self.done()

    # -- progress ------------------------------------------------------------
    def _pump(self):
        if self.device is not None:
            self.device.kick()
        elif self.engine is not None:
            self.engine.kick()

    def poll(self) -> bool:
        """Kick the engine(s), then report completion; fires callbacks on the
        transition to done (the UMWAIT-poll analogue)."""
        self._pump()
        if self.done():
            self._fire_callbacks()
            return True
        return False

    def wait(self, policy: Union[str, WaitPolicy, None] = None) -> Any:
        """Block until the record resolves; returns the raw result payload
        (None when the descriptor errored — use result() to raise instead).
        ``policy`` overrides the device's wait policy for this wait (spin /
        pause / umwait / interrupt — see core/completion.py)."""
        if not self.done():
            if self.device is not None:
                # one-element set wait: same machinery as wait_any/wait_all,
                # so host-busy/host-free accounting covers every wait
                self.device.wait_all([self], policy=policy)
            elif self.engine is None:
                self._pump()
                if not self.done():
                    raise RuntimeError("unresolved promise: no engine will complete it")
            else:
                self.engine.wait(self.record)
        self._fire_callbacks()
        return self.record.result

    def result(self, policy: Union[str, WaitPolicy, None] = None) -> Any:
        """wait(), but a failed descriptor raises instead of returning None."""
        value = self.wait(policy=policy)
        if self.record.status == Status.ERROR:
            raise RuntimeError(self.record.error or "descriptor failed")
        return value

    # -- chaining ------------------------------------------------------------
    def then(self, fn: Callable[[Any], Any]) -> "ChainedFuture":
        """Return a Future for ``fn(result)``, applied when this one retires."""
        return ChainedFuture(self, fn)

    def add_done_callback(self, fn: Callable[["Future"], None]):
        """Register ``fn(future)`` to run when completion is observed
        (poll/wait/result or an engine completion notification).  Callbacks
        fire exactly once — even with concurrent waiters — in registration
        order; a callback added after completion runs immediately."""
        with self._cb_lock:
            if not self._fired:
                self._callbacks.append(fn)
                return
        fn(self)

    # shorter alias of add_done_callback
    done_callback = add_done_callback

    def _fire_callbacks(self):
        if not self.done():
            return
        with self._cb_lock:
            if self._fired:
                return
            self._fired = True
            callbacks, self._callbacks = self._callbacks, []
        if callbacks:
            # user code runs strictly outside _cb_lock; lockcheck verifies
            # no OTHER instrumented lock is held at this dispatch point
            with _lockcheck.notify_region("future.fire_callbacks"):
                for fn in callbacks:
                    fn(self)


class ChainedFuture(Future):
    """Future for a host-side continuation: resolves to fn(parent result)
    once the parent retires.  Errors propagate (parent failure or fn raising
    both mark this record ERROR)."""

    def __init__(self, parent: Future, fn: Callable[[Any], Any]):
        rec = CompletionRecord(desc_id=-1, status=Status.PENDING,
                               op=f"then({op_str(parent)})")
        super().__init__(parent.device, None, rec)
        self.parent = parent
        self.fn = fn

    def _resolve(self):
        if self.record.is_done():
            return
        if self.parent.record.status == Status.ERROR:
            self.record.status = Status.ERROR
            self.record.error = self.parent.record.error or "parent failed"
        else:
            try:
                self.record.result = self.fn(self.parent.record.result)
                self.record.status = Status.SUCCESS
            except Exception as e:  # noqa: BLE001
                self.record.status = Status.ERROR
                self.record.error = f"{type(e).__name__}: {e}"
        if self.device is not None:
            self.device._on_future_done(self)  # deliver to completion sets

    def done(self) -> bool:
        if not self.record.is_done() and self.parent.done():
            self._resolve()
        return self.record.is_done()

    def poll(self) -> bool:
        if self.parent.poll():
            self._resolve()
        if self.done():
            self._fire_callbacks()
            return True
        return False

    def wait(self, policy: Union[str, WaitPolicy, None] = None) -> Any:
        if not self.record.is_done():
            self.parent.wait(policy=policy)
            self._resolve()
        self._fire_callbacks()
        return self.record.result


class Promise(Future):
    """A software fence: a Future completed by the host, not an engine.
    Use as ``after=[p]`` to hold submissions until ``p.set_result(...)``."""

    def __init__(self, device: Optional["Device"] = None):
        super().__init__(device, None,
                         CompletionRecord(desc_id=-1, status=Status.PENDING, op="promise"))

    def set_result(self, value: Any = None):
        self.record.result = value
        self.record.status = Status.SUCCESS
        if self.device is not None:
            self.device._on_future_done(self)  # callbacks + completion sets
            self.device.kick()  # release anything fenced on this promise
        else:
            self._fire_callbacks()

    def set_error(self, error: Union[str, BaseException]):
        self.record.error = str(error)
        self.record.status = Status.ERROR
        if self.device is not None:
            self.device._on_future_done(self)
            self.device.kick()
        else:
            self._fire_callbacks()

    def wait(self, policy: Union[str, WaitPolicy, None] = None) -> Any:
        """A promise is host-completed: an unresolved one can never be
        waited to completion by pumping engines, so fail fast instead of
        parking forever."""
        if not self.done():
            self._pump()
            if not self.done():
                raise RuntimeError("unresolved promise: no engine will complete it")
        self._fire_callbacks()
        return self.record.result


def op_str(f: Future) -> str:
    return f.record.op or "?"


# --------------------------------------------------------------------------- policies
class SubmitPolicy:
    """Chooses which engine instance receives a submission (paper Fig. 10:
    multi-instance scaling depends on balanced placement)."""

    name = "base"

    def select(self, engines: Sequence[StreamEngine], desc: Submittable,
               producer: Optional[str]) -> StreamEngine:
        raise NotImplementedError


class RoundRobinPolicy(SubmitPolicy):
    """Rotate across instances regardless of load (the paper's baseline)."""

    name = "round_robin"

    def __init__(self):
        self._next = 0
        self._lock = _lockcheck.checked_lock("policy.round_robin")

    def select(self, engines, desc, producer):
        with self._lock:
            e = engines[self._next % len(engines)]
            self._next += 1
            return e


class LeastLoadedPolicy(SubmitPolicy):
    """Pick the instance with the lowest aggregate WQ occupancy — the
    paper's guideline for avoiding a hot instance when transfer sizes are
    skewed.  Ties break toward the lowest index (stable placement)."""

    name = "least_loaded"

    @staticmethod
    def occupancy(e: StreamEngine) -> float:
        qs = [w for g in e.config.groups for w in g.wqs]
        return sum(len(w) for w in qs) / max(sum(w.size for w in qs), 1)

    def select(self, engines, desc, producer):
        return min(engines, key=self.occupancy)


class StickyPolicy(SubmitPolicy):
    """Per-producer affinity: one producer always lands on one instance
    (DWQ-per-core analogue, G6).  Unnamed producers fall back to
    round-robin so anonymous traffic still spreads."""

    name = "sticky"

    def __init__(self):
        self._fallback = RoundRobinPolicy()

    def select(self, engines, desc, producer):
        if producer is None:
            return self._fallback.select(engines, desc, producer)
        h = zlib.crc32(producer.encode()) & 0xFFFFFFFF
        return engines[h % len(engines)]


class NumaLocalPolicy(SubmitPolicy):
    """Locality first (paper §4 / Fig. 13: keep the engine and both buffers
    NUMA-local): prefer engines on the descriptor's home node — the
    destination's node when known (that's where the data lands), else the
    source's — and apply the ``inner`` policy among them.  When every
    home-node engine is saturated (aggregate WQ occupancy >= ``saturation``)
    or the descriptor has no home, degrade gracefully to ``inner`` over ALL
    engines: a remote engine beats a stalled submission."""

    name = "numa_local"

    def __init__(self, inner: Union[str, SubmitPolicy, None] = "least_loaded",
                 saturation: float = 1.0):
        self.inner = get_policy(inner)
        self.saturation = saturation

    def select(self, engines, desc, producer):
        home = getattr(desc, "dst_node", None)
        if home is None:
            home = getattr(desc, "src_node", None)
        if home is not None:
            ready = [e for e in engines
                     if getattr(e, "node_id", 0) == home
                     and LeastLoadedPolicy.occupancy(e) < self.saturation]
            if ready:
                return self.inner.select(ready, desc, producer)
        return self.inner.select(engines, desc, producer)


POLICIES: Dict[str, Callable[[], SubmitPolicy]] = {
    "round_robin": RoundRobinPolicy,
    "least_loaded": LeastLoadedPolicy,
    "sticky": StickyPolicy,
    "numa_local": NumaLocalPolicy,
}


def get_policy(policy: Union[str, SubmitPolicy, None]) -> SubmitPolicy:
    if policy is None:
        return RoundRobinPolicy()
    if isinstance(policy, SubmitPolicy):
        return policy
    try:
        return POLICIES[policy]()
    except KeyError:
        raise ValueError(f"unknown submit policy {policy!r}; "
                         f"expected one of {sorted(POLICIES)}") from None


def _dominant_node(nodes: Sequence[Optional[int]],
                   default: Optional[int]) -> Optional[int]:
    """Most common known home node in a batch (placement votes), or the
    hint/None when no member has one."""
    known = [n for n in nodes if n is not None]
    if not known:
        return default
    return Counter(known).most_common(1)[0][0]


# --------------------------------------------------------------------------- device
class Device:
    """Top-level submission facade: a fabric of StreamEngine instances laid
    out over a ``Topology`` of NUMA nodes (default: one node — the flat
    pre-topology world, bit-for-bit compatible).

    Every submit routes through the SubmitPolicy, returns a Future, and
    turns WQ RETRY into bounded exponential backoff (max_retries doublings
    of backoff_base_s) ending in QueueFull — never an unbounded spin.

    Locality (paper §4 / Fig. 13): ``register(array, node)`` records a
    buffer's home node; each submission derives its operands' nodes from
    the registry (or a per-submit ``node=`` hint), the policy can place it
    accordingly (``numa_local``), and the engine charges the inter-node
    link for every operand left on a foreign node.

    ``device`` is where the engines run: None means CUDA (raising where no
    card is present); the plain PyTorch versions run only for ``"cpu"``.
    """

    def __init__(self, engines: Optional[Sequence[StreamEngine]] = None, *,
                 n_instances: int = 1,
                 topology: Optional[Topology] = None,
                 policy: Union[str, SubmitPolicy, None] = "round_robin",
                 wait_policy: Union[str, WaitPolicy, None] = "umwait",
                 config: Optional[DeviceConfig] = None,
                 config_kw: Optional[Dict[str, Any]] = None,
                 wq_configs: Optional[Sequence[WQConfig]] = None,
                 pes_per_group: int = 4,
                 max_retries: int = 10, backoff_base_s: float = 20e-6,
                 validate: str = "warn",
                 device: Union[str, torch.device, None] = None):
        if validate not in ("strict", "warn", "off"):
            raise ValueError(f"validate must be 'strict', 'warn', or 'off', "
                             f"got {validate!r}")
        # submit-time descriptor validation mode (analysis/desclint.py):
        # strict raises the typed DescriptorError taxonomy, warn bumps the
        # desclint_warnings counter, off skips the checks
        self.validate = validate
        if engines is not None:
            if config is not None or wq_configs is not None or config_kw is not None:
                raise ValueError("pass pre-built engines OR a config/wq_configs "
                                 "to build them from, not both")
            self.engines = list(engines)
            self.topology = topology or Topology.single_node(len(self.engines))
        else:
            if config is not None and wq_configs is not None:
                raise ValueError("pass either config= or wq_configs=, not both")
            if config is not None and config_kw is not None:
                raise ValueError("pass either config= or config_kw=, not both")
            # nodes carry their own engine counts; without a topology,
            # n_instances engines land on one node (the legacy shape)
            self.topology = topology or Topology.single_node(n_instances)
            self.engines = []
            per_node = Counter()
            for nid in self.topology.engine_nodes():
                i = per_node[nid]
                per_node[nid] += 1
                if wq_configs is not None:
                    # each instance gets its own WorkQueue objects from the
                    # same WQCFG records (configs are frozen and shareable;
                    # queues are per-instance state)
                    cfg_e = DeviceConfig.from_wq_configs(
                        wq_configs, pes_per_group=pes_per_group, device=device)
                elif config is not None:
                    cfg_e = (config if device is None
                             else dataclasses.replace(config, device=device))
                else:
                    cfg_e = DeviceConfig.default(**(config_kw or {}), device=device)
                name = (f"dsa{i}" if self.topology.n_nodes == 1
                        else f"n{nid}dsa{i}")
                self.engines.append(StreamEngine(cfg_e, name=name, node_id=nid,
                                                 topology=self.topology))
        # buffer-locality registry: id(array) -> (home node, weakref); the
        # weakref callback evicts the entry when the array dies, so a reused
        # id can't inherit a stale home
        self._homes: Dict[int, Any] = {}
        self.policy = get_policy(policy)
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        # per-policy-decision telemetry: which instance each submission
        # landed on, per op, plus backoff pressure
        self.policy_stats: Dict[str, Any] = {
            "policy": self.policy.name,
            "decisions": Counter(),       # engine name -> submissions routed
            "decisions_by_op": Counter(),  # (engine, op) -> submissions
            "backoff_retries": 0,
            "queue_full": 0,
            "desclint_warnings": 0,  # warn-mode validation findings
        }
        self._lock = _lockcheck.checked_lock("device.stats")
        # serializes engine mutation (records/slots/deferred have no internal
        # locking) so background submitters — e.g. async checkpoint CRCs —
        # can share the device with foreground traffic
        self._engine_lock = _lockcheck.checked_rlock("device.engine")
        # ---- completion subsystem (core/completion.py) -------------------
        # default wait scheme for this device; every wait can override it
        self.wait_policy = get_wait_policy(wait_policy)
        # host-busy/host-free cycle accounting per policy name (Fig. 11)
        self.wait_stats: Dict[str, WaitStats] = defaultdict(WaitStats)
        # live futures keyed by their record's identity, so an engine
        # completion notification finds its Future without a scan; weak so
        # dropped futures don't pin results
        self._inflight: "weakref.WeakValueDictionary[int, Future]" = (
            weakref.WeakValueDictionary()
        )
        self._sinks: List[Any] = []  # registered CompletionSets
        self._sinks_lock = _lockcheck.checked_lock("device.sinks")
        # engine notifications arrive while _engine_lock is held; user
        # callbacks must NOT run under it (a blocking callback would
        # deadlock against other waiters), so notifications queue here and
        # dispatch after the lock is released
        self._done_notifications: "deque[Future]" = deque()
        # SLO hint table (register_slo_classes): slo= submits resolve their
        # wq/priority defaults from here, keeping the class -> WQ mapping in
        # one place instead of at every call site
        self._slo_classes: Dict[str, Any] = {}
        # live submit rings (weak: a dropped ring must not leak); kick()
        # flushes them so every wait-policy pump advances deferred bursts
        self._rings: List[Any] = []
        for e in self.engines:
            e.add_listener(self._on_record_done)

    # ------------------------------------------------------------------ locality
    def register(self, array: Any, node: int) -> Any:
        """Record ``array``'s home node in the buffer-locality registry.
        Descriptors naming it derive their src/dst node from here; returns
        the array so registration chains through pool updates."""
        if not 0 <= node < self.topology.n_nodes:
            raise ValueError(
                f"node {node} out of range for {self.topology.n_nodes}-node topology"
            )
        key = id(array)
        try:
            ref = weakref.ref(array, lambda _r, k=key: self._homes.pop(k, None))
        except TypeError:
            ref = None  # unreferenceable objects: entry lives forever
        self._homes[key] = (node, ref)
        return array

    def home(self, array: Any, default: Optional[int] = None) -> Optional[int]:
        """The registered home node of ``array`` (``default`` if unknown)."""
        if array is None:
            return default
        ent = self._homes.get(id(array))
        return ent[0] if ent is not None else default

    def _stamp_locality(self, desc: Submittable, node_hint: Optional[int]) -> None:
        """Resolve operand home nodes onto the descriptor before placement:
        registry first, then the per-submit ``node=`` hint; operands still
        unresolved stay None (= wherever the engine runs, i.e. local)."""
        members = (desc.descriptors if isinstance(desc, BatchDescriptor)
                   else (desc,))
        for d in members:
            if d.src_node is None:
                d.src_node = self.home(d.src, node_hint)
            if d.dst_node is None:
                d.dst_node = (self.home(d.dst_pool, node_hint)
                              if d.dst_pool is not None else node_hint)
        if isinstance(desc, BatchDescriptor):
            if desc.src_node is None:
                desc.src_node = _dominant_node(
                    [d.src_node for d in members], node_hint)
            if desc.dst_node is None:
                desc.dst_node = _dominant_node(
                    [d.dst_node for d in members], node_hint)

    # ------------------------------------------------------------------ SLO hints
    def register_slo_classes(self, classes: Sequence[Any]) -> None:
        """Register SLO classes (objects with ``name``/``wq``/``priority``,
        e.g. the serving layer's SLO classes) so submissions can carry a
        ``slo=`` hint instead of repeating the class -> WQ mapping at every
        call site.  Re-registering replaces the table."""
        table: Dict[str, Any] = {}
        for c in classes:
            table[c.name] = c
        self._slo_classes = table

    def occupancy(self, wq: Union[str, None] = None,
                  node: Optional[int] = None) -> Optional[float]:
        """Aggregate WQ occupancy probe — the admission controller's view
        of engine-side pressure.  Averages ``len/size`` over the matching
        WQs: ``wq`` restricts to that WQ name, ``node`` to that node's
        engines; None when nothing matches (an unknown name is not 'idle')."""
        occs: List[float] = []
        engines = (self.engines if node is None else self.engines_on(node))
        for e in engines:
            for g in e.config.groups:
                for w in g.wqs:
                    if wq is None or w.name == wq:
                        occs.append(w.occupancy)
        if not occs:
            return None
        return sum(occs) / len(occs)

    # ------------------------------------------------------------------ submit
    def submit(self, desc: Submittable, *, after: Optional[Sequence[Any]] = None,
               group: Optional[int] = None, wq: Union[int, str, None] = None,
               priority: Optional[int] = None,
               producer: Optional[str] = None,
               node: Optional[int] = None,
               slo: Optional[str] = None) -> Future:
        """Submit one descriptor; returns its Future.

        ``after``: Futures / CompletionRecords this descriptor must not
        launch before (DSA batch-fence semantics across submissions).
        ``wq``: target WQ as an index or a WQ name; ``priority`` steers to
        the nearest-priority WQ when ``wq`` is not given (searching all
        groups, or only ``group`` when one is pinned).  Both compose with
        the SubmitPolicy (the policy picks the instance, the hint picks
        the WQ on it) and with ``after=`` fences.
        ``node``: home-node hint for operands the registry doesn't know —
        the ``numa_local`` policy places the submission there and the
        engine charges the link if placement lands elsewhere.
        ``slo``: a registered SLO class name (register_slo_classes); fills
        in ``wq``/``priority`` defaults from the class when the caller
        didn't pass them explicitly.
        Raises QueueFull when the target WQ stays full through every
        backoff attempt."""
        wq, priority = self._resolve_slo(slo, wq, priority)
        deps = list(after) if after is not None else None
        self._prepare(desc, node=node)
        eng = self.policy.select(self.engines, desc, producer)
        delay = self.backoff_base_s
        for attempt in range(self.max_retries + 1):
            with self._engine_lock:
                status, rec = eng.submit(desc, group=group, wq=wq,
                                         priority=priority,
                                         producer=producer, after=deps)
            self._dispatch_done()  # retirals observed by the submit's kick
            if status != Status.RETRY:
                with self._lock:
                    self.policy_stats["decisions"][eng.name] += 1
                    self.policy_stats["decisions_by_op"][f"{eng.name}/{op_name(desc)}"] += 1
                    self.policy_stats["backoff_retries"] += attempt
                fut = Future(self, eng, rec)
                self._inflight[id(rec)] = fut
                if rec.is_done():
                    # completed (or failed its fence) before the Future
                    # existed: the engine notification missed the registry
                    self._on_future_done(fut)
                return fut
            self.kick()  # give PEs a chance to retire and free WQ slots
            time.sleep(delay)
            delay *= 2
        with self._lock:
            self.policy_stats["backoff_retries"] += self.max_retries
            self.policy_stats["queue_full"] += 1
        raise QueueFull(eng.name, self.max_retries + 1)

    def _resolve_slo(self, slo: Optional[str], wq: Union[int, str, None],
                     priority: Optional[int]) -> Tuple[Union[int, str, None],
                                                       Optional[int]]:
        """Fill wq/priority defaults from a registered SLO class when the
        caller didn't pass them explicitly (shared by submit/submit_many
        and the submit ring)."""
        if slo is None:
            return wq, priority
        cls = self._slo_classes.get(slo)
        if cls is None:
            raise KeyError(f"unregistered SLO class {slo!r}; call "
                           f"register_slo_classes first "
                           f"(have {sorted(self._slo_classes)})")
        cls_wq = getattr(cls, "wq", None)
        if wq is None and cls_wq is not None and self.has_wq(cls_wq):
            wq = cls_wq
        if priority is None and wq is None:
            priority = getattr(cls, "priority", None)
        return wq, priority

    def _prepare(self, desc: Submittable, *, node: Optional[int]) -> None:
        """Per-descriptor submit-side prep shared by every submission path:
        stamp operand locality, then run desclint."""
        self._stamp_locality(desc, node)
        if self.validate != "off":
            self._desclint(desc)

    def submit_many(self, descs: Sequence[Submittable], *,
                    after: Optional[Sequence[Any]] = None,
                    group: Optional[int] = None,
                    wq: Union[int, str, None] = None,
                    priority: Optional[int] = None,
                    producer: Optional[str] = None,
                    node: Optional[int] = None,
                    slo: Optional[str] = None,
                    chunk: int = 32) -> List[Future]:
        """Fused submission: route ``descs`` in doorbell bursts of up to
        ``chunk``, taking the device and WQ locks once per burst instead of
        once per descriptor and charging the non-posted ENQCMD round trip
        once per burst (each member's ``fused_n`` is stamped with the burst
        width).  Validation stays exactly per-descriptor; the whole call shares one ``after`` fence list
        (batch-fence semantics) and one policy decision per burst.
        Returns one Future per descriptor, in order; raises QueueFull when
        a burst stays refused through every backoff attempt."""
        descs = list(descs)
        if not descs:
            return []
        wq, priority = self._resolve_slo(slo, wq, priority)
        deps = list(after) if after is not None else None
        futures: List[Future] = []
        step = max(int(chunk), 1)
        for start in range(0, len(descs), step):
            burst = descs[start:start + step]
            for d in burst:
                self._prepare(d, node=node)
                d.fused_n = len(burst)
            eng = self.policy.select(self.engines, burst[0], producer)
            delay = self.backoff_base_s
            results = None
            for attempt in range(self.max_retries + 1):
                with self._engine_lock:
                    results = eng.submit_many(burst, group=group, wq=wq,
                                              priority=priority,
                                              producer=producer, after=deps)
                self._dispatch_done()
                if results[0][0] != Status.RETRY:
                    break
                self.kick()
                time.sleep(delay)
                delay *= 2
            else:
                with self._lock:
                    self.policy_stats["backoff_retries"] += self.max_retries
                    self.policy_stats["queue_full"] += 1
                raise QueueFull(eng.name, self.max_retries + 1)
            with self._lock:
                self.policy_stats["decisions"][eng.name] += len(burst)
                for d in burst:
                    self.policy_stats["decisions_by_op"][f"{eng.name}/{op_name(d)}"] += 1
                self.policy_stats["backoff_retries"] += attempt
            for _status, rec in results:
                fut = Future(self, eng, rec)
                self._inflight[id(rec)] = fut
                if rec.is_done():
                    self._on_future_done(fut)
                futures.append(fut)
        return futures

    def submit_ring(self, depth: int = 64, chunk: int = 32,
                    **defaults) -> "SubmitRing":
        """Opt-in deferred submission ring (see SubmitRing): ``add`` buffers
        descriptors and returns live Futures; the buffered burst flushes
        through the fused submit_many path on ``flush()``, when the ring
        fills, or on any ``Device.kick()`` — which every wait policy pumps,
        so waiting on a ringed Future flushes it automatically."""
        ring = SubmitRing(self, depth=depth, chunk=chunk, **defaults)
        self._rings.append(weakref.ref(ring))
        return ring

    def _flush_rings(self):
        """Flush live submit rings (dropping dead weakrefs); called from
        kick() so WaitPolicy pump loops advance deferred submissions."""
        dead = False
        for ref in list(self._rings):
            ring = ref()
            if ring is None:
                dead = True
                continue
            ring.flush()
        if dead:
            self._rings = [r for r in self._rings if r() is not None]

    def _desclint(self, desc: Submittable) -> None:
        """Validate after locality stamping (so registry-vs-hint conflicts
        were resolvable) and before placement.  Lazy import: desclint needs
        repro_torch.core.descriptor, which this module helps initialise."""
        from repro_torch.analysis import desclint

        diags = desclint.check(desc, device=self)
        if not diags:
            return
        if self.validate == "strict" and any(
                d.severity == "error" for d in diags):
            raise desclint.error_for(diags, desc=desc)
        with self._lock:
            self.policy_stats["desclint_warnings"] += len(diags)

    def promise(self) -> Promise:
        """A host-completed fence Future (see Promise)."""
        return Promise(self)

    def engines_on(self, node: int) -> List[StreamEngine]:
        """The engine instances living on one NUMA node of the fabric."""
        return [e for e in self.engines if getattr(e, "node_id", 0) == node]

    def has_wq(self, name: str) -> bool:
        """True when every instance exposes a WQ with this name (safe to use
        as a ``wq=`` hint regardless of which instance the policy picks)."""
        return all(
            any(w.name == name for g in e.config.groups for w in g.wqs)
            for e in self.engines
        )

    # ------------------------------------------------------------------ completion
    def _resolve_wait_policy(self, policy: Union[str, WaitPolicy, None]) -> WaitPolicy:
        return self.wait_policy if policy is None else get_wait_policy(policy)

    def _wait_bucket(self, name: str) -> WaitStats:
        """Per-policy WaitStats, created under the device lock so two
        threads' first waits can't race defaultdict.__missing__ and strand
        one thread's counts in an orphaned bucket."""
        with self._lock:
            return self.wait_stats[name]

    def _on_record_done(self, rec: CompletionRecord):
        """Engine completion notification (runs under _engine_lock): queue
        the resolved record's Future; callbacks and completion-set delivery
        happen in _dispatch_done once the lock is released."""
        fut = self._inflight.pop(id(rec), None)
        if fut is not None:
            self._done_notifications.append(fut)

    def _dispatch_done(self):
        """Fire queued completion notifications — exactly-once callbacks
        plus delivery to registered sets — outside the engine lock."""
        while True:
            try:
                fut = self._done_notifications.popleft()
            except IndexError:
                return
            self._on_future_done(fut)

    def _on_future_done(self, fut: "Future"):
        fut._fire_callbacks()
        with self._sinks_lock:
            sinks = list(self._sinks)
        for sink in sinks:
            sink._deliver(fut)

    def _add_sink(self, sink):
        with self._sinks_lock:
            self._sinks.append(sink)

    def _remove_sink(self, sink):
        with self._sinks_lock:
            try:
                self._sinks.remove(sink)
            except ValueError:
                pass

    def _inflight_work(self):
        """What a parked wait policy blocks on (the UMWAIT monitor arm):
        (PE worker handles still launching, completion events of launched
        kernels not yet retired)."""
        with self._engine_lock:
            work: List[Any] = []
            events: List[Any] = []
            for e in self.engines:
                for active in e._active.values():
                    for s in active:
                        if s.record is None or s.record.is_done():
                            continue
                        if s.work is not None and not s.work.done():
                            work.append(s.work)
                        elif s.event is not None:
                            events.append(s.event)
            return work, events

    def wait_any(self, futures: Sequence["Future"], *,
                 policy: Union[str, WaitPolicy, None] = None,
                 timeout: Optional[float] = None):
        """Wait until at least one of ``futures`` completes; returns
        ``(done, pending)``.  ``timeout=0`` is a single non-parking poll
        pass — the pipeline-friendly form."""
        return _completion.wait_any(self, futures, policy=policy, timeout=timeout)

    def wait_all(self, futures: Sequence["Future"], *,
                 policy: Union[str, WaitPolicy, None] = None,
                 timeout: Optional[float] = None):
        """Wait until every future completes (raises WaitTimeout past the
        deadline); returns the futures.  Failures are 'complete' — call
        ``result()`` per future to raise."""
        return _completion.wait_all(self, futures, policy=policy, timeout=timeout)

    def as_completed(self, futures: Sequence["Future"], *,
                     policy: Union[str, WaitPolicy, None] = None,
                     timeout: Optional[float] = None) -> Iterator["Future"]:
        """Iterate ``futures`` in completion order, driving one wait-policy
        loop for the whole set."""
        return _completion.as_completed(self, futures, policy=policy, timeout=timeout)

    # ------------------------------------------------------------------ async ops
    def memcpy_async(self, src: torch.Tensor, **kw):
        return self.submit(WorkDescriptor(op=OpType.MEMCPY, src=src), **kw)

    def dualcast_async(self, src: torch.Tensor, **kw):
        return self.submit(WorkDescriptor(op=OpType.DUALCAST, src=src), **kw)

    def fill_async(self, pattern, n_words: int, **kw):
        return self.submit(
            WorkDescriptor(op=OpType.FILL, pattern=pattern, n_words=n_words), **kw
        )

    def compare_async(self, a, b, **kw):
        return self.submit(WorkDescriptor(op=OpType.COMPARE, src=a, src2=b), **kw)

    def crc32_async(self, buf, **kw):
        return self.submit(WorkDescriptor(op=OpType.CRC32, src=buf), **kw)

    def copy_crc_async(self, src, **kw):
        """Fused memcpy+CRC32 in ONE kernel launch; the Future resolves to
        ``(copy, crc)``.  Bit-exact with the unfused memcpy/crc32 pair at
        roughly half the modeled device time (one read pass, one launch)."""
        return self.submit(WorkDescriptor(op=OpType.COPY_CRC, src=src), **kw)

    def fill_verify_async(self, pattern, n_words: int, **kw):
        """Fused fill+compare_pattern in ONE kernel launch; the Future
        resolves to ``(filled, (ok, first_bad_idx))`` — the written buffer
        plus its in-kernel readback verification."""
        return self.submit(
            WorkDescriptor(op=OpType.FILL_VERIFY, pattern=pattern,
                           n_words=n_words), **kw
        )

    def delta_create_async(self, src, ref, cap: int = 1024, **kw):
        return self.submit(
            WorkDescriptor(op=OpType.DELTA_CREATE, src=src, src2=ref, cap=cap), **kw
        )

    def delta_apply_async(self, ref, offsets, data, **kw):
        return self.submit(
            WorkDescriptor(op=OpType.DELTA_APPLY, src=ref, src_idx=offsets, src2=data), **kw
        )

    def compare_pattern_async(self, buf, pattern, **kw):
        return self.submit(
            WorkDescriptor(op=OpType.COMPARE_PATTERN, src=buf, pattern=pattern), **kw
        )

    def dif_insert_async(self, buf, **kw):
        """Frame ``buf`` with per-block DIF tags (CRC + ref/app tag)."""
        return self.submit(WorkDescriptor(op=OpType.DIF_INSERT, src=buf), **kw)

    def dif_check_async(self, framed, **kw):
        """Verify per-block DIF tags; resolves to the ok-mask per block."""
        return self.submit(WorkDescriptor(op=OpType.DIF_CHECK, src=framed), **kw)

    def dif_strip_async(self, framed, **kw):
        """Drop DIF framing, recovering the raw word stream."""
        return self.submit(WorkDescriptor(op=OpType.DIF_STRIP, src=framed), **kw)

    def batch_copy_async(self, src_pool, dst_pool, src_idx, dst_idx, **kw):
        return self.submit(
            WorkDescriptor(op=OpType.BATCH_COPY, src=src_pool, dst_pool=dst_pool,
                           src_idx=src_idx, dst_idx=dst_idx), **kw
        )

    def batch_async(self, descriptors: Sequence[WorkDescriptor], **kw):
        return self.submit(BatchDescriptor(descriptors=list(descriptors)), **kw)

    # ------------------------------------------------------------------ sync sugar
    def wait(self, fut: Future, *, policy: Union[str, WaitPolicy, None] = None) -> Any:
        return fut.wait(policy=policy)

    def poll(self, fut: Future) -> bool:
        return fut.poll()

    def memcpy(self, src):
        return self.wait(self.memcpy_async(src))

    def crc32(self, buf) -> int:
        return int(self.wait(self.crc32_async(buf)))

    def compare(self, a, b):
        return self.wait(self.compare_async(a, b))

    def delta_create(self, src, ref, cap: int = 1024):
        return self.wait(self.delta_create_async(src, ref, cap=cap))

    def delta_apply(self, ref, offsets, data):
        return self.wait(self.delta_apply_async(ref, offsets, data))

    # ------------------------------------------------------------------ lifecycle
    def kick(self):
        """Pump every instance's arbiter + deferred fences once; completion
        callbacks for anything that retired fire after the lock drops.
        Deferred submit rings flush first, so a kick (and therefore every
        wait-policy pump loop) pushes ring-buffered bursts to the engines
        before the arbiters run."""
        if self._rings:
            self._flush_rings()
        with self._engine_lock:
            for e in self.engines:
                e.kick()
        self._dispatch_done()

    def drain(self):
        """Run all instances dry, including cross-engine fences: a deferred
        descriptor on engine A whose parent lives on engine B resolves here
        because every engine is pumped each round."""
        while True:  # dsalint: disable=DSA103 — drain IS the terminal pump
            with self._engine_lock:
                for e in self.engines:
                    e.kick()
                    e.drain()
                pending = any(e._deferred for e in self.engines) or any(
                    len(w) for e in self.engines for g in e.config.groups for w in g.wqs
                )
                done = not pending
                if pending:
                    released = False
                    for e in self.engines:
                        for *_, deps, _rec in e._deferred:
                            if all(d.is_done() for d in deps):
                                released = True
                    if not released:
                        # remaining fences wait on unresolved promises;
                        # nothing an engine pump can do
                        done = True
            self._dispatch_done()  # callbacks fire outside the lock
            if done:
                return


class SubmitRing:
    """Opt-in deferred submission ring (the paper's batched-doorbell
    guideline as an API): ``add()`` validates and buffers a descriptor,
    returning a live Future immediately — and ``flush()``
    pushes the buffered burst through the engine's fused ``submit_many``
    path, taking the device and WQ locks once per burst and paying one
    amortized ENQCMD doorbell per burst of up to ``chunk``.

    The ring flushes itself when it reaches ``depth``, on ``flush()``/
    ``close()``/context exit, and on every ``Device.kick()`` — which every
    WaitPolicy pump loop calls, so simply waiting on a ringed Future
    flushes it.  A burst refused by a full WQ stays buffered and retries on
    the next flush; consecutive adds sharing the same ``after`` fence list
    flush as one burst (batch-fence semantics).

        with device.submit_ring(depth=64) as ring:
            futs = [ring.add(WorkDescriptor(op=OpType.MEMCPY, src=x))
                    for x in buffers]
        device.wait_all(futs)
    """

    def __init__(self, device: Device, depth: int = 64, chunk: int = 32, *,
                 group: Optional[int] = None, wq: Union[int, str, None] = None,
                 priority: Optional[int] = None, producer: Optional[str] = None,
                 node: Optional[int] = None, slo: Optional[str] = None):
        self.device = device
        self.depth = max(int(depth), 1)
        self.chunk = max(min(int(chunk), self.depth), 1)
        wq, priority = device._resolve_slo(slo, wq, priority)
        self._kw = dict(group=group, wq=wq, priority=priority,
                        producer=producer, node=node, slo=slo)
        # (descriptor, record, deps) in submission order
        self._pending: "deque[Tuple[Any, CompletionRecord, Optional[List[Any]]]]" = deque()
        self._lock = _lockcheck.checked_lock("device.ring")
        self._flushing = False
        self.stats = {"added": 0, "flushed": 0, "doorbells": 0, "retries": 0}

    def __len__(self) -> int:
        return len(self._pending)

    @staticmethod
    def _fence_key(deps: Optional[List[Any]]) -> Tuple[int, ...]:
        return tuple(id(d) for d in deps) if deps else ()

    def add(self, desc: Submittable, *,
            after: Optional[Sequence[Any]] = None) -> Future:
        """Buffer one descriptor; returns its Future immediately (PENDING
        until a flush lands it on an engine).  Validation and locality
        stamping run here at add time: strict desclint raises before
        anything is buffered."""
        deps = list(after) if after is not None else None
        self.device._prepare(desc, node=self._kw["node"])
        rec = CompletionRecord(desc_id=desc.desc_id, status=Status.PENDING,
                               op=op_name(desc))
        fut = Future(self.device, None, rec)
        self.device._inflight[id(rec)] = fut
        with self._lock:
            self._pending.append((desc, rec, deps))
            self.stats["added"] += 1
            full = len(self._pending) >= self.depth
        if full:
            self.flush()
        return fut

    def flush(self) -> int:
        """Submit buffered descriptors in fused bursts; returns how many
        landed on an engine.  A burst the WQ refuses (RETRY) goes back to
        the head of the ring for the next flush — every wait-policy kick
        retries it, so backpressure resolves without busy-spinning here."""
        dev = self.device
        with self._lock:
            if self._flushing or not self._pending:
                return 0
            self._flushing = True
        flushed = 0
        try:
            while True:
                with self._lock:
                    if not self._pending:
                        break
                    key = self._fence_key(self._pending[0][2])
                    burst = [self._pending.popleft()]
                    while (self._pending and len(burst) < self.chunk
                           and self._fence_key(self._pending[0][2]) == key):
                        burst.append(self._pending.popleft())
                descs = [b[0] for b in burst]
                for d in descs:
                    d.fused_n = len(descs)
                eng = dev.policy.select(dev.engines, descs[0],
                                        self._kw["producer"])
                with dev._engine_lock:
                    results = eng.submit_many(
                        descs, group=self._kw["group"], wq=self._kw["wq"],
                        priority=self._kw["priority"],
                        producer=self._kw["producer"], after=burst[0][2],
                        records=[b[1] for b in burst])
                dev._dispatch_done()
                if results[0][0] == Status.RETRY:
                    with self._lock:
                        self._pending.extendleft(reversed(burst))
                        self.stats["retries"] += 1
                    break
                with dev._lock:
                    dev.policy_stats["decisions"][eng.name] += len(burst)
                    for d in descs:
                        dev.policy_stats["decisions_by_op"][
                            f"{eng.name}/{op_name(d)}"] += 1
                flushed += len(burst)
                self.stats["flushed"] += len(burst)
                self.stats["doorbells"] += 1
        finally:
            with self._lock:
                self._flushing = False
        return flushed

    def close(self):
        """Drain the ring completely, pumping the device through WQ
        backpressure with the device's bounded backoff; raises QueueFull
        if the buffered burst can never land."""
        delay = self.device.backoff_base_s
        for _attempt in range(self.device.max_retries + 1):
            self.flush()
            if not self._pending:
                return
            self.device.kick()
            time.sleep(delay)
            delay *= 2
        with self.device._lock:
            self.device.policy_stats["queue_full"] += 1
        raise QueueFull("submit_ring", self.device.max_retries + 1)

    def __enter__(self) -> "SubmitRing":
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            self.flush()  # best effort; don't mask the in-flight exception


def make_device(n_instances: int = 1, *,
                policy: Union[str, SubmitPolicy, None] = "round_robin",
                wait_policy: Union[str, WaitPolicy, None] = "umwait",
                wq_configs: Optional[Sequence[WQConfig]] = None,
                topology: Optional[Topology] = None,
                max_retries: int = 10, backoff_base_s: float = 20e-6,
                validate: str = "warn",
                trace: Any = None,
                device: Union[str, torch.device, None] = None,
                **cfg_kw) -> Device:
    """Build a Device over fresh engine instances (Fig. 10 topology).

    ``topology`` lays the instances out over NUMA nodes (each ``Node``
    names its own engine count; ``n_instances`` is ignored then) and turns
    on cross-node link charging; the default is one flat node with
    ``n_instances`` engines.  ``wq_configs`` provisions each instance from
    WQCFG records (mode, size partition, priority, traffic class — Fig. 9
    knobs); otherwise ``cfg_kw`` forwards to DeviceConfig.default
    (wqs_per_group, wq_size, wq_mode, pes_per_group, n_groups).
    ``wait_policy`` sets the default completion wait scheme (spin / pause /
    umwait / interrupt — Fig. 11).
    ``validate`` sets the submit-time descriptor validation mode
    (analysis/desclint.py): "strict" raises the typed DescriptorError
    taxonomy on malformed descriptors, "warn" (default) records them on the
    ``desclint_warnings`` counter, "off" skips the checks.
    ``trace`` (descriptor-lifecycle tracing) is not ported yet: anything but
    None raises NotImplementedError.
    ``device`` is where the engines run: None means CUDA and raises where
    no card is present; ``"cpu"`` runs the kernels' plain PyTorch versions."""
    if trace is not None:
        raise NotImplementedError(
            "make_device(trace=...): descriptor-lifecycle tracing is not "
            "ported to repro_torch yet")
    if wq_configs is not None:
        pes = cfg_kw.pop("pes_per_group", 4)
        if cfg_kw:
            raise ValueError(f"wq_configs replaces default-config knobs; "
                             f"unexpected {sorted(cfg_kw)}")
        return Device(n_instances=n_instances, topology=topology, policy=policy,
                      wait_policy=wait_policy,
                      wq_configs=wq_configs, pes_per_group=pes,
                      max_retries=max_retries, backoff_base_s=backoff_base_s,
                      validate=validate, device=device)
    return Device(n_instances=n_instances, topology=topology, policy=policy,
                  wait_policy=wait_policy, config_kw=cfg_kw or None,
                  max_retries=max_retries, backoff_base_s=backoff_base_s,
                  validate=validate, device=device)
