"""The streaming engine: groups, PEs, arbitration, async completion.

Maps the DSA execution pipeline (paper Fig. 1a) onto PyTorch and CUDA:

  WQs     -> bounded host-side queues (core/queues.py), provisioned by
             WQConfig (mode, size partition, priority 1-15, traffic class)
  group   -> {WQs, PE slots, read-buffer share} with a priority-weighted
             deficit arbiter (WQ -> group -> engine dispatch, Fig. 9)
  PE      -> one in-flight kernel slot with its own CUDA stream;
             "processing" a descriptor = launching its kernel (ops.py) on
             the slot's stream from a PE worker thread.  A CUDA event
             recorded after the launch is the completion record's hardware
             write: poll() queries it, wait() synchronises on it (the
             UMWAIT analogue)
  batch   -> homogeneous copy batches fuse into ONE batch_copy kernel
             launch (F2); mixed batches run back-to-back under one record

The engine is also a *model*: every completion record carries the projected
device time from core/perfmodel.py next to the measured host time, which is
what the paper-figure benchmarks plot.  QoS enters the model in two places:
a shared WQ charges the ENQCMD non-posted round trip per submission, and a
WQ with ``traffic_class="to_cache"`` steers destination writes to the L2
tier (DDIO analogue, Fig. 12).

The engine's ``device`` replaces the JAX package's interpret switch: on a
CUDA engine every op launches the CUDA kernels (or raises), on a CPU engine
every op runs their plain PyTorch versions.  Operands must live on the
engine's device.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.analysis import lockcheck as _lockcheck
from repro_torch.core.descriptor import (
    BatchDescriptor,
    CacheHint,
    CompletionRecord,
    OpType,
    Status,
    WorkDescriptor,
    op_name,
)
from repro_torch.core.perfmodel import DEFAULT_MODEL, EngineModel
from repro_torch.core.queues import Submittable, WorkQueue, WQConfig
from repro_torch.kernels import ops

#: ops of the JAX package's engine that this port does not run yet; their
#: descriptors resolve Status.ERROR with a NotImplementedError message
UNPORTED_OPS = (
    OpType.FILL, OpType.COMPARE, OpType.COMPARE_PATTERN, OpType.DUALCAST,
    OpType.DELTA_CREATE, OpType.DELTA_APPLY, OpType.DIF_INSERT,
    OpType.DIF_CHECK, OpType.DIF_STRIP, OpType.FILL_VERIFY, OpType.CACHE_FLUSH,
)


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """The engine's device: ``None`` means CUDA.  Asking for CUDA where no
    card is present raises; the CPU runs only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch needs a CUDA device (torch.cuda.is_available() is "
                "False); pass device='cpu' to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected 'cuda' or 'cpu'")
    return dev


def _tensor_leaves(x: Any) -> Iterator[torch.Tensor]:
    """The tensors in an op's result (nested tuples, lists and dicts)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensor_leaves(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensor_leaves(v)


# The PE "fabric": kernel launches run on worker threads so the submitting
# thread is never the one that launches (or, on the CPU, computes) the
# descriptor.  One shared pool: per-PE concurrency is already bounded by
# each group's slot count.
_PE_POOL: Optional[concurrent.futures.ThreadPoolExecutor] = None
_PE_POOL_LOCK = _lockcheck.checked_lock("engine.pe_pool")


def _pe_pool() -> concurrent.futures.ThreadPoolExecutor:
    global _PE_POOL
    with _PE_POOL_LOCK:
        if _PE_POOL is None:
            _PE_POOL = concurrent.futures.ThreadPoolExecutor(
                max_workers=max(os.cpu_count() or 4, 4),
                thread_name_prefix="pe",
            )
        return _PE_POOL


@dataclasses.dataclass
class GroupConfig:
    name: str
    wqs: Sequence[WorkQueue]
    n_pes: int = 1
    read_buffers: int = 8  # QoS knob (modeled: scales small-transfer depth)


@dataclasses.dataclass
class DeviceConfig:
    """Default shape mirrors SPR DSA (Table 2): 8 WQs, 4 PEs per instance.
    ``device`` is where the engine runs (None: CUDA)."""

    groups: Sequence[GroupConfig] = ()
    device: Union[str, torch.device, None] = None
    model: EngineModel = dataclasses.field(default_factory=lambda: DEFAULT_MODEL)

    @staticmethod
    def default(n_groups: int = 1, wqs_per_group: int = 2, pes_per_group: int = 4,
                wq_size: int = 32, wq_mode: str = "dedicated",
                device: Union[str, torch.device, None] = None) -> "DeviceConfig":
        groups = []
        for g in range(n_groups):
            wqs = [
                WorkQueue(f"g{g}wq{i}", mode=wq_mode, size=wq_size)
                for i in range(wqs_per_group)
            ]
            groups.append(GroupConfig(f"group{g}", wqs, n_pes=pes_per_group))
        return DeviceConfig(groups=groups, device=device)

    @staticmethod
    def from_wq_configs(wq_configs: Sequence[WQConfig],
                        pes_per_group: int = 4,
                        device: Union[str, torch.device, None] = None) -> "DeviceConfig":
        """Build the WQ -> group topology from WQCFG records (Fig. 9 sweeps).
        WQs with the same ``group`` index share that group's PEs and compete
        under its priority arbiter; groups are created densely 0..max."""
        if not wq_configs:
            raise ValueError("wq_configs must name at least one WQConfig")
        names = [c.name for c in wq_configs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate WQ names in wq_configs: {names}")
        n_groups = max(c.group for c in wq_configs) + 1
        groups = []
        for g in range(n_groups):
            wqs = [WorkQueue.from_config(c) for c in wq_configs if c.group == g]
            if not wqs:
                raise ValueError(f"wq_configs leaves group {g} empty; "
                                 f"group indices must be dense")
            groups.append(GroupConfig(f"group{g}", wqs, n_pes=pes_per_group))
        return DeviceConfig(groups=groups, device=device)


class _PESlot:
    """One in-flight descriptor on a processing engine.

    ``work`` is the PE worker's handle (the launch runs off-thread); once it
    resolves, the record holds the result tensors and ``event`` the CUDA
    event recorded after the launch on the slot's ``stream``, and
    retirement waits only on that event.  ``desc`` keeps the descriptor,
    and so its operands, alive until the slot retires: the caching
    allocator must not hand an input's memory to new work while the kernel
    still reads it."""

    def __init__(self, device: torch.device):
        self.record: Optional[CompletionRecord] = None
        self.work: Optional[concurrent.futures.Future] = None
        self.event: Optional[torch.cuda.Event] = None
        self.desc: Optional[Submittable] = None
        self.t0: float = 0.0
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    @property
    def busy(self) -> bool:
        return self.record is not None and not self.record.is_done()

    def _clear(self) -> None:
        self.record = None
        self.work = None
        self.event = None
        self.desc = None

    def try_retire(self) -> bool:
        if self.record is None:
            return False
        if self.work is not None:
            if not self.work.done():
                return False
            rec = self.record
            try:
                outputs, nbytes, modeled_us, event = self.work.result()
            except Exception as e:  # noqa: BLE001 — kernel launch failed
                rec.status = Status.ERROR
                rec.error = f"{type(e).__name__}: {e}"
                rec.wall_time_us = (time.perf_counter() - self.t0) * 1e6
                self._clear()
                return True
            rec.result = outputs
            rec.bytes_processed = nbytes
            rec.modeled_time_us = modeled_us
            self.event = event
            self.work = None
        if self.event is None or self.event.query():
            self.record.wall_time_us = (time.perf_counter() - self.t0) * 1e6
            if self.record.status == Status.RUNNING:
                self.record.status = Status.SUCCESS
            self._clear()
            return True
        return False

    def block(self):
        """Host-side block until this slot's descriptor can retire (the
        targeted UMWAIT): join the PE worker, then the launch's event."""
        work = self.work
        if work is not None:
            work.exception()  # wait; failures surface at try_retire
            return
        if self.event is not None:
            self.event.synchronize()


class StreamEngine:
    """One DSA-instance analogue.

    ``node_id``/``topology`` place the instance on a NUMA node
    (core/topology.py): descriptors whose operands live on a foreign node
    are charged the inter-node link (bandwidth cap + latency per crossing),
    and the node's tier table overrides the global one when set.  The
    defaults (node 0, no topology) are the flat single-domain world."""

    def __init__(self, config: Optional[DeviceConfig] = None, name: str = "dsa0",
                 node_id: int = 0, topology: Optional[Any] = None):
        self.config = config or DeviceConfig.default()
        self.name = name
        self.node_id = node_id
        self.topology = topology
        # only a multi-node fabric charges the link; a single node never does
        self.link = (topology.link if topology is not None
                     and getattr(topology, "n_nodes", 1) > 1 else None)
        self._tiers = (topology.node(node_id).tiers if topology is not None
                       else None)
        # completion listeners (core/completion.py): called with each
        # CompletionRecord as it resolves, so a Device can feed its
        # completion sets without anyone pumping per-record
        self._listeners: List[Any] = []
        self.device = resolve_device(self.config.device)
        self.model = self.config.model
        self._slots: Dict[str, List[_PESlot]] = {
            g.name: [_PESlot(self.device) for _ in range(g.n_pes)]
            for g in self.config.groups
        }
        # hot-path slot recycling: ``_free`` is the ready ring of idle slot
        # objects, ``_active`` the in-flight list.  kick() retires only the
        # active list and dispatches by popping the free ring, so a kick is
        # O(in-flight + dispatched) instead of O(total slots); slot objects
        # (and their CUDA streams) are reused forever (``_slots`` stays the
        # full inventory).
        self._free: Dict[str, List[_PESlot]] = {
            g.name: list(self._slots[g.name]) for g in self.config.groups
        }
        self._active: Dict[str, List[_PESlot]] = {
            g.name: [] for g in self.config.groups
        }
        # deficit counters for priority-weighted draining (one per WQ)
        self._credit: Dict[str, Dict[str, float]] = {
            g.name: {w.name: 0.0 for w in g.wqs} for g in self.config.groups
        }
        self.records: Dict[int, CompletionRecord] = {}
        # cheap monotonic counters, bumped once per resolved record in
        # _notify, so a sampler can read deltas of these each tick instead
        # of rescanning ``records``.  ``completed`` counts every resolution
        # (including errors and failed fences), matching what a
        # record-walking Telemetry counts.
        self.counters: Dict[str, float] = {
            "completed": 0, "errors": 0, "bytes": 0,
            "modeled_us": 0.0, "wall_us": 0.0,
            "local_ops": 0, "local_bytes": 0,
            "cross_ops": 0, "cross_bytes": 0, "link_bytes": 0,
            # submission-side counters: every accepted descriptor bumps
            # ``submitted``; those arriving through a fused doorbell
            # (submit_many / submit ring) also bump ``fused_descs``, with
            # one ``fused_batches`` per doorbell
            "submitted": 0, "fused_batches": 0, "fused_descs": 0,
        }
        self._counters_lock = _lockcheck.checked_lock("engine.counters")
        # deferred submissions waiting on dependency fences:
        # (desc, group, wq, producer, deps, record)
        self._deferred: List[Tuple[Submittable, int, int, Optional[str], List[Any], CompletionRecord]] = []
        # fence capacity: deferred descriptors hold WQ-adjacent state, so the
        # park list is bounded like a WQ (RETRY past this -> caller backoff)
        self.max_deferred = 4 * sum(
            w.size for g in self.config.groups for w in g.wqs
        )

    # ------------------------------------------------------------------ completion notify
    def add_listener(self, fn) -> None:
        """Register ``fn(record)`` to run when any completion record on this
        engine resolves (success, error, or failed fence)."""
        self._listeners.append(fn)

    def _notify(self, rec: CompletionRecord) -> None:
        self._count(rec)
        for fn in self._listeners:
            fn(rec)

    def _count(self, rec: CompletionRecord) -> None:
        """Fold one resolved record into the monotonic counters (every
        resolve path funnels through _notify, so each record counts once)."""
        with self._counters_lock:
            c = self.counters
            c["completed"] += 1
            if rec.status == Status.ERROR:
                c["errors"] += 1
            c["bytes"] += rec.bytes_processed
            c["modeled_us"] += rec.modeled_time_us
            c["wall_us"] += rec.wall_time_us
            if rec.link_hops > 0:
                c["cross_ops"] += 1
                c["cross_bytes"] += rec.bytes_processed
                c["link_bytes"] += rec.bytes_processed * rec.link_hops
            else:
                c["local_ops"] += 1
                c["local_bytes"] += rec.bytes_processed

    def _count_submitted(self, n: int, fused: bool) -> None:
        with self._counters_lock:
            c = self.counters
            c["submitted"] += n
            if fused:
                c["fused_batches"] += 1
                c["fused_descs"] += n

    def counters_snapshot(self) -> Dict[str, float]:
        """Point-in-time copy of the monotonic counters (delta-sampling
        safe: values never decrease)."""
        with self._counters_lock:
            return dict(self.counters)

    def _retire(self, slot: "_PESlot") -> bool:
        """try_retire + completion notification (the IRQ/monitored-write
        analogue: fires exactly when the record transitions to done)."""
        rec = slot.record
        if slot.try_retire():
            self._notify(rec)
            return True
        return False

    def _submit_point(self) -> Optional[Tuple[torch.cuda.Stream, torch.cuda.Event]]:
        """The submitter's current stream and an event recorded on it now:
        the operands were produced there, so the slot stream waits on the
        event before launching (see CompletionRecord.submit_point)."""
        if self.device.type != "cuda":
            return None
        stream = torch.cuda.current_stream(self.device)
        ev = torch.cuda.Event()
        ev.record(stream)
        return stream, ev

    # ------------------------------------------------------------------ submission
    def wq(self, group: int = 0, wq: int = 0) -> WorkQueue:
        return self.config.groups[group].wqs[wq]

    def resolve_wq(self, group: Optional[int] = None,
                   wq: Union[int, str, None] = None,
                   priority: Optional[int] = None) -> Tuple[int, int]:
        """Map per-submit hints to a (group, wq) index pair.

        ``wq`` as a string selects by WQ name across ALL groups (the name
        wins over ``group``).  ``wq=None`` with a ``priority`` hint picks
        the WQ whose configured priority is nearest the hint (ties toward
        the higher-priority WQ), the QoS-level steer; an explicit
        ``group=`` pins the priority search to that group (so WQs placed in
        an isolation group never lose submissions to another group's WQs).
        Plain ints index directly; ``group=None`` means group 0 unless a
        priority hint widens the search."""
        if isinstance(wq, str):
            for gi, g in enumerate(self.config.groups):
                for wi, w in enumerate(g.wqs):
                    if w.name == wq:
                        return gi, wi
            known = [w.name for g in self.config.groups for w in g.wqs]
            raise KeyError(f"no WQ named {wq!r} on {self.name}; have {known}")
        if wq is None and priority is not None:
            candidates = (
                enumerate(self.config.groups) if group is None
                else [(group, self.config.groups[group])]
            )
            best = min(
                ((gi, wi, w) for gi, g in candidates
                 for wi, w in enumerate(g.wqs)),
                key=lambda t: (abs(t[2].priority - priority), -t[2].priority, t[0], t[1]),
            )
            return best[0], best[1]
        return group or 0, int(wq or 0)

    def submit(self, desc: Submittable, group: Optional[int] = None,
               wq: Union[int, str, None] = None,
               producer: Optional[str] = None,
               after: Optional[Sequence[Any]] = None,
               priority: Optional[int] = None) -> Tuple[Status, CompletionRecord]:
        """Enqueue a descriptor.  ``after`` is a sequence of dependency fences
        (CompletionRecords or anything with ``is_done()``/``status``): the
        descriptor is held back (the DSA batch-fence analogue) and only
        enters its WQ once every dependency has retired.  ``wq`` may be an
        index or a WQ name; ``priority`` steers to the nearest-priority WQ
        when no explicit ``wq`` is given (see resolve_wq)."""
        group, wq_idx = self.resolve_wq(group, wq, priority)
        after = list(after or ())
        failed = next((d for d in after
                       if d.is_done() and d.status in (Status.ERROR, Status.OVERFLOW)), None)
        if failed is not None:
            rec = CompletionRecord(desc_id=desc.desc_id, status=Status.ERROR,
                                   op=op_name(desc),
                                   error=f"dependency failed: {failed.status.name}")
            self.records[desc.desc_id] = rec
            self._count_submitted(1, fused=False)
            self._notify(rec)
            return Status.ERROR, rec
        deps = [d for d in after if not d.is_done()]
        if deps:
            if len(self._deferred) >= self.max_deferred:
                # fence list full: same RETRY contract as a full WQ, so the
                # Device layer applies bounded backoff / QueueFull here too
                return Status.RETRY, CompletionRecord(
                    desc_id=desc.desc_id, status=Status.RETRY, op=op_name(desc)
                )
            rec = CompletionRecord(desc_id=desc.desc_id, status=Status.PENDING,
                                   op=op_name(desc), submit_point=self._submit_point())
            self.records[desc.desc_id] = rec
            self._deferred.append((desc, group, wq_idx, producer, deps, rec))
            self._count_submitted(1, fused=False)
            self.kick()
            return Status.PENDING, rec
        status = self.wq(group, wq_idx).submit(desc, producer=producer)
        rec = CompletionRecord(desc_id=desc.desc_id, status=status, op=op_name(desc))
        if status != Status.RETRY:
            rec.submit_point = self._submit_point()
            self.records[desc.desc_id] = rec
            self._count_submitted(1, fused=False)
        self.kick()
        return status, rec

    def submit_many(self, descs: Sequence[Submittable],
                    group: Optional[int] = None,
                    wq: Union[int, str, None] = None,
                    producer: Optional[str] = None,
                    after: Optional[Sequence[Any]] = None,
                    priority: Optional[int] = None,
                    records: Optional[Sequence[CompletionRecord]] = None,
                    ) -> List[Tuple[Status, CompletionRecord]]:
        """Fused-doorbell submission: enqueue ``descs`` with ONE WQ lock
        acquisition and ONE arbiter kick (the batched MOVDIR64B/ENQCMD
        analogue).  The whole burst shares one ``after`` fence list (DSA
        batch-fence semantics) and one submit point, and is all-or-nothing:
        on a full WQ the single returned entry is ``(RETRY, rec)`` and
        nothing was enqueued, so the Device layer can back off and resubmit
        the burst as a unit.

        ``records`` lets a submit ring pass in pre-created
        CompletionRecords whose Futures are already in callers' hands."""
        descs = list(descs)
        if not descs:
            return []
        group, wq_idx = self.resolve_wq(group, wq, priority)
        after = list(after or ())
        recs = list(records) if records is not None else [None] * len(descs)

        def bind(rec, desc, status, ready):
            if rec is None:
                rec = CompletionRecord(desc_id=desc.desc_id, status=status,
                                       op=op_name(desc))
            else:
                rec.status = status
                if rec.op is None:
                    rec.op = op_name(desc)
            rec.submit_point = ready
            return rec

        out: List[Tuple[Status, CompletionRecord]] = []
        failed = next((d for d in after
                       if d.is_done() and d.status in (Status.ERROR, Status.OVERFLOW)), None)
        if failed is not None:
            # a torn fence fails the whole batch (nothing may launch)
            for desc, rec in zip(descs, recs):
                rec = bind(rec, desc, Status.ERROR, None)
                rec.error = f"dependency failed: {failed.status.name}"
                self.records[desc.desc_id] = rec
                out.append((Status.ERROR, rec))
            self._count_submitted(len(descs), fused=True)
            for _, rec in out:
                self._notify(rec)
            return out
        deps = [d for d in after if not d.is_done()]
        if deps:
            if len(self._deferred) + len(descs) > self.max_deferred:
                return [(Status.RETRY, CompletionRecord(
                    desc_id=descs[0].desc_id, status=Status.RETRY,
                    op=op_name(descs[0])))]
            ready = self._submit_point()
            for desc, rec in zip(descs, recs):
                rec = bind(rec, desc, Status.PENDING, ready)
                self.records[desc.desc_id] = rec
                # members park individually but keep their fused_n stamp, so
                # the amortized doorbell charge survives the fence hold
                self._deferred.append((desc, group, wq_idx, producer,
                                       list(deps), rec))
                out.append((Status.PENDING, rec))
            self._count_submitted(len(descs), fused=True)
            self.kick()
            return out
        status = self.wq(group, wq_idx).submit_many(descs, producer=producer)
        if status == Status.RETRY:
            return [(Status.RETRY, CompletionRecord(
                desc_id=descs[0].desc_id, status=Status.RETRY,
                op=op_name(descs[0])))]
        ready = self._submit_point()
        for desc, rec in zip(descs, recs):
            rec = bind(rec, desc, Status.PENDING, ready)
            self.records[desc.desc_id] = rec
            out.append((Status.PENDING, rec))
        self._count_submitted(len(descs), fused=True)
        self.kick()
        return out

    # ------------------------------------------------------------------ dispatch
    def _pump_deferred(self):
        """Release deferred descriptors whose dependency fences have retired.
        A failed dependency fails the dependent (no silent launch on a torn
        fence); a full WQ keeps the entry deferred for the next kick."""
        still: List[Tuple[Submittable, int, int, Optional[str], List[Any], CompletionRecord]] = []
        for desc, group, wq, producer, deps, rec in self._deferred:
            done = [d for d in deps if d.is_done()]
            failed = next((d for d in done
                           if d.status in (Status.ERROR, Status.OVERFLOW)), None)
            if failed is not None:
                rec.status = Status.ERROR
                rec.error = f"dependency failed: {failed.status.name}"
                self._notify(rec)
                continue
            remaining = [d for d in deps if not d.is_done()]
            if remaining:
                still.append((desc, group, wq, producer, remaining, rec))
                continue
            # each deferred entry targets its own (group, wq): there is no
            # homogeneous burst to fuse here
            status = self.wq(group, wq).submit(desc, producer=producer)  # dsalint: disable=DSA106
            if status == Status.RETRY:
                still.append((desc, group, wq, producer, [], rec))
        self._deferred = still

    def kick(self):
        """Group arbiters: release retired fences, then move descriptors from
        WQs onto PE slots.  Retirement scans only the in-flight list and
        dispatch pops recycled slot objects off the free ring, so a kick
        costs O(in-flight + dispatched): an idle or fully-busy engine pays
        nothing per spare slot."""
        if self._deferred:
            self._pump_deferred()
        for g in self.config.groups:
            active = self._active[g.name]
            free = self._free[g.name]
            if active:
                still = []
                for s in active:
                    if self._retire(s):
                        free.append(s)
                    else:
                        still.append(s)
                active[:] = still
            while free:
                picked = self._arbitrate(g)
                if picked is None:
                    break
                desc, src_wq = picked
                slot = free.pop()
                self._launch(slot, desc, src_wq)
                active.append(slot)

    def _arbitrate(self, g: GroupConfig) -> Optional[Tuple[Submittable, WorkQueue]]:
        """Priority-weighted deficit draining (paper Fig. 9 arbiter).

        Each round every backlogged WQ earns credit equal to its priority
        (floor 1); the richest WQ is drained and its credit resets.  A
        priority-15 WQ therefore gets ~15 grants for each grant a
        priority-1 WQ gets, and no backlogged WQ starves: its credit grows
        every round until it wins.  Occupancy breaks ties so fuller WQs
        drain first at equal priority."""
        nonempty = [w for w in g.wqs if len(w)]
        if not nonempty:
            return None
        credits = self._credit[g.name]
        for w in nonempty:
            credits[w.name] += max(w.priority, 1)
        w = max(nonempty, key=lambda w: (credits[w.name], w.occupancy))
        credits[w.name] = 0.0
        desc = w.pop()
        if desc is None:
            return None
        return desc, w

    # ------------------------------------------------------------------ execution
    def _launch(self, slot: _PESlot, desc: Submittable, src_wq: Optional[WorkQueue] = None):
        # descriptors may be enqueued on a WQ directly (raw portal writes);
        # materialize their completion record lazily
        rec = self.records.setdefault(
            desc.desc_id, CompletionRecord(desc_id=desc.desc_id, op=op_name(desc))
        )
        if rec.op is None:
            rec.op = op_name(desc)
        rec.status = Status.RUNNING
        sn, dn, hops = self._locality(desc)
        rec.engine_node = self.node_id
        rec.src_node = sn
        rec.dst_node = dn
        rec.link_hops = hops
        dst_tier = "hbm"
        enqcmd_s = 0.0
        if src_wq is not None:
            rec.wq = src_wq.name
            rec.queue_delay_us = src_wq.last_queue_delay_us
            rec.steering = src_wq.traffic_class
            if src_wq.traffic_class == "to_cache":
                dst_tier = "vmem"
            if src_wq.mode == "shared":
                # fused-doorbell amortization (paper Fig. 3 / G1): a burst
                # of N descriptors submitted through one doorbell pays one
                # non-posted ENQCMD round trip total, i.e. 1/N each
                fused_n = max(int(getattr(desc, "fused_n", 1) or 1), 1)
                enqcmd_s = self.model.enqcmd_overhead_s / fused_n
        point = rec.submit_point
        rec.submit_point = None
        if point is None:
            point = self._submit_point()  # raw portal write: order after now
        slot.record = rec
        slot.desc = desc
        slot.t0 = time.perf_counter()
        slot.event = None

        def work(desc=desc, dst_tier=dst_tier, enqcmd_s=enqcmd_s,
                 stream=slot.stream, point=point):
            # runs on a PE worker thread: the launch happens off the
            # submitting thread, on the slot's own stream, after the
            # submitter's stream reached the submit point
            if stream is None:
                outputs, nbytes, modeled = self._execute(desc, dst_tier)
                return outputs, nbytes, (modeled + enqcmd_s) * 1e6, None
            submit_stream, ready = point
            with torch.cuda.stream(stream):
                stream.wait_event(ready)
                outputs, nbytes, modeled = self._execute(desc, dst_tier)
                for t in _tensor_leaves(outputs):
                    t.record_stream(submit_stream)
                done = torch.cuda.Event()
                done.record(stream)
            return outputs, nbytes, (modeled + enqcmd_s) * 1e6, done

        slot.work = _pe_pool().submit(work)

    def _execute(self, desc: Submittable, dst_tier: str):
        if isinstance(desc, BatchDescriptor):
            return self._execute_batch(desc, dst_tier=dst_tier)
        return self._execute_one(desc, dst_tier=dst_tier)

    def _locality(self, desc) -> Tuple[int, int, int]:
        """Resolve a submittable's (src_node, dst_node, link_hops) relative
        to this engine: an unstamped operand is wherever the engine runs."""
        sn = getattr(desc, "src_node", None)
        dn = getattr(desc, "dst_node", None)
        sn = self.node_id if sn is None else sn
        dn = self.node_id if dn is None else dn
        hops = int(sn != self.node_id) + int(dn != self.node_id)
        return sn, dn, hops

    def _model_kw(self, kw: dict, dst_tier: str, hops: int) -> dict:
        """Locality-aware op_time defaults: node tier table + link charge."""
        kw.setdefault("dst_tier", dst_tier)
        if self._tiers is not None:
            kw.setdefault("tiers", self._tiers)
        if hops and self.link is not None:
            kw.setdefault("link", self.link)
            kw.setdefault("link_hops", hops)
        return kw

    def _check_operands(self, d: WorkDescriptor) -> None:
        for name in ("src", "dst_pool"):
            t = getattr(d, name)
            if isinstance(t, torch.Tensor) and t.device.type != self.device.type:
                raise ValueError(f"{d.op.value}: operand {name!r} is on {t.device}, "
                                 f"engine {self.name} runs on {self.device}")

    def _execute_one(self, d: WorkDescriptor, dst_tier: str = "hbm"):
        m = self.model
        nbytes = d.nbytes
        # per-descriptor TO_CACHE hints steer like a to_cache WQ (G3)
        if d.cache_hint == CacheHint.TO_CACHE:
            dst_tier = "vmem"
        _, _, hops = self._locality(d)

        def t_op(nb, **kw):
            return m.op_time(nb, **self._model_kw(kw, dst_tier, hops))

        if d.op in UNPORTED_OPS:
            raise NotImplementedError(
                f"op {d.op.value!r} is not ported to repro_torch yet "
                f"(ported: memcpy, crc32, copy_crc, batch_copy)")
        self._check_operands(d)
        if d.op == OpType.MEMCPY:
            out = ops.memcpy(d.src)
            t = t_op(nbytes)
        elif d.op == OpType.CRC32:
            out = ops.crc32(d.src)
            t = t_op(nbytes, read_factor=0.5)
        elif d.op == OpType.BATCH_COPY:
            out = ops.batch_copy(d.src, d.dst_pool, d.src_idx, d.dst_idx)
            t = t_op(nbytes, batch_size=int(d.src_idx.shape[0]))
        elif d.op == OpType.COPY_CRC:
            # fused memcpy+CRC32: one launch, one read pass feeding both the
            # write stream and the checksum, against two launches and two
            # read passes (memcpy at 1.0 + crc32 at 0.5) unfused
            out = ops.copy_crc(d.src)
            t = t_op(nbytes)
        else:
            raise ValueError(f"unsupported op {d.op}")
        return out, nbytes, t

    def _execute_batch(self, b: BatchDescriptor, dst_tier: str = "hbm"):
        descs = list(b.descriptors)
        # F2 fusion: homogeneous same-shape copies -> ONE batch_copy launch.
        # Fuse only when per-descriptor flags agree: a mixed cache-hint batch
        # or an explicit destination pool would be silently dropped by the
        # fused kernel (it writes a fresh zeroed pool), so those fall back to
        # the unfused per-descriptor path.
        if (
            len(descs) > 1
            and all(d.op == OpType.MEMCPY for d in descs)
            and all(d.dst_pool is None for d in descs)
            and len({d.cache_hint for d in descs}) == 1
            and len({(tuple(d.src.shape), d.src.dtype) for d in descs}) == 1
        ):
            if descs[0].cache_hint == CacheHint.TO_CACHE:
                dst_tier = "vmem"
            for d in descs:
                self._check_operands(d)
            pool = torch.stack([d.src for d in descs])
            idx = torch.arange(len(descs), dtype=torch.int32, device=pool.device)
            out = ops.batch_copy(pool, torch.zeros_like(pool), idx, idx)
            nbytes = b.nbytes
            _, _, hops = self._locality(b)
            t = self.model.op_time(descs[0].nbytes,
                                   **self._model_kw({"batch_size": len(descs)},
                                                    dst_tier, hops))
            return list(out.unbind(0)), nbytes, t
        outs = []
        nbytes = 0
        t = self.model.launch_overhead_s
        for d in descs:
            o, nb, td = self._execute_one(d, dst_tier=dst_tier)
            outs.append(o)
            nbytes += nb
            t += td - self.model.launch_overhead_s + self.model.submit_overhead_s
        return outs, nbytes, t

    # ------------------------------------------------------------------ completion
    def poll(self, rec: CompletionRecord) -> bool:
        self.kick()
        return rec.is_done()

    def _recycle(self, gname: str, slot: _PESlot) -> bool:
        """Retire one in-flight slot and return it to the free ring (the
        blocking-wait counterpart of kick()'s active-list sweep)."""
        if self._retire(slot):
            self._active[gname].remove(slot)
            self._free[gname].append(slot)
            return True
        return False

    def wait(self, rec: CompletionRecord):
        """UMWAIT analogue: block until the completion record resolves."""
        while not rec.is_done():  # dsalint: disable=DSA103 — this IS the raw wait primitive WaitPolicy builds on
            self.kick()
            if rec.status == Status.RUNNING:
                for gname, active in self._active.items():
                    for s in list(active):
                        if s.record is rec:
                            s.block()
                            self._recycle(gname, s)
        self.kick()
        return rec.result

    def drain(self):
        """Run until WQs, PE slots, AND locally-resolvable fences are empty.
        Deferred descriptors whose dependencies live on another engine are
        left for Device.drain(), which pumps every instance."""
        while (  # dsalint: disable=DSA103 — engine drain is the terminal pump
            any(len(w) for g in self.config.groups for w in g.wqs)
            or any(s.busy for active in self._active.values() for s in active)
            or any(all(d.is_done() for d in deps) for *_, deps, _rec in self._deferred)
        ):
            self.kick()
            for gname, active in self._active.items():
                for s in list(active):
                    if s.busy:
                        s.block()
                        self._recycle(gname, s)
