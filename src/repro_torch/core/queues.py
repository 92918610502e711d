"""Work queues (paper §3.2, §3.4): dedicated (DWQ) vs shared (SWQ) plus the
WQCFG-style provisioning record.

DWQ: single producer, MOVDIR64B-style posted submit — always accepted while
capacity remains, owner-checked.
SWQ: multi-producer, ENQCMD-style non-posted submit — returns RETRY when
full; internal lock models the hardware's atomic enqueue (software needs no
locks, per the paper).  The non-posted round trip costs extra submit time,
which the engine charges into the modeled completion time.

``WQConfig`` mirrors the DSA WQCFG register block the paper sweeps in
Fig. 9: mode, size partition of the instance's 128 WQ entries, priority
(1-15, higher drains first under the group arbiter), and a traffic class
steering completions/destination writes toward LLC (DDIO, Fig. 12) or
memory.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Optional, Sequence, Tuple, Union

from repro_torch.analysis import lockcheck as _lockcheck
from repro_torch.core.descriptor import BatchDescriptor, Status, WorkDescriptor

Submittable = Union[WorkDescriptor, BatchDescriptor]

#: steering targets for a WQ's traffic class (paper Fig. 12 / G3): "to_cache"
#: is the DDIO analogue (completion + destination lines allocated in LLC /
#: the card's L2), "to_memory" writes around the cache.
TRAFFIC_CLASSES = ("to_memory", "to_cache")

PRIORITY_MIN, PRIORITY_MAX = 1, 15


@dataclasses.dataclass(frozen=True)
class WQConfig:
    """One WQ's provisioning record (the WQCFG analogue).

    group      which engine group the WQ belongs to (WQ -> group -> PEs)
    mode       "dedicated" (MOVDIR64B, owner-checked) | "shared" (ENQCMD)
    size       entry partition; the paper's instances split 128 entries
               across enabled WQs
    priority   1-15, higher is drained preferentially by the group arbiter
    traffic_class  completion/destination steering: "to_cache" | "to_memory"
    owner      producer name enforced on dedicated WQs (None = any)
    """

    name: str
    mode: str = "dedicated"
    size: int = 32
    priority: int = 1
    traffic_class: str = "to_memory"
    owner: Optional[str] = None
    group: int = 0

    def __post_init__(self):
        if self.mode not in ("dedicated", "shared"):
            raise ValueError(f"WQConfig.mode must be dedicated|shared, got {self.mode!r}")
        if not PRIORITY_MIN <= self.priority <= PRIORITY_MAX:
            raise ValueError(
                f"WQConfig.priority must be in [{PRIORITY_MIN}, {PRIORITY_MAX}] "
                f"(DSA WQCFG priority field), got {self.priority}"
            )
        if self.size < 1:
            raise ValueError(f"WQConfig.size must be >= 1, got {self.size}")
        if self.traffic_class not in TRAFFIC_CLASSES:
            raise ValueError(
                f"WQConfig.traffic_class must be one of {TRAFFIC_CLASSES}, "
                f"got {self.traffic_class!r}"
            )
        if self.group < 0:
            raise ValueError(f"WQConfig.group must be >= 0, got {self.group}")


class WorkQueue:
    def __init__(self, name: str, mode: str = "dedicated", size: int = 32,
                 priority: int = 0, owner: Optional[str] = None,
                 traffic_class: str = "to_memory"):
        assert mode in ("dedicated", "shared")
        self.name = name
        self.mode = mode
        self.size = size
        self.priority = priority
        self.owner = owner
        self.traffic_class = traffic_class
        self._q: Deque[Tuple[Submittable, float]] = collections.deque()
        self._lock = _lockcheck.checked_lock("wq")
        # monotonic counters — the obs sampler reads deltas of these per
        # tick, so they only ever grow (bytes_submitted tracks descriptor
        # payload accepted into the queue, the WQ-inflow analogue)
        self.stats = {"submitted": 0, "retried": 0, "dispatched": 0,
                      "queue_delay_us": 0.0, "bytes_submitted": 0}
        # queueing delay of the most recent pop(); the engine reads this to
        # stamp the descriptor's CompletionRecord
        self.last_queue_delay_us: float = 0.0

    @classmethod
    def from_config(cls, cfg: WQConfig) -> "WorkQueue":
        return cls(cfg.name, mode=cfg.mode, size=cfg.size, priority=cfg.priority,
                   owner=cfg.owner, traffic_class=cfg.traffic_class)

    def __len__(self) -> int:
        return len(self._q)

    @property
    def occupancy(self) -> float:
        return len(self._q) / self.size

    @property
    def headroom(self) -> int:
        """Free entries — the occupancy probe's admission view: an arrival
        whose class WQ has no headroom is better shed at the door than
        bounced off ENQCMD RETRY after burning backoff."""
        return max(self.size - len(self._q), 0)

    @property
    def mean_queue_delay_us(self) -> float:
        return self.stats["queue_delay_us"] / max(self.stats["dispatched"], 1)

    def submit(self, desc: Submittable, producer: Optional[str] = None) -> Status:
        now = time.perf_counter()
        if self.mode == "dedicated":
            if self.owner is not None and producer is not None and producer != self.owner:
                raise PermissionError(
                    f"DWQ {self.name} owned by {self.owner}; got producer {producer}"
                )
            if len(self._q) >= self.size:
                # a full DWQ is a programming error in DSA (posted write drops)
                self.stats["retried"] += 1
                return Status.RETRY
            self._q.append((desc, now))
            self.stats["submitted"] += 1
            self.stats["bytes_submitted"] += desc.nbytes
            return Status.PENDING
        # shared: atomic non-posted enqueue with RETRY status
        with self._lock:
            if len(self._q) >= self.size:
                self.stats["retried"] += 1
                return Status.RETRY
            self._q.append((desc, now))
            self.stats["submitted"] += 1
            self.stats["bytes_submitted"] += desc.nbytes
            return Status.PENDING

    def submit_many(self, descs: Sequence[Submittable],
                    producer: Optional[str] = None) -> Status:
        """Fused-doorbell enqueue: accept ``descs`` atomically under ONE lock
        acquisition (the single MOVDIR64B/ENQCMD analogue for a batch), or
        RETRY without enqueuing anything when the whole burst doesn't fit —
        all-or-nothing, so a retried burst can be resubmitted as a unit."""
        now = time.perf_counter()
        if self.mode == "dedicated":
            if self.owner is not None and producer is not None and producer != self.owner:
                raise PermissionError(
                    f"DWQ {self.name} owned by {self.owner}; got producer {producer}"
                )
            return self._enqueue_burst(descs, now)
        with self._lock:
            return self._enqueue_burst(descs, now)

    def _enqueue_burst(self, descs: Sequence[Submittable], now: float) -> Status:
        if len(self._q) + len(descs) > self.size:
            self.stats["retried"] += 1
            return Status.RETRY
        for d in descs:
            self._q.append((d, now))
        self.stats["submitted"] += len(descs)
        self.stats["bytes_submitted"] += sum(d.nbytes for d in descs)
        return Status.PENDING

    def pop(self) -> Optional[Submittable]:
        with self._lock:
            if self._q:
                desc, t_enq = self._q.popleft()
                delay_us = (time.perf_counter() - t_enq) * 1e6
                self.last_queue_delay_us = delay_us
                self.stats["dispatched"] += 1
                self.stats["queue_delay_us"] += delay_us
                return desc
            return None
