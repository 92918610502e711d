"""Per-record counter accumulation — the "counters" half of telemetry.

The old ``Telemetry`` interleaved two jobs: walking engine completion
records into per-op / per-WQ / per-node counters, and rolling those
counters up into the PCM-style snapshot/report.  This module owns the
first job so both the post-hoc ``Telemetry`` rollup (core/telemetry.py)
and a live sampler (``obs/``, a later part of the port) can share one
accumulation path.

``CounterStore.drain_engine`` also fixes the old unbounded-growth leak:
a completion record is counted exactly once and then PRUNED from the
engine's ``records`` dict (and its id retired from the seen-set), so a
long-running serving loop no longer grows memory linearly with the
number of submitted descriptors.  Pass ``prune=False`` to keep records
alive (e.g. when several independent consumers walk the same engines);
the seen-set is then intersected with the live record ids each drain so
it stays bounded by the records dict itself.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Iterable, Set


@dataclasses.dataclass
class OpCounter:
    count: int = 0
    bytes: int = 0
    modeled_us: float = 0.0
    wall_us: float = 0.0


def size_bucket(nbytes: int) -> str:
    if nbytes < 4096:
        return "<4KB"
    if nbytes < 65536:
        return "4-64KB"
    if nbytes < 1 << 20:
        return "64KB-1MB"
    return ">=1MB"


def new_node_bucket() -> dict:
    return {"local_ops": 0, "local_bytes": 0,
            "cross_ops": 0, "cross_bytes": 0, "link_bytes": 0}


class CounterStore:
    """Accumulates completion records into per-op x size-class, per-WQ, and
    per-NUMA-node counters.  One store per telemetry consumer; engines are
    walked via ``drain_engine`` (records counted once, pruned by default)."""

    def __init__(self, engine_names: Iterable[str], prune: bool = True):
        self.prune = prune
        self.ops: Dict[str, Dict[str, OpCounter]] = {
            name: defaultdict(OpCounter) for name in engine_names
        }
        self.per_wq_ops: Dict[str, Dict[str, OpCounter]] = {
            name: defaultdict(OpCounter) for name in self.ops
        }
        self.node_traffic: Dict[int, dict] = defaultdict(new_node_bucket)
        # ids counted but intentionally left in engine.records (prune=False);
        # re-intersected with the live ids every drain so it cannot outgrow
        # the records dict
        self._seen: Dict[str, Set[int]] = {name: set() for name in self.ops}

    def observe(self, engine_name: str, node_id: int, rec) -> None:
        """Count one resolved completion record (exactly-once is the
        caller's contract — ``drain_engine`` enforces it)."""
        key = f"{rec.op or '?'}/{size_bucket(rec.bytes_processed)}"
        c = self.ops[engine_name][key]
        c.count += 1
        c.bytes += rec.bytes_processed
        c.modeled_us += rec.modeled_time_us
        c.wall_us += rec.wall_time_us
        nt = self.node_traffic[node_id]
        if rec.link_hops > 0:
            nt["cross_ops"] += 1
            nt["cross_bytes"] += rec.bytes_processed
            nt["link_bytes"] += rec.bytes_processed * rec.link_hops
        else:
            nt["local_ops"] += 1
            nt["local_bytes"] += rec.bytes_processed
        if rec.wq is not None:
            wc = self.per_wq_ops[engine_name][rec.wq]
            wc.count += 1
            wc.bytes += rec.bytes_processed
            wc.modeled_us += rec.modeled_time_us
            wc.wall_us += rec.wall_time_us

    def drain_engine(self, engine) -> int:
        """Walk one engine's completion records, counting each resolved
        record once.  Returns the number of records newly counted.

        prune=True (default): counted records are popped from
        ``engine.records`` and never re-enter the seen-set — O(resolved)
        work, O(in-flight) memory.
        prune=False: records stay; the seen-set marks them counted and is
        clipped to the ids still present."""
        name = engine.name
        node_id = getattr(engine, "node_id", 0)
        seen = self._seen.setdefault(name, set())
        self.ops.setdefault(name, defaultdict(OpCounter))
        self.per_wq_ops.setdefault(name, defaultdict(OpCounter))
        counted = 0
        live: Set[int] = set()
        for desc_id, rec in list(engine.records.items()):
            if not rec.is_done():
                live.add(desc_id)
                continue
            if desc_id in seen:
                live.add(desc_id)
                continue
            self.observe(name, node_id, rec)
            counted += 1
            if self.prune:
                engine.records.pop(desc_id, None)
            else:
                seen.add(desc_id)
                live.add(desc_id)
        if seen:
            seen &= live  # retire ids whose records are gone
        return counted

    def totals(self) -> dict:
        """Cross-engine totals (ops/bytes) — the reconciliation anchor the
        obs sampler tests compare their delta sums against."""
        count = sum(c.count for per in self.ops.values() for c in per.values())
        nbytes = sum(c.bytes for per in self.ops.values() for c in per.values())
        return {"count": count, "bytes": nbytes}
