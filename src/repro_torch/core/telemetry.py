"""Engine telemetry — the paper's PCM counterpart (§5: "DSA performance
telemetry functionalities are provided by the PCM library ... inbound-
outbound traffic and request count on each DSA instance").

This module is the ROLLUP half: ``snapshot()`` aggregates counters into the
per-engine / per-WQ / per-NUMA-node dict the benchmarks read, and
``report()`` renders the PCM-style table.  The per-record accumulation
lives in core/counters.py (``CounterStore``), which a live sampler can
share (``obs/``, a later part of the port).

Counters per engine instance: per-op x size-class counts/bytes/latency, WQ
occupancy samples, retry totals.  When attached to a ``Device``, the
snapshot also attributes submissions per policy decision (which instance
the SubmitPolicy routed each op to, plus backoff pressure) and reports the
completion-wait accounting per WaitPolicy — host-busy vs host-free cycles,
wakes, IRQs, and the measured host-free fraction (the paper's Fig. 11
"umwait fraction", measured instead of assumed).

Memory: ``sample()`` consumes completion records — each resolved record is
counted once and pruned from the engine's ``records`` dict, so telemetry
over a long-running serving loop stays O(in-flight), not O(ops ever
submitted).  Attach ONE record-walking consumer per engine set; a second
record-walker would miss records the first one pruned: build it with
``prune=False`` if you really need two.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Union

from repro_torch.core.counters import CounterStore, OpCounter, size_bucket
from repro_torch.core.device import Device
from repro_torch.core.engine import StreamEngine

__all__ = ["Telemetry", "OpCounter", "size_bucket"]


class Telemetry:
    """Attach to a Device (preferred) or a list of engines; samples are
    taken on poll()/sample()."""

    def __init__(self, engines: Union["Device", List[StreamEngine], None] = None,
                 device: Optional["Device"] = None, prune: bool = True):
        if device is None and engines is not None and hasattr(engines, "engines"):
            device = engines  # Telemetry(device) convenience form
        if device is not None:
            self.device = device
            self.engines = list(device.engines)
        else:
            self.device = None
            self.engines = list(engines or [])
        self.store = CounterStore((e.name for e in self.engines), prune=prune)
        self.wq_samples = {e.name: [] for e in self.engines}
        # per-WQ rollups: occupancy samples and completion latency, keyed by
        # WQ name within each engine (Fig. 9 queueing-delay attribution)
        self.per_wq_samples = {
            e.name: {w.name: [] for g in e.config.groups for w in g.wqs}
            for e in self.engines
        }
        self.t0 = time.perf_counter()

    # counter views (same live dicts the store accumulates into)
    @property
    def ops(self):
        return self.store.ops

    @property
    def per_wq_ops(self):
        return self.store.per_wq_ops

    @property
    def node_traffic(self):
        return self.store.node_traffic

    def sample(self):
        for e in self.engines:
            occ = [w.occupancy for g in e.config.groups for w in g.wqs]
            self.wq_samples[e.name].append(sum(occ) / max(len(occ), 1))
            for g in e.config.groups:
                for w in g.wqs:
                    self.per_wq_samples[e.name][w.name].append(w.occupancy)
            self.store.drain_engine(e)

    def snapshot(self) -> dict:
        self.sample()
        out = {"elapsed_s": time.perf_counter() - self.t0, "engines": {}}
        for e in self.engines:
            retries = sum(w.stats["retried"] for g in e.config.groups for w in g.wqs)
            submitted = sum(w.stats["submitted"] for g in e.config.groups for w in g.wqs)
            samples = self.wq_samples[e.name]
            wq_rollup = {}
            for g in e.config.groups:
                for w in g.wqs:
                    occ = self.per_wq_samples[e.name][w.name]
                    comp = self.store.per_wq_ops[e.name].get(w.name, OpCounter())
                    wq_rollup[w.name] = {
                        "mode": w.mode,
                        "priority": w.priority,
                        "traffic_class": w.traffic_class,
                        "size": w.size,
                        "submitted": w.stats["submitted"],
                        "retried": w.stats["retried"],
                        "dispatched": w.stats["dispatched"],
                        "mean_occupancy": sum(occ) / max(len(occ), 1),
                        "mean_queue_delay_us": w.mean_queue_delay_us,
                        "completed": comp.count,
                        "bytes": comp.bytes,
                        "modeled_us": comp.modeled_us,
                    }
            out["engines"][e.name] = {
                "submitted": submitted,
                "retries": retries,
                "mean_wq_occupancy": sum(samples) / max(len(samples), 1),
                "wqs": wq_rollup,
                "ops": {
                    k: dataclasses.asdict(v)
                    for k, v in sorted(self.store.ops[e.name].items())
                },
            }
        # per-node rollup: engines grouped by NUMA node, local vs cross-node
        # traffic, and the modeled inter-node link occupancy (link-seconds of
        # cross traffic over wall time).  Sums across nodes equal the device
        # totals — every record lands in exactly one node bucket.
        topo = getattr(self.device, "topology", None) if self.device else None
        if topo is None:
            for e in self.engines:
                topo = getattr(e, "topology", None)
                if topo is not None:
                    break
        link_bw = topo.link.bw if topo is not None and topo.n_nodes > 1 else None
        elapsed = max(out["elapsed_s"], 1e-12)
        out["nodes"] = {}
        for nid in sorted({getattr(e, "node_id", 0) for e in self.engines}):
            nt = dict(self.store.node_traffic.get(nid) or
                      {"local_ops": 0, "local_bytes": 0, "cross_ops": 0,
                       "cross_bytes": 0, "link_bytes": 0})
            nt["engines"] = [e.name for e in self.engines
                             if getattr(e, "node_id", 0) == nid]
            nt["link_occupancy"] = (
                nt["link_bytes"] / link_bw / elapsed if link_bw else 0.0
            )
            out["nodes"][nid] = nt
        if self.device is not None:
            ps = self.device.policy_stats
            out["policy"] = {
                "name": ps["policy"],
                "decisions": dict(ps["decisions"]),
                "decisions_by_op": dict(ps["decisions_by_op"]),
                "backoff_retries": ps["backoff_retries"],
                "queue_full": ps["queue_full"],
            }
            # per-WaitPolicy host-cycle accounting (Fig. 11, measured);
            # copy first: waiters on other threads may add policy buckets
            out["wait"] = {
                name: ws.as_dict()
                for name, ws in sorted(dict(self.device.wait_stats).items())
            }
        return out

    def report(self) -> str:
        snap = self.snapshot()
        lines = [f"engine telemetry ({snap['elapsed_s']:.2f}s)"]
        for name, e in snap["engines"].items():
            lines.append(
                f"  {name}: submitted={e['submitted']} retries={e['retries']} "
                f"wq_occ={e['mean_wq_occupancy']:.2f}"
            )
            for wname, w in e["wqs"].items():
                lines.append(
                    f"    wq {wname:<10s} [{w['mode'][:4]} pri={w['priority']:<2d} "
                    f"{w['traffic_class']}]: disp={w['dispatched']:<5d} "
                    f"retry={w['retried']:<4d} occ={w['mean_occupancy']:.2f} "
                    f"qdelay={w['mean_queue_delay_us']:.1f}us"
                )
            for key, c in e["ops"].items():
                gbps = c["bytes"] / max(c["modeled_us"] * 1e-6, 1e-12) / 1e9
                lines.append(
                    f"    {key:>20s}: n={c['count']:<5d} bytes={c['bytes']:<12d} "
                    f"modeled={c['modeled_us']:.1f}us ({gbps:.1f}GB/s projected)"
                )
        for nid, n in snap.get("nodes", {}).items():
            if len(snap.get("nodes", {})) == 1 and not n["cross_ops"]:
                continue  # flat single-node device: nothing to attribute
            lines.append(
                f"  node {nid} [{', '.join(n['engines'])}]: "
                f"local={n['local_bytes']}B/{n['local_ops']}ops "
                f"cross={n['cross_bytes']}B/{n['cross_ops']}ops "
                f"link_occ={n['link_occupancy']:.1%}"
            )
        pol = snap.get("policy")
        if pol:
            placed = ", ".join(f"{k}={v}" for k, v in sorted(pol["decisions"].items()))
            lines.append(
                f"  policy {pol['name']}: placements [{placed or 'none'}] "
                f"backoff_retries={pol['backoff_retries']} queue_full={pol['queue_full']}"
            )
        for name, w in snap.get("wait", {}).items():
            lines.append(
                f"  wait {name}: waits={w['waits']} polls={w['polls']} "
                f"wakes={w['wakes']} irqs={w['irqs']} "
                f"busy={w['busy_s']*1e3:.2f}ms free={w['free_s']*1e3:.2f}ms "
                f"host_free={w['host_free_frac']:.1%} "
                f"(modeled wake/irq overhead {w['modeled_overhead_s']*1e6:.1f}us)"
            )
        return "\n".join(lines)
