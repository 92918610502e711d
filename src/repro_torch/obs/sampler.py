"""pcm-accel-style periodic sampler over a ``Device``.

The paper's §5 telemetry (and Intel PCM's pcm-accel tool) works by
sampling accelerator counters at a fixed interval and reporting per-
interval rates — inbound/outbound traffic and request count per DSA
instance — because raw cumulative counters are unusable without periodic
rollup.  ``Sampler`` is that loop for this repo's engine fabric:

  * every tick reads each engine's MONOTONIC counters
    (``StreamEngine.counters``, bumped once per resolved record) and each
    WQ's stats dict, and folds the DELTA since the previous tick into
    bounded ring-buffer time series — O(engines + WQs) per tick, never a
    rescan of completion records;
  * per-engine bandwidth and utilization, per-WQ occupancy / inflow /
    queueing delay, per-NUMA-node local vs cross traffic and link
    occupancy, per-WaitPolicy host-free fraction, and QueueFull/backoff
    pressure are all first-class metrics (docs/observability.md has the
    glossary);
  * ``start()`` runs the tick on a background thread at ``interval_s``
    (registering with ``Device.attach_observer``); ``tick()`` can equally
    be driven by hand with an injected clock — that is how the
    deterministic tests and ``--once`` monitoring run;
  * exporters: ``to_csv()`` / ``to_jsonl()`` (one row per tick, one column
    per metric) and ``summary()`` (p50/p95/max/mean per metric over a
    trailing window).

Reconciliation contract: the sum of a delta series (``engine.*.bytes``,
``engine.*.ops``) equals the corresponding total in
``Telemetry.snapshot()`` taken over the same run — both count exactly the
resolved completion records — as long as the ring buffer has not rotated
(capacity x interval covers the run).  tests/test_obs.py pins this.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.obs.series import Series


class Sampler:
    """Periodic delta sampler over a Device's engines/WQs/nodes/waits."""

    def __init__(self, device: Any, interval_s: float = 0.1,
                 capacity: int = 600,
                 clock: Callable[[], float] = time.perf_counter):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.device = device
        self.interval_s = interval_s
        self.capacity = capacity
        self.clock = clock
        self.series: Dict[str, Series] = {}
        # one dict per tick: {"time_s": t, "dt_s": dt, metric: value, ...}
        self._rows: collections.deque = collections.deque(maxlen=capacity)
        self._columns: List[str] = ["time_s", "dt_s"]  # first-seen order
        # running totals of the delta counters (reconciliation anchor);
        # unlike the ring buffers these never rotate out
        self.totals: Dict[str, Dict[str, float]] = {
            "engines": {}, "nodes": {}, "device": {"ticks": 0},
        }
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # first exception a tick raised on the background thread (e.g. the
        # device was torn down mid-run): the thread stops sampling instead
        # of crashing with a traceback, and stop()/callers can inspect it
        self.error: Optional[BaseException] = None
        # gauges pushed between ticks (serving stages etc.); folded into the
        # next tick's row so exports stay one-row-per-tick
        self._pending_gauges: Dict[str, float] = {}
        self.t0 = self.clock()
        self._last_t = self.t0
        self._prev = self._read_counters()

    # ------------------------------------------------------------------ raw reads
    def _read_counters(self) -> dict:
        """One coherent pass over every monotonic counter the tick deltas
        against: engine counters, per-WQ stats, wait stats, policy stats."""
        prev: dict = {"engines": {}, "wqs": {}, "wait": {}, "policy": {}}
        for e in self.device.engines:
            prev["engines"][e.name] = e.counters_snapshot()
            for g in e.config.groups:
                for w in g.wqs:
                    prev["wqs"][(e.name, w.name)] = dict(w.stats)
        for name, ws in list(getattr(self.device, "wait_stats", {}).items()):
            prev["wait"][name] = {"busy_s": ws.busy_s, "free_s": ws.free_s,
                                  "wakes": ws.wakes, "irqs": ws.irqs,
                                  "completions": ws.completions}
        ps = getattr(self.device, "policy_stats", None)
        if ps is not None:
            prev["policy"] = {"backoff_retries": ps["backoff_retries"],
                              "queue_full": ps["queue_full"],
                              "desclint_warnings":
                                  ps.get("desclint_warnings", 0)}
        tracer = getattr(self.device, "tracer", None)
        if tracer is not None:
            prev["trace"] = tracer.counters_snapshot()
        return prev

    # ------------------------------------------------------------------ recording
    def _series(self, name: str, unit: str = "") -> Series:
        s = self.series.get(name)
        if s is None:
            s = self.series[name] = Series(name, capacity=self.capacity,
                                           unit=unit)
        return s

    def _record(self, row: dict, name: str, value: float, t: float,
                unit: str = "") -> None:
        self._series(name, unit).append(t, value)
        row[name] = float(value)
        if name not in self._columns:
            self._columns.append(name)

    def gauge(self, name: str, value: float,
              now: Optional[float] = None) -> None:
        """Record an externally-produced gauge (e.g. the serving pipeline's
        per-stage occupancy) into its own bounded series.  Gauges land in
        the NEXT tick's row so exports stay one-row-per-tick."""
        t = self.clock() if now is None else now
        with self._lock:
            self._series(name).append(t, value)
            self._pending_gauges[name] = float(value)

    # ------------------------------------------------------------------ the tick
    def tick(self, now: Optional[float] = None) -> dict:
        """Take one sample: delta every monotonic counter against the
        previous tick, append per-metric series, and return this tick's
        row.  ``now`` injects a deterministic clock for tests."""
        with self._lock:
            t = self.clock() if now is None else now
            dt = max(t - self._last_t, 1e-9)
            cur = self._read_counters()
            row: dict = {"time_s": t - self.t0, "dt_s": dt}

            node_delta: Dict[int, Dict[str, float]] = {}
            for e in self.device.engines:
                name = e.name
                c = cur["engines"][name]
                p = self._prev["engines"].get(name, {})
                d = {k: c[k] - p.get(k, 0) for k in c}
                self._record(row, f"engine.{name}.bytes", d["bytes"], t, "B")
                self._record(row, f"engine.{name}.ops", d["completed"], t)
                self._record(row, f"engine.{name}.errors", d["errors"], t)
                self._record(row, f"engine.{name}.gbps",
                             d["bytes"] / dt / 1e9, t, "GB/s")
                # submission-side rates: accepted submits this tick and the
                # fraction that arrived through a fused doorbell
                # (submit_many / submit ring) — the batch-amortization
                # health gauge for the pcm_repro SUB/s + FUSED% columns
                subs = d.get("submitted", 0)
                self._record(row, f"engine.{name}.submits", subs, t)
                self._record(row, f"engine.{name}.submits_per_s",
                             subs / dt, t, "/s")
                self._record(row, f"engine.{name}.fused_frac",
                             d.get("fused_descs", 0) / max(subs, 1), t)
                # modeled busy-time over wall interval: the engine-side
                # utilization estimate (can exceed 1 when PEs run parallel)
                self._record(row, f"engine.{name}.util",
                             d["modeled_us"] * 1e-6 / dt, t)
                tot = self.totals["engines"].setdefault(
                    name, {"bytes": 0.0, "ops": 0.0, "errors": 0.0})
                tot["bytes"] += d["bytes"]
                tot["ops"] += d["completed"]
                tot["errors"] += d["errors"]

                occs, depths = [], []
                retried = dispatched = delay_us = inflow = 0.0
                for g in e.config.groups:
                    for w in g.wqs:
                        ws = cur["wqs"][(name, w.name)]
                        wp = self._prev["wqs"].get((name, w.name), {})
                        wd = {k: ws[k] - wp.get(k, 0) for k in ws}
                        occs.append(w.occupancy)
                        depths.append(len(w))
                        retried += wd["retried"]
                        dispatched += wd["dispatched"]
                        delay_us += wd["queue_delay_us"]
                        inflow += wd["bytes_submitted"]
                        self._record(row, f"wq.{name}.{w.name}.occupancy",
                                     w.occupancy, t)
                        self._record(row, f"wq.{name}.{w.name}.inflow_gbps",
                                     wd["bytes_submitted"] / dt / 1e9, t,
                                     "GB/s")
                        self._record(
                            row, f"wq.{name}.{w.name}.queue_delay_us",
                            wd["queue_delay_us"] / max(wd["dispatched"], 1),
                            t, "us")
                self._record(row, f"engine.{name}.wq_occupancy",
                             sum(occs) / max(len(occs), 1), t)
                self._record(row, f"engine.{name}.wq_depth", sum(depths), t)
                self._record(row, f"engine.{name}.retries", retried, t)
                self._record(row, f"engine.{name}.queue_delay_us",
                             delay_us / max(dispatched, 1), t, "us")

                nid = getattr(e, "node_id", 0)
                nd = node_delta.setdefault(
                    nid, {"local_bytes": 0.0, "cross_bytes": 0.0,
                          "link_bytes": 0.0, "local_ops": 0.0,
                          "cross_ops": 0.0})
                for k in nd:
                    nd[k] += d[k]

            topo = getattr(self.device, "topology", None)
            link_bw = (topo.link.bw if topo is not None
                       and getattr(topo, "n_nodes", 1) > 1 else None)
            for nid in sorted(node_delta):
                nd = node_delta[nid]
                self._record(row, f"node.{nid}.local_gbps",
                             nd["local_bytes"] / dt / 1e9, t, "GB/s")
                self._record(row, f"node.{nid}.cross_gbps",
                             nd["cross_bytes"] / dt / 1e9, t, "GB/s")
                self._record(row, f"node.{nid}.link_occupancy",
                             nd["link_bytes"] / link_bw / dt if link_bw
                             else 0.0, t)
                tot = self.totals["nodes"].setdefault(
                    nid, {k: 0.0 for k in nd})
                for k in nd:
                    tot[k] += nd[k]

            for pname, ws in cur["wait"].items():
                wp = self._prev["wait"].get(
                    pname, {k: 0 for k in ("busy_s", "free_s", "wakes",
                                           "irqs", "completions")})
                busy = ws["busy_s"] - wp["busy_s"]
                free = ws["free_s"] - wp["free_s"]
                if busy + free > 0:
                    self._record(row,
                                 f"wait.{pname}.host_free_frac",
                                 free / (busy + free), t)
                self._record(row, f"wait.{pname}.wakes",
                             ws["wakes"] - wp["wakes"], t)
                self._record(row, f"wait.{pname}.irqs",
                             ws["irqs"] - wp["irqs"], t)

            if cur["policy"]:
                pp = self._prev.get("policy") or {"backoff_retries": 0,
                                                  "queue_full": 0}
                self._record(row, "device.backoff_retries",
                             cur["policy"]["backoff_retries"]
                             - pp["backoff_retries"], t)
                self._record(row, "device.queue_full",
                             cur["policy"]["queue_full"]
                             - pp["queue_full"], t)
                self._record(row, "device.desclint_warnings",
                             cur["policy"].get("desclint_warnings", 0)
                             - pp.get("desclint_warnings", 0), t)

            tr_cur = cur.get("trace")
            if tr_cur:
                tr_prev = self._prev.get("trace", {})
                self._record(row, "trace.sampled",
                             tr_cur["sampled"] - tr_prev.get("sampled", 0), t)
                # live phase occupancy: seconds of each lifecycle phase
                # completed per wall second this tick (the pcm_repro
                # phases line; >1 means parallel descriptors in flight)
                for key, val in tr_cur.items():
                    if not (key.startswith("phase.") and key.endswith("_s")):
                        continue
                    phase = key[len("phase."):-len("_s")]
                    self._record(row, f"trace.phase.{phase}.occupancy",
                                 (val - tr_prev.get(key, 0.0)) / dt, t)

            for gname, gval in self._pending_gauges.items():
                row[gname] = gval
                if gname not in self._columns:
                    self._columns.append(gname)
            self._pending_gauges = {}

            self._rows.append(row)
            self.totals["device"]["ticks"] += 1
            self._prev = cur
            self._last_t = t
            return row

    # ------------------------------------------------------------------ lifecycle
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "Sampler":
        """Start the background sampling thread (one tick per interval)
        and register with the device.  Idempotent while running."""
        if self.running:
            return self
        self._stop.clear()
        attach = getattr(self.device, "attach_observer", None)
        if attach is not None:
            attach(self)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="obs-sampler")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — device torn down mid-tick
                # racing a shutdown must not crash the daemon thread with a
                # traceback; record the failure and stop sampling
                self.error = e
                self._stop.set()
                return

    def stop(self, final_tick: bool = True) -> "Sampler":
        """Stop the background thread (taking one last sample so the tail
        of the run is not lost) and detach from the device.  Safe to call
        when the device has already been torn down: a failing final tick
        is recorded on ``self.error`` instead of raising."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if final_tick:
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — shutdown must be clean
                self.error = e
        detach = getattr(self.device, "detach_observer", None)
        if detach is not None:
            try:
                detach(self)
            except Exception as e:  # noqa: BLE001
                self.error = self.error or e
        return self

    def __enter__(self) -> "Sampler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------ export
    def rows(self) -> List[dict]:
        with self._lock:
            return [dict(r) for r in self._rows]

    def columns(self) -> List[str]:
        with self._lock:
            return list(self._columns)

    def to_csv(self, path: Optional[str] = None) -> str:
        from repro_torch.obs.export import to_csv

        return to_csv(self, path)

    def to_jsonl(self, path: Optional[str] = None) -> str:
        from repro_torch.obs.export import to_jsonl

        return to_jsonl(self, path)

    def summary(self, window_s: Optional[float] = None) -> Dict[str, dict]:
        """Windowed rollup per metric: {metric: {n, p50, p95, max, mean,
        last}} over the trailing ``window_s`` seconds (all history when
        None, bounded by the ring capacity)."""
        with self._lock:
            return {name: s.summary(window_s)
                    for name, s in sorted(self.series.items())}
