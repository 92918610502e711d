"""The port's observability subsystem (repro_torch.obs) on
``make_device(device="cpu")``: the counterparts of tests/test_obs.py
(deterministic-clock Sampler ticks, ring-buffer bounds, delta-vs-snapshot
reconciliation, exporters, and the telemetry record pruning the subsystem
rides on), plus cross-package cases: the same numpy data through
``repro.obs`` and ``repro_torch.obs`` gives identical output."""
import csv
import io
import json
import math

import numpy as np
import pytest
import torch

from repro.obs import Series as JSeries
from repro.obs import export as jexport
from repro.obs import percentile as jpercentile
from repro_torch.core import Topology, make_device
from repro_torch.core.telemetry import Telemetry
from repro_torch.obs import Sampler, Series, percentile
from repro_torch.obs import export as texport


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


class FakeClock:
    """Injectable monotonic clock: tests advance it explicitly."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


# ---------------------------------------------------------------- series
def test_percentile_nearest_rank():
    vals = [float(v) for v in range(1, 101)]  # 1..100
    assert percentile(vals, 50) == 50.0
    assert percentile(vals, 95) == 95.0
    assert percentile(vals, 100) == 100.0
    assert percentile([7.0], 50) == 7.0
    with pytest.raises(ValueError):
        percentile([], 50)


def test_series_ring_buffer_bounds():
    s = Series("m", capacity=8)
    for i in range(20):
        s.append(float(i), float(i))
    assert len(s) == 8
    assert s.values == [float(i) for i in range(12, 20)]  # oldest rotated out
    assert s.last() == 19.0
    # trailing window selects by time, not count
    assert [v for _, v in s.window(3.0)] == [16.0, 17.0, 18.0, 19.0]


def test_series_summary_known_values():
    s = Series("m")
    for i, v in enumerate([1.0, 2.0, 3.0, 4.0, 100.0]):
        s.append(float(i), v)
    out = s.summary()
    assert out["n"] == 5
    assert out["p50"] == 3.0
    assert out["max"] == 100.0
    assert out["mean"] == pytest.approx(22.0)
    assert out["last"] == 100.0
    assert Series("empty").summary() == {
        "n": 0, "p50": 0.0, "p95": 0.0, "max": 0.0, "mean": 0.0, "last": 0.0}


# ---------------------------------------------------------------- sampler
def _burst(device, buf, n):
    futs = [device.memcpy_async(buf) for _ in range(n)]
    device.wait_all(futs)
    return futs


def test_sampler_deltas_reconcile_with_snapshot(rng):
    """Acceptance criterion: the summed delta series equal the final
    Telemetry.snapshot() totals — both count the same resolved records."""
    clock = FakeClock()
    d = make_device(device="cpu", n_instances=2)
    tel = Telemetry(d)
    sampler = Sampler(d, clock=clock)
    buf = _f32(rng.normal(size=(256, 128)))  # 128KB
    for _ in range(3):
        _burst(d, buf, 4)
        clock.advance(1.0)
        sampler.tick()
    d.drain()
    clock.advance(1.0)
    sampler.tick()

    snap = tel.snapshot()
    snap_bytes = sum(c["bytes"] for e in snap["engines"].values()
                     for c in e["ops"].values())
    snap_ops = sum(c["count"] for e in snap["engines"].values()
                   for c in e["ops"].values())
    assert snap_ops == 12
    assert snap_bytes == 12 * buf.numel() * 4

    series_bytes = sum(sampler.series[f"engine.{e.name}.bytes"].sum()
                       for e in d.engines)
    series_ops = sum(sampler.series[f"engine.{e.name}.ops"].sum()
                     for e in d.engines)
    assert series_bytes == snap_bytes
    assert series_ops == snap_ops
    # the never-rotating totals agree too
    assert sum(t["bytes"] for t in sampler.totals["engines"].values()) == snap_bytes
    assert sampler.totals["device"]["ticks"] == 4

    # ...and so does the exported CSV, parsed back column by column
    reader = csv.DictReader(io.StringIO(sampler.to_csv()))
    csv_bytes = sum(float(row[f"engine.{e.name}.bytes"] or 0)
                    for row in reader for e in d.engines)
    assert csv_bytes == snap_bytes


def test_sampler_row_ring_bounded(rng):
    clock = FakeClock()
    d = make_device(device="cpu")
    sampler = Sampler(d, capacity=8, clock=clock)
    for _ in range(20):
        clock.advance(0.1)
        sampler.tick()
    assert len(sampler.rows()) == 8
    for s in sampler.series.values():
        assert len(s) <= 8
    # totals still count every tick, including the rotated-out ones
    assert sampler.totals["device"]["ticks"] == 20


def test_sampler_per_node_series_match_rollup(rng):
    """On a 2-node fabric the per-node delta series sum to the same node
    rollup Telemetry reports (local vs cross bytes attribution)."""
    clock = FakeClock()
    topo = Topology.symmetric(2, engines_per_node=1)
    d = make_device(device="cpu", topology=topo, policy="numa_local")
    tel = Telemetry(d)
    sampler = Sampler(d, clock=clock)
    buf = _f32(rng.normal(size=(64, 128)))  # 32KB
    d.register(buf, node=0)
    # local on node 0, then cross: engine on node 1 reads the node-0 buffer
    d.wait_all([d.memcpy_async(buf, node=0) for _ in range(3)])
    d.wait_all([d.memcpy_async(buf, node=1) for _ in range(2)])
    d.drain()
    clock.advance(1.0)
    sampler.tick()

    nodes = tel.snapshot()["nodes"]
    for nid, rollup in nodes.items():
        assert sampler.totals["nodes"][nid]["local_bytes"] == rollup["local_bytes"]
        assert sampler.totals["nodes"][nid]["cross_bytes"] == rollup["cross_bytes"]
        assert sampler.totals["nodes"][nid]["link_bytes"] == rollup["link_bytes"]
    assert nodes[1]["cross_bytes"] == 2 * buf.numel() * 4
    # cross traffic shows up in the per-tick rate series with dt=1s
    assert sampler.series["node.1.cross_gbps"].last() == pytest.approx(
        2 * buf.numel() * 4 / 1e9)
    assert sampler.series["node.1.link_occupancy"].last() > 0


def test_sampler_thread_lifecycle_and_observer_registration(rng):
    d = make_device(device="cpu")
    sampler = Sampler(d, interval_s=0.01)
    assert not sampler.running
    sampler.start()
    assert sampler.running
    assert sampler in d.observers
    buf = _f32(rng.normal(size=(64, 128)))
    _burst(d, buf, 3)
    sampler.stop()
    assert not sampler.running
    assert sampler not in d.observers
    # the final stop() tick guarantees the tail was sampled
    assert sum(t["ops"] for t in sampler.totals["engines"].values()) == 3


def test_device_observe_convenience(rng):
    d = make_device(device="cpu")
    with d.observe(interval_s=0.01) as sampler:
        assert sampler.running
        assert sampler in d.observers
    assert not sampler.running


def test_gauges_fold_into_next_tick(rng):
    clock = FakeClock()
    d = make_device(device="cpu")
    sampler = Sampler(d, clock=clock)
    sampler.gauge("serving.queue_depth", 5)
    sampler.gauge("serving.queue_depth", 7)  # last write wins within a tick
    clock.advance(1.0)
    row = sampler.tick()
    assert row["serving.queue_depth"] == 7.0
    assert "serving.queue_depth" in sampler.columns()
    assert sampler.series["serving.queue_depth"].values == [5.0, 7.0]
    clock.advance(1.0)
    assert "serving.queue_depth" not in sampler.tick()  # not sticky


def test_wait_policy_host_free_fraction_series(rng):
    clock = FakeClock()
    d = make_device(device="cpu", wait_policy="umwait")
    sampler = Sampler(d, clock=clock)
    buf = _f32(rng.normal(size=(512, 128)))
    _burst(d, buf, 4)
    clock.advance(1.0)
    sampler.tick()
    s = sampler.series.get("wait.umwait.host_free_frac")
    assert s is not None and len(s) == 1
    assert 0.0 <= s.last() <= 1.0


# ---------------------------------------------------------------- exporters
def test_csv_and_jsonl_round_trip(rng, tmp_path):
    clock = FakeClock()
    d = make_device(device="cpu")
    sampler = Sampler(d, clock=clock)
    buf = _f32(rng.normal(size=(64, 128)))
    _burst(d, buf, 2)
    clock.advance(0.5)
    sampler.tick()
    clock.advance(0.5)
    sampler.tick()

    csv_path = tmp_path / "obs" / "trace.csv"
    text = sampler.to_csv(str(csv_path))
    assert csv_path.read_text() == text
    rows = list(csv.DictReader(io.StringIO(text)))
    assert len(rows) == 2
    assert rows[0]["dt_s"] == "0.5"
    # wide form: every metric that ever appeared is a column in every row
    assert set(sampler.columns()) <= set(rows[0].keys())

    jsonl_path = tmp_path / "obs" / "trace.jsonl"
    jtext = sampler.to_jsonl(str(jsonl_path))
    objs = [json.loads(line) for line in jtext.splitlines()]
    assert len(objs) == 2
    assert objs[0]["dt_s"] == 0.5
    assert [o["time_s"] for o in objs] == [0.5, 1.0]


def test_summary_windowed(rng):
    clock = FakeClock()
    d = make_device(device="cpu")
    sampler = Sampler(d, clock=clock)
    for _ in range(5):
        clock.advance(1.0)
        sampler.tick()
    summ = sampler.summary()
    assert summ["engine.dsa0.bytes"]["n"] == 5
    # a 2s trailing window keeps t in [3, 5] (inclusive cutoff): 3 ticks
    assert sampler.summary(window_s=2.0)["engine.dsa0.bytes"]["n"] == 3


# ---------------------------------------------------------------- leak fix
def test_telemetry_prunes_completion_records(rng):
    """The former unbounded-growth leak: resolved records must leave
    engine.records once sampled, keeping memory O(in-flight)."""
    d = make_device(device="cpu", n_instances=2)
    tel = Telemetry(d)
    buf = _f32(rng.normal(size=(8, 128)))
    for _ in range(5):
        _burst(d, buf, 10)
        tel.sample()
    d.drain()
    tel.sample()
    assert sum(len(e.records) for e in d.engines) == 0
    assert all(len(s) == 0 for s in tel.store._seen.values())
    # pruning must not lose counts
    assert tel.store.totals() == {"count": 50, "bytes": 50 * buf.numel() * 4}


def test_telemetry_prune_false_keeps_records_bounded(rng):
    d = make_device(device="cpu")
    tel_a = Telemetry(d, prune=False)
    tel_b = Telemetry(d, prune=False)  # two record-walkers coexist
    buf = _f32(rng.normal(size=(8, 128)))
    _burst(d, buf, 6)
    d.drain()
    tel_a.sample()
    tel_b.sample()
    assert tel_a.store.totals() == tel_b.store.totals()
    assert tel_a.store.totals()["count"] == 6
    # records survive (prune=False) but the seen-set is clipped to them
    live = sum(len(e.records) for e in d.engines)
    assert live == 6
    assert sum(len(s) for s in tel_a.store._seen.values()) == live


# ---------------------------------------------------------------- monitor
def test_pcm_repro_render_frame(rng):
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                           / "tools"))
    try:
        import pcm_repro_torch
    finally:
        sys.path.pop(0)
    clock = FakeClock()
    topo = Topology.symmetric(2, engines_per_node=1)
    d = make_device(device="cpu", topology=topo, policy="numa_local")
    sampler = Sampler(d, clock=clock)
    buf = _f32(rng.normal(size=(64, 128)))
    _burst(d, buf, 2)
    d.drain()
    clock.advance(1.0)
    sampler.tick()
    text = pcm_repro_torch.render_frame(sampler, d, numa=True, frame=1)
    assert "ENGINE" in text and "GB/s" in text
    for e in d.engines:
        assert e.name in text
    assert "NODE" in text and "CROSS-GB/s" in text
    assert "pressure:" in text


# ---------------------------------------------------------------- exporter edge cases
def test_export_empty_sampler_round_trips(tmp_path):
    """Zero ticks: CSV is a lone header, JSONL is empty — both re-parse."""
    d = make_device(device="cpu")
    sampler = Sampler(d, clock=FakeClock())
    text = sampler.to_csv(str(tmp_path / "empty.csv"))
    assert list(csv.DictReader(io.StringIO(text))) == []
    assert text.splitlines()[0]  # header line present
    jtext = sampler.to_jsonl(str(tmp_path / "empty.jsonl"))
    assert jtext == ""
    assert (tmp_path / "empty.jsonl").read_text() == ""


def test_export_nonfinite_values_stay_parseable():
    """NaN/inf gauges must not produce bare NaN tokens (invalid JSON) or
    poisoned CSV cells: JSONL writes null, CSV an empty cell."""
    clock = FakeClock()
    d = make_device(device="cpu")
    sampler = Sampler(d, clock=clock)
    clock.advance(1.0)
    sampler.gauge("weird.nan", float("nan"))
    sampler.gauge("weird.inf", float("inf"))
    sampler.gauge("weird.ok", 3.0)
    sampler.tick()
    for line in sampler.to_jsonl().splitlines():
        obj = json.loads(line)  # raises on bare NaN/Infinity tokens
        assert obj["weird.nan"] is None
        assert obj["weird.inf"] is None
        assert obj["weird.ok"] == 3.0
    row = next(csv.DictReader(io.StringIO(sampler.to_csv())))
    assert row["weird.nan"] == ""
    assert row["weird.inf"] == ""
    assert row["weird.ok"] == "3"


def test_export_after_ring_wraparound(rng):
    """Exports see only the retained window, with consistent columns."""
    clock = FakeClock()
    d = make_device(device="cpu")
    sampler = Sampler(d, capacity=4, clock=clock)
    buf = _f32(rng.normal(size=(8, 128)))
    for _ in range(10):
        _burst(d, buf, 1)
        clock.advance(1.0)
        sampler.tick()
    d.drain()
    rows = list(csv.DictReader(io.StringIO(sampler.to_csv())))
    assert len(rows) == 4
    assert [float(r["time_s"]) for r in rows] == [7.0, 8.0, 9.0, 10.0]
    objs = [json.loads(line) for line in sampler.to_jsonl().splitlines()]
    assert [o["time_s"] for o in objs] == [7.0, 8.0, 9.0, 10.0]


# ---------------------------------------------------------------- teardown races
def test_sampler_tick_error_is_stored_not_raised():
    """A reader racing device teardown must not kill the monitor thread
    with a traceback: the error lands on sampler.error and stop() still
    detaches cleanly (tools/pcm_repro.py exits 0 and reports it)."""
    d = make_device(device="cpu")
    sampler = Sampler(d, clock=FakeClock())

    def boom():
        raise RuntimeError("engine torn down mid-read")

    for e in d.engines:
        e.counters_snapshot = boom
    sampler.start()
    sampler._thread.join(timeout=5.0)  # _run swallows the error and stops
    assert not sampler._thread.is_alive()
    sampler.stop()  # second stop with the device broken: still no raise
    assert isinstance(sampler.error, RuntimeError)


def test_sampler_stop_survives_final_tick_failure():
    d = make_device(device="cpu")
    sampler = Sampler(d, clock=FakeClock())
    sampler.tick()

    def boom():
        raise RuntimeError("device drained under the sampler")

    for e in d.engines:
        e.counters_snapshot = boom
    sampler.stop()  # final flush tick fails internally; no traceback
    assert isinstance(sampler.error, RuntimeError)
    assert len(sampler.rows()) == 1  # pre-failure data survives


# ---------------------------------------------------------------- trace series
def test_sampler_ticks_trace_phase_occupancy(rng):
    """With make_device(trace=...), each tick derives per-phase occupancy
    (folded phase seconds per wall second) from the tracer's monotonic
    counters — the pcm_repro live phase line."""
    clock = FakeClock()
    d = make_device(device="cpu", trace=1.0)
    sampler = Sampler(d, clock=clock)
    buf = _f32(rng.normal(size=(64, 128)))
    _burst(d, buf, 4)
    d.drain()
    clock.advance(2.0)
    sampler.tick()
    s = sampler.series.get("trace.sampled")
    assert s is not None and s.sum() == 4
    occ = sampler.series["trace.phase.pe_exec.occupancy"]
    folded = d.tracer.counters_snapshot()["phase.pe_exec_s"]
    assert occ.last() == pytest.approx(folded / 2.0)
    # idle second tick: occupancy falls to zero, counters stay monotonic
    clock.advance(2.0)
    sampler.tick()
    assert occ.last() == 0.0


# ---------------------------------------------------------------- across the packages
def _rows(seed: int, n: int = 12):
    """Sampler-style rows from a seed: finite, NaN and inf values, and a
    column that appears mid-run (the wide CSV must fill it in)."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        row = {"time_s": float(i) * 0.5, "dt_s": 0.5,
               "engine.dsa0.bytes": float(rng.integers(0, 1 << 20)),
               "wait.umwait.host_free_frac": float(rng.random())}
        if i % 5 == 3:
            row["weird"] = [float("nan"), float("inf"), -float("inf")][i % 3]
        if i >= n // 2:
            row["late.gauge"] = float(rng.normal())
        rows.append(row)
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_percentile_and_series_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    vals = [float(v) for v in rng.normal(size=97)]
    for q in (0, 1, 25, 50, 90, 95, 99, 100):
        assert percentile(vals, q) == jpercentile(vals, q)
    a, b = Series("m", capacity=16), JSeries("m", capacity=16)
    for t, v in enumerate(vals):
        a.append(float(t), v)
        b.append(float(t), v)
    assert a.values == b.values and a.times == b.times
    assert a.summary() == b.summary()
    assert a.summary(window_s=5.0) == b.summary(window_s=5.0)
    assert a.window(3.0) == b.window(3.0)
    assert a.sum() == b.sum() and a.last() == b.last()


class _Ticks:
    """The two methods the exporters read from a Sampler."""

    def __init__(self, rows):
        self._rows = rows

    def rows(self):
        return list(self._rows)

    def columns(self):
        cols = []
        for row in self._rows:
            cols += [k for k in row if k not in cols]
        return cols


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_csv_and_jsonl_text_match_the_reference(seed):
    ticks = _Ticks(_rows(seed))
    assert texport.to_csv(ticks) == jexport.to_csv(ticks)
    assert texport.to_jsonl(ticks) == jexport.to_jsonl(ticks)
    assert texport.to_csv(_Ticks([])) == jexport.to_csv(_Ticks([]))
    assert texport.to_jsonl(_Ticks([])) == jexport.to_jsonl(_Ticks([]))


def _fill_tracers(seed: int):
    """The same hand-made traces, edges and wait spans in both packages'
    tracers (timestamps from a seed)."""
    from repro.obs import DescTrace as JDescTrace
    from repro.obs import Tracer as JTracer
    from repro_torch.obs import DescTrace, Tracer

    rng = np.random.default_rng(seed)
    out = []
    for Tr, DT in ((Tracer, DescTrace), (JTracer, JDescTrace)):
        out.append(Tr())
    marks = ["create", "submit_enter", "validate0", "validate1", "accept", "dispatch",
             "exec0", "exec1", "resolved", "observed", "cb0", "cb1"]
    for i in range(6):
        t = float(rng.random())
        stamps = np.cumsum(rng.random(len(marks)) * 1e-3) + t
        attrs = {"engine": "dsa0", "batch": int(rng.integers(1, 4)),
                 "odd": float("nan") if i == 2 else 1.5}
        for tracer, DT in zip(out, (DescTrace, JDescTrace)):
            dt = DT(f"req{i % 3}", i + 1, "memcpy", nbytes=4096 * (i + 1), tracer=tracer)
            dt.attrs.update(attrs)
            for m, ts in zip(marks, stamps):
                dt.mark(m, float(ts))
            tracer._ring.append(dt)
    for tracer in out:
        tracer.edge(1, 2, "after")
        tracer.edge(2, 4, "then")
        tracer.wait_span("umwait", 0.25, 0.5, 0.01, 0.24, 3)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_perfetto_text_and_analyzers_match_the_reference(seed):
    from repro.obs import critical_path as jcp
    from repro.obs import host_free_fraction as jhf
    from repro.obs import phase_breakdown as jpb
    from repro_torch.obs import critical_path, host_free_fraction, phase_breakdown

    tt, jt = _fill_tracers(seed)
    assert texport.to_perfetto(tt) == jexport.to_perfetto(jt)
    assert phase_breakdown(tt) == jpb(jt)
    assert critical_path(tt) == jcp(jt)
    assert host_free_fraction(tt) == jhf(jt)
    assert tt.counters_snapshot() == jt.counters_snapshot()
    assert math.isfinite(host_free_fraction(tt))
