"""Descriptor-lifecycle tracing: span model, sampling, dependency edges,
critical path, host-free reconciliation, and the Perfetto export."""
import json

import pytest
import torch

from repro_torch.core import OpType, QueueFull, WorkDescriptor, make_device
from repro_torch.core.descriptor import BatchDescriptor
from repro_torch.obs import (
    HOST_PHASES,
    PHASES,
    DescTrace,
    TraceConfig,
    Tracer,
    TraceRateError,
    critical_path,
    host_free_fraction,
    make_tracer,
    phase_breakdown,
    slowest,
    to_perfetto,
)


@pytest.fixture
def buf():
    return torch.zeros((8, 128), dtype=torch.float32)  # 4KB


def _traced_device(**kw):
    kw.setdefault("trace", 1.0)
    return make_device(device="cpu", n_instances=1, **kw)


# --------------------------------------------------------------------- config
def test_trace_rate_error_is_typed_and_coded():
    for bad in (1.5, -0.1, 2, -3.0):
        with pytest.raises(TraceRateError) as ei:
            TraceConfig(rate=bad)
        assert ei.value.code == "DSA105"
        assert ei.value.rate == bad
        assert isinstance(ei.value, ValueError)


def test_make_device_rejects_bad_rate():
    with pytest.raises(TraceRateError):
        make_device(device="cpu", trace=1.5)  # dsalint: disable=DSA105
    with pytest.raises(TraceRateError):
        make_device(device="cpu", trace=-0.5)  # dsalint: disable=DSA105


def test_make_tracer_spec_resolution():
    assert make_tracer(None) is None
    assert make_tracer(False) is None
    assert make_tracer(True).config.rate == 1.0
    assert make_tracer(0.25).config.rate == 0.25
    cfg = TraceConfig(rate=0.5, capacity=16)
    assert make_tracer(cfg).config is cfg
    t = Tracer()
    assert make_tracer(t) is t
    with pytest.raises(TypeError):
        make_tracer("yes")


def test_untraced_device_has_no_tracer(buf):
    device = make_device(device="cpu", n_instances=1)
    assert device.tracer is None
    fut = device.memcpy_async(buf)
    fut.wait()
    assert fut.trace is None
    device.drain()


# --------------------------------------------------------------------- lifecycle
def test_every_phase_present_on_traced_submit(buf):
    device = _traced_device()
    fut = device.memcpy_async(buf)
    fut.wait()
    device.drain()
    dt = fut.trace
    assert dt is not None
    durs = dt.phase_durations()
    assert set(durs) == set(PHASES)
    assert all(d >= 0.0 for d in durs.values())
    # marks are monotonic after cleaning
    marks = dt.clean_marks()
    ts = list(marks.values())
    assert ts == sorted(ts)


def test_batch_trace_starts_at_first_member_allocation(buf):
    device = _traced_device()
    descs = [WorkDescriptor(op=OpType.MEMCPY, src=buf) for _ in range(4)]
    batch = BatchDescriptor(descriptors=descs)
    fut = device.submit(batch)
    fut.wait()
    device.drain()
    dt = fut.trace
    assert dt.attrs["batch"] == 4
    assert dt.marks["create"] == min(d.created_t for d in descs)


def test_then_continuation_gets_child_trace_and_edge(buf):
    device = _traced_device()
    fut = device.memcpy_async(buf)
    chained = fut.then(lambda r: r)
    chained.wait()
    device.drain()
    child = chained.record.trace
    assert child is not None
    assert child.attrs["kind"] == "then"
    assert child.trace_id == fut.trace.trace_id  # same logical request
    assert child.desc_id != fut.trace.desc_id
    kinds = {(p, c): k for p, c, k in device.tracer.edges()}
    assert kinds[(fut.trace.desc_id, child.desc_id)] == "then"
    # then-traces reuse host_wait + callback only
    assert set(child.phase_durations()) == {"host_wait", "callback"}


def test_after_dependency_records_edge(buf):
    device = _traced_device()
    a = device.memcpy_async(buf)
    b = device.memcpy_async(buf, after=[a])
    device.wait_all([a, b])
    device.drain()
    assert (a.trace.desc_id, b.trace.desc_id, "after") in device.tracer.edges()


def test_spans_track_assignment(buf):
    device = _traced_device()
    fut = device.memcpy_async(buf)
    fut.wait()
    device.drain()
    for sp in fut.trace.spans():
        assert sp.track == ("host" if sp.phase in HOST_PHASES else "engine")
        assert sp.dur >= 0.0


# --------------------------------------------------------------------- sampling
def test_fractional_sampling_is_deterministic(buf):
    device = _traced_device(trace=0.25)
    futs = [device.memcpy_async(buf) for _ in range(32)]
    device.wait_all(futs)
    device.drain()
    sampled = [f for f in futs if f.trace is not None]
    assert len(sampled) == 8  # exactly floor/ceil(32 * 0.25), no RNG
    c = device.tracer.counters_snapshot()
    assert c["sampled"] >= 8
    assert c["skipped"] == 24


def test_rate_zero_samples_nothing(buf):
    device = _traced_device(trace=0.0)
    fut = device.memcpy_async(buf)
    fut.wait()
    device.drain()
    assert fut.trace is None
    assert device.tracer.traces() == []


def test_request_context_shares_trace_id_and_verdict(buf):
    device = _traced_device()
    tracer = device.tracer
    with tracer.request("req42"):
        assert tracer.current_trace_id() == "req42"
        a = device.memcpy_async(buf)
        with tracer.request("inner"):
            assert tracer.current_trace_id() == "inner"
        assert tracer.current_trace_id() == "req42"  # re-entrant restore
        b = device.memcpy_async(buf)
    assert tracer.current_trace_id() is None
    device.wait_all([a, b])
    device.drain()
    assert a.trace.trace_id == b.trace.trace_id == "req42"


def test_request_sampling_verdict_is_stable_per_id():
    tracer = Tracer(TraceConfig(rate=0.5))
    verdicts = {rid: tracer._sample_id(rid) for rid in map(str, range(200))}
    assert any(verdicts.values()) and not all(verdicts.values())
    for rid, v in verdicts.items():
        assert tracer._sample_id(rid) == v  # same id -> same answer


def test_ring_capacity_bounds_retention(buf):
    device = _traced_device(trace=TraceConfig(rate=1.0, capacity=8))
    futs = [device.memcpy_async(buf) for _ in range(20)]
    device.wait_all(futs)
    device.drain()
    tracer = device.tracer
    assert len(tracer.traces()) == 8
    # monotonic fold counters survive ring rotation: all 20 folded
    assert tracer.counters_snapshot()["phase.pe_exec_n"] == 20


def test_marks_are_write_once():
    dt = DescTrace("t", 1, "memcpy")
    t0 = dt.mark("create", 10.0)
    assert dt.mark("create", 99.0) == t0
    assert dt.marks["create"] == 10.0


# --------------------------------------------------------------------- analyzers
def _mk(tracer, desc_id, t0, t1, trace_id=None):
    dt = DescTrace(trace_id or f"d{desc_id}", desc_id, "memcpy", tracer=tracer)
    dt.marks["create"] = t0
    dt.marks["submit_enter"] = t1  # gives the trace one derived span
    dt.marks["observed"] = t1
    tracer._ring.append(dt)
    return dt


def test_critical_path_follows_edges_and_clips_overlap():
    tracer = Tracer()
    _mk(tracer, 1, 0.0, 1.0)
    _mk(tracer, 2, 0.5, 3.0)   # overlaps parent by 0.5s
    _mk(tracer, 3, 0.0, 1.5)   # longer standalone than either alone
    tracer.edge(1, 2, "after")
    cp = critical_path(tracer)
    assert cp["chain"] == [1, 2]
    # 1.0 (node 1) + (3.0 - max(0.5, 1.0)) = 3.0, not 1.0 + 2.5
    assert cp["total_s"] == pytest.approx(3.0)
    assert cp["total_s"] <= cp["elapsed_s"] + 1e-9
    assert cp["elapsed_s"] == pytest.approx(3.0)


def test_critical_path_empty_tracer():
    cp = critical_path(Tracer())
    assert cp == {"chain": [], "total_s": 0.0, "elapsed_s": 0.0,
                  "phases": {}, "shares": {}}


def test_phase_breakdown_shares_sum_to_one(buf):
    device = _traced_device()
    futs = [device.memcpy_async(buf) for _ in range(4)]
    device.wait_all(futs)
    device.drain()
    br = phase_breakdown(device.tracer)
    assert set(br) == set(PHASES)
    assert sum(s["share"] for s in br.values()) == pytest.approx(1.0)
    for s in br.values():
        assert s["count"] == 4
        assert s["p95_s"] >= 0.0


def test_slowest_orders_by_extent():
    tracer = Tracer()
    _mk(tracer, 1, 0.0, 1.0)
    _mk(tracer, 2, 0.0, 5.0)
    _mk(tracer, 3, 0.0, 2.0)
    assert [t.desc_id for t in slowest(tracer, k=2)] == [2, 3]


# --------------------------------------------------------------------- host-free
def test_host_free_fraction_matches_waitstats_exactly(buf):
    """The span-derived host-free fraction against WaitStats': they are
    the SAME numbers by construction, so demand equality."""
    device = _traced_device()
    futs = [device.memcpy_async(buf) for _ in range(8)]
    device.wait_all(futs)
    device.drain()
    spans_frac = host_free_fraction(device.tracer)
    busy = sum(s.busy_s for s in device.wait_stats.values())
    free = sum(s.free_s for s in device.wait_stats.values())
    assert busy + free > 0
    ws_frac = free / (busy + free)
    assert spans_frac == pytest.approx(ws_frac, rel=1e-9)
    assert abs(spans_frac - ws_frac) <= 0.05 * max(ws_frac, 1e-12)


def test_wait_spans_recorded_per_wait(buf):
    device = _traced_device()
    fut = device.memcpy_async(buf)
    fut.wait()
    device.drain()
    waits = device.tracer.wait_spans()
    assert waits
    for w in waits:
        assert w.t1 >= w.t0
        assert w.busy_s >= 0.0 and w.free_s >= 0.0


# --------------------------------------------------------------------- perfetto
def test_perfetto_valid_json_and_monotonic(buf, tmp_path):
    device = _traced_device()
    a = device.memcpy_async(buf)
    b = device.memcpy_async(buf, after=[a])
    c = b.then(lambda r: r)
    device.wait_all([a, b, c])
    device.drain()
    out = tmp_path / "trace.json"
    text = to_perfetto(device.tracer, str(out))
    assert out.read_text() == text
    doc = json.loads(text)  # strict JSON
    events = doc["traceEvents"]
    assert events
    for ev in events:
        if "ts" in ev:
            assert ev["ts"] >= 0
        if ev.get("ph") == "X":
            assert ev["dur"] >= 0
    slices = [ev for ev in events if ev.get("ph") == "X"]
    names = {ev["name"] for ev in slices}
    assert set(PHASES) <= names
    assert any(ev["name"].startswith("wait/") for ev in slices)
    # flow arrows for both edge kinds, start before finish
    flows = {}
    for ev in events:
        if ev.get("ph") in ("s", "f"):
            flows.setdefault(ev["id"], {})[ev["ph"]] = ev
    assert flows
    for pair in flows.values():
        assert set(pair) == {"s", "f"}
        assert pair["f"]["ts"] >= pair["s"]["ts"]
    assert {ev["name"] for ev in events if ev.get("ph") == "s"} == {
        "after", "then"}
    # one metadata process per track, host first
    meta = [ev for ev in events if ev.get("ph") == "M"
            and ev["name"] == "process_name"]
    assert {m["args"]["name"] for m in meta} >= {"dsa-repro/host"}


def test_perfetto_empty_tracer_is_valid():
    doc = json.loads(to_perfetto(Tracer()))
    names = {ev["name"] for ev in doc["traceEvents"]}
    assert names == {"process_name"}  # just the host track metadata


def test_perfetto_nonfinite_attrs_sanitized(tmp_path):
    tracer = Tracer()
    dt = _mk(tracer, 1, 0.0, 1.0)
    dt.attrs["weird"] = float("nan")
    dt.attrs["obj"] = object()
    text = to_perfetto(tracer)
    doc = json.loads(text)  # would raise on bare NaN tokens
    sl = next(ev for ev in doc["traceEvents"] if ev.get("ph") == "X")
    assert sl["args"]["weird"] is None
    assert isinstance(sl["args"]["obj"], str)


# --------------------------------------------------------------------- errors
def test_queuefull_trace_is_terminated_not_leaked(buf):
    device = _traced_device(wq_size=1, max_retries=0)
    futs = []
    saw_full = False
    try:
        for _ in range(64):
            futs.append(device.memcpy_async(buf))  # dsalint: disable=DSA106 — per-descriptor path under test
    except QueueFull:
        saw_full = True
    if futs:
        device.wait_all(futs)
    device.drain()
    if saw_full:
        errored = [dt for dt in device.tracer.traces()
                   if dt.attrs.get("error") == "QueueFull"]
        assert errored
        for dt in errored:
            assert "resolved" in dt.marks  # terminated, not dangling


# --------------------------------------------------------------------- across the packages
def _run_sequence(make, mods, buf):
    """One descriptor sequence on a traced device: plain copies, an after=
    fence, a .then continuation, a CRC, a fused copy batch and a fill.
    Returns {name: (phases, trace_id is per-descriptor)} and the edges by
    name."""
    OT, WD, BD = mods
    device = make(n_instances=1, trace=1.0)
    futs = {}
    futs["a"] = device.memcpy_async(buf)
    futs["b"] = device.memcpy_async(buf, after=[futs["a"]])
    futs["c"] = futs["b"].then(lambda r: r)
    futs["crc"] = device.submit(WD(op=OT.CRC32, src=buf))
    futs["batch"] = device.submit(BD(descriptors=[WD(op=OT.MEMCPY, src=buf)
                                                 for _ in range(3)]))
    futs["fill"] = device.submit(WD(op=OT.FILL, pattern=(7,), n_words=1024))
    device.wait_all(list(futs.values()))
    device.drain()
    name_of = {f.trace.desc_id: n for n, f in futs.items()}
    phases = {n: sorted(f.trace.phase_durations()) for n, f in futs.items()}
    kinds = {n: f.trace.attrs.get("kind") for n, f in futs.items()}
    edges = sorted((name_of[p], name_of[c], k) for p, c, k in device.tracer.edges())
    waits = {w.policy for w in device.tracer.wait_spans()}
    return phases, kinds, edges, waits


def test_traced_sequence_has_the_references_phases_and_edges():
    import jax.numpy as jnp

    from repro.core import OpType as JOT
    from repro.core import WorkDescriptor as JWD
    from repro.core import make_device as j_make_device
    from repro.core.descriptor import BatchDescriptor as JBD

    def t_make(**kw):
        return make_device(device="cpu", **kw)

    got = _run_sequence(t_make, (OpType, WorkDescriptor, BatchDescriptor),
                        torch.zeros((8, 128), dtype=torch.float32))
    want = _run_sequence(j_make_device, (JOT, JWD, JBD), jnp.zeros((8, 128), jnp.float32))
    assert got == want
    phases, kinds, edges, _ = got
    assert phases["a"] == sorted(PHASES)
    assert kinds["c"] == "then"
    assert ("a", "b", "after") in edges and ("b", "c", "then") in edges


def test_server_requests_share_their_trace_id():
    """``VhostStyleServer._trace_request``: with a traced device every
    descriptor a request submits carries ``req<id>``, as in the JAX
    package's server on the same requests."""
    import numpy as np

    from repro.core import make_device as j_make_device
    from repro.serving import nullmodel as j_null
    from repro.serving import pipeline as j_pipe
    from repro_torch.serving import nullmodel as t_null
    from repro_torch.serving import pipeline as t_pipe

    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 64, n).astype(np.int32) for n in (70, 9, 130, 33)]

    def serve(pipe, null, device, null_kw):
        server = pipe.VhostStyleServer(null.NullDecoder(64, **null_kw), {}, slots=2,
                                       max_cache_len=256, device=device)
        for i, p in enumerate(prompts):
            server.enqueue(pipe.Request(req_id=i, prompt=p, max_new_tokens=3))
        assert server.run_until_drained(max_steps=500) < 500
        return sorted((tr.trace_id, tr.op) for tr in device.tracer.traces())

    got = serve(t_pipe, t_null, make_device(device="cpu", n_instances=2, trace=1.0),
                {"device": "cpu"})
    want = serve(j_pipe, j_null, j_make_device(n_instances=2, trace=1.0), {})
    assert got == want
    assert {tid for tid, _ in got} == {f"req{i}" for i in range(len(prompts))}
