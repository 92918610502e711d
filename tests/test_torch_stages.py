"""The port's stage spans (``repro_torch.obs.spans``: ``stage``,
``StageRecorder``, ``STAGES``) on the CPU: off, a span site records and
retains nothing and calls no profiler or CUDA function; under
``torch.profiler.profile`` the spans nest, carry their parents, request
ids and modes, line up with the profiler's own events, and reach across
to a thread that opens spans inside an open cross-thread span (autograd's
backward thread on the card); remat's gradients are the same bit for bit
with spans on; and the server's request stamps add up to no more than a
request's time to its first token."""
import collections
import dataclasses
import gc
import json
import sys
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tree as _tree
from repro_torch.configs import get_config
from repro_torch.core import make_device
from repro_torch.models.api import build_model
from repro_torch.obs import NULL_STAGE, STAGES, StageRecorder, StageSpan, recording, stage
from repro_torch.obs import spans as spans_mod
from repro_torch.obs import to_perfetto
from repro_torch.optim.gradients import GradAccumulator
from repro_torch.serving import pipeline as pipe


@pytest.fixture(autouse=True)
def _empty_ring():
    STAGES.clear()
    yield
    STAGES.clear()


def _site():
    with stage("model.attention", "train"):
        pass


def _retained(n: int):
    """Memory and allocated blocks held after ``n`` span sites, and the
    peak while they ran, each relative to before."""
    gc.collect()
    gc.disable()
    tracemalloc.start()
    try:
        blocks0 = sys.getallocatedblocks()
        cur0, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        for _ in range(n):
            _site()
        cur1, peak = tracemalloc.get_traced_memory()
        blocks1 = sys.getallocatedblocks()
    finally:
        tracemalloc.stop()
        gc.enable()
    return cur1 - cur0, peak - cur0, blocks1 - blocks0


def _reduced(arch: str):
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32")


# --------------------------------------------------------------------------- off
def test_off_a_span_site_is_the_shared_null_context(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called while no span records")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    assert stage("serve.decode", "decode", 3) is NULL_STAGE
    with stage("serve.decode") as got:
        assert got is None
    # the program's own sites, off: a reduced train step and a server's
    # steps record nothing
    cfg = _reduced("hymba-1.5b")
    model = build_model(cfg, remat=True, attn_impl="flash", device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator()
                                     .manual_seed(1))}
    GradAccumulator.accumulate(model.loss, params, batch, 1)
    assert STAGES.spans() == [] and STAGES.dropped == 0


def test_off_a_span_site_retains_nothing():
    """Ten times the span sites hold no more memory, blocks or peak than
    one time as many: nothing is kept or grown per call."""
    _retained(100)  # warm
    small = _retained(1000)
    large = _retained(10000)
    assert large == small
    assert STAGES.spans() == []


# --------------------------------------------------------------------------- on
def test_spans_nest_with_parents_requests_and_modes():
    with profile(activities=[ProfilerActivity.CPU]):
        assert stage("serve.step") is not NULL_STAGE
        with stage("serve.step"):
            with stage("serve.poll"):
                with stage("serve.admit", "prefill", 7):
                    with stage("serve.prefill", "prefill", 7):
                        pass
            with stage("serve.decode", "decode"):
                pass
    assert stage("serve.step") is NULL_STAGE
    got = {s.phase: s for s in STAGES.spans()}
    assert set(got) == {"serve.step", "serve.poll", "serve.admit", "serve.prefill",
                        "serve.decode"}
    assert got["serve.step"].parent is None
    assert got["serve.poll"].parent == got["serve.step"].sid
    assert got["serve.admit"].parent == got["serve.poll"].sid
    assert got["serve.prefill"].parent == got["serve.admit"].sid
    assert got["serve.decode"].parent == got["serve.step"].sid
    assert got["serve.admit"].req == got["serve.prefill"].req == "req7"
    assert got["serve.step"].req is None
    assert got["serve.admit"].mode == "prefill" and got["serve.decode"].mode == "decode"
    assert {s.thread for s in got.values()} == {threading.get_ident()}
    for s in got.values():
        assert isinstance(s, StageSpan) and s.track == "stage"
        assert s.t0 <= s.t1 and s.t0_ns <= s.t1_ns
        if s.parent is not None:
            p = next(x for x in got.values() if x.sid == s.parent)
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns


def test_the_clock_lines_up_with_the_profilers_events():
    """A span around a torch op, converted to the profiler's clock, holds
    the profiler's own event for that op, from the same trace."""
    a, b = torch.randn(256, 256), torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with stage("op"):
            time.sleep(0.002)
            torch.mm(a, b)
            time.sleep(0.002)
    (sp,) = STAGES.spans()
    mm = [ev for ev in prof.profiler.kineto_results.events() if ev.name() == "aten::mm"]
    assert len(mm) == 1
    start = mm[0].start_ns()
    end = start + mm[0].duration_ns()
    assert sp.t0_ns <= start and end <= sp.t1_ns
    # and the op sits between the two sleeps, not at an end of the span
    assert start - sp.t0_ns >= 1_000_000 and sp.t1_ns - end >= 1_000_000


def test_recording_without_a_profiler_and_the_ring_counts_drops(monkeypatch):
    rec = StageRecorder()
    rec._ring = collections.deque(maxlen=4)
    monkeypatch.setattr(spans_mod, "STAGES", rec)
    assert stage("x") is NULL_STAGE
    with spans_mod.recording():
        for i in range(6):
            with stage(f"s{i}"):
                pass
    assert [s.phase for s in rec.spans()] == ["s2", "s3", "s4", "s5"]
    assert rec.dropped == 2
    assert stage("x") is NULL_STAGE
    rec.clear()
    assert rec.spans() == [] and rec.dropped == 0


def test_a_thread_with_no_span_open_takes_the_open_cross_thread_span():
    """Autograd runs a CUDA graph's backward on a thread of its own, with no
    span open there: its spans take the open ``cross_thread`` span as their
    parent.  A Python thread stands in for it on the CPU."""
    x = torch.randn(8, 8, requires_grad=True)

    def body(t):
        with stage("model.attention", "train"):
            return torch.tanh(t @ t)

    def backward():
        y = torch.utils.checkpoint.checkpoint(body, x, use_reentrant=False)
        with stage("other"):
            pass
        y.sum().backward()

    with recording():
        with stage("train.backward", "backward", cross_thread=True):
            th = threading.Thread(target=backward)
            th.start()
            th.join()
        with stage("after"):  # closed: no longer anyone's parent
            pass
    spans = STAGES.spans()
    outer = next(s for s in spans if s.phase == "train.backward")
    inner = [s for s in spans if s.thread == th.ident]
    assert {s.phase for s in inner} == {"model.attention", "other"}
    assert len([s for s in inner if s.phase == "model.attention"]) == 2  # forward, replay
    assert all(s.parent == outer.sid for s in inner)
    assert next(s for s in spans if s.phase == "after").parent is None


def test_a_checkpointed_train_step_under_the_profiler():
    """hymba's reduced model, remat and the flash path (its plain version
    on the CPU): the forward's spans sit under ``train.forward``, the remat
    replays (mode "train") and the attention backward (mode "backward")
    under ``train.backward``."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import AdamW

    cfg = _reduced("hymba-1.5b")
    model = build_model(cfg, remat=True, attn_impl="flash", device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    opt = AdamW(lr=1e-3)
    step = make_train_step(model, opt)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator()
                                     .manual_seed(2))}
    with profile(activities=[ProfilerActivity.CPU]):
        step(params, opt.init(params), batch)
    spans = STAGES.spans()
    by = {s.sid: s for s in spans}
    kinds = {}
    for s in spans:
        parent = by[s.parent].phase if s.parent in by else None
        kinds[(s.phase, s.mode, parent)] = kinds.get((s.phase, s.mode, parent), 0) + 1
    n = cfg.num_layers
    assert kinds == {
        ("train.step", "train", None): 1,
        ("train.forward", "train", "train.step"): 1,
        ("train.backward", "backward", "train.step"): 1,
        ("train.optimizer", "train", "train.step"): 1,
        ("model.attention", "train", "train.forward"): n,
        ("model.ssm", "train", "train.forward"): n,
        ("model.attention", "train", "train.backward"): n,
        ("model.ssm", "train", "train.backward"): n,
        ("model.attention", "backward", "train.backward"): n,
    }


def test_remat_gradients_are_equal_bit_for_bit_with_spans_on():
    cfg = _reduced("hymba-1.5b")
    model = build_model(cfg, remat=True, attn_impl="flash", device="cpu")
    params = model.init(torch.Generator().manual_seed(3))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 24), generator=torch.Generator()
                                     .manual_seed(4))}
    loss0, _, g0 = GradAccumulator.accumulate(model.loss, params, batch, 1)
    with recording():
        loss1, _, g1 = GradAccumulator.accumulate(model.loss, params, batch, 1)
    assert STAGES.spans()
    assert torch.equal(loss0, loss1)
    for a, b in zip(_tree.leaves(g0), _tree.leaves(g1)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------- the server
class _Gauges:
    def __init__(self):
        self.values = {}

    def gauge(self, name, value):
        self.values.setdefault(name, []).append(float(value))


def test_the_servers_request_stamps_add_up_to_no_more_than_the_first_token():
    cfg = _reduced("tinyllama-1.1b")
    model = build_model(cfg, remat=False, attn_impl="flash", device="cpu")
    params = model.init(torch.Generator().manual_seed(5))
    rng = np.random.default_rng(6)
    gauges = _Gauges()
    server = pipe.VhostStyleServer(model, params, slots=2, max_cache_len=96,
                                   device=make_device(device="cpu"), observer=gauges)
    reqs = [pipe.Request(req_id=i, prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                         max_new_tokens=3) for i, n in enumerate((40, 9, 70, 20))]
    with recording():
        for r in reqs:
            server.enqueue(r)
        assert server.run_until_drained(max_steps=500) < 500
    prefill = {s.req: s.t1 - s.t0 for s in STAGES.spans() if s.phase == "serve.prefill"}
    assert set(prefill) == {f"req{r.req_id}" for r in reqs}
    for r in reqs:
        assert r.enqueued_at <= r.submitted_at <= r.admitted_at <= r.first_token_at
        queue_wait = r.submitted_at - r.enqueued_at
        copy_wait = r.admitted_at - r.submitted_at
        assert queue_wait + copy_wait + prefill[f"req{r.req_id}"] <= (
            r.first_token_at - r.enqueued_at)
    g = gauges.values
    assert len(g["serving.request.queue_wait_us"]) == len(reqs)
    assert len(g["serving.request.copy_wait_us"]) == len(reqs)
    assert sorted(g["serving.request.queue_wait_us"]) == pytest.approx(
        sorted((r.submitted_at - r.enqueued_at) * 1e6 for r in reqs))
    # one launch gauge for each step that decoded, each inside its stage
    launches = g["serving.stage.decode_launch_us"]
    n_launched = sum(s.phase == "serve.decode.launch" for s in STAGES.spans())
    assert len(launches) == n_launched > 0
    assert sum(launches) <= sum(g["serving.stage.decode_us"])
    names = {s.phase for s in STAGES.spans()}
    assert {"serve.step", "serve.poll", "serve.admit", "serve.splice", "serve.submit",
            "serve.decode", "serve.decode.launch", "serve.decode.read",
            "model.attention"} <= names
    reads = [s for s in STAGES.spans() if s.phase == "serve.decode.read"]
    decode = {s.sid: s for s in STAGES.spans() if s.phase == "serve.decode"}
    assert reads and all(s.parent in decode for s in reads)


# --------------------------------------------------------------------------- perfetto
def test_perfetto_draws_stage_spans_on_their_own_track(tmp_path):
    device = make_device(device="cpu", trace=True)
    buf = torch.zeros(64, dtype=torch.int32)
    with recording():
        with stage("serve.step"):
            fut = device.memcpy_async(buf)
            with stage("serve.admit", "prefill", 4):
                fut.wait()
    device.drain()
    out = tmp_path / "trace.json"
    text = to_perfetto(device.tracer, str(out), stages=STAGES.spans())
    assert out.read_text() == text
    doc = json.loads(text)  # strict JSON
    events = doc["traceEvents"]
    for ev in events:
        if "ts" in ev:
            assert ev["ts"] >= 0
        if ev.get("ph") == "X":
            assert ev["dur"] >= 0
    procs = {ev["args"]["name"]: ev["pid"] for ev in events
             if ev.get("ph") == "M" and ev["name"] == "process_name"}
    assert {"dsa-repro/host", "dsa-repro/stages"} <= set(procs)
    st = [ev for ev in events if ev.get("cat") == "stage"]
    assert {ev["name"] for ev in st} == {"serve.step", "serve.admit"}
    assert all(ev["pid"] == procs["dsa-repro/stages"] and ev["ph"] == "X" for ev in st)
    admit = next(ev for ev in st if ev["name"] == "serve.admit")
    assert admit["args"]["trace_id"] == "req4" and admit["args"]["mode"] == "prefill"
    # the stage spans and the descriptor's share one time base
    desc = [ev for ev in events if ev.get("cat") == "desc"]
    step = next(ev for ev in st if ev["name"] == "serve.step")
    assert desc and all(step["ts"] <= ev["ts"] for ev in desc)
    # stage spans alone
    alone = json.loads(to_perfetto(None, stages=STAGES.spans()))
    assert {ev["name"] for ev in alone["traceEvents"] if ev.get("ph") == "X"} == {
        "serve.step", "serve.admit"}


def test_the_recorder_is_the_modules_own():
    assert spans_mod.STAGES is STAGES
