"""The readers of the program's stage spans and request gauges
(``bench/harness/stages.py`` and the nine metrics that use it), on
synthetic runs: known kernels, spans and gauges give the known share or
mean, and a run with none of them gives None."""
import pytest

from bench.harness import core, stages
from bench.harness.profiling import DeviceTrace

#: the per-layer metrics this file covers, each with the cells it lists
NAMES = ("serve.queue_wait_ms", "serve.copy_wait_ms", "serve.decode_launch_ms",
         "device.idle.serve.admit", "device.idle.serve.outside",
         "device.idle.train.backward", "device.idle.train.optimizer",
         "device.idle.train.attention", "device.idle.train.ssm")

BASE = 1_700_000_000_000_000_000  # the profiler's clock: epoch ns


def _reader(name):
    return core.load_module(core.BENCH / "metrics" / f"{name}.py",
                            f"bench_metric_{name.replace('.', '_')}")


def _trace(kernels, window_ns):
    tr = DeviceTrace(sync=lambda: None)
    tr.kernels = sorted((BASE + s, BASE + e, n) for s, e, n in kernels)
    tr.window_s = window_ns / 1e9
    return tr


class _Recorder:
    def __init__(self, spans, dropped=0):
        self._spans = spans
        self.dropped = dropped

    def spans(self):
        return list(self._spans)


def _span(name, t0, t1, thread=1, sid=0):
    from repro_torch.obs import StageSpan

    return StageSpan(name, t0 / 1e9, t1 / 1e9, "stage", sid=sid, thread=thread,
                     t0_ns=BASE + t0, t1_ns=BASE + t1)


def _run(cell, kernels=None, window_ns=10_000, spans=(), gauges=None, monkeypatch=None,
         dropped=0):
    from repro_torch.obs import spans as spans_mod

    run = core.Run(core.Cell(cell), 1, 1.0, 1, 0.0, device="cpu")
    run.device_trace = None if kernels is None else _trace(kernels, window_ns)
    run.gauges = gauges or {}
    monkeypatch.setattr(spans_mod, "STAGES", _Recorder(spans, dropped))
    return run


#: kernels at 1000-2000, 3000-4000 (and one inside it), 7000-8000 ns of a
#: 10 us span: idle between kernels 2000-3000 and 4000-7000, 4000 ns (40 %)
KERNELS = [(1000, 2000, "a"), (3000, 4000, "b"), (3200, 3500, "c"), (7000, 8000, "d")]


def test_the_benchmark_lists_each_reader_with_its_cells():
    spec = core.load_json(core.ROOT / "BENCHMARK.json")
    got = {m["name"]: m for m in spec["per_layer"]}
    for name in NAMES:
        assert (core.BENCH / "metrics" / f"{name}.py").is_file()
        m = got[name]
        for cell in m["workloads"]:
            e2e = {e["name"]: e for e in spec["end_to_end"]}[m["moves"]]
            assert cell in e2e.get("workloads", [cell]), (name, cell)


def test_idle_gaps_are_the_device_traces_own():
    tr = _trace(KERNELS, 10_000)
    gaps = stages.idle_gaps(tr.kernels)
    assert [(a - BASE, b - BASE) for a, b in gaps] == [(2000, 3000), (4000, 7000)]
    assert sorted(round(s * 1e9) for s, _ in tr.gaps()) == sorted(b - a for a, b in gaps)


def test_covered_takes_the_union_of_overlapping_spans():
    gaps = [(0, 10), (20, 30)]
    assert stages.covered_ns(gaps, []) == 0
    assert stages.covered_ns(gaps, [(5, 25)]) == 10
    assert stages.covered_ns(gaps, [(5, 25), (6, 24), (0, 3)]) == 13
    assert stages.covered_ns(gaps, [(-5, 100)]) == 20


def test_serving_idle_by_stage(monkeypatch):
    spans = [
        _span("serve.step", 1500, 9000, sid=1),
        _span("serve.admit", 2500, 5000, sid=2),  # 500 + 1000 ns of idle
        _span("serve.decode", 5000, 6000, sid=3),  # 1000 ns
        _span("serve.step", 20_000, 30_000, sid=4),  # after the kernels: left out
    ]
    run = _run("dsmoe16b.rag", KERNELS, spans=spans, monkeypatch=monkeypatch)
    assert _reader("device.idle.serve.admit").read(run) == pytest.approx(15.0)
    # outside every span: 2000-3000 less serve.step's 1500-9000 cover: nothing
    assert _reader("device.idle.serve.outside").read(run) == pytest.approx(0.0)
    spans[0] = _span("serve.step", 2500, 6500, sid=1)
    run = _run("dsmoe16b.chat", KERNELS, spans=spans, monkeypatch=monkeypatch)
    # idle 2000-2500 and 6500-7000 lie outside
    assert _reader("device.idle.serve.outside").read(run) == pytest.approx(10.0)
    assert _reader("device.idle.serve.outside").read(run) <= 100.0 * (
        1 - run.device_trace._union_ns() / 1e9 / run.device_trace.window_s)


def test_training_idle_by_phase_and_layer_kind(monkeypatch):
    spans = [
        _span("train.step", 0, 9000, sid=1),
        _span("train.forward", 1000, 2600, sid=2),
        _span("model.attention", 2200, 2400, sid=3),  # 200 ns
        _span("model.ssm", 2400, 2600, sid=4),  # 200 ns
        _span("train.backward", 2600, 6000, sid=5),  # 400 + 2000 ns
        _span("model.attention", 4500, 5500, thread=2, sid=6),  # autograd's thread
        _span("model.attention", 5000, 5800, thread=2, sid=7),  # overlapping: union
        _span("train.optimizer", 6000, 8000, sid=8),  # 1000 ns
    ]
    run = _run("hymba1.5b.train", KERNELS, spans=spans, monkeypatch=monkeypatch)
    assert _reader("device.idle.train.backward").read(run) == pytest.approx(24.0)
    assert _reader("device.idle.train.optimizer").read(run) == pytest.approx(10.0)
    assert _reader("device.idle.train.attention").read(run) == pytest.approx(15.0)
    assert _reader("device.idle.train.ssm").read(run) == pytest.approx(2.0)


def test_gauge_means(monkeypatch):
    gauges = {"serving.request.queue_wait_us": [1000.0, 3000.0],
              "serving.request.copy_wait_us": [500.0],
              "serving.stage.decode_launch_us": [2000.0, 4000.0, 6000.0]}
    run = _run("dsmoe16b.rag", gauges=gauges, monkeypatch=monkeypatch)
    assert _reader("serve.queue_wait_ms").read(run) == pytest.approx(2.0)
    assert _reader("serve.copy_wait_ms").read(run) == pytest.approx(0.5)
    assert _reader("serve.decode_launch_ms").read(run) == pytest.approx(4.0)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read_gives_none(name, monkeypatch):
    from repro_torch.obs import spans as spans_mod

    # no spans, no gauges, a device span
    assert _reader(name).read(_run("dsmoe16b.rag", KERNELS, monkeypatch=monkeypatch)) is None
    # no device span, spans of every kind
    spans = [_span(n, 0, 9000, sid=i) for i, n in enumerate(
        ("serve.admit", "train.backward", "train.optimizer", "model.attention", "model.ssm"))]
    assert _reader(name).read(_run("dsmoe16b.rag", None, spans=spans,
                                   monkeypatch=monkeypatch)) is None
    # a program with no recorder (the parent of the recorder)
    run = _run("dsmoe16b.rag", KERNELS, spans=spans, monkeypatch=monkeypatch)
    monkeypatch.delattr(spans_mod, "STAGES")
    assert _reader(name).read(run) is None


@pytest.mark.parametrize("name", [n for n in NAMES if n.startswith("device.idle.")])
def test_a_ring_that_let_spans_go_gives_none(name, monkeypatch):
    """Spans the ring let go would read as time in no span: the idle shares
    report nothing rather than a share that misses them."""
    spans = [_span(n, 1500, 9000, sid=i) for i, n in enumerate(
        ("serve.admit", "train.backward", "train.optimizer", "model.attention", "model.ssm"))]
    run = _run("dsmoe16b.rag", KERNELS, spans=spans, monkeypatch=monkeypatch)
    assert _reader(name).read(run) is not None
    run = _run("dsmoe16b.rag", KERNELS, spans=spans, monkeypatch=monkeypatch, dropped=1)
    assert _reader(name).read(run) is None
