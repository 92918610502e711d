"""trace_view on the PyTorch + CUDA port — descriptor-lifecycle trace
inspector and Perfetto exporter, on the card.

    PYTHONPATH=src python tools/trace_view_torch.py [options]

Runs a short traced workload (or just analyzes), then prints the span
summary table, the top-K slowest descriptors, the critical-path report,
and the host-free cross-check (span-derived vs WaitStats-derived — the
paper's Fig. 11 attribution, reconciled two ways).

options:
    --workload {burst,openloop}
                    burst (default): fig2-style mixed-size copies with
                    after= dependency chains and a then() continuation per
                    chain, so the trace exercises every edge kind.
                    openloop: a short VhostStyleServer open-loop run
                    (NullDecoder) — request-scoped trace contexts.
    --rate R        sampling rate in [0, 1] (default 1.0 = every descriptor)
    --descriptors N burst size for --workload burst (default 64)
    --horizon S     virtual horizon for --workload openloop (default 0.5)
    --top K         slowest-descriptor table depth (default 5)
    --perfetto PATH also export trace_event JSON (chrome://tracing /
                    ui.perfetto.dev loadable)
    --check         validate the run: every lifecycle phase present on
                    sampled describe-traces, Perfetto output is strict
                    JSON with ts/dur >= 0, and span-derived host-free
                    agrees with WaitStats within 5%.  Exit nonzero on any
                    failure (the CI trace-smoke gate).
    --json          emit the analysis as JSON instead of tables
    --device cpu    run the workload on the CPU (the kernels' plain
                    versions); the default is the card

The burst launches ``memcpy_words`` and ``crc32_chunk_states`` (with its
fold where a chunk spans several sub-chunks); openloop's prompt copies (of
4-32 tokens, one chunk each) launch ``memcpy_words``.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

sys.path.insert(0, "src")

import torch  # noqa: E402

from repro_torch.core import QueueFull, make_device  # noqa: E402
from repro_torch.core.engine import resolve_device  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    PHASES,
    critical_path,
    host_free_fraction,
    phase_breakdown,
    slowest,
    to_perfetto,
)

#: fig2-style transfer sizes (bytes) for the burst workload
SIZES = [4096, 65536, 1 << 20]


# --------------------------------------------------------------------- workloads
def run_burst(rate: float, n: int, dev: torch.device):
    """Mixed-size copy/CRC burst with after= chains and then() tails."""
    device = make_device(n_instances=2, trace=rate, device=dev)
    bufs = [torch.zeros((max(s // 512, 1), 128), dtype=torch.float32, device=dev)
            for s in SIZES]
    futs = []
    prev = None
    for i in range(n):
        buf = bufs[i % len(SIZES)]
        after = [prev] if prev is not None and i % 4 == 1 else None
        try:
            if i % 4 == 3:
                fut = device.crc32_async(buf, after=after)
            else:
                fut = device.memcpy_async(buf, after=after)
        except QueueFull:
            device.wait_all(futs)
            futs = []
            continue
        if i % 8 == 2:
            futs.append(fut.then(lambda r: r))  # host continuation span
        futs.append(fut)
        prev = fut
    if futs:
        device.wait_all(futs)
    device.drain()
    return device


def run_openloop(rate: float, horizon_s: float, dev: torch.device):
    """Short open-loop serving run with request-scoped trace contexts."""
    from repro_torch.serving import (
        AdmissionController,
        LatencyTracker,
        NullDecoder,
        PoissonArrivals,
        TrafficGenerator,
        VhostStyleServer,
        ZipfLengths,
    )

    device = make_device(n_instances=2, trace=rate, device=dev)
    server = VhostStyleServer(
        NullDecoder(64, device=dev), {}, slots=4, max_cache_len=128, device=device,
        admission=AdmissionController(), tracker=LatencyTracker())
    traffic = TrafficGenerator(
        PoissonArrivals(rate_rps=200.0, seed=7),
        prompt_lengths=ZipfLengths(lo=4, hi=32),
        output_lengths=ZipfLengths(lo=1, hi=8), seed=7)
    server.run_open_loop(traffic, horizon_s, step_s=0.01)
    device.drain()
    return device


# --------------------------------------------------------------------- reports
def summary_report(tracer) -> dict:
    return {
        "phases": phase_breakdown(tracer),
        "critical_path": critical_path(tracer),
        "host_free": host_free_cross_check(tracer),
        "slowest": [
            {"desc_id": dt.desc_id, "trace_id": dt.trace_id, "op": dt.op,
             "duration_s": dt.duration_s}
            for dt in slowest(tracer)
        ],
        "n_traces": len(tracer.traces()),
        "n_edges": len(tracer.edges()),
    }


def host_free_cross_check(tracer) -> dict:
    """Host-free fraction two ways: from the tracer's wait-span counters
    (span-derived) and from the same numbers WaitPolicy billed into the
    device WaitStats buckets — identical by construction, so any drift
    flags an instrumentation bug."""
    spans_frac = host_free_fraction(tracer)
    busy = free = 0.0
    for w in tracer.wait_spans():
        busy += w.busy_s
        free += w.free_s
    total = busy + free
    waitstats_frac = (free / total) if total > 0 else None
    delta = (abs(spans_frac - waitstats_frac)
             if spans_frac is not None and waitstats_frac is not None
             else None)
    return {"spans": spans_frac, "waitstats": waitstats_frac, "delta": delta}


def print_report(report: dict, top: int) -> None:
    print("phase breakdown:")
    hdr = (f"  {'PHASE':<16s} {'COUNT':>6s} {'MEAN-us':>9s} {'P95-us':>9s} "
           f"{'TOTAL-ms':>9s} {'SHARE':>6s}")
    print(hdr)
    print("  " + "-" * (len(hdr) - 2))
    for phase in PHASES:
        s = report["phases"].get(phase)
        if not s or not s["count"]:
            continue
        print(f"  {phase:<16s} {int(s['count']):>6d} {s['mean_s'] * 1e6:>9.2f} "
              f"{s['p95_s'] * 1e6:>9.2f} {s['total_s'] * 1e3:>9.3f} "
              f"{s['share']:>6.1%}")

    cp = report["critical_path"]
    if cp["chain"]:
        print(f"\ncritical path: {len(cp['chain'])} descriptor(s) "
              f"[{' -> '.join(str(d) for d in cp['chain'])}], "
              f"{cp['total_s'] * 1e3:.3f} ms on-path of "
              f"{cp['elapsed_s'] * 1e3:.3f} ms elapsed")
        for phase in PHASES:
            sec = cp["phases"].get(phase, 0.0)
            if sec > 0:
                print(f"  {phase:<16s} {sec * 1e3:>9.3f} ms "
                      f"{cp['shares'].get(phase, 0.0):>6.1%}")

    hf = report["host_free"]
    if hf["spans"] is not None:
        print(f"\nhost-free fraction: spans={hf['spans']:.4f} "
              f"waitstats={hf['waitstats']:.4f} delta={hf['delta']:.2e}")
    else:
        print("\nhost-free fraction: no wait spans recorded")

    if report["slowest"]:
        print(f"\nslowest descriptors (top {top}):")
        for row in report["slowest"][:top]:
            print(f"  desc {row['desc_id']:<6d} {row['op']:<14s} "
                  f"trace={row['trace_id']:<12s} "
                  f"{row['duration_s'] * 1e3:.3f} ms")
    print(f"\n{report['n_traces']} trace(s), {report['n_edges']} edge(s)")


# --------------------------------------------------------------------- checks
def run_checks(tracer, report: dict, perfetto_text: Optional[str]) -> List[str]:
    """Return a list of failure strings (empty == pass)."""
    fails: List[str] = []
    if not tracer.traces():
        fails.append("no traces retained")
    full = [dt for dt in tracer.traces()
            if dt.attrs.get("kind") != "then" and "error" not in dt.attrs]
    for dt in full:
        missing = [p for p in PHASES if p not in dt.phase_durations()]
        if missing:
            fails.append(f"desc {dt.desc_id}: missing phases {missing}")
    hf = report["host_free"]
    if hf["delta"] is None:
        fails.append("host-free cross-check impossible (no wait spans)")
    elif hf["spans"] and hf["delta"] > 0.05 * max(hf["spans"], 1e-12):
        fails.append(f"host-free drift {hf['delta']:.3e} exceeds 5% "
                     f"of {hf['spans']:.4f}")
    if perfetto_text is not None:
        try:
            doc = json.loads(perfetto_text)
        except ValueError as exc:
            fails.append(f"perfetto output is not strict JSON: {exc}")
        else:
            events = doc.get("traceEvents", [])
            if not events:
                fails.append("perfetto output has no traceEvents")
            for ev in events:
                if ev.get("ts", 0) < 0:
                    fails.append(f"negative ts in event {ev.get('name')}")
                if ev.get("dur", 0) < 0:
                    fails.append(f"negative dur in event {ev.get('name')}")
            slice_names = {ev["name"] for ev in events if ev.get("ph") == "X"}
            missing = [p for p in PHASES if p not in slice_names]
            if full and missing:
                fails.append(f"perfetto slices missing phases {missing}")
    return fails


# --------------------------------------------------------------------- main
def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="trace_view_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", choices=("burst", "openloop"),
                    default="burst")
    ap.add_argument("--rate", type=float, default=1.0,
                    help="sampling rate in [0, 1] (default 1.0)")
    ap.add_argument("--descriptors", type=int, default=64,
                    help="burst size (default 64)")
    ap.add_argument("--horizon", type=float, default=0.5,
                    help="openloop virtual horizon seconds (default 0.5)")
    ap.add_argument("--top", type=int, default=5,
                    help="slowest-descriptor table depth (default 5)")
    ap.add_argument("--perfetto", metavar="PATH", default=None,
                    help="write trace_event JSON to PATH")
    ap.add_argument("--check", action="store_true",
                    help="validate phases/Perfetto/host-free; nonzero on fail")
    ap.add_argument("--json", action="store_true",
                    help="emit the analysis as JSON")
    ap.add_argument("--device", default=None,
                    help="where the engines run: the card by default, 'cpu' for the CPU")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.workload == "burst":
        device = run_burst(args.rate, args.descriptors, dev)
    else:
        device = run_openloop(args.rate, args.horizon, dev)
    tracer = device.tracer

    report = summary_report(tracer)
    perfetto_text = None
    if args.perfetto or args.check:
        perfetto_text = to_perfetto(tracer, args.perfetto)
        if args.perfetto and not args.json:
            print(f"wrote {args.perfetto}", file=sys.stderr)

    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True, default=str))
    else:
        print_report(report, args.top)

    if args.check:
        fails = run_checks(tracer, report, perfetto_text)
        if fails:
            for f in fails:
                print(f"CHECK FAIL: {f}", file=sys.stderr)
            return 1
        print("all trace checks passed", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
