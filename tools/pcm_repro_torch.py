"""pcm_repro on the PyTorch + CUDA port — live accelerator monitor,
mirroring Intel pcm-accel's CLI, over the engines on the card.

    PYTHONPATH=src python tools/pcm_repro_torch.py [target] [options]

target (one, like pcm-accel):
    -dsa            monitor the DSA-analogue stream engines (default)

options:
    -numa           lay the fabric out over 2 NUMA nodes and print the
                    per-node table (local vs cross traffic, link occupancy)
    -i <interval>   refresh interval in seconds (default 1.0)
    -n <frames>     stop after N refreshes (default: run for --duration)
    -csv [<path>]   also write the sampled time series as CSV (default
                    path results/obs/pcm_repro_torch.csv); the file is rewritten
                    every frame so a crash keeps the tail
    -silent         print only the measurement frames (no banner)
    --once          take a single sample of a short burst and exit — the
                    CI smoke mode (no live refresh, implies one frame)
    --duration S    workload length in seconds (default 5.0)
    --instances N   engine instances (per node when -numa; default 2)
    --trace [RATE]  attach a descriptor-lifecycle tracer (docs/tracing.md)
                    at the given sampling rate (default 1.0 when the flag
                    is bare); each frame then shows live per-phase
                    occupancy (seconds of phase time folded per wall
                    second) next to the engine table
    --device cpu    run the engines on the CPU (the kernels' plain
                    versions); the default is the card

Shutdown is exception-safe: stopping the workload / sampler during a
device teardown race prints a one-line note instead of a traceback and
the exit code stays 0 — monitors must never fail the run they observe.

Without an external workload the monitor drives its own: a fig2-style
mixed-size copy/CRC loop submitted through the device, so every frame has
traffic to show.  The display refreshes an engine x metric table in place
(ANSI home+clear), pcm-accel style; on exit the windowed p50/p95/max
summary is printed for the headline metrics.  The workload's copies
launch ``memcpy_words`` (a fused-doorbell burst too: one launch a
descriptor), its CRCs ``crc32_chunk_states``.
"""
from __future__ import annotations

import argparse
import sys
import threading
import time
from typing import List, Optional

sys.path.insert(0, "src")

import torch  # noqa: E402

from repro_torch.core import (  # noqa: E402
    OpType, QueueFull, Topology, WorkDescriptor, make_device)
from repro_torch.core.engine import resolve_device  # noqa: E402
from repro_torch.obs import PHASES, Sampler  # noqa: E402

DEFAULT_CSV = "results/obs/pcm_repro_torch.csv"
#: fig2-style transfer-size mix (bytes): small descriptors stress submit
#: overhead, large ones stress bandwidth — both ends of the paper's Fig. 2
WORKLOAD_SIZES = [4096, 65536, 1 << 20]


class BurstWorkload(threading.Thread):
    """Background fig2-style submitter: mixed-size memcpy/crc32 round-robin
    over the fabric (alternating home-node hints on -numa so cross-node
    traffic shows up) until stopped.  Its buffers live where the device's
    engines run, and the thread submits on that card."""

    def __init__(self, device, numa: bool):
        super().__init__(daemon=True, name="pcm-workload")
        self.device = device
        self.where = device.engines[0].device
        self.numa = numa
        self.stop_evt = threading.Event()
        n_nodes = device.topology.n_nodes if numa else 1
        # one buffer set per node, registered to its home so the locality
        # registry (not just the submit hint) drives src_node stamping
        self.bufs = []
        for nid in range(n_nodes):
            per_node = [torch.zeros((max(size // 512, 1), 128), dtype=torch.float32,
                                    device=self.where)
                        for size in WORKLOAD_SIZES]
            if numa:
                for b in per_node:
                    device.register(b, node=nid)
            self.bufs.append(per_node)
        self.submitted = 0

    def burst(self, n: int = 8) -> None:
        """Submit one burst of n descriptors and retire them.  Alternating
        bursts go through the fused ``submit_many`` doorbell, so the SUB/s
        and FUSED% columns show both submission paths live."""
        futs = []
        if (self.submitted // max(n, 1)) % 2 == 0:
            # fused burst: homogeneous copies through one doorbell
            descs = []
            for i in range(n):
                k = self.submitted + i
                buf = self.bufs[k % len(self.bufs)][k % len(WORKLOAD_SIZES)]
                descs.append(WorkDescriptor(op=OpType.MEMCPY, src=buf))
            try:
                futs = self.device.submit_many(descs)
            except QueueFull:
                time.sleep(0.001)  # backpressure: let the PEs catch up
        else:
            for i in range(n):
                k = self.submitted + i
                home = k % len(self.bufs)
                buf = self.bufs[home][k % len(WORKLOAD_SIZES)]
                node = None
                if self.numa:
                    # a quarter of the ops are placed on the remote node (in
                    # both directions) — the engine reads across the link,
                    # lighting up the CROSS-GB/s column
                    node = (1 - home) % self.device.topology.n_nodes \
                        if k % 8 in (1, 6) else home
                try:
                    if k % 4 == 3:
                        futs.append(self.device.crc32_async(buf, node=node))
                    else:
                        futs.append(self.device.memcpy_async(buf, node=node))
                except QueueFull:
                    time.sleep(0.001)  # backpressure: let the PEs catch up
        self.submitted += len(futs)
        if futs:
            self.device.wait_all(futs)

    def run(self) -> None:
        if self.where.type == "cuda":
            torch.cuda.set_device(self.where)  # a new thread starts on card 0
        while not self.stop_evt.is_set():
            self.burst()

    def stop(self) -> None:
        self.stop_evt.set()
        self.join(timeout=10.0)
        self.device.drain()


def _cell(row: dict, key: str, fmt: str = "{:.2f}", default: str = "-") -> str:
    v = row.get(key)
    return default if v is None else fmt.format(v)


def render_frame(sampler: Sampler, device, numa: bool, frame: int) -> str:
    """One engine x metric table (plus the per-node table on -numa) from
    the latest tick's row — the pcm-accel refresh unit."""
    rows = sampler.rows()
    row = rows[-1] if rows else {}
    lines: List[str] = []
    lines.append(f"pcm_repro frame {frame}  t={row.get('time_s', 0.0):7.2f}s  "
                 f"interval={row.get('dt_s', 0.0):.2f}s")
    hdr = (f"{'ENGINE':<10s} {'NODE':>4s} {'GB/s':>8s} {'OPS/s':>9s} "
           f"{'SUB/s':>9s} {'FUSED%':>6s} "
           f"{'UTIL':>6s} {'WQ-OCC':>6s} {'QDELAY-us':>9s} {'RETRY':>6s} "
           f"{'ERR':>4s}")
    lines.append(hdr)
    lines.append("-" * len(hdr))
    dt = max(row.get("dt_s", 1.0), 1e-9)
    for e in device.engines:
        n = e.name
        ops_s = row.get(f"engine.{n}.ops", 0.0) / dt
        fused = row.get(f"engine.{n}.fused_frac")
        lines.append(
            f"{n:<10s} {getattr(e, 'node_id', 0):>4d} "
            f"{_cell(row, f'engine.{n}.gbps'):>8s} {ops_s:>9.1f} "
            f"{_cell(row, f'engine.{n}.submits_per_s', '{:.1f}'):>9s} "
            f"{('-' if fused is None else f'{fused:.0%}'):>6s} "
            f"{_cell(row, f'engine.{n}.util'):>6s} "
            f"{_cell(row, f'engine.{n}.wq_occupancy'):>6s} "
            f"{_cell(row, f'engine.{n}.queue_delay_us', '{:.1f}'):>9s} "
            f"{_cell(row, f'engine.{n}.retries', '{:.0f}'):>6s} "
            f"{_cell(row, f'engine.{n}.errors', '{:.0f}'):>4s}"
        )
    if numa:
        lines.append("")
        nhdr = (f"{'NODE':<6s} {'LOCAL-GB/s':>10s} {'CROSS-GB/s':>10s} "
                f"{'LINK-OCC':>8s}  ENGINES")
        lines.append(nhdr)
        lines.append("-" * len(nhdr))
        for node in device.topology.nodes:
            nid = node.node_id
            engines = ",".join(e.name for e in device.engines_on(nid))
            occ = row.get(f"node.{nid}.link_occupancy")
            lines.append(
                f"{nid:<6d} {_cell(row, f'node.{nid}.local_gbps'):>10s} "
                f"{_cell(row, f'node.{nid}.cross_gbps'):>10s} "
                f"{('-' if occ is None else f'{occ:.1%}'):>8s}  {engines}"
            )
    waits = sorted({k.split(".")[1] for k in row if k.startswith("wait.")})
    for pname in waits:
        frac = row.get(f"wait.{pname}.host_free_frac")
        lines.append(
            f"wait/{pname}: host_free="
            f"{('-' if frac is None else f'{frac:.1%}')} "
            f"wakes={row.get(f'wait.{pname}.wakes', 0):.0f} "
            f"irqs={row.get(f'wait.{pname}.irqs', 0):.0f}"
        )
    lines.append(
        f"pressure: backoff_retries={row.get('device.backoff_retries', 0):.0f} "
        f"queue_full={row.get('device.queue_full', 0):.0f}"
    )
    if any(k.startswith("trace.") for k in row):
        parts = [f"sampled=+{row.get('trace.sampled', 0):.0f}"]
        for phase in PHASES:
            occ = row.get(f"trace.phase.{phase}.occupancy")
            if occ:
                parts.append(f"{phase}={occ:.1%}")
        lines.append("trace: " + " ".join(parts))
    return "\n".join(lines)


def shutdown_quietly(*stoppables) -> None:
    """Stop monitors/workloads without letting a teardown race (sampler
    thread vs device drain) turn into a traceback — the monitor must not
    fail the run it observes."""
    for s in stoppables:
        try:
            s.stop()
        except Exception as exc:  # noqa: BLE001 — deliberate: exit clean
            print(f"pcm_repro: shutdown note ({type(s).__name__}): {exc!r}",
                  file=sys.stderr)


def print_summary(sampler: Sampler) -> None:
    print("\nwindow summary (p50/p95/max per metric):")
    summary = sampler.summary()
    for name, s in summary.items():
        if not any(name.endswith(k) for k in
                   (".gbps", ".util", ".wq_occupancy", ".queue_delay_us",
                    ".host_free_frac", ".link_occupancy")):
            continue
        if s["n"] == 0 or (s["max"] == 0 and s["p95"] == 0):
            continue
        print(f"  {name:<40s} p50={s['p50']:>10.3f} p95={s['p95']:>10.3f} "
              f"max={s['max']:>10.3f}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="pcm_repro_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-dsa", action="store_true", default=True,
                    help="monitor the DSA-analogue engines (default target)")
    ap.add_argument("-numa", action="store_true",
                    help="2-node fabric + per-node traffic table")
    ap.add_argument("-i", type=float, default=1.0, metavar="INTERVAL",
                    help="refresh interval seconds (default 1.0)")
    ap.add_argument("-n", type=int, default=0, metavar="FRAMES",
                    help="stop after N frames (0 = run for --duration)")
    ap.add_argument("-csv", nargs="?", const=DEFAULT_CSV, default=None,
                    metavar="PATH", help=f"write CSV (default {DEFAULT_CSV})")
    ap.add_argument("-silent", action="store_true",
                    help="measurement frames only, no banner")
    ap.add_argument("--once", action="store_true",
                    help="single burst + single frame, no live refresh (CI)")
    ap.add_argument("--duration", type=float, default=5.0,
                    help="workload duration seconds (default 5.0)")
    ap.add_argument("--instances", type=int, default=2,
                    help="engine instances (per node with -numa)")
    ap.add_argument("--trace", nargs="?", const=1.0, default=None,
                    type=float, metavar="RATE",
                    help="descriptor-lifecycle tracing at RATE (default 1.0)")
    ap.add_argument("--device", default=None,
                    help="where the engines run: the card by default, 'cpu' for the CPU")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    topo = (Topology.symmetric(2, engines_per_node=args.instances)
            if args.numa else None)
    device = make_device(n_instances=args.instances, topology=topo,
                         policy="numa_local" if args.numa else "round_robin",
                         trace=args.trace, device=dev)
    sampler = Sampler(device, interval_s=args.i)
    if not args.silent:
        names = ", ".join(e.name for e in device.engines)
        print(f"pcm_repro: monitoring {len(device.engines)} DSA-analogue "
              f"instance(s) [{names}] over {device.topology!r}", flush=True)

    workload = BurstWorkload(device, numa=args.numa)
    if args.once:
        workload.burst(16)
        device.drain()
        sampler.tick()
        print(render_frame(sampler, device, args.numa, frame=1))
        if args.csv:
            sampler.to_csv(args.csv)
            if not args.silent:
                print(f"wrote {args.csv}")
        return 0

    workload.start()
    live = sys.stdout.isatty()
    deadline = time.perf_counter() + args.duration
    frame = 0
    try:
        while (args.n and frame < args.n) or (not args.n and
                                              time.perf_counter() < deadline):
            time.sleep(args.i)
            sampler.tick()
            frame += 1
            text = render_frame(sampler, device, args.numa, frame)
            if live:
                sys.stdout.write("\x1b[H\x1b[2J")  # home + clear, in-place
            print(text, flush=True)
            if args.csv:
                sampler.to_csv(args.csv)  # rewrite: crash keeps the tail
    except KeyboardInterrupt:
        pass
    finally:
        shutdown_quietly(workload, sampler)
    if sampler.error is not None:
        # a tick raced device teardown: report it, keep the exit clean
        print(f"pcm_repro: sampler note: {sampler.error!r}", file=sys.stderr)
    if args.csv:
        try:
            sampler.to_csv(args.csv)
            if not args.silent:
                print(f"wrote {args.csv}")
        except Exception as exc:  # noqa: BLE001 — deliberate: exit clean
            print(f"pcm_repro: csv note: {exc!r}", file=sys.stderr)
    if not args.silent:
        print_summary(sampler)
    return 0


if __name__ == "__main__":
    sys.exit(main())
