#!/usr/bin/env python3
"""Time the 4 KiB round trip (a copy submitted through ``make_device`` and
waited for) under umwait and under spin with each way of idling between two
polls, to choose ``SpinWait._idle``.

    python3 tools/spin_wait_variants.py [--trips 400] [--rounds 3] [--device cpu]
        [--variants umwait,launch-wait,...] [--interleave] [--load N]

The variants: ``pass`` (the poll loop keeps the GIL; the PE thread that
launches the copy runs at the interpreter's switch interval, so it gets
fewer trips), ``sleep(0)``, ``sleep(1 us)``, ``sleep(10 us)``,
``os.sched_yield()``, ``launch-wait`` (while a PE worker is still
launching, block on its handle, as umwait parks; else ``sleep(0)``), and
``sleep(0)`` and ``launch-wait`` with the interpreter's switch interval
cut to 10 us for the spin trips (``sys.setswitchinterval``; 5 ms by
default), and ``event-sync`` (``launch-wait``, then, with every kernel
launched, block on their completion events: the CUDA driver's own poll,
with the GIL given up).  Each round runs every policy's trips in turn
(the order reversed every other round), or with ``--interleave`` one trip
of each in turn (the order rotated every trip), so that a change in the
host's load reaches every variant alike; one device per variant.
``--load N`` keeps N processes busy on the host's cores during the trips,
as a host shared with other work is (they are stopped at the end).  Prints each
variant's median, 90th percentile and mean, the host-free share spin billed
(it must stay 0) and one JSON object.  Runs on the card unless
``--device cpu``; exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def launch_wait(device):
    """Block on the PE workers still launching (they need the GIL); with
    none, give the GIL up once."""
    work, _ = device._inflight_work()
    if work:
        concurrent.futures.wait(work, return_when=concurrent.futures.FIRST_COMPLETED)
    else:
        time.sleep(0)


def event_sync(device):
    """Block on the PE workers still launching; with none, on the
    completion events of the launched kernels (the driver polls them, the
    GIL given up); with neither, give the GIL up once."""
    work, events = device._inflight_work()
    if work:
        concurrent.futures.wait(work, return_when=concurrent.futures.FIRST_COMPLETED)
    elif events:
        for ev in events:
            ev.synchronize()
    else:
        time.sleep(0)


def busy() -> None:
    """One host core kept busy until the process is stopped."""
    while True:
        pass


#: name -> (what the spin loop does between two polls, given the device;
#: the switch interval during the spin trips, None for the default)
VARIANTS = {
    "pass": (None, None),
    "sleep(0)": (lambda d: time.sleep(0), None),
    "sleep(1 us)": (lambda d: time.sleep(1e-6), None),
    "sleep(10 us)": (lambda d: time.sleep(1e-5), None),
    "sched_yield": (lambda d: os.sched_yield(), None),
    "launch-wait": (launch_wait, None),
    "sleep(0), switch 10 us": (lambda d: time.sleep(0), 1e-5),
    "launch-wait, switch 10 us": (launch_wait, 1e-5),
    "event-sync": (event_sync, None),
}
#: the pass variant waits for thread switches (~50-100 ms a trip)
PASS_TRIPS = 30


def idle_with(fn):
    def _idle(self, device, stats, deadline):
        if fn is None:
            return
        t0 = time.perf_counter()
        fn(device)
        stats.busy_s += time.perf_counter() - t0
    return _idle


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trips", type=int, default=400)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default=None)
    ap.add_argument("--variants", default=None,
                    help="comma-separated names (umwait and VARIANTS' keys); all by default")
    ap.add_argument("--interleave", action="store_true",
                    help="one trip of each variant in turn instead of a block each")
    ap.add_argument("--load", type=int, default=0,
                    help="host processes kept busy during the trips")
    args = ap.parse_args()
    from repro_torch.core import completion, make_device

    if args.device != "cpu" and not torch.cuda.is_available():
        print("spin_wait_variants: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0) if args.device != "cpu" else torch.device("cpu")
    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
    base_idle = completion.SpinWait._idle
    base_switch = sys.getswitchinterval()
    names = ["umwait"] + list(VARIANTS)
    if args.variants:
        names = args.variants.split(",")
        unknown = [n for n in names if n != "umwait" and n not in VARIANTS]
        if unknown:
            ap.error(f"unknown variants {unknown}")
    devices = {n: make_device(wait_policy="umwait" if n == "umwait" else "spin", device=dev)
               for n in names}
    x = torch.zeros(1024, dtype=torch.int32, device=dev)
    trips = {n: [] for n in names}

    def trip(name, n):
        switch = None
        if name != "umwait":
            fn, switch = VARIANTS[name]
            completion.SpinWait._idle = idle_with(fn)
        sys.setswitchinterval(switch or base_switch)
        d = devices[name]
        for _ in range(n):
            t0 = time.perf_counter()
            d.memcpy_async(x).wait()  # dsalint: disable=DSA106 — one copy a trip
            trips[name].append(time.perf_counter() - t0)

    ctx = multiprocessing.get_context("spawn")
    load = [ctx.Process(target=busy, daemon=True) for _ in range(args.load)]
    for p in load:
        p.start()
    try:
        for name in names:
            completion.SpinWait._idle = base_idle
            devices[name].memcpy_async(x).wait()  # dsalint: disable=DSA106 — warm-up
        for r in range(args.rounds):
            order = names if r % 2 == 0 else names[::-1]
            if not args.interleave:
                for name in order:
                    trip(name, PASS_TRIPS if name == "pass" else args.trips)
                continue
            for i in range(args.trips):
                for name in order[i % len(order):] + order[:i % len(order)]:
                    if name != "pass" or i < PASS_TRIPS:
                        trip(name, 1)
    finally:
        completion.SpinWait._idle = base_idle
        sys.setswitchinterval(base_switch)
        for p in load:
            p.terminate()
        for p in load:
            p.join()
    spin = completion.WaitStats()
    for name, d in devices.items():
        if name != "umwait":
            spin.merge(d.wait_stats["spin"])
    out = {"card": card, "device": str(dev), "spin_host_free_share": spin.host_free_frac,
           "interleave": args.interleave, "load": args.load, "ms": {}}
    print(f"4 KiB round trip on {card} ({dev}), {args.rounds} rounds, "
          f"{'interleaved' if args.interleave else 'in blocks'}, {args.load} busy processes:")
    for name, ts in trips.items():
        ts = sorted(ts)
        row = {"median": statistics.median(ts) * 1e3, "p90": ts[int(0.9 * len(ts))] * 1e3,
               "mean": statistics.mean(ts) * 1e3, "trips": len(ts)}
        out["ms"][name] = row
        print(f"  {name:26s} median {row['median']:.4f} ms, p90 {row['p90']:.4f}, "
              f"mean {row['mean']:.4f} ({len(ts)} trips)")
    print(f"spin's host-free share {spin.host_free_frac} (busy {spin.busy_s:.4f} s, "
          f"free {spin.free_s} s)")
    print(json.dumps(out))
    return 0 if spin.free_s == 0.0 else 1


if __name__ == "__main__":
    sys.exit(main())
