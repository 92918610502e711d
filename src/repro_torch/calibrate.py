"""Measure the card's constants for ``core/perfmodel.py``.

    PYTHONPATH=src python -m repro_torch.calibrate [--out calibrate.json]

Needs a CUDA card and exits non-zero without one.  Prints one JSON object
with the card's name and power limit and, for each constant, the value and
how it was measured:

  copy_bw_hbm      the port's memcpy kernel at 1 GiB (copied bytes / s)
  copy_bw_l2       the same kernel at 16 MiB, warm in the 50 MB L2
  h2d_bw, d2h_bw   pinned host <-> device copies of 256 MiB
  h2d_lat_s        a pinned 4-byte host -> device copy, event-timed
  launch_round_trip_s   one 4 KiB memcpy_words launch -> event -> host sees
                   it (median host time)
  ramp_bytes       s * (peak / bw(s) - 1) for the kernel's rate bw(s) at 1 MiB
                   (the size at which one descriptor reaches half the peak)
  per_pe_frac      one stream's rate at 64 MiB over the 1 GiB peak,
                   divided by the ramp at 64 MiB
  sw_copy_bw       Tensor.copy_ at 1 GiB
  sw_round_trip_s  one 4 KiB Tensor.copy_ -> event -> host (median)

Kernel times are CUDA-event times over back-to-back launches (median of
several windows); round trips are host clock times.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from repro_torch.kernels import memcpy as _mc

GiB = 1 << 30
MiB = 1 << 20
# upper bound of the host's time to enqueue one wrapper call, and a lower
# bound of the card's clock, for sizing the spin that holds the stream
HOST_CALL_S = 200e-6
SPIN_HZ = 1.0e9


def card() -> dict:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in out.split(","))
    return {"name": name, "power_limit": limit,
            "torch_name": torch.cuda.get_device_name(0)}


def event_ms(fn, reps: int, windows: int = 5) -> float:
    """Device time of one call of ``fn``: the median over ``windows`` of the
    mean CUDA-event time of ``reps`` back-to-back calls.  Each window first
    parks the stream in a spin kernel long enough for the host to enqueue
    every call, so the calls run back to back on the card and the host's
    per-call cost (tens of microseconds in Python) does not show as device
    time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(reps * HOST_CALL_S * SPIN_HZ))
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


def round_trip_s(fn, reps: int = 200) -> float:
    """Median host time of one call followed by waiting on an event."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        ev = torch.cuda.Event()
        t0 = time.perf_counter()
        fn()
        ev.record()
        ev.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def words(nbytes: int) -> torch.Tensor:
    return torch.empty(nbytes // 4, dtype=torch.uint32, device="cuda")


def measure() -> dict:
    res = {"card": card()}
    big = words(GiB)
    t = event_ms(lambda: _mc.memcpy_words(big), reps=5) * 1e-3
    peak = GiB / t
    res["copy_bw_hbm"] = peak
    l2 = words(16 * MiB)
    res["copy_bw_l2"] = 16 * MiB / (event_ms(lambda: _mc.memcpy_words(l2), reps=50) * 1e-3)
    one = words(MiB)
    bw_1m = MiB / (event_ms(lambda: _mc.memcpy_words(one), reps=200) * 1e-3)
    res["ramp_bytes"] = MiB * (peak / bw_1m - 1.0)
    mid = words(64 * MiB)
    bw_64m = 64 * MiB / (event_ms(lambda: _mc.memcpy_words(mid), reps=20) * 1e-3)
    ramp_64m = 64 * MiB / (64 * MiB + res["ramp_bytes"])
    res["per_pe_frac"] = min(bw_64m / (peak * ramp_64m), 1.0)
    del big

    host = torch.empty(256 * MiB, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(256 * MiB, dtype=torch.uint8, device="cuda")
    res["h2d_bw"] = 256 * MiB / (event_ms(lambda: dev.copy_(host, non_blocking=True), reps=5) * 1e-3)
    res["d2h_bw"] = 256 * MiB / (event_ms(lambda: host.copy_(dev, non_blocking=True), reps=5) * 1e-3)
    h4 = torch.empty(4, dtype=torch.uint8, pin_memory=True)
    d4 = torch.empty(4, dtype=torch.uint8, device="cuda")
    res["h2d_lat_s"] = event_ms(lambda: d4.copy_(h4, non_blocking=True), reps=100) * 1e-3

    small = words(4096)
    res["launch_round_trip_s"] = round_trip_s(lambda: _mc.memcpy_words(small))
    sdst = torch.empty_like(small)
    res["sw_round_trip_s"] = round_trip_s(lambda: sdst.copy_(small))
    a = torch.empty(GiB, dtype=torch.uint8, device="cuda")
    b = torch.empty_like(a)
    res["sw_copy_bw"] = GiB / (event_ms(lambda: b.copy_(a), reps=5) * 1e-3)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device; the constants are the card's", file=sys.stderr)
        return 1
    res = measure()
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
