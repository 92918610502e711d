"""The port's spin wait: it blocks on a PE worker that is still launching
and gives the GIL up between its polls of the completion events, so the
worker runs at once instead of at the interpreter's switch interval, and it
still bills every waited second busy (Fig. 11's accounting: spin's
host-free share is 0).  On the CPU the PE thread computes the copy; it
needs the GIL just as it does to launch the kernel on the card (phase 3e of
chip_smoke.py and tools/spin_wait_variants.py time the policies there).
"""
import concurrent.futures
import statistics
import threading
import time

import pytest
import torch

from repro_torch.core import completion, make_device
from repro_torch.obs import host_free_fraction

N_TRIPS = 40
#: a spin round trip that waited for a thread switch took ~100 ms on the
#: CPU (5 ms switches, ~20 of them); one that yields takes well under 1 ms
ROUND_TRIP_LIMIT_S = 0.02


def test_spin_bills_every_waited_second_busy():
    device = make_device(wait_policy="spin", trace=1.0, device="cpu")
    x = torch.arange(1 << 16, dtype=torch.int32)
    futs = [device.memcpy_async(x) for _ in range(8)]
    device.wait_all(futs)
    for _ in range(8):
        f = device.memcpy_async(x)  # dsalint: disable=DSA106 — one copy a trip
        f.wait()
        futs.append(f)
    assert all(torch.equal(f.result(), x) for f in futs)
    st = device.wait_stats["spin"]
    assert st.waits >= 9 and st.polls >= st.waits
    assert st.free_s == 0.0 and st.busy_s > 0.0
    assert st.host_free_frac == 0.0
    assert host_free_fraction(device.tracer) == 0.0
    spans = device.tracer.wait_spans()
    assert len(spans) == st.waits and all(s.free_s == 0.0 and s.busy_s > 0.0 for s in spans)


class _Launching:
    """A device stub whose PE workers are launching ``work``."""

    def __init__(self, work=()):
        self.work = list(work)

    def _inflight_work(self):
        return [w for w in self.work if not w.done()], []


def test_spin_gives_up_the_gil_between_polls_and_bills_it_busy(monkeypatch):
    """With every kernel launched, an idle step of the poll loop is one
    ``time.sleep(0)``, and the time it takes is added to ``busy_s``."""
    calls = []
    real_sleep = time.sleep

    def sleep(s):
        calls.append(s)
        real_sleep(0.001)

    monkeypatch.setattr(completion.time, "sleep", sleep)
    stats = completion.WaitStats()
    completion.SpinWait()._idle(_Launching(), stats, None)
    assert calls == [0]
    assert stats.busy_s >= 0.001 and stats.free_s == 0.0


def test_spin_blocks_on_a_launching_pe_worker_and_bills_it_busy():
    """While a PE worker is still launching, the idle step blocks on its
    handle until the launch is done (or the deadline), billed busy."""
    launch = concurrent.futures.Future()
    threading.Timer(0.02, launch.set_result, (None,)).start()
    stats = completion.WaitStats()
    completion.SpinWait()._idle(_Launching([launch]), stats, None)
    assert launch.done() and stats.busy_s >= 0.015 and stats.free_s == 0.0
    stuck = concurrent.futures.Future()
    t0 = time.perf_counter()
    completion.SpinWait()._idle(_Launching([stuck]), stats, t0 + 0.01)
    assert 0.005 < time.perf_counter() - t0 < 1.0 and not stuck.done()
    assert stats.free_s == 0.0


@pytest.mark.parametrize("wait_policy", ["spin", "umwait"])
def test_a_4k_round_trip_does_not_wait_for_a_thread_switch(wait_policy):
    """The median 4 KiB copy submitted and waited for under the policy stays
    far below one that waits for the PE thread's turn at the GIL."""
    device = make_device(wait_policy=wait_policy, device="cpu")
    x = torch.zeros(1024, dtype=torch.int32)
    device.memcpy_async(x).wait()
    trips = []
    for _ in range(N_TRIPS):
        t0 = time.perf_counter()
        device.memcpy_async(x).wait()  # dsalint: disable=DSA106 — one copy a trip
        trips.append(time.perf_counter() - t0)
    assert statistics.median(trips) < ROUND_TRIP_LIMIT_S, trips
    st = device.wait_stats[wait_policy]
    if wait_policy == "spin":
        assert st.free_s == 0.0
