"""Open-loop traffic engine: arrival processes and workload synthesis.

The paper's DPDK Vhost case study (§6) measures the serving datapath under
*sustained packet arrival* — an open loop where requests keep coming whether
or not the server is keeping up — not a pre-built request list replayed in
closed loop.  This module is that traffic source for the Vhost-style
serving pipeline:

  ArrivalProcess   a seeded, deterministic generator of absolute arrival
                   times on a VIRTUAL clock.  Re-iterating a process (or
                   re-seeding an identical one) draws the identical trace,
                   which is what makes the statistical test harness and the
                   overload soak tests reproducible.

    PoissonArrivals   memoryless arrivals at a constant rate (CV^2 = 1),
                      the baseline every queueing result assumes.
    BurstyArrivals    MMPP-style on-off modulation: dwell times are
                      exponential, arrivals within a state are Poisson at
                      that state's rate.  CV^2 > 1 — the bursty traffic
                      that actually breaks naive admission.
    DiurnalArrivals   sinusoidal rate ramp (trough -> peak -> trough per
                      period) via Lewis-Shedler thinning, the
                      millions-of-users daily cycle compressed onto the
                      virtual clock.

  ZipfLengths      bounded Zipf-distributed request lengths (rank-based:
                   short requests common, long-tail heavy), used for both
                   context and output lengths.

  TrafficGenerator arrival process x length distributions x SLO-class mix
                   -> a deterministic trace of OpenRequest records, each
                   carrying its arrival time, SLO class, and lengths.

Statistical helpers (``interarrival_stats``, ``zipf_tail_slope``) are the
assertion vocabulary of tests/test_traffic.py; benchmarks reuse them so the
generator's properties are checked in the same terms they were specified.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


# --------------------------------------------------------------------------- arrival processes
class ArrivalProcess:
    """Seeded generator of absolute arrival times (virtual seconds).

    ``times(horizon_s)`` yields strictly increasing floats in
    ``[0, horizon_s)``.  Every call re-seeds an identical stream: same
    process + same seed => identical trace, independent of how many other
    processes drew randomness in between (each process owns its rng)."""

    name = "base"

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def _rng(self) -> np.random.Generator:
        return np.random.default_rng(self.seed)

    def times(self, horizon_s: float) -> Iterator[float]:
        raise NotImplementedError

    def rate_at(self, t: float) -> Optional[float]:
        """Instantaneous offered rate (requests/s) at virtual time ``t``,
        when the process defines one (diurnal does; stationary processes
        return their mean rate)."""
        return None

    def mean_rate(self) -> float:
        """Long-run offered rate in requests/s."""
        raise NotImplementedError


class PoissonArrivals(ArrivalProcess):
    """Constant-rate Poisson process: i.i.d. exponential inter-arrivals."""

    name = "poisson"

    def __init__(self, rate_rps: float, seed: int = 0):
        super().__init__(seed)
        if rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
        self.rate_rps = float(rate_rps)

    def times(self, horizon_s: float) -> Iterator[float]:
        rng = self._rng()
        t = 0.0
        while True:
            t += rng.exponential(1.0 / self.rate_rps)
            if t >= horizon_s:
                return
            yield t

    def rate_at(self, t: float) -> float:
        return self.rate_rps

    def mean_rate(self) -> float:
        return self.rate_rps


class BurstyArrivals(ArrivalProcess):
    """Two-state MMPP (on-off modulated Poisson): exponential dwell times,
    Poisson arrivals at ``on_rps`` inside a burst and ``off_rps`` between
    bursts.  Memorylessness makes the event-driven simulation exact: a gap
    drawn at the current state's rate that would cross the state boundary
    is discarded and redrawn from the boundary.

    The squared coefficient of variation of inter-arrivals exceeds 1
    whenever ``on_rps != off_rps`` — the burstiness the property tests pin.
    """

    name = "bursty"

    def __init__(self, on_rps: float, off_rps: float = 0.0,
                 mean_on_s: float = 1.0, mean_off_s: float = 1.0,
                 seed: int = 0):
        super().__init__(seed)
        if on_rps <= 0:
            raise ValueError(f"on_rps must be > 0, got {on_rps}")
        if off_rps < 0:
            raise ValueError(f"off_rps must be >= 0, got {off_rps}")
        if mean_on_s <= 0 or mean_off_s <= 0:
            raise ValueError("mean_on_s and mean_off_s must be > 0")
        self.on_rps = float(on_rps)
        self.off_rps = float(off_rps)
        self.mean_on_s = float(mean_on_s)
        self.mean_off_s = float(mean_off_s)

    def times(self, horizon_s: float) -> Iterator[float]:
        rng = self._rng()
        t = 0.0
        on = True  # start inside a burst so short horizons still see traffic
        state_end = rng.exponential(self.mean_on_s)
        while t < horizon_s:
            rate = self.on_rps if on else self.off_rps
            if rate <= 0:
                # silent state: jump straight to the next burst
                t = state_end
                on = not on
                state_end = t + rng.exponential(
                    self.mean_on_s if on else self.mean_off_s)
                continue
            gap = rng.exponential(1.0 / rate)
            if t + gap >= state_end:
                # arrival would land past the state switch: restart the
                # (memoryless) draw from the boundary in the next state
                t = state_end
                on = not on
                state_end = t + rng.exponential(
                    self.mean_on_s if on else self.mean_off_s)
                continue
            t += gap
            if t >= horizon_s:
                return
            yield t

    def mean_rate(self) -> float:
        w_on = self.mean_on_s / (self.mean_on_s + self.mean_off_s)
        return self.on_rps * w_on + self.off_rps * (1.0 - w_on)

    def rate_at(self, t: float) -> float:
        return self.mean_rate()  # stationary mean; per-state rate is random


class DiurnalArrivals(ArrivalProcess):
    """Sinusoidal rate ramp between ``trough_rps`` and ``peak_rps`` with the
    given period, sampled by Lewis-Shedler thinning of a ``peak_rps``
    homogeneous process.  ``rate_at(t)`` is the exact intensity, so tests
    can check that windowed arrival counts track the ramp."""

    name = "diurnal"

    def __init__(self, peak_rps: float, trough_rps: float,
                 period_s: float, seed: int = 0, phase: float = 0.0):
        super().__init__(seed)
        if peak_rps <= 0 or not 0 <= trough_rps <= peak_rps:
            raise ValueError(
                f"need 0 <= trough_rps <= peak_rps and peak_rps > 0; "
                f"got trough={trough_rps} peak={peak_rps}")
        if period_s <= 0:
            raise ValueError(f"period_s must be > 0, got {period_s}")
        self.peak_rps = float(peak_rps)
        self.trough_rps = float(trough_rps)
        self.period_s = float(period_s)
        self.phase = float(phase)

    def rate_at(self, t: float) -> float:
        # trough at t=0 (+phase), peak at half period
        x = 2.0 * math.pi * (t / self.period_s) + self.phase
        return self.trough_rps + (self.peak_rps - self.trough_rps) * 0.5 * (
            1.0 - math.cos(x))

    def times(self, horizon_s: float) -> Iterator[float]:
        rng = self._rng()
        t = 0.0
        while True:
            t += rng.exponential(1.0 / self.peak_rps)
            if t >= horizon_s:
                return
            if rng.uniform() * self.peak_rps < self.rate_at(t):
                yield t

    def mean_rate(self) -> float:
        return 0.5 * (self.peak_rps + self.trough_rps)


# --------------------------------------------------------------------------- length distribution
class ZipfLengths:
    """Bounded Zipf over the integer lengths ``[lo, hi]``: rank 1 (= ``lo``)
    is the most likely, and P(rank k) ~ k**-s.  Real request logs are
    heavy-tailed in exactly this way (short prompts dominate, the tail
    carries the bytes), and the bound keeps the KV budget finite.

    The pmf is materialized once, so sampling is one ``rng.choice`` and the
    tail slope is available in closed form for the property tests."""

    def __init__(self, s: float = 1.1, lo: int = 1, hi: int = 1024):
        if not lo >= 1:
            raise ValueError(f"lo must be >= 1, got {lo}")
        if not hi >= lo:
            raise ValueError(f"need hi >= lo, got [{lo}, {hi}]")
        if s <= 0:
            raise ValueError(f"s must be > 0, got {s}")
        self.s = float(s)
        self.lo = int(lo)
        self.hi = int(hi)
        ranks = np.arange(1, self.hi - self.lo + 2, dtype=np.float64)
        w = ranks ** -self.s
        self._pmf = w / w.sum()
        self._values = np.arange(self.lo, self.hi + 1, dtype=np.int64)

    def sample(self, n: int, rng: np.random.Generator) -> np.ndarray:
        return rng.choice(self._values, size=n, p=self._pmf)

    def pmf(self) -> np.ndarray:
        return self._pmf.copy()

    def mean(self) -> float:
        return float((self._values * self._pmf).sum())


# --------------------------------------------------------------------------- generated trace
@dataclasses.dataclass(frozen=True)
class OpenRequest:
    """One generated arrival, before materialization into a serving Request:
    when it lands, what SLO class it belongs to, and how big it is."""

    req_id: int
    arrival_s: float
    slo: str
    prompt_len: int
    max_new_tokens: int

    def materialize(self, vocab_size: int = 256):
        """Build the serving-pipeline Request for this arrival.  The prompt
        is keyed by req_id, so the same trace always materializes the same
        token streams."""
        from repro_torch.serving.pipeline import Request

        rng = np.random.default_rng(0xC0FFEE ^ self.req_id)
        return Request(
            req_id=self.req_id,
            prompt=rng.integers(0, vocab_size, self.prompt_len).astype(np.int32),
            max_new_tokens=self.max_new_tokens,
            slo=self.slo,
            arrival_s=self.arrival_s,
        )


class TrafficGenerator:
    """Arrival process x Zipf lengths x SLO-class mix -> deterministic trace.

    Independent child seeds (``np.random.SeedSequence.spawn``) drive the
    class and length draws, so the arrival process, the class mix, and the
    length marginals each see their own stream: changing one knob never
    perturbs the others' draws — the property the same-seed tests pin.
    """

    def __init__(self, arrivals: ArrivalProcess, *,
                 prompt_lengths: Optional[ZipfLengths] = None,
                 output_lengths: Optional[ZipfLengths] = None,
                 class_mix: Optional[Dict[str, float]] = None,
                 seed: int = 0):
        self.arrivals = arrivals
        self.prompt_lengths = prompt_lengths or ZipfLengths(s=1.1, lo=8, hi=256)
        self.output_lengths = output_lengths or ZipfLengths(s=1.2, lo=2, hi=64)
        mix = class_mix or {"latency": 0.25, "bulk": 0.75}
        total = sum(mix.values())
        if total <= 0 or any(v < 0 for v in mix.values()):
            raise ValueError(f"class_mix must be non-negative with a positive "
                             f"sum, got {mix}")
        self.class_names = sorted(mix)
        self.class_probs = np.asarray(
            [mix[c] / total for c in self.class_names])
        self.seed = int(seed)

    def trace(self, horizon_s: float) -> List[OpenRequest]:
        """The full deterministic arrival trace over ``[0, horizon_s)``."""
        times = list(self.arrivals.times(horizon_s))
        n = len(times)
        cls_seed, plen_seed, olen_seed = np.random.SeedSequence(
            self.seed).spawn(3)
        classes = np.random.default_rng(cls_seed).choice(
            len(self.class_names), size=n, p=self.class_probs)
        plens = self.prompt_lengths.sample(n, np.random.default_rng(plen_seed))
        olens = self.output_lengths.sample(n, np.random.default_rng(olen_seed))
        return [
            OpenRequest(req_id=i, arrival_s=float(times[i]),
                        slo=self.class_names[int(classes[i])],
                        prompt_len=int(plens[i]),
                        max_new_tokens=int(olens[i]))
            for i in range(n)
        ]

    def offered_rps(self) -> float:
        return self.arrivals.mean_rate()


# --------------------------------------------------------------------------- statistics
def interarrival_stats(times: Sequence[float]) -> Tuple[float, float]:
    """(mean gap, CV^2 of gaps) for an arrival-time sequence.  CV^2 = 1 for
    Poisson, > 1 for bursty, < 1 for regular traffic."""
    gaps = np.diff(np.asarray(times, dtype=np.float64))
    if len(gaps) < 2:
        raise ValueError(f"need >= 3 arrivals for gap stats, got {len(times)}")
    mean = float(gaps.mean())
    var = float(gaps.var())
    return mean, var / (mean * mean) if mean > 0 else float("inf")


def windowed_rates(times: Sequence[float], horizon_s: float,
                   window_s: float) -> Tuple[np.ndarray, np.ndarray]:
    """(window centers, empirical rate per window) — the diurnal-tracking
    assertion's view of a trace."""
    edges = np.arange(0.0, horizon_s + window_s, window_s)
    counts, _ = np.histogram(np.asarray(times), bins=edges)
    centers = 0.5 * (edges[:-1] + edges[1:])
    return centers, counts / window_s


def zipf_tail_slope(samples: Sequence[int], lo: int = 1) -> float:
    """Least-squares slope of log(frequency) vs log(rank) over the sampled
    lengths (ranked by value: ``lo`` is rank 1).  For a Zipf(s) source the
    slope converges to ``-s``; the property test asserts the fitted slope
    is within tolerance of the configured exponent.  Only ranks observed
    at least 5 times enter the fit — the extreme tail is shot noise."""
    vals, counts = np.unique(np.asarray(samples, dtype=np.int64),
                             return_counts=True)
    ranks = vals - lo + 1
    keep = (counts >= 5) & (ranks >= 1)
    if keep.sum() < 3:
        raise ValueError("too few well-populated ranks for a slope fit")
    x = np.log(ranks[keep].astype(np.float64))
    y = np.log(counts[keep].astype(np.float64))
    slope, _ = np.polyfit(x, y, 1)
    return float(slope)
