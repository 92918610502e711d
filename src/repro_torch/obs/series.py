"""Bounded ring-buffer time series — the storage primitive of the sampler.

pcm-accel keeps a sliding window of per-interval accelerator counters; a
``Series`` is that window for one metric: ``(t, value)`` pairs in a deque
with a hard capacity, so a sampler left running for hours holds a bounded
tail (capacity x interval seconds of history) instead of growing without
limit.  ``summary()`` gives the windowed p50/p95/max/mean rollup the
overload experiments read."""
from __future__ import annotations

import collections
import math
from typing import Iterator, List, Optional, Tuple


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) over a non-empty list."""
    if not values:
        raise ValueError("percentile of empty series")
    ordered = sorted(values)
    rank = max(int(math.ceil(q / 100.0 * len(ordered))), 1)
    return ordered[rank - 1]


class Series:
    """One metric's bounded time series of ``(t, value)`` samples."""

    def __init__(self, name: str, capacity: int = 600, unit: str = ""):
        if capacity < 1:
            raise ValueError(f"Series capacity must be >= 1, got {capacity}")
        self.name = name
        self.unit = unit
        self.capacity = capacity
        self._buf: collections.deque = collections.deque(maxlen=capacity)

    def append(self, t: float, value: float) -> None:
        self._buf.append((t, float(value)))

    def __len__(self) -> int:
        return len(self._buf)

    def __iter__(self) -> Iterator[Tuple[float, float]]:
        return iter(self._buf)

    @property
    def times(self) -> List[float]:
        return [t for t, _ in self._buf]

    @property
    def values(self) -> List[float]:
        return [v for _, v in self._buf]

    def last(self) -> Optional[float]:
        return self._buf[-1][1] if self._buf else None

    def window(self, window_s: Optional[float] = None) -> List[Tuple[float, float]]:
        """The samples of the trailing ``window_s`` seconds (all when None)."""
        if window_s is None or not self._buf:
            return list(self._buf)
        cutoff = self._buf[-1][0] - window_s
        return [(t, v) for t, v in self._buf if t >= cutoff]

    def sum(self) -> float:
        """Sum of the buffered values — for delta series (bytes/ops per
        tick) this is the total over the retained window, which equals the
        all-time total while nothing has rotated out."""
        return sum(v for _, v in self._buf)

    def summary(self, window_s: Optional[float] = None) -> dict:
        """p50/p95/max/mean/last over the trailing window (empty -> zeros)."""
        vals = [v for _, v in self.window(window_s)]
        if not vals:
            return {"n": 0, "p50": 0.0, "p95": 0.0, "max": 0.0,
                    "mean": 0.0, "last": 0.0}
        return {
            "n": len(vals),
            "p50": percentile(vals, 50),
            "p95": percentile(vals, 95),
            "max": max(vals),
            "mean": sum(vals) / len(vals),
            "last": vals[-1],
        }

    def __repr__(self) -> str:
        tail = f", last={self.last():.3g}" if self._buf else ""
        return (f"Series({self.name!r}, n={len(self)}/{self.capacity}"
                f"{tail})")
