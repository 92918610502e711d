"""Fault tolerance & straggler mitigation for the multi-pod launcher
(the JAX package's ``repro.distributed.fault``, which is pure Python).

On a real cluster each host runs one process (torch.distributed); here the
protocol is exercised with simulated ranks.  Components:

* ``Heartbeat`` — per-rank liveness file updated every step; the monitor
  declares a rank dead after ``timeout_s`` and triggers restart-from-
  checkpoint (the driver owns the restart).
* ``StragglerDetector`` — per-rank step-time EWMA + z-score over the fleet;
  persistent outliers are flagged with a pluggable policy (log / exclude).
* ``RestartPolicy`` — bounded restarts with exponential backoff, always from
  the newest CRC-valid checkpoint (CheckpointManager.restore already skips
  corrupt saves).
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional


class Heartbeat:
    def __init__(self, directory: str, rank: int):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.rank = rank
        self.path = self.dir / f"rank_{rank:05d}.hb"

    def beat(self, step: int):
        self.path.write_text(json.dumps({"step": step, "t": time.time()}))


class HeartbeatMonitor:
    def __init__(self, directory: str, world_size: int, timeout_s: float = 60.0):
        self.dir = Path(directory)
        self.world_size = world_size
        self.timeout_s = timeout_s

    def dead_ranks(self, now: Optional[float] = None) -> List[int]:
        now = time.time() if now is None else now
        dead = []
        for r in range(self.world_size):
            p = self.dir / f"rank_{r:05d}.hb"
            if not p.exists():
                dead.append(r)
                continue
            try:
                t = json.loads(p.read_text())["t"]
            except (json.JSONDecodeError, KeyError):
                dead.append(r)
                continue
            if now - t > self.timeout_s:
                dead.append(r)
        return dead

    def all_alive(self) -> bool:
        return not self.dead_ranks()


@dataclasses.dataclass
class StragglerDetector:
    """EWMA step time per rank + fleet z-score flagging."""

    alpha: float = 0.2
    z_threshold: float = 3.0
    min_samples: int = 8
    _ewma: Dict[int, float] = dataclasses.field(default_factory=dict)
    _count: Dict[int, int] = dataclasses.field(default_factory=dict)

    def record(self, rank: int, step_time_s: float):
        prev = self._ewma.get(rank, step_time_s)
        self._ewma[rank] = (1 - self.alpha) * prev + self.alpha * step_time_s
        self._count[rank] = self._count.get(rank, 0) + 1

    def stragglers(self) -> List[int]:
        ranks = [r for r, c in self._count.items() if c >= self.min_samples]
        if len(ranks) < 4:
            return []
        vals = [self._ewma[r] for r in ranks]
        mean = sum(vals) / len(vals)
        var = sum((v - mean) ** 2 for v in vals) / len(vals)
        std = max(var ** 0.5, 1e-9)
        return [r for r in ranks if (self._ewma[r] - mean) / std > self.z_threshold]


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 16
    backoff_base_s: float = 0.1
    backoff_max_s: float = 60.0
    _restarts: int = 0

    def should_restart(self) -> bool:
        return self._restarts < self.max_restarts

    def backoff(self) -> float:
        d = min(self.backoff_base_s * (2 ** self._restarts), self.backoff_max_s)
        self._restarts += 1
        return d


def run_with_restarts(
    train_fn: Callable[[int], int],
    checkpointed_step: Callable[[], Optional[int]],
    policy: Optional[RestartPolicy] = None,
    sleep=time.sleep,
) -> int:
    """Driver loop: run train_fn(start_step); on failure, back off and resume
    from the newest valid checkpoint.  Returns the final step reached."""
    policy = policy or RestartPolicy()
    start = checkpointed_step() or 0
    while True:
        try:
            return train_fn(start)
        except Exception as e:  # noqa: BLE001 — node failure analogue
            if not policy.should_restart():
                raise
            sleep(policy.backoff())
            start = checkpointed_step() or 0
            print(f"[fault] restarting from step {start} after {type(e).__name__}: {e}")
