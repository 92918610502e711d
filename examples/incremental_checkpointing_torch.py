"""Fault-tolerance example on the PyTorch + CUDA port: incremental
checkpoints (delta records + CRC32 + dualcast replica), corruption
detection, and elastic restore, with the state on the card.

    PYTHONPATH=src python examples/incremental_checkpointing_torch.py [--device cpu]

``main`` returns the manager's stats and whether the restored state is
exact.  ``--device cpu`` keeps the state on the CPU.
"""
from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.core.engine import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the state lives: the card by default, 'cpu' for the CPU")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    state = {"w": torch.from_numpy(rng.normal(size=(512, 512)).astype(np.float32)).to(dev),
             "m": torch.zeros((512, 512), dtype=torch.float32, device=dev)}

    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(CheckpointConfig(
            directory=str(Path(d) / "ck"), full_every=100, replicas=2, async_save=False))

        mgr.save(1, state)  # full snapshot
        # training drift: 0.5% of weights change per "step"
        for step in (2, 3):
            flat = state["w"].cpu().numpy().reshape(-1).copy()
            idx = rng.choice(flat.size, flat.size // 200, replace=False)
            flat[idx] += 0.01
            state = {**state, "w": torch.from_numpy(flat.reshape(512, 512)).to(dev)}
            mgr.save(step, state)

        print(f"saves: {mgr.all_steps()}  stats: {mgr.stats}")
        print(f"delta saved {mgr.stats['bytes_saved_by_delta']/1e6:.2f}MB vs full snapshots")

        # corrupt the newest save's primary copy; CRC detects it and the replica
        # (dualcast) recovers
        newest = Path(d) / "ck" / "step_00000003"
        victim = next(newest.glob("*.bin"), None) or next(newest.glob("*.npz"))
        raw = bytearray(victim.read_bytes())
        raw[5] ^= 0xFF
        victim.write_bytes(bytes(raw))

        step, restored = mgr.restore(treedef_like=state)
        ok = torch.equal(restored["w"].to(dev), state["w"])
        print(f"restored step {step} after corruption; exact={ok} (replica recovered it)")
    return {"stats": dict(mgr.stats), "step": step, "exact": ok}


if __name__ == "__main__":
    main()
