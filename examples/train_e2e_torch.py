"""End-to-end training driver example on the PyTorch + CUDA port: a ~1M-param
tinyllama-family model for a few hundred steps on the card, with async
incremental checkpointing and restart.

    PYTHONPATH=src python examples/train_e2e_torch.py [--steps 300] [--device cpu]

The port's driver trains with flash attention, so every step launches
``flash_attention`` (in the forward and in each remat replay).
``--ckpt-dir`` defaults to a new temporary directory: the driver resumes
from the newest checkpoint it finds there.

(Full-size runs use the same driver: repro_torch.launch.train --no-reduced.)
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.launch.train import train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--device", default=None,
                    help="where to train: the card by default, 'cpu' for the CPU")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new temporary directory)")
    args = ap.parse_args(argv)

    ns = argparse.Namespace(
        arch=args.arch, reduced=True, steps=args.steps, batch=8, seq=128,
        lr=1e-3, micro_steps=2, seed=0,
        ckpt_dir=args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_example_ckpt_"),
        ckpt_every=50, full_every=4, replicas=2, log_every=25, no_remat=False,
        device=args.device,
    )
    final = train(ns)
    print(f"reached step {final}")
    return final


if __name__ == "__main__":
    main()
