"""End-to-end training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

Integrates the substrate layers the port has: synthetic data pipeline
(async prefetch from pinned memory), the dense model family with flash
attention, AdamW + grad
accumulation + clipping, async incremental checkpointing (delta + CRC, the
CRC kernel with ``--crc-impl kernel``), heartbeat + straggler tracking, and
restart-from-checkpoint on failure.  It trains on the host mesh
(``launch.mesh.make_host_mesh``: one rank, ("data", "model") of (1, 1)),
under the mesh's sharding rules, with the parameters laid out by
``tree_shardings`` and the AdamW moments by the ZeRO-1 specs
(``opt_state_shardings``), as DTensors; checkpoints restore onto the same
layout.  It runs on the card; ``--device cpu`` runs it on the CPU (gloo)
with the kernels' plain versions.  ``--layers`` cuts the depth.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import torch

from repro_torch import tree as _tree
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import make_device
from repro_torch.core.engine import resolve_device
from repro_torch.data.pipeline import Prefetcher, SyntheticLMDataset
from repro_torch.distributed.annotate import use_rules
from repro_torch.distributed.fault import Heartbeat, StragglerDetector, run_with_restarts
from repro_torch.distributed.params import opt_state_shardings, tree_shardings
from repro_torch.distributed.sharding import place, rules_for_mesh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models.api import build_model
from repro_torch.optim.adamw import AdamW, cosine_schedule


def train(args) -> int:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if getattr(args, "layers", None):
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    dev = resolve_device(getattr(args, "device", None))
    mesh = make_host_mesh(dev)
    rules = rules_for_mesh(mesh)
    # flash attention: the kernel in every forward and remat replay (the
    # JAX package's driver keeps the model's default, the chunked path)
    model = build_model(cfg, mesh=mesh, remat=not args.no_remat, attn_impl="flash", device=dev)
    opt = AdamW(lr=cosine_schedule(args.lr, warmup=20, total=max(args.steps, 21)))
    step_fn = make_train_step(model, opt, micro_steps=args.micro_steps)

    # checkpoint traffic (kernel CRCs when enabled) shares one engine pool
    device = make_device(n_instances=getattr(args, "instances", 1),
                         policy=getattr(args, "policy", "round_robin"), device=dev)
    ckpt = CheckpointManager(
        CheckpointConfig(directory=args.ckpt_dir, full_every=args.full_every,
                         replicas=args.replicas, async_save=True,
                         crc_impl=getattr(args, "crc_impl", "zlib")),
        device=device,
    )
    dataset = SyntheticLMDataset(cfg, args.batch, args.seq, seed=args.seed)
    hb = Heartbeat(str(Path(args.ckpt_dir) / "hb"), rank=0)
    straggler = StragglerDetector()

    def run(start_step: int) -> int:
        params = model.init(torch.Generator(dev).manual_seed(args.seed))
        opt_state = opt.init(params)
        shardings = {"params": tree_shardings(params, mesh, rules),
                     "opt": opt_state_shardings(opt_state, params, mesh, rules)}
        params = _tree.tree_map(place, params, shardings["params"])
        opt_state = _tree.tree_map(place, opt_state, shardings["opt"])
        if start_step > 0:
            s, tree = ckpt.restore(shardings=shardings,
                                   treedef_like={"params": params, "opt": opt_state})
            params, opt_state = tree["params"], tree["opt"]
            start_step = s
            print(f"[train] resumed from step {s}")
        prefetch = Prefetcher(dataset, start_step=start_step, device=dev)
        losses = []
        try:
            with use_rules(mesh, rules):
                for i in range(start_step, args.steps):
                    t0 = time.perf_counter()
                    step_i, batch = next(prefetch)
                    params, opt_state, metrics = step_fn(params, opt_state, batch)
                    loss = float(metrics["loss"])
                    losses.append(loss)
                    dt = time.perf_counter() - t0
                    straggler.record(0, dt)
                    hb.beat(i)
                    if (i + 1) % args.ckpt_every == 0:
                        ckpt.save(i + 1, {"params": params, "opt": opt_state})
                    if (i + 1) % args.log_every == 0:
                        print(
                            f"step {i+1:5d} loss {loss:.4f} gnorm "
                            f"{float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms",
                            flush=True,
                        )
        finally:
            prefetch.stop()
        ckpt.save(args.steps, {"params": params, "opt": opt_state})
        ckpt.wait()
        print(f"[train] done; first loss {losses[0]:.4f} last loss {losses[-1]:.4f}; "
              f"ckpt stats {ckpt.stats}")
        return args.steps

    return run_with_restarts(run, ckpt.latest_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--no-reduced", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--micro-steps", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--full-every", type=int, default=4)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--instances", type=int, default=1)
    ap.add_argument("--policy", default="round_robin",
                    choices=["round_robin", "least_loaded", "sticky"])
    ap.add_argument("--crc-impl", default="zlib", choices=["zlib", "kernel"])
    ap.add_argument("--device", default=None,
                    help="where to train: the card by default, 'cpu' for the CPU")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (width unchanged)")
    args = ap.parse_args(argv)
    train(args)


if __name__ == "__main__":
    main()
