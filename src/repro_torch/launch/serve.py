"""Serving entry point: continuous batching with the Vhost-style 3-stage pipeline,
on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --requests 16 --slots 4 --max-new 8

Serves ``cfg.reduced()`` with random weights made from ``--seed``, as the
reference does.  It runs on the card and raises where no CUDA card is
present; ``--device cpu`` serves on the CPU with the kernels' plain
versions.  The prompt copies launch ``memcpy_words`` and, where a burst's
chunks fuse, ``batch_copy_pages``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import make_device
from repro_torch.core.engine import resolve_device
from repro_torch.models.api import build_model
from repro_torch.serving.pipeline import Request, VhostStyleServer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-cache", type=int, default=128)
    ap.add_argument("--instances", type=int, default=2)
    ap.add_argument("--policy", default="least_loaded",
                    choices=["round_robin", "least_loaded", "sticky"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where to serve: the card by default, 'cpu' for the CPU")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    model = build_model(cfg, remat=False, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    server = VhostStyleServer(
        model, params, slots=args.slots, max_cache_len=args.max_cache,
        device=make_device(n_instances=args.instances, policy=args.policy, device=dev),
    )

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for i in range(args.requests):
        server.enqueue(
            Request(req_id=i,
                    prompt=rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32),
                    max_new_tokens=args.max_new)
        )
    steps = server.run_until_drained()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    m = server.metrics
    ps = server.device.policy_stats
    placed = ", ".join(f"{k}={v}" for k, v in sorted(ps["decisions"].items()))
    print(f"served {m['completed']}/{args.requests} requests in {steps} pipeline steps, "
          f"{dt:.2f}s; decoded {m['decoded_tokens']} tokens "
          f"({m['decoded_tokens']/dt:.1f} tok/s); copy bursts {m['copy_bursts']}; "
          f"policy {ps['policy']} placements [{placed}]; on "
          f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'the CPU'}")
    if m["completed"] != args.requests:
        raise SystemExit(f"only {m['completed']} of {args.requests} requests completed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
