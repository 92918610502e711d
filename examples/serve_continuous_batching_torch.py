"""Serving example on the PyTorch + CUDA port: continuous batching with the
Vhost-style 3-stage async pipeline (paper §6.4) on the card: batched
prompt copies through the engine (``memcpy_words``, and
``batch_copy_pages`` where a burst's chunks fuse), in-order admission via
the reorder array, decode overlapped with page movement; then the paged
KV pool's swaps, each one ``batch_copy_pages`` launch.

    PYTHONPATH=src python examples/serve_continuous_batching_torch.py [--device cpu]

``--device cpu`` serves on the CPU with the kernels' plain versions.
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
from repro_torch.serving.kv_pool import PagedKVPool
from repro_torch.serving.pipeline import Request, VhostStyleServer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where to serve: the card by default, 'cpu' for the CPU")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("gemma3-1b").reduced()
    model = build_model(cfg, remat=False, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))

    server = VhostStyleServer(model, params, slots=4, max_cache_len=96,
                              device=make_device(n_instances=2, policy="least_loaded",
                                                 device=dev))
    rng = np.random.default_rng(0)
    for i in range(10):
        server.enqueue(Request(req_id=i,
                               prompt=rng.integers(0, cfg.vocab_size, 24).astype(np.int32),
                               max_new_tokens=6))
    t0 = time.perf_counter()
    steps = server.run_until_drained()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    m = server.metrics
    print(f"served {m['completed']} requests in {steps} pipeline steps / {dt:.1f}s; "
          f"{m['decoded_tokens']} tokens; {m['copy_bursts']} batched copy bursts")

    # --- two-tier paged KV pool: batch-descriptor swap in/out -----------------
    # the pool's tiers live where the server's engines run, and its swaps go
    # through them as batch descriptors
    kv_dim = cfg.num_kv_heads * cfg.head_dim
    pool = PagedKVPool(n_device_pages=16, n_host_pages=32, page_tokens=16,
                       kv_dim=kv_dim, device=server.device)
    pool.alloc(seq_id=0, n_pages=4)
    for p in range(4):
        pool.write_page(0, p, torch.ones((16, kv_dim), device=dev) * p)
    before = pool.read_pages(0).clone()
    pool.swap_out(0)   # device -> host, ONE batch descriptor
    pool.swap_in(0)    # host -> device
    round_trip = torch.equal(pool.read_pages(0), before)
    assert round_trip
    print(f"kv pool: {pool.stats.pages_moved} pages moved in "
          f"{pool.stats.batch_copies} batch copies; roundtrip ok")
    return {"completed": m["completed"], "steps": steps,
            "decoded_tokens": m["decoded_tokens"], "copy_bursts": m["copy_bursts"],
            "pages_moved": pool.stats.pages_moved, "batch_copies": pool.stats.batch_copies,
            "round_trip": round_trip}


if __name__ == "__main__":
    main()
