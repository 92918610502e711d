"""Quickstart on the PyTorch + CUDA port: the DSA-style streaming engine in
60 lines, on the card.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The entry point is a ``Device``: N engine instances (paper Fig. 10) behind
a submit policy.  Every submission returns a ``Future``: wait on it, poll
it, chain host work with ``.then``, or pass it as ``after=`` to fence a
later descriptor on it (DSA batch-fence semantics across submissions).
The copies launch ``memcpy_words``, the CRC ``crc32_chunk_states`` and its
fold, the delta section ``delta_record_words`` and ``delta_apply_words``,
and the batch ``batch_copy_pages``.  ``--device cpu`` runs the kernels'
plain versions on the CPU.
"""
from __future__ import annotations

import argparse
import zlib

import numpy as np
import torch

from repro_torch.core import OpType, WorkDescriptor, make_device
from repro_torch.core.engine import resolve_device


def words(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A uint32 numpy array as a uint32 tensor on ``dev`` (moved as int32:
    the same bits)."""
    return torch.from_numpy(a.view(np.int32).copy()).to(dev).view(torch.uint32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the engines run: the card by default, 'cpu' for the CPU")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {}

    # A device over 2 engine instances, placing each submission on the least
    # loaded instance (paper Fig. 10: multi-instance load balancing).
    device = make_device(n_instances=2, policy="least_loaded", device=dev)

    # --- async memcpy (G2: async always) ------------------------------------
    x_np = np.random.default_rng(0).normal(size=(1024, 128)).astype(np.float32)
    x = torch.from_numpy(x_np).to(dev)
    fut = device.memcpy_async(x)
    # ... host does other work here while the engine streams ...
    y = fut.result()
    assert torch.equal(y, x)
    out["memcpy_bytes"] = fut.record.bytes_processed
    print(f"memcpy: {fut.record.bytes_processed} bytes, "
          f"modeled H100 time {fut.record.modeled_time_us:.1f}us, status={fut.status.name}")

    # --- chaining: host continuation fires when the CRC retires --------------
    crc_hex = device.crc32_async(x).then(lambda c: f"0x{int(c):08x}")
    assert crc_hex.result() == f"0x{zlib.crc32(x_np.astype('<f4').tobytes()) & 0xFFFFFFFF:08x}"
    out["crc32"] = crc_hex.result()
    print(f"crc32: {crc_hex.result()} (matches zlib, via .then)")

    # --- dependency fences: `after=` defers launch until parents retire ------
    gate = device.promise()  # a host-event fence
    fenced = device.memcpy_async(x, after=[gate])
    device.kick()
    out["fence_held"] = not fenced.done()
    assert out["fence_held"]  # parked in the engine's fence list, not launched
    gate.set_result(None)     # host event fires -> the engine releases the copy
    assert torch.equal(fenced.result(), x)
    print("fence: copy deferred until the promise retired, then launched")

    # --- delta records (incremental state) -----------------------------------
    base_np = np.random.default_rng(1).integers(0, 2**31, 4096).astype(np.uint32)
    changed_np = base_np.copy()
    changed_np[[7, 99, 2048]] += 1
    base, changed = words(base_np, dev), words(changed_np, dev)
    offsets, data, count, overflow = device.delta_create_async(changed, base, cap=64).result()
    restored = device.delta_apply(base, offsets, data)
    assert torch.equal(restored.view(torch.int32), changed.view(torch.int32))
    out["delta_count"], out["delta_overflow"] = int(count), bool(overflow)
    print(f"delta: {int(count)} changed words, overflow={bool(overflow)}; roundtrip exact")

    # --- batch descriptor (F2: one submission, many copies) ------------------
    descs = [WorkDescriptor(op=OpType.MEMCPY,
                            src=torch.full((8, 128), i, dtype=torch.float32, device=dev))
             for i in range(8)]
    outs = device.batch_async(descs).result()
    out["batch"] = [o.cpu() for o in outs]
    print(f"batch: {len(outs)} copies fused into one kernel launch")

    # --- where did the policy place everything? ------------------------------
    device.drain()
    placed = dict(device.policy_stats["decisions"])
    out["placements"] = placed
    print(f"policy={device.policy_stats['policy']} placements={placed}")
    print("done.")
    return out


if __name__ == "__main__":
    main()
