"""Distributed-optimization collectives (the JAX package's
``repro.distributed.collectives`` in PyTorch).

* ``ring_all_reduce`` -- the sum over one mesh axis as a reduce-scatter of
  the padded, flattened tensor followed by an all-gather (the reference's
  ``psum_scatter`` + ``all_gather`` inside ``shard_map``).
* ``compressed_psum_tree`` -- int8 symmetric quantization with error
  feedback (the residual is carried into the next step), cutting gradient
  all-reduce bytes 4x on the wire.

Each rank passes its own value (a tensor, or a DTensor whose local shard
is used) and gets the reduced value back as a tensor.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch import tree as _tree
from repro_torch.optim.gradients import compress_int8, decompress_int8


def _local(x):
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def ring_all_reduce(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """Sum of ``x`` over ``axis``: reduce-scatter my 1/n, then all-gather."""
    import torch.distributed as dist

    x = _local(x)
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if n == 1:
        return x
    group = mesh.get_group(axis)
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    mine = flat.new_empty(flat.numel() // n)
    dist.reduce_scatter_tensor(mine, flat.contiguous(), group=group)
    full = flat.new_empty(flat.numel())
    dist.all_gather_into_tensor(full, mine, group=group)
    return full[: x.numel()].reshape(x.shape)


def compressed_psum_tree(grads: Any, mesh, axis: str, error_fb: Optional[Any] = None
                         ) -> Tuple[Any, Any]:
    """int8 + error-feedback gradient reduction over ``axis``.

    Returns (reduced grads, new error feedback tree).  Quantization happens
    before the wire: the int8 values are summed as int32 and the scales
    averaged; the residual ``g32 - decompress(q, scale)`` is added to the
    NEXT step's gradient."""
    import torch.distributed as dist

    n = mesh.size(mesh.mesh_dim_names.index(axis))
    group = mesh.get_group(axis)
    if error_fb is None:
        error_fb = _tree.tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                                        device=g.device), grads)

    def one(g, e):
        g = _local(g)
        g32 = g.to(torch.float32) + _local(e)
        q, scale = compress_int8(g32)
        qsum = q.to(torch.int32)
        ssum = scale.clone()
        if n > 1:
            dist.all_reduce(qsum, group=group)
            dist.all_reduce(ssum, group=group)
        ssum = ssum / n  # pmean of the scales
        red = (qsum.to(torch.float32) * ssum / n).to(g.dtype)
        new_e = g32 - decompress_int8(q, scale, torch.float32)
        return red, new_e

    flat_g, treedef = _tree.flatten(grads)
    flat_e = _tree.flatten_like(treedef, error_fb)
    outs = [one(g, e) for g, e in zip(flat_g, flat_e)]
    return (_tree.unflatten(treedef, [o[0] for o in outs]),
            _tree.unflatten(treedef, [o[1] for o in outs]))
