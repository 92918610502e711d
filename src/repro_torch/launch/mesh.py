"""Mesh construction (the JAX package's ``repro.launch.mesh`` in PyTorch).

FUNCTIONS, not module constants: importing this module starts no process
group.  Single pod: 16x16 = 256 ranks ("data", "model").  Multi-pod:
2x16x16 = 512 ranks ("pod", "data", "model"): the "pod" axis is the
data-parallel axis that crosses the inter-pod network.  Both need a world
of that size already set up (``torch.distributed.init_process_group``);
the tests build them under the fake process group.

The reference's ``axis_types_kw`` (JAX's Auto / Explicit axis types) has no
counterpart: a ``DeviceMesh`` has no axis types, and activations follow
DTensor's propagation, constrained by ``repro_torch.distributed.ann``.
"""
from __future__ import annotations

import socket

import torch


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_host_mesh(device=None):
    """A (1, 1) ("data", "model") mesh on the caller's device: CUDA unless
    ``device`` says otherwise.  Starts a world-1 process group when none
    exists, at a free local port: NCCL for CUDA tensors (with gloo beside
    it for CPU tensors, so a CPU host mesh can follow in the same process),
    gloo alone for the CPU."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_host_mesh: no CUDA device; pass device='cpu' for the CPU")
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index if dev.index is not None
                                  else torch.cuda.current_device())
        dist.init_process_group(
            "cpu:gloo,cuda:nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1)
    elif dist.get_world_size() != 1:
        raise RuntimeError("make_host_mesh: the process group has "
                           f"{dist.get_world_size()} ranks; the host mesh is one")
    return init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data", "model"))
