"""Activation sharding annotations resolved against a context-set mesh and
rules (the JAX package's ``repro.distributed.annotate`` in PyTorch).

``ann(x, "batch", None, "heads", None)`` lays ``x`` out by the rules when a
context is active (the analogue of ``with_sharding_constraint``: a DTensor
is redistributed, a tensor is taken as the full value, the same on every
rank, and becomes a DTensor), and is the identity otherwise, so the same
model code runs unsharded.

Inside ``use_rules`` a tensor met in an operation with a DTensor counts as
replicated (DTensor's ``implicit_replication``): rotary tables, masks and
positions are made whole on every rank, as in the reference.

The context is the process's, not a thread's (the reference keeps it per
thread): autograd runs the backward of CUDA work on a thread of its own,
and a checkpointed layer replays its forward there, under the same rules.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

from repro_torch.distributed.sharding import NamedSharding, ShardingRules, place

_ctx = None  # (mesh, rules) of the innermost use_rules, or None


def _current():
    return _ctx


@contextlib.contextmanager
def use_rules(mesh, rules: ShardingRules):
    from torch.distributed.tensor import DTensor

    global _ctx
    dispatcher = DTensor._op_dispatcher
    prev, prev_implicit = _ctx, dispatcher._allow_implicit_replication
    _ctx = (mesh, rules)
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        _ctx = prev
        dispatcher._allow_implicit_replication = prev_implicit


def logical_sharding(shape, logical_dims) -> Optional[NamedSharding]:
    ctx = _current()
    if ctx is None:
        return None
    mesh, rules = ctx
    return NamedSharding(mesh, rules.spec(shape, logical_dims))


def ann(x: torch.Tensor, *logical_dims):
    """Lay ``x`` out by logical dim names (None = unsharded)."""
    ctx = _current()
    if ctx is None:
        return x
    mesh, rules = ctx
    return place(x, NamedSharding(mesh, rules.spec(x.shape, logical_dims)))


def shard_map(fn, mesh, in_specs, out_specs, reduces=()):
    """``fn`` on each rank's shards (the reference's ``shard_map``, through
    DTensor's ``local_map``).  Tensor arguments are laid out by their spec
    first (None: passed as it is); ``out_specs`` is one spec or a tuple,
    one per output.  Given no DTensor, the outputs come back whole, as
    tensors.

    Gradients, for an input replicated on a mesh axis: where ``fn`` sums
    over that axis itself (``reduces``, with ``all_reduce_sum``, whose
    backward is the identity) each rank's gradient is its share, and they
    are summed there in the backward (Megatron's "f"), so the gradient is
    whole; where the outputs are sharded on the axis it is left a partial
    sum, as DTensor leaves a replicated weight's; otherwise each rank holds
    the whole gradient already."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding import placements

    many = isinstance(out_specs, tuple)
    out_pl = [placements(mesh, s) for s in (out_specs if many else (out_specs,))]
    names = list(mesh.mesh_dim_names)

    def grad_pl(pl):
        return [p if isinstance(p, Shard) or names[i] in reduces
                else Partial() if any(isinstance(o[i], Shard) for o in out_pl)
                else Replicate() for i, p in enumerate(pl)]

    def call(*args):
        given = any(is_dtensor(a) for a in args)
        in_pl, grads, placed, sum_back = [], [], [], []
        for a, s in zip(args, in_specs):
            if s is None or not isinstance(a, torch.Tensor):
                in_pl.append(None)
                grads.append(None)
                placed.append(a)
                sum_back.append(())
                continue
            pl = placements(mesh, s)
            in_pl.append(pl)
            grads.append(grad_pl(pl))
            placed.append(place(a, NamedSharding(mesh, s)))
            sum_back.append(tuple(mesh.get_group(names[i]) for i, p in enumerate(pl)
                                  if not isinstance(p, Shard) and names[i] in reduces))

        def local(*xs):
            return fn(*(_SumGradOver.apply(x, g) if g and x.requires_grad else x
                        for x, g in zip(xs, sum_back)))

        out = local_map(local, out_placements=out_pl if many else out_pl[0],
                        in_placements=tuple(in_pl), in_grad_placements=tuple(grads),
                        device_mesh=mesh)(*placed)
        if given:
            return out
        return tuple(full(o) for o in out) if many else full(out)

    return call


class _SumGradOver(torch.autograd.Function):
    """The identity; the backward sums the gradient over process groups."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.clone()
        for grp in ctx.groups:
            dist.all_reduce(g, group=grp)
        return g, None


class _AllReduceSum(torch.autograd.Function):
    """Sum over process groups; the backward is the identity (each rank
    already holds the whole cotangent of the replicated sum)."""

    @staticmethod
    def forward(ctx, x, groups):
        import torch.distributed as dist

        x = x.clone()
        for g in groups:
            dist.all_reduce(x, group=g)
            all_reduce_sum.launches += 1
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``psum`` of a local tensor over mesh ``axes`` (a name or a tuple)."""
    from repro_torch.distributed.sharding import _as_tuple

    return _AllReduceSum.apply(x, [mesh.get_group(a) for a in _as_tuple(axes)])


all_reduce_sum.launches = 0  # all_reduce calls made (one a group)


def axis_index(mesh, axes) -> int:
    """This rank's index along mesh ``axes`` taken together, major first
    (JAX's ``axis_index`` of a tuple of axes)."""
    from repro_torch.distributed.sharding import _as_tuple

    r = 0
    for a in _as_tuple(axes):
        r = r * mesh.size(list(mesh.mesh_dim_names).index(a)) + mesh.get_local_rank(a)
    return r


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def full(x):
    """The whole value of ``x`` as a tensor (a DTensor is gathered; a
    tensor comes back as it is).  Differentiable, but a tensor taken out
    this way must go back in through ``ann`` (or ``place``) before it
    meets a DTensor again: the gradient of a tensor replicated implicitly
    inside a DTensor operation is a DTensor, which the way out cannot
    take."""
    return x.full_tensor() if is_dtensor(x) else x


def replicate(x):
    """``x`` replicated on every rank, still a DTensor (a tensor comes back
    as it is)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def unflatten(t: torch.Tensor, dim: int, sizes) -> torch.Tensor:
    """``t`` with dimension ``dim`` split into ``sizes`` (a reshape).
    DTensor cannot split a dimension sharded over more ranks than its first
    part has entries (XLA reshards there by itself, e.g. tinyllama's 4 KV
    heads at tp 16, or 8 microbatches of a batch split 16 ways): such a
    DTensor is gathered on that dimension first."""
    dim = dim % t.ndim
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard

        mesh = t.device_mesh
        on = [isinstance(pl, Shard) and pl.dim == dim for pl in t.placements]
        if sizes[0] % math.prod(mesh.size(i) for i, o in enumerate(on) if o):
            t = t.redistribute(mesh, [Replicate() if o else pl
                                      for pl, o in zip(t.placements, on)])
    return t.unflatten(dim, sizes)
